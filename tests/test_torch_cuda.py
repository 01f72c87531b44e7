"""PyTorch port on the card: the fused MLP kernels (forward K1, backward K2)
against their plain versions.

Needs an NVIDIA card and nvcc, and skips elsewhere. Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.weights import load_nerf_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_backward,
    fused_nerf_mlp_backward_reference,
    fused_nerf_mlp_reference,
    unpack_grads,
)
from nerf_rs_tpu_torch.render import render_image

pytestmark = pytest.mark.cuda

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
# Kernel against plain version: f32 differs by summation order only; bf16
# by summation order between bf16 roundings (tests/test_fused_mlp.py's bars).
TOL = {"float32": (1e-4, 1e-3, 1e-4), "bfloat16": (2e-2, 2e-2, 2e-2)}
# Backward kernel against plain version, per gradient ||g_k - g_p|| / ||g_p||:
# f32 differs by summation order; bf16 also by where that order flips a
# bf16 rounding of a layer's output gradient.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def np_params(arch, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return out


def inputs(rays, samples, seed, device):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(rays, samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(rays, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return torch.from_numpy(pts).to(device), torch.from_numpy(dirs).to(device)


def check(net, pts, dirs, dtype, sigma_only):
    rgb_atol, sig_atol, sig_rtol = TOL[dtype]
    before = fused_nerf_mlp.launches
    rgb, sig = fused_nerf_mlp(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert fused_nerf_mlp.launches == before + 1
    rgb_r, sig_r = fused_nerf_mlp_reference(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    assert rgb.shape == rgb_r.shape and sig.shape == sig_r.shape
    torch.testing.assert_close(rgb, rgb_r, atol=rgb_atol, rtol=0)
    torch.testing.assert_close(sig, sig_r, atol=sig_atol, rtol=sig_rtol)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ArchConfig(width=128, v_width=64, depth=4, skip_at=2),
                                  ArchConfig(width=100, v_width=36, depth=3, skip_at=5)],
                         ids=["small", "unaligned_noskip"])
def test_kernel_matches_plain_ragged(card, arch, dtype, sigma_only):
    """A ragged sample count (37 x 29 = 1073, not a tile multiple), per-ray dirs."""
    net = NerfMLP(np_params(arch, 0), device=card)
    pts, dirs = inputs(37, 29, 1, card)
    check(net, pts, dirs, dtype, sigma_only)
    check(net, pts, dirs.expand(37, 29, 3).contiguous(), dtype, sigma_only)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_kernel_matches_plain_lego(card, net, dtype):
    module = NerfMLP(load_nerf_params(LEGO / net), device=card)
    pts, dirs = inputs(64, 96, 2, card)
    check(module, pts * 0.4, dirs, dtype, net == "coarse")


def test_kernel_refuses_what_it_does_not_take(card):
    net = NerfMLP(np_params(ArchConfig(width=128, v_width=64, depth=4, skip_at=2), 3),
                  device=card)
    pts, dirs = inputs(4, 8, 3, card)
    with pytest.raises(TypeError):
        fused_nerf_mlp(net, pts.double(), dirs)
    with pytest.raises(ValueError, match="contiguous"):
        fused_nerf_mlp(net, pts.transpose(0, 1), dirs.transpose(0, 1))
    with pytest.raises(ValueError, match="viewdirs on"):
        fused_nerf_mlp(net, pts, dirs.cpu())


def test_render_on_card_matches_cpu(card):
    """A small lego frame through the kernel on the card against the
    plain version on the CPU."""
    cam = camera_from_golden(load_golden(LEGO / "tf_reference_samples.json"))
    coarse, fine = (load_nerf_params(LEGO / n) for n in ("coarse", "fine"))
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=512, impl="pallas")
    before = fused_nerf_mlp.launches
    gpu = render_image(coarse, fine, cam, 32, 32, random.key(0, card), cfg, device=card)
    assert fused_nerf_mlp.launches == before + 2 * 2
    cpu = render_image(coarse, fine, cam, 32, 32, random.key(0, "cpu"), cfg)
    mse = float(((gpu.cpu().double() - cpu.double()) ** 2).mean())
    assert -10 * np.log10(max(mse, 1e-20)) > 60.0


def rel_err(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def backward_pair(net, pts, dirs, g_rgb, g_sig, dtype, sigma_only):
    kw = dict(dtype=dtype, sigma_only=sigma_only)
    before = fused_nerf_mlp_backward.launches
    got = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig, **kw)
    torch.cuda.synchronize()
    assert fused_nerf_mlp_backward.launches == before + 1
    want = fused_nerf_mlp_backward_reference(net, pts, dirs, g_rgb, g_sig, **kw)
    return got, want


def cotangents(shape, seed, device):
    rng = np.random.default_rng(seed)
    g_rgb = torch.from_numpy(rng.normal(size=(*shape, 3)).astype(np.float32)).to(device)
    g_sig = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    return g_rgb, g_sig


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [SMALL, ArchConfig(width=100, v_width=36, depth=3, skip_at=5)],
                         ids=["small", "unaligned_noskip"])
def test_backward_kernel_matches_plain_ragged(card, arch, dtype, sigma_only):
    """K2 on a ragged sample count (37 x 29, not a tile multiple) with one
    dir per ray: every leaf's gradient, d(points) and d(dirs)."""
    net = NerfMLP(np_params(arch, 4), device=card)
    pts, dirs = inputs(37, 29, 5, card)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 6, card)
    got, want = backward_pair(net, pts, dirs, g_rgb, g_sig, dtype, sigma_only)
    pk = net.packed(dtype)
    tree_k, tree_p = unpack_grads(pk, got[0], got[1]), unpack_grads(pk, want[0], want[1])
    for layer in tree_p:
        for part in ("kernel", "bias"):
            want_leaf = tree_p[layer][part]
            if sigma_only and layer in ("bottleneck", "viewdirs", "rgb"):
                assert not tree_k[layer][part].any() and not want_leaf.any()
            else:
                assert rel_err(tree_k[layer][part], want_leaf) <= BWD_TOL[dtype], (layer, part)
    assert rel_err(got[2], want[2]) <= BWD_TOL[dtype]
    if sigma_only:
        assert not got[3].any()
    else:
        assert rel_err(got[3], want[3]) <= BWD_TOL[dtype]


def test_backward_kernel_is_deterministic(card):
    net = NerfMLP(np_params(SMALL, 7), device=card)
    pts, dirs = inputs(64, 48, 8, card)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 9, card)
    a = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig)
    b = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_autograd_through_kernels_matches_plain_autograd(card):
    """fused_nerf_mlp's gradients on the card (K1 + K2) against torch
    autograd of the plain oracle, leaf by leaf; sigma-only leaves the color
    branch at exactly zero."""
    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    for sigma_only in (False, True):
        net = NerfMLP(np_params(SMALL, 10), device=card, requires_grad=True)
        pts, dirs = inputs(16, 40, 11, card)
        grads = []
        before = fused_nerf_mlp_backward.launches
        for fn in (fused_nerf_mlp, nerf_mlp):
            net.zero_grad()
            rgb, sig = fn(net, pts, dirs, sigma_only=sigma_only)
            (rgb.square().sum() + 1e-2 * sig.sum()).backward()
            grads.append({k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                          for k, p in net.weights.items()})
        assert fused_nerf_mlp_backward.launches == before + 1
        for k, want in grads[1].items():
            if sigma_only and k.startswith(("bottleneck", "viewdirs", "rgb")):
                assert not grads[0][k].any(), k
            else:
                assert rel_err(grads[0][k], want) <= BWD_TOL["float32"], k


def test_train_step_kernels_match_plain(card):
    """One train step on the card from the same state, batch and key:
    impl="pallas" (K1 and K2) against impl="xla" (the plain MLP). Loss to
    1e-5; parameters within tests/test_train.py's bound, over all entries
    (the fine samples move with the coarse sigmas' last bits)."""
    from nerf_rs_tpu_torch.config import TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.train import create_train_state, train_step

    cfg = TrainConfig(batch_rays=4096, arch=SMALL,
                      render=RenderConfig(n_coarse=16, n_fine=32, ray_chunk=4096))
    teacher = {net: load_nerf_params(LEGO / net) for net in ("coarse", "fine")}
    batch = next(DistillationDataset(teacher, cfg=cfg.render.replace(impl="pallas"),
                                     device=card).batches(cfg.batch_rays))
    states, losses = {}, {}
    before = fused_nerf_mlp_backward.launches
    for impl in ("pallas", "xla"):
        state = create_train_state(torch.Generator(device=card).manual_seed(0), cfg)
        step_cfg = cfg.replace(render=cfg.render.replace(impl=impl))
        states[impl], metrics = train_step(state, batch, random.key(1, card), step_cfg)
        losses[impl] = {k: float(v) for k, v in metrics.items()}
    assert fused_nerf_mlp_backward.launches == before + 2
    assert abs(losses["pallas"]["loss"] - losses["xla"]["loss"]) <= 1e-5 * losses["xla"]["loss"], \
        losses
    diffs = {(net, name): (p.detach() - states["xla"].params[net].weights[name].detach()).abs()
             for net in ("coarse", "fine")
             for name, p in states["pallas"].params[net].weights.items()}
    shares = {k: float((d > 1e-5).float().mean()) for k, d in diffs.items()}
    assert max(float(d.max()) for d in diffs.values()) < 2 * cfg.lr_init
    assert (sum(int((d > 1e-5).sum()) for d in diffs.values())
            < 1e-3 * sum(d.numel() for d in diffs.values())), shares
