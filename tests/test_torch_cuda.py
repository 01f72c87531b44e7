"""PyTorch port on the card: the fused MLP kernels (forward K1 on the
tensor cores, split-f32 ``wgmma`` in f32 and ``wgmma`` in bf16; backward K2
on the tensor cores, ``mma.sync`` 3xTF32 in f32 with K1 f32's recompute,
and ``wgmma`` in bf16),
the fused resampler (K3), the hash encode and the int8 MLP kernel against
their plain versions, and the packed accel render against the unpacked one.

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
    bf16_sigma_agrees,
    fused_nerf_mlp,
    fused_nerf_mlp_backward,
    fused_nerf_mlp_backward_reference,
    fused_nerf_mlp_reference,
    pack_params,
    unpack_grads,
)
from nerf_rs_tpu_torch.render import render_image

pytestmark = pytest.mark.cuda

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
# Kernel against plain version: f32 differs by summation order only; bf16
# by summation order between bf16 roundings (tests/test_fused_mlp.py's bars;
# bf16 sigma as fused_mlp.bf16_sigma_agrees holds it, against a float64
# evaluation).
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
    """One K1 launch (on the tensor cores in both dtypes) against the
    plain version; a second call bitwise equal."""
    rgb_atol, sig_atol, sig_rtol = TOL[dtype]
    before, before_tc = fused_nerf_mlp.launches, fused_nerf_mlp.tc_launches
    rgb, sig = fused_nerf_mlp(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert fused_nerf_mlp.launches == before + 1
    assert fused_nerf_mlp.tc_launches == before_tc + 1
    rgb_r, sig_r = fused_nerf_mlp_reference(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    assert rgb.shape == rgb_r.shape and sig.shape == sig_r.shape
    torch.testing.assert_close(rgb, rgb_r, atol=rgb_atol, rtol=0)
    if dtype == "float32":
        torch.testing.assert_close(sig, sig_r, atol=sig_atol, rtol=sig_rtol)
    else:
        _, sig_64 = fused_nerf_mlp_reference(net, pts.double(), dirs.double(), dtype=dtype,
                                             sigma_only=sigma_only)
        ok, counts = bf16_sigma_agrees(sig, sig_r, sig_64)
        assert ok, (counts, float((sig - sig_r).abs().max()))
    again = fused_nerf_mlp(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    assert torch.equal(rgb, again[0]) and torch.equal(sig, again[1])


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ArchConfig(width=128, v_width=64, depth=4, skip_at=2),
                                  ArchConfig(width=100, v_width=36, depth=3, skip_at=5)],
                         ids=["small", "unaligned_noskip"])
@pytest.mark.parametrize("rays, samples", [(37, 29), (331, 67)], ids=["1073", "22177"])
def test_kernel_matches_plain_ragged(card, rays, samples, arch, dtype, sigma_only):
    """Ragged sample counts (not multiples of the 64- or 128-sample tiles;
    22177 samples are 174 tensor-core tiles, more than the card's SMs, so
    the persistent CTAs loop), per-ray and per-sample dirs."""
    net = NerfMLP(np_params(arch, 0), device=card)
    pts, dirs = inputs(rays, samples, 1, card)
    check(net, pts, dirs, dtype, sigma_only)
    check(net, pts, dirs.expand(rays, samples, 3).contiguous(), dtype, sigma_only)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_kernel_matches_plain_lego(card, net, dtype, sigma_only):
    module = NerfMLP(load_nerf_params(LEGO / net), device=card)
    pts, dirs = inputs(64, 96, 2, card)
    check(module, pts * 0.4, dirs, dtype, sigma_only)


def test_f32_kernel_near_float64_lego_fine(card):
    """K1 f32 (split-f32 on the tensor cores) on lego fine inputs at the
    render's sample count, held to the float64 evaluation of the same
    function: rgb and sigma each no further from it than twice the plain
    f32 version (cuBLAS f32 products)."""
    module = NerfMLP(load_nerf_params(LEGO / "fine"), device=card)
    pts, dirs = inputs(1024, 192, 15, card)
    pts = pts * 0.4
    with torch.no_grad():
        got = fused_nerf_mlp(module, pts, dirs)
        plain = fused_nerf_mlp_reference(module, pts, dirs)
        exact = fused_nerf_mlp_reference(module, pts.double(), dirs.double())
    for name, g, p, e in zip(("rgb", "sigma"), got, plain, exact):
        dist, plain_dist = (float((x.double() - e).abs().max()) for x in (g, p))
        assert dist <= 2 * plain_dist, (name, dist, plain_dist)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_is_deterministic(card, dtype):
    """Two K1 calls at the fine render shape (8192 x 192: the persistent
    CTAs walk many tiles) give bitwise-equal outputs."""
    module = NerfMLP(load_nerf_params(LEGO / "fine"), device=card)
    pts, dirs = inputs(8192, 192, 16, card)
    with torch.no_grad():
        a = fused_nerf_mlp(module, pts * 0.4, dirs, dtype=dtype)
        b = fused_nerf_mlp(module, pts * 0.4, dirs, dtype=dtype)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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
@pytest.mark.parametrize("arch", [SMALL, ArchConfig(width=100, v_width=36, depth=3, skip_at=5),
                                  "lego_fine"], ids=["small", "unaligned_noskip", "lego_fine"])
def test_backward_kernel_matches_plain_ragged(card, arch, dtype, sigma_only):
    """K2 on a ragged sample count (37 x 29, not a tile multiple) with one
    dir per ray: every leaf's gradient, d(points) and d(dirs). The lego
    fine network runs at the training shape, 4096 rays x 192 samples
    (6144 tiles of 128, more than the card's SMs, so the persistent CTAs
    loop); there f32 is held, as chip_smoke.py's phase 8 holds it, to the
    float64 evaluation: within max(1e-4, 1.5 x the plain version's
    distance) of it."""
    if arch == "lego_fine":
        net = NerfMLP(load_nerf_params(LEGO / "fine"), device=card)
        pts, dirs = inputs(4096, 192, 5, card)
        pts = pts * 0.4
    else:
        net = NerfMLP(np_params(arch, 4), device=card)
        pts, dirs = inputs(37, 29, 5, card)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 6, card)
    got, want = backward_pair(net, pts, dirs, g_rgb, g_sig, dtype, sigma_only)
    exact = None
    if arch == "lego_fine" and dtype == "float32":
        exact = fused_nerf_mlp_backward_reference(net, pts.double(), dirs.double(), g_rgb.double(),
                                                  g_sig.double(), sigma_only=sigma_only)

    def close(g_k, g_p, g_64=None):
        if g_64 is None:
            return rel_err(g_k, g_p) <= BWD_TOL[dtype]
        return (rel_err(g_k.double(), g_64)
                <= max(BWD_TOL[dtype], 1.5 * rel_err(g_p.double(), g_64)))

    pk = net.packed(dtype)
    tree_k, tree_p = unpack_grads(pk, got[0], got[1]), unpack_grads(pk, want[0], want[1])
    tree_64 = unpack_grads(pk, exact[0], exact[1]) if exact is not None else None
    for layer in tree_p:
        for part in ("kernel", "bias"):
            want_leaf = tree_p[layer][part]
            if sigma_only and layer in ("bottleneck", "viewdirs", "rgb"):
                assert not tree_k[layer][part].any() and not want_leaf.any()
            else:
                g_64 = tree_64[layer][part] if tree_64 is not None else None
                assert close(tree_k[layer][part], want_leaf, g_64), (layer, part)
    assert close(got[2], want[2], exact[2] if exact is not None else None)
    if sigma_only:
        assert not got[3].any()
    else:
        assert close(got[3], want[3], exact[3] if exact is not None else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_is_deterministic(card, dtype):
    """Two calls bitwise equal: each CTA adds its tiles into its own
    partial in a fixed order, and the partials are summed in a fixed
    order."""
    net = NerfMLP(np_params(SMALL, 7), device=card)
    pts, dirs = inputs(512, 48, 8, card)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 9, card)
    a = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig, dtype=dtype)
    b = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig, dtype=dtype)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_recomputes_the_forwards_activations(card, dtype):
    """K2's recompute gives K1's trunk activations bit for bit, so K2
    differentiates the activations and ReLU masks that made the loss. With
    the sigma head's weights at zero and its bias at 1 (every mask on) and
    a sigma cotangent of 1 on sample s alone, K2's alpha gradient is the
    recomputed last trunk output of s, exactly; with the sigma head's
    weights at the unit vector e_k and its bias at 0, K1's sigma is that
    output's entry k, exactly (one non-zero product in each sum)."""
    params = np_params(SMALL, 12)
    rays, samples = 37, 29
    pts, dirs = inputs(rays, samples, 13, card)

    def tree(w_alpha, b_alpha):
        t = {layer: {k: torch.from_numpy(v).to(card) for k, v in p.items()}
             for layer, p in params.items()}
        t["alpha"] = {"kernel": w_alpha.reshape(-1, 1).to(card),
                      "bias": torch.full((1,), b_alpha, device=card)}
        return t

    width = SMALL.width
    h = torch.empty((rays * samples, width), device=card)
    for k in range(width):
        _, sig = fused_nerf_mlp(tree(torch.eye(width)[k], 0.0), pts, dirs, dtype=dtype,
                                sigma_only=True)
        h[:, k] = sig.reshape(-1)
    pk = pack_params(tree(torch.zeros(width), 1.0), dtype)
    g_rgb = torch.zeros((rays, samples, 3), device=card)
    for s in (0, 500, rays * samples - 1):            # first tile, a middle one, the ragged last
        g_sig = torch.zeros(rays * samples, device=card)
        g_sig[s] = 1.0
        dw, db, _, _ = fused_nerf_mlp_backward(pk, pts, dirs, g_rgb, g_sig.reshape(rays, samples),
                                               dtype=dtype, sigma_only=True, input_grads=False)
        got = unpack_grads(pk, dw, db)["alpha"]["kernel"][:, 0]
        assert torch.equal(got, h[s]), (s, float((got - h[s]).abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_through_kernels_matches_plain_autograd(card, dtype):
    """fused_nerf_mlp's gradients on the card (K1 + K2) against the plain
    path's, leaf by leaf: f32 against torch autograd of the plain oracle;
    bf16 (K1 and K2 both wgmma on the tensor cores, K2 recomputing the
    forward with K1's own device code) against fused_nerf_mlp on CPU
    tensors, the plain forward and backward. Sigma-only leaves the color branch at exactly
    zero."""
    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    plain = (nerf_mlp, card) if dtype == "float32" else (fused_nerf_mlp, torch.device("cpu"))
    for sigma_only in (False, True):
        grads = []
        before = fused_nerf_mlp_backward.launches
        for fn, device in ((fused_nerf_mlp, card), plain):
            net = NerfMLP(np_params(SMALL, 10), device=device, requires_grad=True)
            pts, dirs = inputs(16, 40, 11, device)
            kw = {} if fn is nerf_mlp else {"dtype": dtype}
            rgb, sig = fn(net, pts, dirs, sigma_only=sigma_only, **kw)
            (rgb.square().sum() + 1e-2 * sig.sum()).backward()
            grads.append({k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                          for k, p in net.weights.items()})
        assert fused_nerf_mlp_backward.launches == before + 1
        for k, want in grads[1].items():
            if sigma_only and k.startswith(("bottleneck", "viewdirs", "rgb")):
                assert not grads[0][k].any(), k
            else:
                assert rel_err(grads[0][k], want) <= BWD_TOL[dtype], k


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


def resample_inputs(n, nc, nf, seed, device):
    """tests/test_resample.py's rows: jittered t over [2, 6], sigma with
    mass in every bin, uniforms."""
    rng = np.random.default_rng(seed)
    t_c = 2.0 + (np.arange(nc) + rng.uniform(size=(n, nc))) * (4.0 / nc)
    sigma = rng.uniform(0, 2.0, size=(n, nc))
    u = rng.uniform(size=(n, nf))
    far = rng.uniform(5.0, 6.0, size=(n, 1))
    return [torch.from_numpy(x.astype(np.float32)).to(device) for x in (t_c, sigma, u, far)]


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar_far", "per_ray_far"])
def test_resample_kernel_matches_plain(card, per_ray):
    """K3 at the bench's chunk, 16384 rays x (64, 128), against its plain
    version on the card, with tests/test_resample.py's tail bars: the CDFs
    differ by scan-order ulps, which a bin holding little mass stretches
    across its width, so 99% of entries lie within 5e-5 + 1e-5 |t| and
    every entry within a coarse bin. Rows sorted, every coarse t kept
    exactly, two calls bitwise equal."""
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample, fused_resample_reference

    t_c, sigma, u, far_rows = resample_inputs(16384, 64, 128, 12, card)
    far = far_rows if per_ray else 6.0
    before = fused_resample.launches
    got = fused_resample(t_c, sigma, u, far)
    again = fused_resample(t_c, sigma, u, far)
    torch.cuda.synchronize()
    assert fused_resample.launches == before + 2
    want = fused_resample_reference(t_c, sigma, u, far)
    assert got.shape == (16384, 192) and torch.equal(got, again)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    slot = torch.searchsorted(got, t_c).clamp(max=191)
    assert torch.equal(torch.gather(got, 1, slot), t_c)
    err = (got - want).abs()
    assert float(err.max()) <= 4.0 / 64
    assert float((err <= 5e-5 + 1e-5 * want.abs()).float().mean()) >= 0.99


def check_resample(t_c, sigma, u, far):
    """K3 against its plain version with tests/test_resample.py's bars (99%
    of entries within 5e-5 + 1e-5 |t|, every entry within the widest
    coarse bin), rows sorted, every coarse t kept exactly, two calls
    bitwise equal, one launch each."""
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample, fused_resample_reference

    n, nc = t_c.shape
    m = nc + u.shape[1]
    before = fused_resample.launches
    got = fused_resample(t_c, sigma, u, far)
    again = fused_resample(t_c, sigma, u, far)
    torch.cuda.synchronize()
    assert fused_resample.launches == before + 2
    want = fused_resample_reference(t_c, sigma, u, far)
    assert got.shape == (n, m) and torch.equal(got, again)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    slot = torch.searchsorted(got, t_c.contiguous()).clamp(max=m - 1)
    assert torch.equal(torch.gather(got, 1, slot), t_c)
    err = (got - want).abs()
    widest = float((t_c.sort(dim=1).values.diff(dim=1)).max()) * 2
    assert float(err.max()) <= max(widest, 4.0 / nc)
    assert float((err <= 5e-5 + 1e-5 * want.abs()).float().mean()) >= 0.99
    return got


@pytest.mark.parametrize("nc, nf", [(33, 95), (3, 1), (5, 3), (64, 1984), (1000, 1048),
                                    (2045, 3)])
def test_resample_kernel_at_rows_off_powers_of_two_and_the_limit(card, nc, nf):
    """K3 where Nc + Nf is not a power of two, Nf not a multiple of 32, and
    at the 2048 limit (Nc + Nf = MAX_ROW, Nc or Nf alone near it)."""
    t_c, sigma, u, far_rows = resample_inputs(1031, nc, nf, 23, card)
    check_resample(t_c, sigma, u, far_rows)


@pytest.mark.parametrize("coarse", ["sorted", "unsorted"])
def test_resample_kernel_on_rows_with_ties(card, coarse):
    """K3 on rows with ties: repeated coarse t (whose zero-width bins put
    fine samples exactly on coarse values, ties across the two lists),
    repeated uniforms (ties among the fine samples), and the coarse row
    sorted or shuffled (the kernel sorts it where it is not sorted, as the
    plain merge does)."""
    rng = np.random.default_rng(24)
    t_c, sigma, u, far_rows = resample_inputs(4096, 64, 128, 25, "cpu")
    t_c[:, 1::2] = t_c[:, 0::2]                             # each t twice
    u = torch.from_numpy(rng.choice(rng.uniform(size=9), size=u.shape).astype(np.float32))
    if coarse == "unsorted":
        t_c = torch.gather(t_c, 1, torch.from_numpy(np.argsort(rng.uniform(size=t_c.shape), 1)))
    got = check_resample(*(x.to(card) for x in (t_c, sigma, u, far_rows)))
    assert bool((got[:, 1:] == got[:, :-1]).any(dim=1).all())   # every row has ties


@pytest.mark.parametrize("change", [dict(accel_compact="off", accel_aabb_probes=32),
                                    dict(accel_sample_aabb=True, accel_aabb_probes=32)],
                         ids=["off_probes", "aabb_probes_per_ray_far"])
def test_accel_packed_matches_unpacked_on_card(card, change):
    """A 64x64 lego frame through K1 and K3 on a 64^3 grid: every hit ray
    of the packed render is bitwise the unpacked render's, and K3 launches
    once per rendered chunk."""
    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.render import _image_ray_ranges

    cam = camera_from_golden(load_golden(LEGO / "tf_reference_samples.json"))
    coarse, fine = (NerfMLP(load_nerf_params(LEGO / n), device=card) for n in ("coarse", "fine"))
    grid = build_scene_grid(coarse, fine, resolution=64)
    cfg = RenderConfig(n_coarse=64, n_fine=128, ray_chunk=512, impl="pallas",
                       sampling_impl="pallas", **change)
    _, dirs = camera_rays(cam, 64, 64, card)
    (t0, t1), _, n_hit = _image_ray_ranges(grid, torch.as_tensor(cam.position, device=card), dirs,
                                           torch.tensor(cam.near, device=card),
                                           torch.tensor(cam.far, device=card), cfg)
    hit = (t1 > t0).reshape(64, 64)
    assert 0 < int(n_hit) < 64 * 64
    unpacked = render_image(coarse, fine, cam, 64, 64, random.key(0, card), cfg, grid=grid)
    before = fused_resample.launches
    packed = render_image(coarse, fine, cam, 64, 64, random.key(0, card),
                          cfg.replace(accel_cull_rays=True), grid=grid)
    torch.cuda.synchronize()
    assert fused_resample.launches - before == -(-int(n_hit) // 512)
    assert torch.equal(packed[hit], unpacked[hit])


def hash_inputs(cfg, n, seed, device, dtype):
    """Tables U(-1, 1) and n points in and around the config's box, the
    first rows NaN and +-inf."""
    rng = np.random.default_rng(seed)
    tables = rng.uniform(-1, 1, (cfg.levels, 1 << cfg.table_log2, cfg.features))
    pts = rng.uniform(-2.2, 2.2, (n, 3))
    pts[:3] = [[np.nan, 0.1, 0.2], [np.inf, -0.5, 0.0], [-np.inf, np.nan, 1.0]]
    return (torch.from_numpy(tables.astype(np.float32)).to(device, dtype),
            torch.from_numpy(pts.astype(np.float32)).to(device))


@pytest.mark.parametrize("features", [2, 8], ids=["paper_f2", "wide_f8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_hash_encode_kernel_matches_plain(card, dtype, features):
    """The hash-encode kernel against its plain version on 65536 points:
    f32 within 1e-5 of the largest table entry (both sum the same products
    in the same order, so they agree exactly unless a rounding differs);
    bf16 within 2 bf16 ulps of the largest feature. Two calls bitwise
    equal, one launch each."""
    from nerf_rs_tpu_torch.config import HashGridConfig
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode, hash_encode_reference

    cfg = HashGridConfig(features=features, levels=16 if features == 2 else 4)
    tables, pts = hash_inputs(cfg, 65536, 20, card, dtype)
    before = fused_hash_encode.launches
    got = fused_hash_encode(tables, pts, cfg)
    again = fused_hash_encode(tables, pts, cfg)
    torch.cuda.synchronize()
    assert fused_hash_encode.launches == before + 2
    want = hash_encode_reference(tables, pts, cfg)
    assert got.shape == (65536, cfg.levels * features) and got.dtype == dtype
    assert torch.equal(got, again)
    if dtype == torch.float32:
        atol = 1e-5 * float(tables.abs().max())
    else:
        atol = 2 * 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def check_encode(tables, pts, cfg):
    """The encode kernel against its plain version with
    test_hash_encode_kernel_matches_plain's bars, two calls bitwise equal,
    one launch each."""
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode, hash_encode_reference

    before = fused_hash_encode.launches
    got = fused_hash_encode(tables, pts, cfg)
    again = fused_hash_encode(tables, pts, cfg)
    torch.cuda.synchronize()
    assert fused_hash_encode.launches == before + 2
    want = hash_encode_reference(tables, pts, cfg)
    assert got.shape == (*pts.shape[:-1], cfg.levels * cfg.features) and got.dtype == tables.dtype
    assert torch.equal(got, again)
    if tables.dtype == torch.float32:
        atol = 1e-5 * float(tables.abs().max())
    else:
        atol = 2 * 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("n", [1, 31, 64, 100, 4097])
@pytest.mark.parametrize("features", [2, 8], ids=["paper_f2", "wide_f8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_hash_encode_kernel_at_tail_tiles(card, dtype, features, n):
    """The encode at n < 32, a whole tile, and tail tiles (n not a multiple
    of the kernel's 64-sample tile), the first points NaN and inf."""
    from nerf_rs_tpu_torch.config import HashGridConfig

    cfg = HashGridConfig(features=features, levels=16 if features == 2 else 4)
    tables, pts = hash_inputs(cfg, max(n, 3), 26, card, dtype)
    check_encode(tables, pts[:n], cfg)


@pytest.mark.parametrize("features", [2, 8], ids=["paper_f2", "wide_f8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_hash_encode_kernel_on_ray_ordered_points(card, dtype, features):
    """The encode on points as the render hands them: 4096 rays x 192
    samples sorted along each ray (where a warp's lanes share cells and
    corner pairs share loads), rays from a sphere of radius 4 around the
    paper config's box, through it."""
    from nerf_rs_tpu_torch.config import HashGridConfig

    cfg = HashGridConfig(features=features, levels=16 if features == 2 else 4)
    tables, _ = hash_inputs(cfg, 3, 27, card, dtype)
    rng = np.random.default_rng(28)
    o = rng.normal(size=(4096, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + rng.normal(size=(4096, 3)) * 0.18
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = 2.0 + 4.0 * (np.arange(192) + rng.uniform(size=(4096, 192))) / 192
    pts = (o[:, None, :] + d[:, None, :] * t[..., None]).astype(np.float32)
    check_encode(tables, torch.from_numpy(pts).to(card), cfg)


def test_hash_encode_backward_on_card_matches_cpu(card):
    """The plain backward on the card (sort-based accumulation) against the
    CPU's: d(tables) to 1e-5 relative, bitwise repeatable on the card."""
    from nerf_rs_tpu_torch.config import HashGridConfig
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode

    cfg = HashGridConfig(levels=4, table_log2=12, res_min=4, res_max=32, aabb=(-1.0, 1.0))
    tables, pts = hash_inputs(cfg, 4096, 21, "cpu", torch.float32)
    cot = torch.from_numpy(np.random.default_rng(22).normal(size=(4096, 8)).astype(np.float32))
    grads = []
    for device in ("cpu", card, card):
        t = tables.detach().to(device).requires_grad_(True)
        torch.sum(fused_hash_encode(t, pts.to(device), cfg) * cot.to(device)).backward()
        grads.append(t.grad.cpu())
    assert torch.equal(grads[1], grads[2])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6)


# The int8 kernel against its plain version: the same codes, the same int32
# sums and the same three rounded dequant ops, so sigma is bitwise equal;
# rgb may differ only where the kernel's expf differs from torch.sigmoid's.
INT8_RGB_ATOL = 2e-6


def check_int8(net, pts, dirs, sigma_only):
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, fused_int8_mlp_reference

    before = fused_int8_mlp.launches
    rgb, sig = fused_int8_mlp(net, pts, dirs, sigma_only=sigma_only)
    again = fused_int8_mlp(net, pts, dirs, sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert fused_int8_mlp.launches == before + 2
    rgb_r, sig_r = fused_int8_mlp_reference(net, pts, dirs, sigma_only=sigma_only)
    assert rgb.shape == rgb_r.shape and sig.shape == sig_r.shape
    assert torch.equal(rgb, again[0]) and torch.equal(sig, again[1])
    assert torch.equal(sig, sig_r), float((sig - sig_r).abs().max())
    torch.testing.assert_close(rgb, rgb_r, atol=INT8_RGB_ATOL, rtol=0)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("arch", [SMALL, ArchConfig(width=100, v_width=36, depth=3, skip_at=0)],
                         ids=["small", "ragged_skip"])
def test_int8_kernel_matches_plain_ragged(card, arch, sigma_only):
    """A ragged sample count (37 x 29), widths not multiples of 8, the skip
    at dense1; per-ray and per-sample dirs; two calls bitwise equal."""
    net = NerfMLP(np_params(arch, 30), device=card)
    pts, dirs = inputs(37, 29, 31, card)
    check_int8(net, pts * 0.4, dirs, sigma_only)
    check_int8(net, pts * 0.4, dirs.expand(37, 29, 3).contiguous(), sigma_only)


@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_int8_kernel_matches_plain_lego(card, net):
    module = NerfMLP(load_nerf_params(LEGO / net), device=card)
    pts, dirs = inputs(64, 96, 32, card)
    check_int8(module, pts * 0.4, dirs, net == "coarse")


@pytest.mark.parametrize("sigma_only", [False, True])
def test_int8_kernel_over_several_persistent_rounds(card, sigma_only):
    """331 x 157 lego fine samples: 812 tiles of 64, so every CTA of the
    persistent grid walks several rounds of two tiles, and the last tile is
    ragged (63 samples); per-ray dirs."""
    module = NerfMLP(load_nerf_params(LEGO / "fine"), device=card)
    pts, dirs = inputs(331, 157, 36, card)
    check_int8(module, pts * 0.4, dirs, sigma_only)


def saturating_params(arch, seed):
    """Weights of one magnitude a layer, every column but the last 8 all
    positive, constant biases: the trunk's outputs are equal in 248 columns,
    so 248 of each row's codes are 127 and the int32 sums reach 127^2 x 248
    and more (the skip layer's K = 320 included)."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        sign = np.where(rng.uniform(size=(d_in, d_out)) < 0.5, -1.0, 1.0)
        sign[:, :max(1, d_out - 8)] = 1.0
        out[layer] = {"kernel": (sign / d_in).astype(np.float32),
                      "bias": np.ones(d_out, np.float32)}
    return out


def test_int8_kernel_exact_at_saturated_codes(card):
    """Codes at 127 across whole rows in every trunk layer: the kernel's
    int32 sums at their largest (over 127^2 x 248 in every layer after the
    first, the skip layer's K = 320 included) still give sigma bit for bit
    and rgb within INT8_RGB_ATOL."""
    from nerf_rs_tpu_torch.models import quant
    from nerf_rs_tpu_torch.models.encoding import positional_encoding

    arch = ArchConfig(width=256, v_width=128, depth=8, skip_at=4)
    net = NerfMLP(saturating_params(arch, 37), device=card)
    pts, dirs = inputs(64, 96, 38, card)
    pts = pts * 0.4
    tree = net.tree()
    h0 = positional_encoding(pts.reshape(-1, 3), 10)
    h, sums = h0, []
    for i in range(arch.depth):
        x = torch.cat([h0, h], -1) if tree[f"dense{i}"]["kernel"].shape[0] == 256 + 63 else h
        codes, _ = quant.quantize_weights(tree[f"dense{i}"]["kernel"])
        acc = quant._codes(x, quant._row_scale(x)) @ codes.to(torch.float32)
        sums.append((x.shape[-1], float(acc.abs().max())))
        h = torch.relu(quant._qdense_real(tree, f"dense{i}", x))
    assert (319, sums[5][1]) == sums[5] and all(m > 127 ** 2 * 248 for _, m in sums[1:]), sums
    check_int8(net, pts, dirs, False)
    check_int8(net, pts, dirs, True)


def test_int8_kernel_refuses_what_it_does_not_serve(card):
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp

    wide = NerfMLP(np_params(ArchConfig(width=264, v_width=32, depth=2, skip_at=5), 33),
                   device=card)
    pts, dirs = inputs(4, 8, 34, card)
    with pytest.raises(NotImplementedError, match="width=264"):
        fused_int8_mlp(wide, pts, dirs)
    net = NerfMLP(np_params(SMALL, 35), device=card)
    with pytest.raises(NotImplementedError, match="L=\\(10,4\\)"):
        fused_int8_mlp(net, pts, dirs, x_freqs=8)


def test_int8_render_on_card_matches_plain(card):
    """A small lego frame with impl="int8": two kernel launches per chunk,
    and at least 60 dB from the same frame with the plain version."""
    import nerf_rs_tpu_torch.ops.kernels.int8_mlp as im

    cam = camera_from_golden(load_golden(LEGO / "tf_reference_samples.json"))
    coarse, fine = (NerfMLP(load_nerf_params(LEGO / n), device=card) for n in ("coarse", "fine"))
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=512, impl="int8")
    before = im.fused_int8_mlp.launches
    got = render_image(coarse, fine, cam, 32, 32, random.key(0, card), cfg)
    torch.cuda.synchronize()
    assert im.fused_int8_mlp.launches == before + 2 * 2
    real = im.fused_int8_mlp
    im.fused_int8_mlp = im.fused_int8_mlp_reference
    try:
        plain = render_image(coarse, fine, cam, 32, 32, random.key(0, card), cfg)
    finally:
        im.fused_int8_mlp = real
    mse = float(((got.double() - plain.double()) ** 2).mean())
    assert -10 * np.log10(max(mse, 1e-20)) >= 60.0
