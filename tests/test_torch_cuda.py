"""PyTorch port on the card: the fused MLP kernels (forward K1 on the
tensor cores, split-f32 ``wgmma`` in f32 and ``wgmma`` in bf16, and past
width 256 or depth 16 its wide pair, f32 on the CUDA cores and bf16
``wgmma``, and past width 512 its wide1k pair; backward K2
on the tensor cores, ``mma.sync`` 3xTF32 in f32 with K1 f32's recompute,
and ``wgmma`` in bf16, and past width 256 or depth 16 its wide pair, the
same products with the wide forwards' recomputes),
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
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes, init_nerf_params
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


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ArchConfig(width=384, v_width=192, depth=8, skip_at=4),
                                  ArchConfig(width=512, v_width=512, depth=32, skip_at=10),
                                  ArchConfig(width=200, v_width=264, depth=20, skip_at=1),
                                  ArchConfig(width=64, v_width=64, depth=20, skip_at=4),
                                  ArchConfig(width=1024, v_width=512, depth=8, skip_at=4),
                                  ArchConfig(width=1024, v_width=128, depth=8, skip_at=4),
                                  ArchConfig(width=776, v_width=264, depth=12, skip_at=4),
                                  ArchConfig(width=1024, v_width=1024, depth=32, skip_at=10),
                                  ArchConfig(width=200, v_width=600, depth=3, skip_at=0),
                                  ArchConfig(width=520, v_width=64, depth=2, skip_at=5)],
                         ids=["384x192x8", "512x512x32", "200x264x20", "64x64x20", "1024x512x8",
                              "1024x128x8", "776x264x12", "1024x1024x32", "200x600x3",
                              "520x64x2"])
def test_wide_kernel_matches_plain(card, arch, dtype, sigma_only):
    """K1's wide pair (csrc/fused_mlp_wide_tc.cu in bf16 on the tensor
    cores, csrc/fused_mlp_wide_f32.cu in f32 on the CUDA cores) past width
    256 or depth 16, and its wide1k pair past width 512
    (csrc/fused_mlp_wide1k_tc.cu in bf16 and csrc/fused_mlp_wide1k_f32tc.cu
    in split-f32, both on the tensor cores in clusters that split each
    layer's columns), ragged, at widths not a multiple of 64 or 128, with
    only the view branch past 512, and with one 64-column piece in a layer
    (520x64: the second CTA of a cluster owns none of the view layer, and
    the f32 kernel's last three quarters none): one launch, counted as wide
    (and on the tensor cores but for f32 up to width 512, and as wide1k
    past 512), against the plain version at check's bars; a second call
    bitwise equal."""
    net = NerfMLP(np_params(arch, 3), device=card)
    pts, dirs = inputs(331, 67, 4, card)
    rgb_atol, sig_atol, sig_rtol = TOL[dtype]
    counts = (fused_nerf_mlp.launches, fused_nerf_mlp.tc_launches, fused_nerf_mlp.wide_launches,
              fused_nerf_mlp.wide1k_launches)
    wide1k = max(arch.width, arch.v_width) > 512
    with torch.no_grad():
        rgb, sig = fused_nerf_mlp(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
        torch.cuda.synchronize()
        assert (fused_nerf_mlp.launches, fused_nerf_mlp.tc_launches,
                fused_nerf_mlp.wide_launches, fused_nerf_mlp.wide1k_launches) == (
                    counts[0] + 1, counts[1] + (dtype == "bfloat16" or wide1k), counts[2] + 1,
                    counts[3] + wide1k)
        rgb_r, sig_r = fused_nerf_mlp_reference(net, pts, dirs, dtype=dtype,
                                                sigma_only=sigma_only)
        torch.testing.assert_close(rgb, rgb_r, atol=rgb_atol, rtol=0)
        if dtype == "float32":
            torch.testing.assert_close(sig, sig_r, atol=sig_atol, rtol=sig_rtol)
        else:
            _, sig_64 = fused_nerf_mlp_reference(net, pts.double(), dirs.double(), dtype=dtype,
                                                 sigma_only=sigma_only)
            ok, bars = bf16_sigma_agrees(sig, sig_r, sig_64)
            assert ok, (bars, float((sig - sig_r).abs().max()))
        again = fused_nerf_mlp(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    assert torch.equal(rgb, again[0]) and torch.equal(sig, again[1])


WIDE1K_F32 = [ArchConfig(width=1024, v_width=512, depth=8, skip_at=4),
              ArchConfig(width=1024, v_width=128, depth=8, skip_at=4),
              ArchConfig(width=776, v_width=264, depth=12, skip_at=4),
              ArchConfig(width=1024, v_width=1024, depth=32, skip_at=10)]


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("arch", WIDE1K_F32, ids=["1024x512x8", "1024x128x8", "776x264x12",
                                                 "1024x1024x32"])
def test_wide1k_f32_tensor_core_kernel_matches_plain(card, arch, sigma_only):
    """K1 f32 past width 512 on the tensor cores
    (csrc/fused_mlp_wide1k_f32tc.cu, split-f32 wgmma in clusters of four
    CTAs) at chip_smoke.py phase 29 (e)'s random networks, over 8192
    samples (128 64-sample tiles, so that clusters take more than one):
    one launch, counted on the tensor cores and as wide and wide1k, within
    the f32 bars of the plain version and, like the split-f32 arithmetic's
    emulation on the CPU (tests/test_torch_wide1k_split_f32.py), no further
    from the float64 evaluation than twice the plain version is; a second
    call bitwise equal."""
    g = torch.Generator(device=card).manual_seed(29)
    net = NerfMLP(init_nerf_params(g, arch), device=card)
    pts, dirs = inputs(128, 64, 5, card)
    rgb_atol, sig_atol, sig_rtol = TOL["float32"]
    names = ("launches", "tc_launches", "wide_launches", "wide1k_launches")
    before = [getattr(fused_nerf_mlp, k) for k in names]
    with torch.no_grad():
        rgb, sig = fused_nerf_mlp(net, pts, dirs, sigma_only=sigma_only)
        torch.cuda.synchronize()
        assert [getattr(fused_nerf_mlp, k) - b for k, b in zip(names, before)] == [1, 1, 1, 1]
        again = fused_nerf_mlp(net, pts, dirs, sigma_only=sigma_only)
        plain = fused_nerf_mlp_reference(net, pts, dirs, sigma_only=sigma_only)
        exact = fused_nerf_mlp_reference(net, pts.double(), dirs.double(), sigma_only=sigma_only)
    torch.testing.assert_close(rgb, plain[0], atol=rgb_atol, rtol=0)
    torch.testing.assert_close(sig, plain[1], atol=sig_atol, rtol=sig_rtol)
    assert torch.equal(rgb, again[0]) and torch.equal(sig, again[1])
    for got, want, ref in zip((rgb, sig), plain, exact):
        dist = float((got.double() - ref).abs().max())
        assert dist <= 2 * float((want.double() - ref).abs().max()) + 1e-30, dist


def test_wide_network_refuses_gradients_before_launch(card):
    """Past K1's envelope (width 1152), which is K2's, the card refuses the
    network: the autograd function raises before K1 launches (the pack
    cannot hold it), and so does K1 without gradients. At width 640, which
    K1 serves, K2 serves it too: its backward runs as one wide1k launch.
    The int8 wrapper refuses 640 before it launches, while the renderer's
    int8 choice runs the plain int8 MLP."""
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp
    from nerf_rs_tpu_torch.render import get_mlp_fn

    wider = NerfMLP(np_params(ArchConfig(width=1152, v_width=128, depth=3, skip_at=1), 5),
                    device=card, requires_grad=True)
    net = NerfMLP(np_params(ArchConfig(width=640, v_width=128, depth=3, skip_at=1), 5),
                  device=card, requires_grad=True)
    pts, dirs = inputs(16, 8, 6, card)
    before = fused_nerf_mlp.launches, fused_nerf_mlp_backward.launches
    with pytest.raises(ValueError, match="width, v_width <= 1024 .* width=1152"):
        fused_nerf_mlp(wider, pts, dirs)
    g = torch.ones_like(pts[..., 0])
    wide1k = fused_nerf_mlp_backward.wide1k_launches
    out = fused_nerf_mlp_backward(net, pts, dirs, g[..., None].expand(16, 8, 3), g)
    assert fused_nerf_mlp_backward.wide1k_launches == wide1k + 1
    assert all(bool(torch.isfinite(t).all()) for t in out)
    before = before[0], before[1] + 1
    with torch.no_grad():
        with pytest.raises(ValueError, match="width=1152"):
            fused_nerf_mlp(wider, pts, dirs)
        with pytest.raises(NotImplementedError, match="int8 kernel serves"):
            fused_int8_mlp(net, pts, dirs)
        plain = get_mlp_fn(RenderConfig(impl="int8"), net, card)(net, pts, dirs)
    assert (fused_nerf_mlp.launches, fused_nerf_mlp_backward.launches) == before
    assert all(bool(torch.isfinite(t).all()) for t in plain)


WIDE_ARCHS = [ArchConfig(width=384, v_width=192, depth=8, skip_at=4),
              ArchConfig(width=512, v_width=512, depth=32, skip_at=10),
              ArchConfig(width=200, v_width=264, depth=20, skip_at=1),
              ArchConfig(width=64, v_width=64, depth=20, skip_at=4)]
WIDE_IDS = ["384x192x8", "512x512x32", "200x264x20", "64x64x20"]


def widened_lego(width, v_width, depth, device, requires_grad=False):
    """The lego fine network widened to (width, v_width, depth) by
    ``chip_smoke.widen_nerf``: the same function, so its activations and
    ReLU masks are a trained network's, not a random one's."""
    return NerfMLP(chip_smoke_module().widen_nerf(load_nerf_params(LEGO / "fine"), width,
                                                  v_width, depth),
                   device=device, requires_grad=requires_grad)


def chip_smoke_module():
    import sys

    root = str(LEGO.parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net_kind, dims", [
    ("lego", (384, 192, 8)), ("lego", (512, 256, 32)), ("lego", (264, 136, 20)),
    ("random", WIDE_ARCHS[0]), ("random", WIDE_ARCHS[1]), ("random", WIDE_ARCHS[2]),
    ("lego", (1024, 512, 8)), ("random", ArchConfig(width=1024, v_width=512, depth=8, skip_at=4)),
    ("random", ArchConfig(width=776, v_width=264, depth=12, skip_at=4)),
    ("random", ArchConfig(width=1024, v_width=1024, depth=32, skip_at=10))],
    ids=["384x192x8", "512x256x32", "264x136x20_unaligned", "random_384x192x8",
         "random_512x512x32", "random_200x264x20", "1024x512x8", "random_1024x512x8",
         "random_776x264x12", "random_1024x1024x32"])
def test_wide_backward_kernel_matches_plain(card, net_kind, dims, dtype, sigma_only):
    """K2's wide pair (csrc/fused_mlp_wide_bwd_tc.cu after the wide f32
    forward's record mode; csrc/fused_mlp_wide_bwd_bf16.cu) past width 256
    or depth 16, and past width 512 its wide1k kernels (the wide1k
    forwards' record modes, csrc/fused_mlp_wide1k_bwd.cu), ragged (37 x 29,
    not a multiple of the 64-sample tile): on the lego widened (identity
    layers past its depth 8; unaligned widths too; 4x to 1024/512/8), and
    on random networks (np_params, seed 5) at 384/192/8, 512/512/32,
    200/264/20, 1024/512/8, 776/264/12 and 1024/1024/32, where the deep
    layers are not copies. One launch, counted as wide (and wide1k past
    512); every leaf's gradient, d(points) and d(dirs) at the narrow K2's
    bars: f32 within max(1e-4, 1.5 x the plain version's distance) of the
    float64 evaluation, the ReLU masks f32 cannot resolve set as the
    kernel's forward set them (chip_smoke.kernel_mask_exact, PERF.md §2);
    bf16 within 3e-2 of the plain version, except on the random networks
    32 deep, where any summation order but cuBLAS's own lies further than
    that from plain (PERF.md §7): there each gradient lies within max(3e-2,
    1.5 x the plain version's distance) of the float64 evaluation (the
    reference on float64 inputs, rounded where the kernels round), and the
    kernel's largest distance over the call's gradients is no larger than
    the plain version's. The color branch exactly zero in sigma-only
    calls."""
    if net_kind == "lego":
        net = widened_lego(*dims, card)
    else:
        net = NerfMLP(np_params(dims, 5), device=card)
    pts, dirs = inputs(37, 29, 5, card)
    if net_kind == "lego":
        pts = pts * 0.4
    g_rgb, g_sig = cotangents(pts.shape[:-1], 6, card)
    wide, wide1k = fused_nerf_mlp_backward.wide_launches, fused_nerf_mlp_backward.wide1k_launches
    got, want = backward_pair(net, pts, dirs, g_rgb, g_sig, dtype, sigma_only)
    pk = net.packed(dtype)
    assert fused_nerf_mlp_backward.wide_launches == wide + 1
    assert fused_nerf_mlp_backward.wide1k_launches == wide1k + int(pk.wide1k)
    smoke = chip_smoke_module()
    named_k, named_p = smoke.named_gradients(pk, got), smoke.named_gradients(pk, want)
    args = (pts, dirs, g_rgb, g_sig)
    deep_bf16 = dtype == "bfloat16" and net_kind == "random" and pk.depth == 32
    if dtype == "float32" or deep_bf16:
        exact = fused_nerf_mlp_backward_reference(net, *(a.double() for a in args), dtype=dtype,
                                                  sigma_only=sigma_only)
        named_64 = smoke.named_gradients(pk, exact)
    if dtype == "float32":
        oracle, _ = smoke.kernel_mask_exact(net, args, sigma_only, named_64)
    far = {"kernel": 0.0, "plain": 0.0}
    for key in named_p:
        layer = key.split("/")[0]
        if sigma_only and (layer in ("bottleneck", "viewdirs", "rgb") or key == "d(dirs)"):
            assert not named_k[key].any() and not named_p[key].any(), key
        elif dtype == "float32":
            bar = max(BWD_TOL[dtype], 1.5 * rel_err(named_p[key].double(), named_64[key]))
            assert rel_err(named_k[key].double(), oracle[key]) <= bar, (
                key, rel_err(named_k[key].double(), oracle[key]), bar)
        elif deep_bf16:
            plain = rel_err(named_p[key].double(), named_64[key])
            kernel = rel_err(named_k[key].double(), named_64[key])
            assert kernel <= max(BWD_TOL[dtype], 1.5 * plain), (key, kernel, plain)
            far = {"kernel": max(far["kernel"], kernel), "plain": max(far["plain"], plain)}
        else:
            assert rel_err(named_k[key], named_p[key]) <= BWD_TOL[dtype], (
                key, rel_err(named_k[key], named_p[key]))
    assert far["kernel"] <= far["plain"], far
    assert all(bool(torch.isfinite(t).all()) for t in got if t is not None)


@pytest.mark.parametrize("dims", [(256, 128, 8), (384, 192, 18), (1024, 512, 8)],
                         ids=["narrow", "wide", "wide1k"])
def test_recorded_outputs_are_the_forwards(card, dims):
    """``recorded_outputs`` (K2's f32 record pass, read back) on the lego
    widened (narrow: the lego fine itself): every layer within 1e-5 x its
    largest entry of the plain f32 forward's, and the last trunk layer's
    units bit for bit what K1's own forward gives them (the network with
    a sigma head of e_k: its sigma is unit k), on a ragged sample count."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import recorded_outputs

    if dims[0] == 256:
        params = load_nerf_params(LEGO / "fine")
    else:
        params = chip_smoke_module().widen_nerf(load_nerf_params(LEGO / "fine"), *dims)
    net = NerfMLP(params, device=card)
    pts, dirs = inputs(37, 29, 13, card)
    pts = pts * 0.4
    got = recorded_outputs(net, pts, dirs)
    want = recorded_outputs(NerfMLP(params, device=torch.device("cpu")), pts.cpu(), dirs.cpu())
    assert len(got) == len(want) == dims[2] + 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g.cpu(), w, atol=1e-5 * float(w.abs().max()), rtol=0)
    last = got[dims[2] - 1]
    for k in (0, 5, dims[0] - 1):
        tree = {layer: {p: torch.from_numpy(v).to(card) for p, v in part.items()}
                for layer, part in params.items()}
        head = torch.zeros((dims[0], 1), device=card)
        head[k, 0] = 1.0
        tree["alpha"] = {"kernel": head, "bias": torch.zeros(1, device=card)}
        with torch.no_grad():
            _, sig = fused_nerf_mlp(tree, pts, dirs, dtype="float32", sigma_only=True)
        assert torch.equal(sig.reshape(-1), last[:, k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_backward_kernel_is_deterministic(card, dtype):
    """The wide K2 gives two calls bitwise equal, with and without input
    gradients: the dW kernel sums each weight over a round's slices in a
    fixed order and adds the rounds in order; the per-CTA bias and head
    sums are summed in a fixed order."""
    net = NerfMLP(np_params(WIDE_ARCHS[0], 7), device=card)
    pts, dirs = inputs(512, 48, 8, card)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 9, card)
    for input_grads in (True, False):
        a = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig, dtype=dtype,
                                    input_grads=input_grads)
        b = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig, dtype=dtype,
                                    input_grads=input_grads)
        assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
        if input_grads:
            assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_backward_over_several_rounds_is_deterministic_and_plain(card, dtype, monkeypatch):
    """A wide K2 call cut into at least three rounds (the round budget at
    one byte: one tile a CTA a round), its last round and last tile ragged
    (509 x 53 samples): two calls bitwise equal, with and without input
    gradients; one dW launch a round; every gradient at
    test_wide_backward_kernel_matches_plain's bars (f32 against the float64
    evaluation with the kernel's unresolvable masks, bf16 against the plain
    version)."""
    several_rounds(card, WIDE_ARCHS[0], dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide1k_backward_over_several_rounds_is_deterministic_and_plain(card, dtype,
                                                                       monkeypatch):
    """test_wide_backward_over_several_rounds_is_deterministic_and_plain past
    width 512 (a random 1024/512/4 network): each round's wide1k record
    pass, half-tile backward and dW kernel over its own tiles, bitwise
    equal twice and at the same bars."""
    several_rounds(card, ArchConfig(width=1024, v_width=512, depth=4, skip_at=2), dtype,
                   monkeypatch)


def several_rounds(card, arch, dtype, monkeypatch):
    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    monkeypatch.setitem(fm.WIDE_ROUND_BYTES, dtype, 1)
    net = NerfMLP(np_params(arch, 7), device=card)
    pts, dirs = inputs(509, 53, 8, card)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 9, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = fm.wide_plan(net.packed(dtype), pts.numel() // 3, sms, sigma_only=False)
    assert plan.rounds >= 3 and plan.tiles % plan.round_tiles and (pts.numel() // 3) % 64
    before = fused_nerf_mlp_backward.dw_launches
    got, want = backward_pair(net, pts, dirs, g_rgb, g_sig, dtype, False)
    assert fused_nerf_mlp_backward.dw_launches == before + plan.rounds
    for input_grads in (True, False):
        a = fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig, dtype=dtype,
                                    input_grads=input_grads)
        assert all(torch.equal(x, y) for x, y in zip(a[:2], got[:2]))
        if input_grads:
            assert torch.equal(a[2], got[2]) and torch.equal(a[3], got[3])
    pk = net.packed(dtype)
    smoke = chip_smoke_module()
    named_k, named_p = smoke.named_gradients(pk, got), smoke.named_gradients(pk, want)
    if dtype == "float32":
        args = (pts, dirs, g_rgb, g_sig)
        exact = fused_nerf_mlp_backward_reference(net, *(x.double() for x in args))
        named_64 = smoke.named_gradients(pk, exact)
        oracle, _ = smoke.kernel_mask_exact(net, args, False, named_64)
    for key in named_p:
        if dtype == "float32":
            bar = max(BWD_TOL[dtype], 1.5 * rel_err(named_p[key].double(), named_64[key]))
            assert rel_err(named_k[key].double(), oracle[key]) <= bar, (
                key, rel_err(named_k[key].double(), oracle[key]), bar)
        else:
            assert rel_err(named_k[key], named_p[key]) <= BWD_TOL[dtype], (
                key, rel_err(named_k[key], named_p[key]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_backward_recomputes_the_forwards_activations(card, dtype):
    """The wide K2's recompute gives wide K1's trunk activations bit for
    bit (test_backward_recomputes_the_forwards_activations's construction,
    on the lego widened to width 384 and depth 18): with the sigma head's
    weights at zero and its bias at 1 and a sigma cotangent of 1 on sample
    s alone, K2's alpha gradient is the recomputed last trunk output of s;
    with the weights at e_k and the bias at 0, wide K1's sigma is that
    output's entry k."""
    recomputes_the_forward(card, dtype, 384, 192, 18)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide1k_backward_recomputes_the_forwards_activations(card, dtype):
    """The same past width 512: K2's recompute (the wide1k forward's own
    kernel in record mode) gives the wide1k K1's trunk activations bit for
    bit, on the lego widened to 1024/512/8, at 129 of the 1024 units (every
    eighth, so every 64-column piece of each CTA's half or quarter, and the
    last unit), each a K1 launch."""
    recomputes_the_forward(card, dtype, 1024, 512, 8, units=[*range(0, 1024, 8), 1023])


def recomputes_the_forward(card, dtype, width, v_width, depth, units=None):
    params = chip_smoke_module().widen_nerf(load_nerf_params(LEGO / "fine"), width, v_width,
                                            depth)
    rays, samples = 37, 29
    pts, dirs = inputs(rays, samples, 13, card)
    pts = pts * 0.4
    base = {layer: {k: torch.from_numpy(v).to(card) for k, v in p.items()}
            for layer, p in params.items()}
    units = range(width) if units is None else units

    def tree(w_alpha, b_alpha):
        t = dict(base)
        t["alpha"] = {"kernel": w_alpha.reshape(-1, 1).to(card),
                      "bias": torch.full((1,), b_alpha, device=card)}
        return t

    h = torch.zeros((rays * samples, width), device=card)
    with torch.no_grad():
        for k in units:
            _, sig = fused_nerf_mlp(tree(torch.eye(width)[k], 0.0), pts, dirs, dtype=dtype,
                                    sigma_only=True)
            h[:, k] = sig.reshape(-1)
    pk = pack_params(tree(torch.zeros(width), 1.0), dtype)
    assert pk.wide
    g_rgb = torch.zeros((rays, samples, 3), device=card)
    for s in (0, 500, rays * samples - 1):            # first tile, a middle one, the ragged last
        g_sig = torch.zeros(rays * samples, device=card)
        g_sig[s] = 1.0
        dw, db, _, _ = fused_nerf_mlp_backward(pk, pts, dirs, g_rgb, g_sig.reshape(rays, samples),
                                               dtype=dtype, sigma_only=True, input_grads=False)
        got = unpack_grads(pk, dw, db)["alpha"]["kernel"][:, 0][list(units)]
        want = h[s][list(units)]
        assert torch.equal(got, want), (s, float((got - want).abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_autograd_through_kernels_matches_plain_autograd(card, dtype):
    """The lego widened to 512/256/8: its gradients through fused_nerf_mlp
    on the card (wide K1 and wide K2, input gradients included) against
    the plain path's: f32 against torch autograd of the plain oracle, bf16
    against fused_nerf_mlp on CPU tensors (the plain forward and
    backward)."""
    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    plain = (nerf_mlp, card) if dtype == "float32" else (fused_nerf_mlp, torch.device("cpu"))
    grads = []
    before = fused_nerf_mlp_backward.wide_launches
    for fn, device in ((fused_nerf_mlp, card), plain):
        net = widened_lego(512, 256, 8, device, requires_grad=True)
        pts, dirs = inputs(16, 40, 11, device)
        pts = (pts * 0.4).requires_grad_(True)
        kw = {} if fn is nerf_mlp else {"dtype": dtype}
        rgb, sig = fn(net, pts, dirs, **kw)
        (rgb.square().sum() + 1e-2 * sig.sum()).backward()
        grads.append({**{k: p.grad.cpu() for k, p in net.weights.items()},
                      "points": pts.grad.cpu()})
    assert fused_nerf_mlp_backward.wide_launches == before + 1
    for k, want in grads[1].items():
        assert rel_err(grads[0][k], want) <= BWD_TOL[dtype], k


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


@pytest.mark.parametrize("levels", [65, 130], ids=["65", "130"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_hash_encode_past_64_levels_runs_the_kernel_in_blocks(card, dtype, levels):
    """Past the 64 levels one launch serves, the field's encode
    (``blocked_hash_encode``) launches the kernel once a block of 64 levels
    (2 and 3 launches) and matches the plain version at
    test_hash_encode_kernel_matches_plain's bars, two calls bitwise equal;
    the field's table gradient is finite and non-zero; ``fused_hash_encode``
    still refuses the tables."""
    from nerf_rs_tpu_torch.config import HashGridConfig
    from nerf_rs_tpu_torch.models.hashgrid import hash_encode
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import (
        blocked_hash_encode,
        fused_hash_encode,
        hash_encode_reference,
    )

    cfg = HashGridConfig(levels=levels, table_log2=12, res_max=512)
    tables, pts = hash_inputs(cfg, 4097, 27, card, dtype)
    before = fused_hash_encode.launches
    got = blocked_hash_encode(tables, pts, cfg)
    again = blocked_hash_encode(tables, pts, cfg)
    torch.cuda.synchronize()
    assert fused_hash_encode.launches == before + 2 * -(-levels // 64)
    want = hash_encode_reference(tables, pts, cfg)
    assert got.shape == (4097, levels * cfg.features) and got.dtype == dtype
    assert torch.equal(got, again)
    if dtype == torch.float32:
        atol = 1e-5 * float(tables.abs().max())
    else:
        atol = 2 * 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    t = tables.clone().requires_grad_()
    hash_encode(t, pts, cfg).float().square().sum().backward()
    assert bool(torch.isfinite(t.grad.float()).all()) and float(t.grad.float().abs().max()) > 0
    with pytest.raises(NotImplementedError, match="item 12"):
        fused_hash_encode(tables, pts, cfg)


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
    """Past the int8 kernels' envelope (width 576, depth 33) and for other
    encodings: NotImplementedError, no launch."""
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp

    pts, dirs = inputs(4, 8, 34, card)
    before = fused_int8_mlp.launches
    for arch, text in ((ArchConfig(width=576, v_width=32, depth=2, skip_at=5), "width=576"),
                       (ArchConfig(width=64, v_width=32, depth=33, skip_at=4), "depth=33")):
        net = NerfMLP(np_params(arch, 33), device=card)
        with pytest.raises(NotImplementedError, match=text):
            fused_int8_mlp(net, pts, dirs)
    assert fused_int8_mlp.launches == before
    net = NerfMLP(np_params(SMALL, 35), device=card)
    with pytest.raises(NotImplementedError, match="L=\\(10,4\\)"):
        fused_int8_mlp(net, pts, dirs, x_freqs=8)


# The wide int8 kernel (csrc/int8_mlp_wide_tc.cu): past width 256 or depth
# 16, up to 512 and 32, at check_int8's bars.
WIDE_INT8 = [ArchConfig(width=300, v_width=72, depth=18, skip_at=4),
             ArchConfig(width=264, v_width=32, depth=2, skip_at=0),
             ArchConfig(width=64, v_width=64, depth=17, skip_at=4),
             ArchConfig(width=256, v_width=128, depth=20, skip_at=4),
             ArchConfig(width=512, v_width=512, depth=32, skip_at=10)]


def check_wide_int8(net, pts, dirs, sigma_only):
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp

    before = fused_int8_mlp.wide_launches
    check_int8(net, pts, dirs, sigma_only)
    assert fused_int8_mlp.wide_launches == before + 2


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("arch", WIDE_INT8, ids=["300x72x18", "264x32x2", "64x64x17",
                                                 "256x128x20", "512x512x32"])
def test_wide_int8_kernel_matches_plain_ragged(card, arch, sigma_only):
    """A ragged sample count (37 x 29), ragged widths, one 64-column piece
    (the second warpgroup without columns), 32 layers at 512; per-ray and
    per-sample dirs; two calls bitwise equal, both on the wide kernel."""
    net = NerfMLP(np_params(arch, 40), device=card)
    pts, dirs = inputs(37, 29, 41, card)
    check_wide_int8(net, pts * 0.4, dirs, sigma_only)
    check_wide_int8(net, pts * 0.4, dirs.expand(37, 29, 3).contiguous(), sigma_only)


@pytest.mark.parametrize("arch", [(512, 256, 20), (384, 192, 8)], ids=["512x256x20", "384x192x8"])
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_wide_int8_kernel_matches_plain_widened_lego(card, net, arch):
    """The lego networks widened by chip_smoke.widen_nerf (phase 29's),
    331 x 157 samples: many tiles a CTA, the last one ragged."""
    import sys

    sys.path.insert(0, str(LEGO.parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(LEGO.parents[1]))
    tree = chip_smoke.widen_nerf(load_nerf_params(LEGO / net), *arch,
                                 seed=("coarse", "fine").index(net))
    module = NerfMLP(tree, device=card)
    pts, dirs = inputs(331, 157, 42, card)
    check_wide_int8(module, pts * 0.4, dirs, net == "coarse")


def test_wide_int8_kernel_exact_at_saturated_codes(card):
    """saturating_params at 512/256/8: whole rows of codes at 127, the
    skip layer's K = 576, the wide kernel's largest sums: sigma bit for
    bit, rgb within INT8_RGB_ATOL."""
    net = NerfMLP(saturating_params(ArchConfig(width=512, v_width=256, depth=8, skip_at=4), 43),
                  device=card)
    pts, dirs = inputs(64, 96, 44, card)
    check_wide_int8(net, pts * 0.4, dirs, False)
    check_wide_int8(net, pts * 0.4, dirs, True)


def test_wide_int8_kernel_empty_batch(card):
    """No samples: empty outputs and no launch."""
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp

    net = NerfMLP(np_params(WIDE_INT8[0], 45), device=card)
    before = fused_int8_mlp.launches, fused_int8_mlp.wide_launches
    rgb, sig = fused_int8_mlp(net, torch.zeros(0, 7, 3, device=card),
                              torch.zeros(0, 1, 3, device=card))
    assert rgb.shape == (0, 7, 3) and sig.shape == (0, 7)
    assert (fused_int8_mlp.launches, fused_int8_mlp.wide_launches) == before


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


@pytest.mark.parametrize("family", ["mlp", "hashgrid"])
def test_checkpoint_of_a_card_state_restores_bitwise_on_the_cpu_and_back(card, tmp_path, family):
    """A state trained one step on the card, saved, restored on the CPU and
    saved again from there, restores on the card bitwise: params, moments,
    count and step."""
    from nerf_rs_tpu_torch.config import HashGridConfig, TrainConfig
    from nerf_rs_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
    from nerf_rs_tpu_torch.train import create_train_state, train_step

    render = RenderConfig(n_coarse=8, n_fine=8, ray_chunk=64, impl="pallas")
    if family == "hashgrid":
        render = render.replace(model="hashgrid",
                                hash=HashGridConfig(levels=4, table_log2=12, res_max=64))
    cfg = TrainConfig(batch_rays=64, arch=SMALL, render=render)
    state = create_train_state(torch.Generator(device=card).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    batch = {"origins": torch.zeros(64, 3, device=card),
             "dirs": torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).to(card),
             "rgb": torch.from_numpy(rng.uniform(size=(64, 3)).astype(np.float32)).to(card),
             "near": torch.tensor(2.0, device=card), "far": torch.tensor(6.0, device=card)}
    state, _ = train_step(state, batch, random.key(1, card), cfg)
    on_cpu = restore_checkpoint(save_checkpoint(tmp_path / "a", state), "cpu")
    back = restore_checkpoint(save_checkpoint(tmp_path / "b", on_cpu), card)
    for restored in (on_cpu, back):
        assert (restored.step, restored.count) == (1, 1)
        for net, module in state.params.items():
            for name, p in module.weights.items():
                for got, want in ((restored.params[net].weights[name], p),
                                  (restored.mu[net][name], state.mu[net][name]),
                                  (restored.nu[net][name], state.nu[net][name])):
                    assert torch.equal(got.detach().cpu(), want.detach().cpu()), (net, name)
    assert back.params[next(iter(back.params))].weights["dense0_kernel" if family == "mlp"
                                                        else "hash_tables"].device.type == "cuda"


def test_render_checkpoint_equals_render_of_its_export_on_the_card(card, tmp_path):
    """``render --checkpoint --device cuda`` writes the bytes of ``render
    --weights <export> --device cuda``: the same networks through K1."""
    from nerf_rs_tpu_torch.cli import main as cli_main
    from nerf_rs_tpu_torch.config import TrainConfig
    from nerf_rs_tpu_torch.io.checkpoint import save_checkpoint
    from nerf_rs_tpu_torch.train import create_train_state

    state = create_train_state(torch.Generator(device=card).manual_seed(4), TrainConfig())
    ck = save_checkpoint(tmp_path / "ck", state)
    assert cli_main(["export", "--checkpoint", str(ck), "-o", str(tmp_path / "exp")]) == 0
    base = ["render", "--device", "cuda", "--width", "64", "--height", "64", "--coarse-samples",
            "32", "--fine-samples", "64"]
    before = fused_nerf_mlp.launches
    assert cli_main([*base, "--checkpoint", str(ck), "-o", str(tmp_path / "ck.ppm")]) == 0
    assert fused_nerf_mlp.launches == before + 2
    assert cli_main([*base, "--weights", str(tmp_path / "exp"), "-o", str(tmp_path / "w.ppm")]) == 0
    assert (tmp_path / "ck.ppm").read_bytes() == (tmp_path / "w.ppm").read_bytes()


def test_blender_dataset_on_the_card_equals_the_cpus(card, tmp_path):
    """A nerf_synthetic scene loaded for the card (ray directions computed
    there, batches gathered in pinned memory and copied without blocking)
    against the same scene loaded for the CPU: origins, frame indices and
    colours bitwise, directions within 1e-6 (tests/test_torch_data.py's
    bar against JAX); the first three batches of a seed likewise, on the
    card."""
    import json

    from nerf_rs_tpu_torch.data import BlenderDataset
    from nerf_rs_tpu_torch.io.image import save_png

    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        save_png(tmp_path / f"r_{i}.png", rng.uniform(size=(24, 32, 4)).astype(np.float32), 24, 32)
        pos = np.array([4 * np.sin(i), -4 * np.cos(i), 1.0], np.float32)
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, pos
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    on_card, on_cpu = (BlenderDataset(tmp_path, device=d) for d in (card, "cpu"))
    for name in ("frame_origins", "frame_idx", "rgb"):
        np.testing.assert_array_equal(getattr(on_card, name), getattr(on_cpu, name), err_msg=name)
    np.testing.assert_allclose(on_card.dirs, on_cpu.dirs, rtol=0, atol=1e-6)
    card_batches, cpu_batches = on_card.batches(512, seed=3), on_cpu.batches(512, seed=3)
    for _ in range(3):
        got, want = next(card_batches), next(cpu_batches)
        assert all(v.device.type == "cuda" for v in got.values())
        for name in ("origins", "rgb", "near", "far"):
            assert torch.equal(got[name].cpu(), want[name]), name
        torch.testing.assert_close(got["dirs"].cpu(), want["dirs"], rtol=0, atol=1e-6)


# ---- occupancy-culled training and extract ----

def culled_step_pair(card, accel_kw, n_coarse=16, n_fine=32):
    """One train step on the card from the same state, batch, key and
    lego grid (64^3, as ``train --accel-every`` builds it from the lego
    networks), impl="pallas" (K1 forward and K2 backward on the rows the
    grid leaves, compacted to their capacity or masked) against
    impl="xla": (states, metrics, K1 and K2 launches of the kernel step).
    Compaction without capacities in ``accel_kw`` takes them from
    ``accel.capacities_from_occupancy`` of the grid, as the CLI does."""
    from nerf_rs_tpu_torch.accel import build_scene_grid, capacities_from_occupancy
    from nerf_rs_tpu_torch.config import TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.train import create_train_state, train_step

    cfg = TrainConfig(batch_rays=4096, arch=SMALL, render=RenderConfig(
        n_coarse=n_coarse, n_fine=n_fine, ray_chunk=4096, **accel_kw))
    teacher = {net: NerfMLP(load_nerf_params(LEGO / net), device=card)
               for net in ("coarse", "fine")}
    grid = build_scene_grid(teacher["coarse"], teacher["fine"], resolution=64)
    if accel_kw.get("accel_compact") in ("scatter", "gather") and \
            "accel_coarse_capacity" not in accel_kw:
        cap_c, cap_f = capacities_from_occupancy(float(grid.occ.float().mean()), cfg.render)
        cfg = cfg.replace(render=cfg.render.replace(accel_coarse_capacity=cap_c,
                                                    accel_fine_capacity=cap_f))
    batch = next(DistillationDataset(teacher, cfg=cfg.render.replace(impl="pallas"),
                                     device=card).batches(cfg.batch_rays))
    states, metrics, launches = {}, {}, None
    for impl in ("pallas", "xla"):
        state = create_train_state(torch.Generator(device=card).manual_seed(0), cfg)
        before = (fused_nerf_mlp.launches, fused_nerf_mlp_backward.launches)
        states[impl], m = train_step(state, batch, random.key(1, card),
                                     cfg.replace(render=cfg.render.replace(impl=impl)), grid=grid)
        metrics[impl] = {k: float(v) for k, v in m.items()}
        if impl == "pallas":
            launches = (fused_nerf_mlp.launches - before[0],
                        fused_nerf_mlp_backward.launches - before[1])
    return cfg, states, metrics, launches


def assert_one_step_bound(cfg, states, metrics, share_of=("coarse", "fine")):
    """tests/test_train.py's one-step bound between the kernel and plain
    states: loss to 1e-5 relative, every parameter within 2 lr, under 0.1%
    of the entries of the networks ``share_of`` more than 1e-5 apart."""
    assert abs(metrics["pallas"]["loss"] - metrics["xla"]["loss"]) <= \
        1e-5 * metrics["xla"]["loss"], metrics
    diffs = {net: [(p.detach() - states["xla"].params[net].weights[name].detach()).abs()
                   for name, p in states["pallas"].params[net].weights.items()]
             for net in ("coarse", "fine")}
    assert max(float(d.max()) for ds in diffs.values() for d in ds) < 2 * cfg.lr_init
    shared = [d for net in share_of for d in diffs[net]]
    assert sum(int((d > 1e-5).sum()) for d in shared) < 1e-3 * sum(d.numel() for d in shared)


@pytest.mark.parametrize("compact", ["none", "scatter", "gather"])
def test_culled_train_step_kernels_match_plain(card, compact):
    """A culled step with K1 and K2 (two launches each: coarse and fine)
    on the grid's rows against the plain MLP's step: the one-step bound;
    the coarse pass's live rows equal (geometry alone) and no overflow at
    capacities from ``accel.capacities_from_occupancy`` of the grid."""
    cfg, states, metrics, launches = culled_step_pair(card, dict(accel_compact=compact))
    assert launches == (2, 2)
    assert_one_step_bound(cfg, states, metrics)
    assert metrics["pallas"]["live_frac_coarse"] == metrics["xla"]["live_frac_coarse"] < 1.0
    assert metrics["pallas"]["accel_overflow"] == metrics["xla"]["accel_overflow"] == 0.0


@pytest.mark.parametrize("compact", ["scatter", "gather"])
def test_culled_train_step_with_an_overflowing_capacity(card, compact):
    """Capacities far below the live rows: both steps overflow (the
    indicator is 1 and the coarse pass's live rows exceed its capacity)
    and keep the same first rows of the coarse pass, whose rows are
    geometry alone, so the coarse network meets the one-step bound; the
    fine pass keeps the first live rows of samples that move with the
    coarse sigmas' last bits, so there a live row near a cell boundary
    shifts which rows are kept, and the fine network is held to 2 lr
    (measured on an H100: 0.2% of all entries > 1e-5 apart)."""
    cfg, states, metrics, launches = culled_step_pair(
        card, dict(accel_compact=compact, accel_coarse_capacity=0.02, accel_fine_capacity=0.02))
    assert launches == (2, 2)
    for impl in ("pallas", "xla"):
        assert metrics[impl]["accel_overflow"] == 1.0 and metrics[impl]["live_frac_coarse"] > 1.0
    assert metrics["pallas"]["live_frac_coarse"] == metrics["xla"]["live_frac_coarse"]
    assert_one_step_bound(cfg, states, metrics, share_of=("coarse",))


def test_culled_placement_step_kernels_match_plain(card):
    """Single-pass training under 128-probe placement (the teacher_sp30
    recipe's render) with mask-only culling: one K1 and one K2 launch,
    the one-step bound against the plain MLP."""
    cfg, states, metrics, launches = culled_step_pair(
        card, dict(accel_sample_aabb=True, accel_aabb_probes=128, accel_pad_probes=4.0),
        n_coarse=64, n_fine=0)
    assert launches == (1, 1)
    assert_one_step_bound(cfg, states, metrics)


def test_extract_lattice_through_k1_bf16(card):
    """extract's lattice of the lego fine network at 96^3 on the card runs
    K1 bf16 sigma-only (one launch a chunk, on the tensor cores); its
    cells fall on the other side of the iso level 10 from the plain f32
    lattice's on at most 1% of the cells next to the surface (a bf16 sigma
    near the level; the plain bf16 version flips 0.18% at 64^3 on a CPU),
    and the meshes' face counts agree within 2%."""
    from nerf_rs_tpu_torch.accel import _oracle_sigma, density_grid
    from nerf_rs_tpu_torch.extract import extract_scene_mesh, extract_voxel_mesh

    fine = NerfMLP(load_nerf_params(LEGO / "fine"), device=card)
    before, before_tc = fused_nerf_mlp.launches, fused_nerf_mlp.tc_launches
    sig = density_grid(fine, resolution=96, chunk=96 ** 3 // 4).cpu().numpy()
    assert (fused_nerf_mlp.launches - before, fused_nerf_mlp.tc_launches - before_tc) == (4, 4)
    plain = density_grid(fine, resolution=96, mlp_fn=_oracle_sigma).cpu().numpy()
    side, side_plain = sig > 10.0, plain > 10.0
    near = side_plain != np.roll(side_plain, 1, 0)
    for ax in (1, 2):
        near |= side_plain != np.roll(side_plain, 1, ax)
    assert (side != side_plain).sum() <= 1e-2 * near.sum(), ((side != side_plain).sum(), near.sum())
    verts, faces = extract_scene_mesh(fine, fine, resolution=96)
    assert abs(len(faces) - len(extract_voxel_mesh(plain, 10.0)[1])) <= 0.02 * len(faces)


@pytest.fixture
def nccl_world_of_1(card, tmp_path):
    """A world of 1 under NCCL on the card (a file:// store), torn down
    after the test."""
    import datetime

    import torch.distributed as dist

    from nerf_rs_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, device=card,
                         timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl" and mesh.device == card
        yield mesh
    finally:
        multihost.shutdown()


def test_world_of_1_sharded_frame_is_bitwise_render_image(nccl_world_of_1):
    """render_image_sharded in a world of 1 under NCCL: render_image's
    frame bit for bit (the all-gather of one rank is a copy), K1 twice a
    chunk on the tensor cores; the culled path too."""
    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.parallel.render_sharded import render_image_sharded

    mesh = nccl_world_of_1
    golden = load_golden(LEGO / "tf_reference_samples.json")
    cam = camera_from_golden(golden)
    coarse, fine = (NerfMLP(load_nerf_params(LEGO / n), device=mesh.device)
                    for n in ("coarse", "fine"))
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=2048, impl="pallas")
    key = random.key(0, mesh.device)
    before, before_tc = fused_nerf_mlp.launches, fused_nerf_mlp.tc_launches
    got = render_image_sharded(coarse, fine, cam, 64, 64, key, cfg, mesh=mesh)
    assert (fused_nerf_mlp.launches - before, fused_nerf_mlp.tc_launches - before_tc) == (4, 4)
    assert torch.equal(got, render_image(coarse, fine, cam, 64, 64, key, cfg))
    grid = build_scene_grid(coarse, fine, resolution=64)
    acfg = cfg.replace(accel_compact="off", accel_aabb_probes=32, accel_range_stride=4,
                       accel_cull_rays=True, sampling_impl="pallas", dtype="bfloat16")
    assert torch.equal(render_image_sharded(coarse, fine, cam, 64, 64, key, acfg, mesh=mesh,
                                            grid=grid),
                       render_image(coarse, fine, cam, 64, 64, key, acfg, grid=grid))


def test_world_of_1_sharded_step_is_bitwise_train_step(nccl_world_of_1):
    """sharded_train_step in a world of 1 under NCCL, from the same state,
    batch and key as train_step: the same params and metrics bit for bit,
    K2 twice."""
    from nerf_rs_tpu_torch.config import TrainConfig
    from nerf_rs_tpu_torch.parallel.train_sharded import sharded_train_step
    from nerf_rs_tpu_torch.train import create_train_state, train_step

    mesh = nccl_world_of_1
    cfg = TrainConfig(batch_rays=256, arch=SMALL, render=RenderConfig(
        n_coarse=16, n_fine=32, ray_chunk=256, impl="pallas"))
    states = [create_train_state(torch.Generator(device=mesh.device).manual_seed(0), cfg)
              for _ in range(2)]
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = {"origins": torch.zeros(256, 3, device=mesh.device),
             "dirs": torch.from_numpy(dirs).to(mesh.device),
             "rgb": torch.from_numpy(rng.uniform(size=(256, 3)).astype(np.float32)).to(mesh.device),
             "near": torch.tensor(2.0, device=mesh.device),
             "far": torch.tensor(6.0, device=mesh.device)}
    key = random.key(1, mesh.device)
    _, want = train_step(states[0], batch, key, cfg)
    before = fused_nerf_mlp_backward.launches
    _, got = sharded_train_step(mesh, states[1], batch, key, cfg)
    assert fused_nerf_mlp_backward.launches - before == 2
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for net, module in states[0].params.items():
        for name, p in module.weights.items():
            assert torch.equal(states[1].params[net].weights[name], p), (net, name)
