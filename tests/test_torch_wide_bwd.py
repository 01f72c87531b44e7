"""PyTorch port, K2's wide envelope: the gradients of networks wider than
256 or deeper than 16, up to width and v_width 512 and depth 32, which the
backward kernel K2 serves through its wide pair on the card
(``csrc/fused_mlp_wide_bwd_tc.cu``, ``csrc/fused_mlp_wide_bwd_bf16.cu``).

On the CPU the wrappers run the plain versions: the port's K2 plain
version on a wide pack (``fused_nerf_mlp_backward_reference``, through the
autograd function ``_FusedMLP``) against ``jax.grad`` of the JAX package's
fused MLP (its Pallas backward kernel in interpret mode, as
tests/test_torch_fused_mlp_bwd.py runs it for the narrow K2), and the
packed layouts the wide kernels read (``unpack_grads`` / ``pack_params``
round trips, the transposed tensor-core pack of a wide f32 pack). The
kernels are held to the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 29)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io.weights import params_to_torch
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_backward,
    fused_nerf_mlp_backward_reference,
    pack_params,
    unpack_grads,
)
from test_torch_fused_mlp_bwd import mma_segments, np_params, np_rays, torch_leaves, untile_mma

torch.set_num_threads(1)

# (width, v_width, depth, skip_at): a 384-wide network and a 512-wide one
# deeper than 16.
WIDE = [ArchConfig(384, 192, 8, 4), ArchConfig(512, 256, 20, 4)]
WIDE_IDS = ["384x192x8", "512x256x20"]
COLOR = ("bottleneck", "viewdirs", "rgb")
# f32: every parameter gradient within tests/test_torch_fused_mlp_bwd.py's
# bars of JAX's kernel (the same function, sums in another order). The
# input gradients sum the encode's 63 rows, each scaled by up to 2^9, of
# sums over the whole trunk: at width 384 one d(points) entry of 384 lies
# 1.1e-4 from JAX's, while the port's and JAX's are each within 3.8e-4 of
# the float64 evaluation; they are held as K2's f32 gradients are on the
# card (PERF.md §2), ||g - g_jax|| / ||g_jax|| <= 1e-4. bf16 (JAX's
# encode with exact sin, as the port takes it): both kernels round each
# layer's output gradient to bf16 at the same places but sum in other
# orders, and a rounding one order flips cascades through the trunk; in a
# random network 20 layers deep each lies 4-5% from the same function
# summed exactly (the reference on float64 inputs, rounded where the
# kernels round). So, as PERF.md §2 holds K2's f32 gradients to float64,
# each port gradient lies within max(3e-2, 1.5 x JAX's distance) of that
# evaluation (3e-2: PERF.md §2's bf16 bar for K2 against its plain
# version), as a relative norm.
ATOL, RTOL = 1e-6, 1e-4
F32_INPUT_REL = 1e-4
BF16_REL, BF16_VS_JAX = 3e-2, 1.5


@pytest.fixture(scope="module", params=WIDE, ids=WIDE_IDS)
def wide(request):
    return request.param, np_params(request.param, 0)


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rays, samples", [(4, 32), (5, 40)], ids=["n128", "n200_ragged"])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_wide_grads_match_jax_fused_kernel(wide, rays, samples, sigma_only, dtype, monkeypatch):
    """Parameter, point and per-ray dir gradients of sum(g_rgb * rgb +
    g_sigma * sigma) through the port's fused MLP on CPU tensors (the
    backward's plain version on a wide pack) against jax.grad of the JAX
    kernel at the same width and depth, at the bars above; n = 200 is not
    a multiple of either package's tile. With sigma_only the rgb cotangent
    gives the color branch no gradient in either package."""
    arch, params = wide
    monkeypatch.setenv("NERF_FUSED_TRIG", "exact")
    pts, dirs, g_rgb, g_sig = np_rays(rays, samples, 1)

    def jax_loss(p, x, d):
        rgb, sig = jax_fused_nerf_mlp(p, x, d, sigma_only=sigma_only, dtype=dtype)
        return jnp.sum(rgb * g_rgb) + jnp.sum(sig * g_sig)

    want_p, want_x, want_d = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pts), jnp.asarray(dirs))
    leaves = torch_leaves(params)
    x = torch.tensor(pts, requires_grad=True)
    d = torch.tensor(dirs, requires_grad=True)
    assert pack_params(params_to_torch(params, "cpu"), dtype).wide
    rgb, sig = fused_nerf_mlp(leaves, x, d, sigma_only=sigma_only, dtype=dtype)
    (torch.sum(rgb * torch.from_numpy(g_rgb)) + torch.sum(sig * torch.from_numpy(g_sig))).backward()
    got = {f"{layer}/{part}": t.grad.numpy() for layer, p in leaves.items()
           for part, t in p.items()}
    want = {f"{layer}/{part}": np.asarray(want_p[layer][part]) for layer in params
            for part in ("kernel", "bias")}
    got.update(points=x.grad.numpy(), dirs=d.grad.numpy())
    want.update(points=np.asarray(want_x), dirs=np.asarray(want_d))
    assert got["dirs"].shape == dirs.shape
    tree = params_to_torch(params, "cpu")
    out = fused_nerf_mlp_backward_reference(
        tree, *(torch.from_numpy(a).double() for a in (pts, dirs, g_rgb, g_sig)), dtype=dtype,
        sigma_only=sigma_only)
    leaves64 = unpack_grads(pack_params(tree, dtype), out[0], out[1])
    exact = {f"{layer}/{part}": leaves64[layer][part].numpy() for layer in params
             for part in ("kernel", "bias")}
    exact.update(points=out[2].numpy(), dirs=out[3].sum(1, keepdim=True).numpy())
    for name, w in want.items():
        if sigma_only and name.split("/")[0] in COLOR:
            assert not got[name].any() and not w.any(), name
        elif dtype == "float32" and name in ("points", "dirs"):
            assert rel(got[name], w) <= F32_INPUT_REL, (name, rel(got[name], w))
        elif dtype == "float32":
            np.testing.assert_allclose(got[name], w, atol=ATOL, rtol=RTOL, err_msg=name)
        else:
            bar = max(BF16_REL, BF16_VS_JAX * rel(w, exact[name]))
            assert rel(got[name], exact[name]) <= bar, (name, rel(got[name], exact[name]), bar)


def test_wide_backward_wrapper_on_cpu_is_the_reference_and_counts_no_launch(wide):
    """K2's wrapper on CPU tensors of a wide network: the plain version,
    no launch counted (wide or not), in both dtypes."""
    arch, params = wide
    pts, dirs, g_rgb, g_sig = (torch.from_numpy(a) for a in np_rays(3, 24, 5))
    tree = params_to_torch(params, "cpu")
    before = fused_nerf_mlp_backward.launches, fused_nerf_mlp_backward.wide_launches
    for dtype in ("float32", "bfloat16"):
        got = fused_nerf_mlp_backward(tree, pts, dirs, g_rgb, g_sig, dtype=dtype)
        want = fused_nerf_mlp_backward_reference(tree, pts, dirs, g_rgb, g_sig, dtype=dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fused_nerf_mlp_backward.launches, fused_nerf_mlp_backward.wide_launches) == before


@pytest.mark.parametrize("arch", [ArchConfig(512, 512, 32, 10), ArchConfig(512, 256, 32, 31),
                                  ArchConfig(200, 264, 20, 1)],
                         ids=["512x512x32", "512x256x32_noskip", "200x264x20_unaligned"])
def test_wide_unpack_grads_inverts_pack(arch):
    """unpack_grads of a wide pack's own weights and biases gives the
    param tree back, at width 512 and depth 32 and at unaligned widths:
    every leaf lands where pack_params took it from, through the tables'
    32 layer slots."""
    params = params_to_torch(np_params(arch, 6), "cpu")
    pk = pack_params(params, "float32")
    assert pk.wide and pk.layout.size == 3 * fm.MAX_DEPTH + 9
    tree = unpack_grads(pk, pk.weights, pk.biases)
    assert tree.keys() == params.keys()
    for layer, p in params.items():
        for part, t in p.items():
            assert torch.equal(tree[layer][part], t), f"{layer}/{part}"


@pytest.mark.parametrize("arch", [ArchConfig(512, 512, 32, 10), ArchConfig(384, 192, 8, 4)],
                         ids=["512x512x32", "384x192x8"])
def test_wide_transposed_pack_round_trip(arch):
    """A wide f32 pack holds the transposed tensor-core pack the wide f32
    backward reads: layout_mma has 2 x 32 + 3 entries, dense{i} at i, its
    encode part at 32 + i, the color segments at 64-66; each segment reads
    back through the inverse of its tiling as hi + lo, within 2^-22 of
    the weight, its padding zero, and every element of the pack belongs to
    exactly one segment."""
    params = params_to_torch(np_params(arch, 9), "cpu")
    pk = pack_params(params, "float32")
    assert pk.wide and pk.layout_mma.size == 2 * fm.MAX_DEPTH + 3
    assert (pk.layout_mma[arch.depth:fm.MAX_DEPTH] == -1).all()
    hi, lo = pk.mma_wt[0], pk.mma_wt[1]
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    covered = np.zeros(hi.numel(), np.int64)
    for name, (slot, k, ld) in mma_segments(pk, arch).items():
        want = pk.mat(name).double().numpy().T
        kp, n = -(-want.shape[0] // 16) * 16, want.shape[1]
        off = int(pk.layout_mma[slot])
        got_hi, idx = untile_mma(hi.double().numpy(), off, kp, n)
        got_lo, _ = untile_mma(lo.double().numpy(), off, kp, n)
        np.add.at(covered, idx.reshape(-1), 1)
        r = want.shape[0]
        err = np.abs(got_hi[:r] + got_lo[:r] - want)
        assert (err <= 2.0 ** -22 * np.abs(want)).all(), (name, float(err.max()))
        assert not got_hi[r:].any() and not got_lo[r:].any(), name
    assert (covered == 1).all()


def test_wide_student_grads_through_nerf_mlp_module(wide):
    """A wide NerfMLP trained through the fused path on the CPU gets every
    parameter's gradient, equal to torch autograd of the port's oracle
    (``models.mlp.nerf_mlp``) at the f32 bars."""
    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    arch, params = wide
    pts, dirs, _, _ = np_rays(2, 20, 2)
    grads = []
    for fn in (fused_nerf_mlp, nerf_mlp):
        net = NerfMLP(params, requires_grad=True)
        rgb, sig = fn(net, torch.from_numpy(pts), torch.from_numpy(dirs))
        (rgb.mean() + 1e-3 * sig.mean()).backward()
        grads.append({k: p.grad for k, p in net.weights.items()})
    for name, want in grads[1].items():
        np.testing.assert_allclose(grads[0][name].numpy(), want.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def _chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_recorded_outputs_on_cpu_are_the_plain_forwards(wide):
    """``recorded_outputs`` (what K2's f32 mode differentiates: its record
    pass's trunk, bottleneck and view outputs) on CPU tensors is the plain
    f32 forward's, layer by layer, at the network's widths."""
    arch = WIDE[0] if wide else ArchConfig(64, 32, 4, 2)
    net = NerfMLP(np_params(arch, 3), device=torch.device("cpu"))
    pts, dirs, _, _ = (torch.from_numpy(a) for a in np_rays(3, 5, 4))
    out = fm.recorded_outputs(net, pts, dirs)
    assert len(out) == arch.depth + 2
    assert [o.shape[1] for o in out] == [arch.width] * (arch.depth + 1) + [arch.v_width]
    pk = net.packed("float32")
    enc = fm._encode(pts.reshape(-1, 3), 10, fm._ENC_X)
    h = torch.relu(enc @ pk.mat("dense0") + pk.bias("dense0"))
    assert torch.equal(out[0], h[:, :arch.width])
    assert bool((out[-1] >= 0).all()) and out[-1].shape[0] == 15


@pytest.mark.parametrize("sigma_only", [False, True], ids=["full", "sigma_only"])
def test_kernel_mask_oracle_takes_the_kernels_masks(sigma_only, monkeypatch):
    """``chip_smoke.kernel_mask_exact``, phases 8 and 29's float64 oracle
    for K2 in f32: with the recorded outputs unchanged (the plain
    forward's on the CPU) it is the float64 evaluation itself; with every
    recorded trunk and view mask flipped (and tau 2^-6, so that many
    masks count as unresolved), each sample holding an unresolved mask
    that the "kernel" sets the other way takes all of its masks from the
    recorded outputs (the sigma head's from K1's sigma), and the result
    equals ``mask_gradients`` over all samples with those masks set, to
    1e-12."""
    smoke = _chip_smoke()
    net = NerfMLP(np_params(ArchConfig(64, 32, 4, 2), 3), device=torch.device("cpu"))
    pts, dirs, g_rgb, g_sig = (torch.from_numpy(a) for a in np_rays(6, 9, 1))
    args = (pts, dirs, g_rgb, g_sig)
    exact = fused_nerf_mlp_backward_reference(net, *(a.double() for a in args),
                                              sigma_only=sigma_only)
    g64 = smoke.named_gradients(net.packed("float32"), exact)
    same, info = smoke.kernel_mask_exact(net, args, sigma_only, g64)
    assert info["other_side"] == 0 and all(torch.equal(same[k], g64[k]) for k in g64)
    monkeypatch.setattr(smoke, "MASK_TAU", 2.0 ** -6)
    real = fm.recorded_outputs

    def flipped(params, p, d):
        return [torch.where(o > 0, torch.zeros_like(o), torch.full_like(o, 1e-3))
                for o in real(params, p, d)]

    monkeypatch.setattr(fm, "recorded_outputs", flipped)
    fixed, info = smoke.kernel_mask_exact(net, args, sigma_only, g64)
    found = smoke.unresolved_masks(net, args, sigma_only)
    touched = torch.unique(torch.cat([rows for name, (rows, _, _) in found.items()
                                      if name != "alpha"]))
    assert info["unresolved"] > 100 and info["samples"] == touched.numel() > 0
    rec = flipped(net, pts.reshape(-1, 3)[touched], torch.broadcast_to(dirs, pts.shape)
                  .reshape(-1, 3)[touched])
    sig = fused_nerf_mlp(net, pts.reshape(-1, 3)[touched], torch.broadcast_to(dirs, pts.shape)
                         .reshape(-1, 3)[touched], sigma_only=True)[1].reshape(-1, 1)
    layers = {f"dense{i}": rec[i] for i in range(4)}
    layers["alpha"] = sig
    if not sigma_only:
        layers["viewdirs"] = rec[5]
    masks = {}
    for name, out in layers.items():
        rows = touched[:, None].expand(-1, out.shape[1]).reshape(-1)
        units = torch.arange(out.shape[1])[None, :].expand(touched.numel(), -1).reshape(-1)
        masks[name] = (rows, units, (out > 0).reshape(-1))
    want, _ = smoke.mask_gradients(net, args, sigma_only, masks=masks)
    for k in want:
        assert smoke.rel_err(fixed[k], want[k]) <= 1e-12 or not bool(want[k].any()), k
