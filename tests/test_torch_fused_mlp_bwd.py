"""PyTorch port, MLP backward: the gradients of the port's fused MLP on the
CPU (the backward kernel's plain version, through the autograd function)
against ``jax.grad`` of the JAX package's fused MLP (its Pallas backward
kernel in interpret mode, as tests/test_fused_mlp.py runs it) and against
torch autograd of the port's own oracle; the packed gradient layout.

The CUDA kernel itself is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm
from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io.weights import params_to_torch
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes, nerf_mlp
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_backward,
    fused_nerf_mlp_backward_reference,
    fused_nerf_mlp_reference,
    pack_params,
    split_f32_dense,
    unpack_grads,
)

torch.set_num_threads(1)

SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)
COLOR = ("bottleneck", "viewdirs", "rgb")   # layers only the color branch uses
# f32 against JAX's kernel and against autograd of the oracle: the same
# function with sums in another order (tests/test_fused_mlp.py's bars).
ATOL, RTOL = 1e-6, 1e-4


def np_params(arch, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return out


def np_rays(rays, samples, seed):
    """Points (rays, samples, 3), one unit dir per ray (rays, 1, 3), and
    cotangents for rgb and sigma."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(rays, samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(rays, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g_rgb = rng.normal(size=(rays, samples, 3)).astype(np.float32)
    g_sig = rng.normal(size=(rays, samples)).astype(np.float32) * 1e-2
    return pts, dirs, g_rgb, g_sig


def torch_leaves(params):
    return {layer: {part: torch.tensor(a, requires_grad=True) for part, a in p.items()}
            for layer, p in params.items()}


@pytest.fixture(scope="module")
def small():
    return np_params(SMALL, 0)


@pytest.mark.parametrize("rays, samples", [(4, 32), (5, 40)], ids=["n128", "n200_ragged"])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_grads_match_jax_fused_kernel(small, rays, samples, sigma_only):
    """Parameter, point and per-ray dir gradients of sum(g_rgb * rgb +
    g_sigma * sigma) against jax.grad of the JAX kernel; n = 200 is not a
    multiple of its 128-sample tile. With sigma_only the rgb cotangent
    gives the color branch no gradient in either package."""
    pts, dirs, g_rgb, g_sig = np_rays(rays, samples, 1)

    def jax_loss(p, x, d):
        rgb, sig = jax_fused_nerf_mlp(p, x, d, sigma_only=sigma_only)
        return jnp.sum(rgb * g_rgb) + jnp.sum(sig * g_sig)

    want_p, want_x, want_d = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, small), jnp.asarray(pts), jnp.asarray(dirs))
    leaves = torch_leaves(small)
    x = torch.tensor(pts, requires_grad=True)
    d = torch.tensor(dirs, requires_grad=True)
    rgb, sig = fused_nerf_mlp(leaves, x, d, sigma_only=sigma_only)
    (torch.sum(rgb * torch.from_numpy(g_rgb)) + torch.sum(sig * torch.from_numpy(g_sig))).backward()
    for layer, parts in leaves.items():
        for part, t in parts.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_p[layer][part]),
                                       atol=ATOL, rtol=RTOL, err_msg=f"{layer}/{part}")
            if sigma_only and layer in COLOR:
                assert not t.grad.any(), f"{layer}/{part}"
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), atol=ATOL, rtol=RTOL)
    assert d.grad.shape == dirs.shape
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_d), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("as_module", [False, True], ids=["tree", "module"])
def test_fused_grads_reach_every_parameter_on_cpu(small, as_module):
    """Every parameter gets a gradient through the fused path on the CPU,
    equal to torch autograd of the oracle (its pack once dropped them)."""
    pts, dirs, _, _ = np_rays(6, 20, 2)
    grads = []
    for fn in (fused_nerf_mlp, nerf_mlp):
        net = NerfMLP(small, requires_grad=True) if as_module else torch_leaves(small)
        rgb, sig = fn(net, torch.from_numpy(pts), torch.from_numpy(dirs))
        (rgb.mean() + 1e-3 * sig.mean()).backward()
        tree = net.tree() if as_module else net
        grads.append({(layer, part): t.grad for layer, p in tree.items() for part, t in p.items()})
    for name, want in grads[1].items():
        got = grads[0][name]
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL, err_msg=str(name))


def test_input_grads_only_when_asked(small, monkeypatch):
    """Points' and dirs' gradients are computed only when they need them;
    the parameters' always come back."""
    import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm

    seen = []
    real = fm.fused_nerf_mlp_backward_reference

    def spy(*args, **kw):
        seen.append(kw["input_grads"])
        return real(*args, **kw)

    monkeypatch.setattr(fm, "fused_nerf_mlp_backward_reference", spy)
    pts, dirs, _, _ = np_rays(2, 16, 3)
    net = NerfMLP(small, requires_grad=True)
    rgb, sig = fused_nerf_mlp(net, torch.from_numpy(pts), torch.from_numpy(dirs))
    (rgb.sum() + sig.sum()).backward()
    x = torch.tensor(pts, requires_grad=True)
    rgb, sig = fused_nerf_mlp(net, x, torch.from_numpy(dirs))
    (rgb.sum() + sig.sum()).backward()
    assert seen == [False, True]
    assert x.grad is not None and all(p.grad is not None for p in net.parameters())


def test_changed_parameter_before_backward_raises(small):
    """The autograd function saves its parameter tensors: an in-place
    change between forward and backward raises, as autograd does."""
    pts, dirs, _, _ = np_rays(2, 8, 4)
    net = NerfMLP(small, requires_grad=True)
    rgb, sig = fused_nerf_mlp(net, torch.from_numpy(pts), torch.from_numpy(dirs))
    with torch.no_grad():
        net.weights["dense1_kernel"].mul_(2.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        (rgb.sum() + sig.sum()).backward()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_wrapper_on_cpu_is_the_reference_and_counts_no_launch(small, dtype):
    pts, dirs, g_rgb, g_sig = np_rays(3, 24, 5)
    args = (params_to_torch(small, "cpu"), torch.from_numpy(pts), torch.from_numpy(dirs),
            torch.from_numpy(g_rgb), torch.from_numpy(g_sig))
    before = fused_nerf_mlp_backward.launches
    got = fused_nerf_mlp_backward(*args, dtype=dtype)
    want = fused_nerf_mlp_backward_reference(*args, dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_nerf_mlp_backward.launches == before
    assert got[0].dtype == torch.float32 and got[0].shape == pack_params(args[0], dtype).weights.shape
    assert got[2].shape == pts.shape and got[3].shape == pts.shape


@pytest.mark.parametrize("arch", [SMALL, ArchConfig(), ArchConfig(width=100, v_width=36, depth=3,
                                                                    skip_at=5),
                                  ArchConfig(width=512, v_width=256, depth=32, skip_at=4)],
                         ids=["small", "canonical", "unaligned_noskip", "wide_512x256x32"])
def test_unpack_grads_inverts_pack(arch):
    """unpack_grads of a pack's own weights and biases gives the param
    tree back: every leaf lands where pack_params took it from."""
    params = params_to_torch(np_params(arch, 6), "cpu")
    pk = pack_params(params, "float32")
    tree = unpack_grads(pk, pk.weights, pk.biases)
    assert tree.keys() == params.keys()
    for layer, p in params.items():
        for part, t in p.items():
            assert torch.equal(tree[layer][part], t), f"{layer}/{part}"


def untile_mma(flat, off, k, n):
    """The (k, n) matrix at ``off`` of the f32 tensor-core pack, read element
    by element back from the tf32 B-fragment order csrc/fused_mlp_bwd_tc.cu
    loads (lane 4 g + t of block (kb, nb) holds column 8 nb + g, rows
    t + 4 j)."""
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    r = kk % 16
    t, j = r % 4, r // 4
    lane = 4 * (nn % 8) + t
    idx = off + (((kk // 16) * (n // 8) + nn // 8) * 32 + lane) * 4 + j
    return flat[idx], idx


def mma_segments(pk, arch):
    """{name: (index in the table, rows K, ld N)} of the product segments;
    the table has d layer slots (16, or 32 in a wide pack)."""
    d = (pk.layout_mma.size - 3) // 2
    out = {f"dense{i}": (i, *pk.segments[f"dense{i}"][1:]) for i in range(arch.depth)}
    out.update({f"dense{i}_enc": (d + i, *pk.segments[f"dense{i}_enc"][1:])
                for i in range(1, arch.depth) if f"dense{i}_enc" in pk.segments})
    out.update({name: (2 * d + j, *pk.segments[name][1:])
                for j, name in enumerate(("bottleneck", "viewdirs", "viewdirs_dir"))})
    return out


def test_transposed_pack_holds_every_product_segment(small):
    """The f32 backward kernel's pack: mma_wt holds the transpose of each
    segment but the heads (the recompute reads ``weights``), at
    layout_mma's offsets, read back through the inverse of its tiling (K
    padded to a multiple of 16 with zeros) as hi + lo; every element of the
    pack belongs to exactly one segment. bf16 packs hold none: the bf16
    backward reads the tensor-core forward's pack, transposed where it
    needs to."""
    params = params_to_torch(small, "cpu")
    bf = pack_params(params, "bfloat16")
    assert bf.mma_wt is None and bf.layout_mma is None and bf.weights_tc is not None
    pk = pack_params(params, "float32")
    segs = mma_segments(pk, SMALL)
    assert pk.layout_mma.size == 35 and (pk.layout_mma[SMALL.depth:16] == -1).all()
    assert pk.weights_tc is None and pk.layout_tc is None
    assert pk.mma_wt.dtype == torch.float32 and pk.mma_wt.shape[0] == 2
    flat = pk.mma_wt.sum(0).numpy()                 # hi + lo, exact in float32
    covered = np.zeros(flat.size, np.int64)
    for name, (slot, k, ld) in segs.items():
        want = pk.mat(name).numpy().T
        kp, n = -(-want.shape[0] // 16) * 16, want.shape[1]
        got, idx = untile_mma(flat, int(pk.layout_mma[slot]), kp, n)
        np.add.at(covered, idx.reshape(-1), 1)
        np.testing.assert_allclose(got[:want.shape[0]], want, rtol=2.0 ** -21, atol=0,
                                   err_msg=name)
        assert not got[want.shape[0]:].any(), name
    assert (covered == 1).all()


@pytest.mark.parametrize("arch", [SMALL, ArchConfig(), ArchConfig(width=100, v_width=36, depth=3,
                                                                    skip_at=5),
                                  ArchConfig(width=512, v_width=256, depth=32, skip_at=4)],
                         ids=["small", "lego", "unaligned_noskip", "wide_512x256x32"])
def test_mma_pack_split_round_trip(arch):
    """The f32 tensor-core pack splits each weight into tf32 hi and lo:
    both have their low 13 mantissa bits zero, hi + lo is within 2^-22 |w|
    of w, hi is w rounded to nearest tf32, and the padding of both is
    zero; the tiling inverts (test above)."""
    params = params_to_torch(np_params(arch, 9), "cpu")
    pk = pack_params(params, "float32")
    hi, lo = pk.mma_wt[0], pk.mma_wt[1]
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    for name, (slot, k, ld) in mma_segments(pk, arch).items():
        want = pk.mat(name).double().numpy().T
        kp, n = -(-want.shape[0] // 16) * 16, want.shape[1]
        off = int(pk.layout_mma[slot])
        got_hi, _ = untile_mma(hi.double().numpy(), off, kp, n)
        got_lo, _ = untile_mma(lo.double().numpy(), off, kp, n)
        r = want.shape[0]
        err = np.abs(got_hi[:r] + got_lo[:r] - want)
        assert (err <= 2.0 ** -22 * np.abs(want)).all(), (name, float(err.max()))
        # hi is the nearest tf32 (10 mantissa bits): within half its ulp.
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 10)
        assert (np.abs(got_hi[:r] - want) <= 0.5 * ulp).all(), name
        assert not got_hi[r:].any() and not got_lo[r:].any(), name


def tf32_rna(x):
    """float32 rounded to tf32 (10 mantissa bits), to nearest, ties away
    from zero, by bit operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class KernelF32Products(torch.overrides.TorchFunctionMode):
    """The backward reference's float32 matrix products as the f32 backward
    kernel computes them: dW = H^T dZ and W dz, the reference's products
    with a transposed operand, the heads' excepted, on the tensor cores as
    3xTF32 (each operand split into tf32 hi and lo, the three products
    lo.hi + hi.lo + hi.hi, each exact in float32, summed in float32); the
    two heads (width 1 and 3, on the CUDA cores) in plain float32. The
    recompute's layer products are not matrix products here: the test
    swaps the reference's ``_dense`` for ``split_f32_dense``, K1 f32's
    arithmetic, which the kernel's recompute runs (its float64 products
    pass through this mode). Other dtypes and functions pass through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
                and all(a.dtype == torch.float32 for a in args[:2])):
            a, b = args[:2]
            transposed = not (a.is_contiguous() and b.is_contiguous())
            head = min(a.shape[-1], b.shape[-1]) <= 3
            if transposed and not head:
                ah, bh = tf32_rna(a), tf32_rna(b)
                al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
                return (al @ bh + ah @ bl) + ah @ bh
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", ["small", "unaligned_noskip", "lego_fine"])
def test_3xtf32_backward_meets_the_f32_bar(small, arch, monkeypatch):
    """The numeric design of the f32 backward kernel as built, before the
    card sees it: the backward reference with the kernel's products
    (:class:`KernelF32Products`: dW and W dz in 3xTF32, the heads in plain
    f32; the recompute's layers in K1 f32's split-f32 arithmetic,
    ``split_f32_dense``), on a few hundred samples, holds every gradient
    (leaves, d(points), d(dirs)) within max(1e-4, 1.5 x the plain f32
    version's distance) of the float64 evaluation, chip_smoke.py's phase-8
    bar. The recompute is the forward's own arithmetic: on the card, a
    recompute in other arithmetic (3xTF32) flipped a ReLU mask at a
    pre-activation below f32's resolution in the unaligned network and
    moved every trunk gradient by 1-3% (PERF.md §6); here every layer
    output the emulated recompute makes equals the emulated forward's bit
    for bit."""
    from pathlib import Path

    from nerf_rs_tpu_torch.io.weights import load_nerf_params

    if arch == "small":
        params, scale = params_to_torch(small, "cpu"), 1.0
    elif arch == "unaligned_noskip":
        unaligned = ArchConfig(width=100, v_width=36, depth=3, skip_at=5)
        params, scale = params_to_torch(np_params(unaligned, 4), "cpu"), 1.0
    else:
        lego = Path(__file__).resolve().parents[1] / "assets" / "lego_rust" / "fine"
        params, scale = params_to_torch(load_nerf_params(lego), "cpu"), 0.4
    pts, dirs, g_rgb, g_sig = (torch.from_numpy(a) for a in np_rays(8, 40, 12))
    pts = pts * scale
    pk = pack_params(params, "float32")
    args = (pts, dirs, g_rgb, g_sig)
    plain = fused_nerf_mlp_backward_reference(pk, *args)
    exact = fused_nerf_mlp_backward_reference(pk, *(a.double() for a in args))
    layers = {"forward": [], "recompute": []}

    def recording(into):
        def dense(sources, b):
            out = split_f32_dense(sources, b)
            layers[into].append(out)
            return out
        return dense

    with KernelF32Products():
        monkeypatch.setattr(fm, "_dense", recording("forward"))
        fused_nerf_mlp_reference(pk, pts, dirs)
        monkeypatch.setattr(fm, "_dense", recording("recompute"))
        emulated = fused_nerf_mlp_backward_reference(pk, *args)
    monkeypatch.undo()

    def grads(out):
        tree = unpack_grads(pk, out[0], out[1])
        g = {f"{layer}/{part}": tree[layer][part].double() for layer in tree
             for part in ("kernel", "bias")}
        g["d(points)"], g["d(dirs)"] = out[2].double(), out[3].double()
        return g

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    ge, gp, g64 = grads(emulated), grads(plain), grads(exact)
    assert not torch.equal(emulated[0], plain[0])      # the emulation ran
    # The emulated recompute equals the emulated forward bit for bit:
    # every layer (trunk, bottleneck, view), in the same order.
    assert len(layers["recompute"]) == len(layers["forward"]) == pk.depth + 2
    assert all(torch.equal(a, b) for a, b in zip(layers["recompute"], layers["forward"]))
    for k in g64:
        assert rel(ge[k], g64[k]) <= max(1e-4, 1.5 * rel(gp[k], g64[k])), \
            (k, rel(ge[k], g64[k]), rel(gp[k], g64[k]))
