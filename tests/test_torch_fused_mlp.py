"""PyTorch port, MLP: the fused kernel's plain version against the JAX
Pallas kernel (interpret mode on the CPU, as tests/test_fused_mlp.py runs
it), the port's oracle against the JAX oracle and the TF goldens, and the
kernel's weight packing.

These run on the CPU, where the wrapper takes the plain version; the CUDA
kernel itself is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.models.mlp import nerf_mlp as jax_nerf_mlp
from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io.golden import golden_examples, load_golden
from nerf_rs_tpu_torch.io.weights import load_nerf_params, params_to_torch
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes, count_params, nerf_mlp
import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    bf16_sigma_agrees,
    fused_nerf_mlp,
    fused_nerf_mlp_reference,
    pack_params,
    split_f32_dense,
)

torch.set_num_threads(1)

SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)
LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"


def np_params(arch, seed):
    """Glorot-uniform kernels and small random biases, from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return out


def np_inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def to_jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def small():
    return np_params(SMALL, 0)


@pytest.fixture(scope="module")
def lego():
    return {net: load_nerf_params(LEGO / net) for net in ("coarse", "fine")}


@pytest.mark.parametrize("n", [128, 200])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_reference_matches_jax_fused_f32(small, sigma_only, n):
    """f32, tolerances of tests/test_fused_mlp.py; n=200 is ragged."""
    pts, dirs = np_inputs(n, 1)
    rgb_j, sig_j = jax_fused_nerf_mlp(to_jax(small), jnp.asarray(pts), jnp.asarray(dirs),
                                      sigma_only=sigma_only)
    rgb, sig = fused_nerf_mlp_reference(params_to_torch(small, "cpu"), torch.from_numpy(pts),
                                        torch.from_numpy(dirs), sigma_only=sigma_only)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)
    if sigma_only:
        assert not rgb.any()


def test_reference_bf16_close_to_jax_fused(small):
    """bf16: the two kernels round at the same places but sum (and, in
    JAX, take sin) differently; the bars of tests/test_fused_mlp.py for
    two bf16 orderings."""
    pts, dirs = np_inputs(256, 2)
    rgb_j, sig_j = jax_fused_nerf_mlp(to_jax(small), jnp.asarray(pts), jnp.asarray(dirs),
                                      dtype="bfloat16")
    rgb, sig = fused_nerf_mlp_reference(params_to_torch(small, "cpu"), torch.from_numpy(pts),
                                        torch.from_numpy(dirs), dtype="bfloat16")
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=2e-2)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=2e-2, rtol=2e-2)


def test_reference_per_ray_dirs_and_batch_shape(small):
    """(B, S, 3) points with one (B, 1, 3) dir per ray, as the render
    calls it, equal the per-sample broadcast."""
    pts, dirs = np_inputs(60, 3)
    p = torch.from_numpy(pts).reshape(5, 12, 3)
    d = torch.from_numpy(dirs).reshape(5, 12, 3)[:, :1]
    module = NerfMLP(small)
    rgb, sig = fused_nerf_mlp(module, p, d)
    assert rgb.shape == (5, 12, 3) and sig.shape == (5, 12)
    rgb_b, sig_b = fused_nerf_mlp(module, p, d.expand(5, 12, 3))
    assert torch.equal(rgb, rgb_b) and torch.equal(sig, sig_b)


@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_nerf_mlp_matches_jax_oracle_lego(lego, net):
    pts, dirs = np_inputs(64, 4)
    rgb_j, sig_j = jax_nerf_mlp(to_jax(lego[net]), jnp.asarray(pts), jnp.asarray(dirs))
    rgb, sig = nerf_mlp(params_to_torch(lego[net], "cpu"), torch.from_numpy(pts),
                        torch.from_numpy(dirs))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("impl", ["oracle", "fused"])
def test_lego_meets_tf_goldens(lego, impl):
    """Both MLPs meet the reference's 1e-2 tolerance against the TF goldens."""
    module = {net: NerfMLP(lego[net]) for net in lego}
    for ex in golden_examples(load_golden(LEGO / "tf_reference_samples.json")):
        pts = torch.from_numpy(ex["ray_o"][None] + ex["ray_d"][None] * ex["z_vals"][:, None])
        dirs = torch.from_numpy(np.broadcast_to(ex["viewdir_unit"], pts.shape).copy())
        for net in ("coarse", "fine"):
            fn = nerf_mlp if impl == "oracle" else fused_nerf_mlp
            rgb, sig = fn(module[net], pts, dirs)
            np.testing.assert_allclose(sig.detach().numpy(), ex[f"{net}_sigma"], atol=1e-2)
            np.testing.assert_allclose(rgb.detach().numpy(), ex[f"{net}_rgb"], atol=1e-2)


@pytest.mark.parametrize("arch", [SMALL, ArchConfig(), ArchConfig(width=100, v_width=36, depth=3,
                                                                    skip_at=5)])
def test_pack_params_padding_zero_and_round_trip(arch):
    """Every segment holds its layer's weights transposed to K-major
    (in, out) and zeros everywhere else; unpacking gives the tree back."""
    params = params_to_torch(np_params(arch, 5), "cpu")
    pk = pack_params(params, "float32")
    assert pk.weights.dtype == torch.float32 and pk.biases.dtype == torch.float32
    covered = torch.zeros(pk.weights.numel(), dtype=torch.bool)
    w = arch.width

    def region(name, k_rows, n_cols):
        off, rows, ld = pk.segments[name]
        m = pk.mat(name)
        assert not m[k_rows:].any() and not m[:, n_cols:].any(), name
        covered[off:off + rows * ld] = True
        return m[:k_rows, :n_cols]

    unpacked = {"dense0": region("dense0", 63, w)}
    for i in range(1, arch.depth):
        trunk = region(f"dense{i}", w, w)
        if f"dense{i}_enc" in pk.segments:
            trunk = torch.cat([region(f"dense{i}_enc", 63, w), trunk])
        unpacked[f"dense{i}"] = trunk
    unpacked["alpha"] = region("alpha", w, 1)
    unpacked["bottleneck"] = region("bottleneck", w, w)
    unpacked["viewdirs"] = torch.cat([region("viewdirs", w, arch.v_width),
                                      region("viewdirs_dir", 27, arch.v_width)])
    unpacked["rgb"] = region("rgb", arch.v_width, 3)
    assert not pk.weights[~covered].any()           # alignment gaps are zero
    for layer, p in params.items():
        assert torch.equal(unpacked[layer], p["kernel"]), layer
        off, n = pk.bias_slots[layer]
        assert torch.equal(pk.biases[off:off + n][:p["bias"].numel()], p["bias"]), layer
    assert (pk.layout[:16] >= 0).sum() == arch.depth
    bf = pack_params(params, "bfloat16")
    assert bf.weights.dtype == torch.bfloat16
    assert torch.equal(bf.weights, pk.weights.to(torch.bfloat16))
    assert count_params(params) == sum(int(np.prod(s)) + s[1] for s in arch_shapes(arch).values())


def untile(flat, off, k, n):
    """The (k, n) matrix at ``off`` of the tensor-core pack, read element
    by element from the core-matrix order csrc/fused_mlp_tc.cu copies."""
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    idx = off + (kk // 8) * (n * 8) + (nn // 8) * 64 + (nn % 8) * 8 + kk % 8
    return flat[idx], idx


@pytest.mark.parametrize("arch", [SMALL, ArchConfig(), ArchConfig(width=100, v_width=36, depth=3,
                                                                    skip_at=5)],
                         ids=["small", "lego", "unaligned_noskip"])
def test_tc_pack_round_trip_and_padding(arch):
    """The bf16 pack's tensor-core copy: each layer segment read back
    through the plain inverse of its tiling is the layer's bf16 weights,
    zero-padded to K and N multiples of 64 (the encodes keep K = 64 and
    32, multiples of 16); the two heads are ``weights``' head segments; the
    segments cover the copy exactly once; its table has the order and the
    bias offsets of ``layout``. Its ``weights`` are the f32 pack's in bf16;
    it holds no transposed backward pack (the bf16 backward reads this copy
    transposed), the f32 pack holds no tensor-core copy."""
    params = params_to_torch(np_params(arch, 8), "cpu")
    bf, f32 = pack_params(params, "bfloat16"), pack_params(params, "float32")
    assert f32.weights_tc is None and f32.layout_tc is None
    assert torch.equal(bf.weights, f32.weights.to(torch.bfloat16))
    assert bf.mma_wt is None and bf.layout_mma is None and f32.layout_mma.size == 35
    assert bf.weights_tc.dtype == torch.bfloat16
    flat = bf.weights_tc.float().numpy()
    nw, nv = -(-arch.width // 64) * 64, -(-arch.v_width // 64) * 64
    enc_x, enc_d = 63, 27

    def kern(layer, rows=slice(None)):
        return params[layer]["kernel"][rows].to(torch.bfloat16).float().numpy()

    segs = {"dense0": (bf.layout_tc[0], 64, nw, kern("dense0"))}
    for i in range(1, arch.depth):
        k = kern(f"dense{i}")
        if bf.layout_tc[16 + i] >= 0:
            segs[f"dense{i}_enc"] = (bf.layout_tc[16 + i], 64, nw, k[:enc_x])
            k = k[enc_x:]
        segs[f"dense{i}"] = (bf.layout_tc[i], nw, nw, k)
    assert (bf.layout_tc[:16] >= 0).sum() == arch.depth
    segs["bottleneck"] = (bf.layout_tc[33], nw, nw, kern("bottleneck"))
    segs["viewdirs"] = (bf.layout_tc[34], nw, nv, kern("viewdirs", slice(0, arch.width)))
    segs["viewdirs_dir"] = (bf.layout_tc[35], 32, nv, kern("viewdirs", slice(arch.width, None)))
    assert bf.layout_tc.shape == bf.layout.shape
    np.testing.assert_array_equal(bf.layout_tc[37:], bf.layout[37:])
    covered = np.zeros(flat.size, np.int64)
    for slot, name in ((32, "alpha"), (36, "rgb")):
        off, k, ld = bf.segments[name]
        assert bf.layout_tc[slot] % 8 == 0 and bf.layout[slot] == off, name
        np.testing.assert_array_equal(flat[bf.layout_tc[slot]:bf.layout_tc[slot] + k * ld],
                                      bf.weights[off:off + k * ld].float().numpy(), err_msg=name)
        covered[bf.layout_tc[slot]:bf.layout_tc[slot] + k * ld] += 1
    for name, (off, k, n, want) in segs.items():
        assert k % 16 == 0 and n % 64 == 0 and off % 8 == 0, name
        got, idx = untile(flat, int(off), k, n)
        np.add.at(covered, idx.reshape(-1), 1)
        rows, cols = want.shape
        np.testing.assert_array_equal(got[:rows, :cols], want, err_msg=name)
        assert not got[rows:].any() and not got[:, cols:].any(), name
    assert (covered == 1).all()


def untile_f32tc(flat, off, k, n):
    """The (3, k, n) hi, mid and lo planes at ``off`` of the split pack,
    read element by element from the order csrc/fused_mlp_f32tc.cuh copies:
    per chunk of 16 k rows its three planes, each in core-matrix order."""
    q, kk, nn = np.meshgrid(np.arange(3), np.arange(k), np.arange(n), indexing="ij")
    idx = (off + ((kk // 16) * 3 + q) * (16 * n) + (kk % 16 // 8) * (n * 8) + (nn // 8) * 64
           + (nn % 8) * 8 + kk % 8)
    return flat[idx], idx


@pytest.mark.parametrize("arch", [SMALL, ArchConfig(), ArchConfig(width=100, v_width=36, depth=3,
                                                                    skip_at=5)],
                         ids=["small", "lego", "unaligned_noskip"])
def test_f32tc_pack_round_trip_and_padding(arch):
    """The f32 pack's split copy (the f32 tensor-core kernels' B operand):
    each layer segment read back through the plain inverse of its tiling
    gives three bf16 planes whose sum is the layer's weights within 2^-24
    relative (hi the nearest bf16, mid and lo the rest), zero-padded to K
    and N multiples of 64 (the encodes keep K = 64 and 32); the segments
    cover the copy exactly once; its table has ``layout``'s order and bias
    offsets, and no heads (the kernels read them from ``weights``)."""
    params = params_to_torch(np_params(arch, 8), "cpu")
    pk = pack_params(params, "float32")
    assert pk.weights_f32tc.dtype == torch.bfloat16
    assert pack_params(params, "bfloat16").weights_f32tc is None
    flat = pk.weights_f32tc.double().numpy()
    nw, nv = -(-arch.width // 64) * 64, -(-arch.v_width // 64) * 64
    tab = pk.layout_f32tc
    assert tab.shape == pk.layout.shape and (tab[[32, 36]] == -1).all()
    np.testing.assert_array_equal(tab[37:], pk.layout[37:])
    assert (tab[:16] >= 0).sum() == arch.depth

    def kern(layer, rows=slice(None)):
        return params[layer]["kernel"][rows].double().numpy()

    segs = {"dense0": (tab[0], 64, nw, kern("dense0"))}
    for i in range(1, arch.depth):
        k = kern(f"dense{i}")
        if tab[16 + i] >= 0:
            segs[f"dense{i}_enc"] = (tab[16 + i], 64, nw, k[:63])
            k = k[63:]
        segs[f"dense{i}"] = (tab[i], nw, nw, k)
    segs["bottleneck"] = (tab[33], nw, nw, kern("bottleneck"))
    segs["viewdirs"] = (tab[34], nw, nv, kern("viewdirs", slice(0, arch.width)))
    segs["viewdirs_dir"] = (tab[35], 32, nv, kern("viewdirs", slice(arch.width, None)))
    covered = np.zeros(flat.size, np.int64)
    for name, (off, k, n, want) in segs.items():
        assert k % 16 == 0 and n % 64 == 0 and off % 8 == 0, name
        planes, idx = untile_f32tc(flat, int(off), k, n)
        np.add.at(covered, idx.reshape(-1), 1)
        rows, cols = want.shape
        got = planes.sum(0)
        assert (np.abs(got[:rows, :cols] - want) <= 2.0 ** -24 * np.abs(want)).all(), name
        hi = torch.from_numpy(want).float().to(torch.bfloat16).double().numpy()
        np.testing.assert_array_equal(planes[0, :rows, :cols], hi, err_msg=name)
        assert not got[rows:].any() and not got[:, cols:].any(), name
        assert not planes[:, rows:].any() and not planes[:, :, cols:].any(), name
    assert (covered == 1).all()


@pytest.mark.parametrize("arch", ["small", "unaligned_noskip", "lego_fine"])
def test_split_f32_forward_meets_the_f32_bars(small, lego, arch, monkeypatch):
    """The f32 forward kernel's arithmetic as built, before the card sees
    it: the plain version with every layer product in the kernel's split
    (``split_f32_dense``: bf16x6, its k-step order, hi.hi in its own
    accumulator), held to the JAX fused kernel (interpret mode) at
    test_reference_matches_jax_fused_f32's bars (width 100 is not one the
    JAX kernel takes: there the JAX package's plain MLP, which its CLI falls
    back to), and to the float64 evaluation: no further from it than twice
    the plain f32 version, rgb and sigma each."""
    pts, dirs = np_inputs(320, 11)
    if arch == "small":
        params = small
    elif arch == "unaligned_noskip":
        params = np_params(ArchConfig(width=100, v_width=36, depth=3, skip_at=5), 4)
    else:
        params, pts = lego["fine"], pts * np.float32(0.4)
    tree = params_to_torch(params, "cpu")
    pk = pack_params(tree, "float32")
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    plain = fused_nerf_mlp_reference(pk, x, d)
    exact = fused_nerf_mlp_reference(pk, x.double(), d.double())
    monkeypatch.setattr(fm, "_dense", split_f32_dense)
    emulated = fused_nerf_mlp_reference(pk, x, d)
    monkeypatch.undo()
    jax_fn = jax_nerf_mlp if arch == "unaligned_noskip" else jax_fused_nerf_mlp
    rgb_j, sig_j = jax_fn(to_jax(params), jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(emulated[0].numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(emulated[1].numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)
    assert not torch.equal(emulated[1], plain[1])      # the emulation ran
    for got, want, ref in zip(emulated, plain, exact):
        dist = float((got.double() - ref).abs().max())
        assert dist <= 2 * float((want.double() - ref).abs().max()), dist


@pytest.mark.parametrize("moved, ok", [(0, True), (2, True), (128, False)],
                         ids=["same", "two_cascades", "one_tile"])
def test_bf16_sigma_agrees_catches_a_wrong_tile(moved, ok):
    """The card's bar for the bf16 kernel's sigma at the coarse render
    shape (8192 x 64): a plain version with 5 samples off the float64
    evaluation, a kernel equal to it but for ``moved`` samples moved 5%
    off. Two such samples (a flipped rounding's cascade) pass; one
    128-sample tile fails."""
    rng = np.random.default_rng(0)
    exact = torch.from_numpy(rng.uniform(1.0, 50.0, 8192 * 64))
    plain = exact.float()
    plain[:5] *= 1.05
    kernel = plain.clone()
    kernel[4096:4096 + moved] *= 1.05
    got, counts = bf16_sigma_agrees(kernel, plain, exact)
    assert counts == {"kernel_vs_plain": moved, "kernel_vs_exact": 5 + moved,
                      "plain_vs_exact": 5}
    assert got == ok


def test_pack_params_rejects_unserved_arch():
    with pytest.raises(ValueError, match="width"):
        pack_params(params_to_torch(np_params(ArchConfig(width=320), 6), "cpu"), "float32")


def test_wrapper_on_cpu_is_the_reference_and_counts_no_launch(small):
    pts, dirs = np_inputs(32, 7)
    before = fused_nerf_mlp.launches
    a = fused_nerf_mlp(params_to_torch(small, "cpu"), torch.from_numpy(pts), torch.from_numpy(dirs))
    b = fused_nerf_mlp_reference(params_to_torch(small, "cpu"), torch.from_numpy(pts),
                                 torch.from_numpy(dirs))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fused_nerf_mlp.launches == before
    with pytest.raises(NotImplementedError, match="L=\\(10,4\\)"):
        fused_nerf_mlp(params_to_torch(small, "cpu"), torch.from_numpy(pts),
                       torch.from_numpy(dirs), x_freqs=8)


def test_module_pack_is_kept_until_weights_change(small):
    module = NerfMLP(small)
    pk = module.packed("float32")
    assert module.packed("float32") is pk
    assert module.packed("bfloat16") is not pk
    with torch.no_grad():
        module.weights["dense1_kernel"][0, 0] += 1.0
    pk2 = module.packed("float32")
    assert pk2 is not pk
    assert torch.equal(pk2.mat("dense1")[0, 0], pk.mat("dense1")[0, 0] + 1.0)
