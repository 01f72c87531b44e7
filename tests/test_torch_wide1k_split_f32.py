"""PyTorch port, K1 f32 past width 512 on the tensor cores
(``csrc/fused_mlp_wide1k_f32tc.cu``), its arithmetic and its pack on the
CPU: the plain K1 with every layer product in the kernel's split-f32
arithmetic (``fused_mlp.split_f32_dense(group=WIDE1K_GROUP_STEPS,
pad=WIDE1K_PAD_K)``: six bf16 products a k-step, hi.hi summed a ring chunk
at a time into a running f32 sum, each source padded with zeros to whole
k-steps of the kernel's widths) at width 1024 and at 776/264/12, on a few
samples made from numpy, held

(a) to JAX's f32 forward (its fused kernel in interpret mode at 1024/512/8,
    its plain ``nerf_mlp`` at 776/264/12, which that kernel does not
    serve) within ``chip_smoke.TOLERANCES["float32"]``, the card's bars for
    the kernel against its plain version;
(b) to the float64 evaluation: no further from it than the plain f32
    version is;

and the split pack (``PackedMLP.weights_f32tc1k``, ``f32tc1k_tile``) read
as the kernel reads it: each CTA's columns of a k-step one contiguous run,
its three planes the split of those weights in core-matrix order; the
quarters' pieces (``Quarter`` and ``owner`` in the kernel)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.models.mlp import nerf_mlp as jax_nerf_mlp
from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu_torch.io.weights import params_to_torch
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    bf16_split3,
    f32tc1k_tile,
    f32tc_tile,
    fused_nerf_mlp_reference,
    pack_params,
    quarters,
    split_f32_dense,
)
from test_torch_wide1k import np_inputs, np_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [(1024, 512, 8, 4), (776, 264, 12, 4)]
IDS = ["1024x512x8", "776x264x12"]


def tolerances():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    return cs.TOLERANCES["float32"]


def kernel_dense(sources, b):
    return split_f32_dense(sources, b, group=fm.WIDE1K_GROUP_STEPS, pad=fm.WIDE1K_PAD_K)


def emulated(net, pts, dirs, sigma_only):
    """The plain K1 with every layer product in the kernel's arithmetic."""
    real = fm._dense
    fm._dense = kernel_dense
    try:
        return fused_nerf_mlp_reference(net, pts, dirs, sigma_only=sigma_only)
    finally:
        fm._dense = real


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def case(request):
    """(arch, numpy tree, NerfMLP, numpy inputs) with the sigma head's bias
    1, so that the ReLU does not cut sigma to 0."""
    arch = request.param
    params = np_params(arch, sum(arch))
    params["alpha"]["bias"][:] = 1.0
    return arch, params, NerfMLP(params), np_inputs(24, 5)


@pytest.mark.parametrize("sigma_only", [False, True])
def test_emulation_matches_jax_f32_forward(case, sigma_only):
    """(a) The kernel's arithmetic against JAX's f32 forward on the same
    network and inputs, within the card's f32 bars."""
    arch, params, net, (pts, dirs) = case
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    if arch[0] % 128 == 0:
        rgb_j, sig_j = jax_fused_nerf_mlp(tree, jnp.asarray(pts), jnp.asarray(dirs),
                                          sigma_only=sigma_only)
    else:
        rgb_j, sig_j = jax_nerf_mlp(tree, jnp.asarray(pts), jnp.asarray(dirs),
                                    sigma_only=sigma_only)
    rgb, sig = emulated(net, torch.from_numpy(pts), torch.from_numpy(dirs), sigma_only)
    tol = tolerances()
    assert float(sig.min()) > 0.0
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=tol["rgb_atol"], rtol=0)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=tol["sigma_atol"],
                               rtol=tol["sigma_rtol"])
    if sigma_only:
        assert not rgb.any()


def test_emulation_is_as_close_to_float64_as_plain(case):
    """(b) rgb and sigma each no further from the float64 evaluation than
    the plain f32 version is (the largest distance over 96 samples: both
    lie about two f32 units in the last place from it, and over 24 samples
    the largest of either is one sample's rounding), and the arithmetic is
    not plain's."""
    _, _, net, _ = case
    pts, dirs = (torch.from_numpy(a) for a in np_inputs(96, 6))
    plain = fused_nerf_mlp_reference(net, pts, dirs)
    exact = fused_nerf_mlp_reference(net, pts.double(), dirs.double())
    got = emulated(net, pts, dirs, False)
    assert not torch.equal(got[1], plain[1])
    for g, p, e in zip(got, plain, exact):
        dist = float((g.double() - e).abs().max())
        assert dist <= float((p.double() - e).abs().max()), dist


@pytest.mark.parametrize("k, group", [(200, 2), (200, 3), (776, 2), (64, 2), (256, 4),
                                      (208, 1)])
def test_padding_moves_the_groups_as_the_kernel_pads(k, group):
    """Padded to whole 64-row pieces, a source whose k-steps do not fill
    them gives later sources' groups the kernel's starts: with groups of
    more than one k-step the padded sums differ from the unpadded ones
    unless both step counts end on a group boundary; with the kernel's
    group of one, padding adds zeros only and changes no bit."""
    rng = np.random.default_rng(k + group)
    a1 = torch.from_numpy(rng.normal(size=(16, k)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(k, 64)).astype(np.float32))
    a2 = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    sources = [(a1, w1), (a2, w2)]
    padded = split_f32_dense(sources, b, group=group, pad=64)
    plain = split_f32_dense(sources, b, group=group)
    steps, padded_steps = -(-k // 16), -(-k // 64) * 4
    moved = group > 1 and not (steps % group == 0 and padded_steps % group == 0)
    assert torch.equal(padded, plain) != moved
    exact = (a1.double() @ w1.double() + a2.double() @ w2.double()) + b.double()
    assert float((padded.double() - exact).abs().max()) < 1e-4 * float(exact.abs().max())


@pytest.mark.parametrize("pieces", list(range(1, 17)))
def test_quarters_cover_each_piece_once(pieces):
    """The kernel's quarters of a layer's 64-column pieces: every piece
    once, in order, at most four a CTA (one pass), the first pieces % 4
    one more; ``owner`` (the CTA whose buffer holds a column of the layer
    input) is the inverse; each warpgroup of a CTA takes at most two
    (``wide::Share``)."""
    qs = quarters(pieces)
    assert len(qs) == fm.WIDE1K_QUARTERS
    covered = [p for p0, count in qs for p in range(p0, p0 + count)]
    assert covered == list(range(pieces))
    assert max(count for _, count in qs) <= 4
    assert [count for _, count in qs] == sorted((count for _, count in qs), reverse=True)
    base, rem = divmod(pieces, 4)
    for p in range(pieces):
        q = p // (base + 1) if p < rem * (base + 1) else rem + (p - rem * (base + 1)) // base
        p0, count = qs[q]
        assert p0 <= p < p0 + count
    for _, count in qs:
        assert max((count + 1) // 2, count // 2) <= 2


def planes_of_chunk(run: torch.Tensor, nq: int):
    """The three (16, nq) planes of a chunk as the kernel's wgmma
    descriptors read it: plane j at j * 16 nq elements; in it, element (k,
    c) at core matrix (k // 8) * nq / 8 + c // 8 (LBO nq * 16 bytes between
    the two k-groups, SBO 128 between column groups), row c % 8, column k %
    8."""
    out = []
    for j in range(3):
        plane = run[j * 16 * nq:(j + 1) * 16 * nq]
        k = torch.arange(16).view(16, 1)
        c = torch.arange(nq).view(1, nq)
        idx = ((k // 8) * (nq // 8) + c // 8) * 64 + (c % 8) * 8 + k % 8
        out.append(plane[idx])
    return out


@pytest.mark.parametrize("n", [1024, 832, 320, 128, 64])
def test_f32tc1k_tile_chunks_are_each_quarters_split_weights(n):
    """Each CTA's chunk of a k-step (3 x 16 x nq elements from ``(s * 48 n
    + 48 * 64 * p0)``, the kernel's chunk table) read through the kernel's
    descriptors is the split (hi, mid, lo) of the weights of that k-step and
    quarter, and is ``f32tc_tile``'s chunk of those columns."""
    k = 48
    rng = np.random.default_rng(n)
    m = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    flat = f32tc1k_tile(m, k, n)
    assert flat.numel() == 3 * k * n
    split = bf16_split3(m)
    for s in range(k // 16):
        for p0, count in quarters(n // 64):
            if not count:
                continue
            nq = 64 * count
            off = s * 48 * n + 48 * 64 * p0
            run = flat[off:off + 48 * nq]
            block = m[16 * s:16 * s + 16, 64 * p0:64 * p0 + nq]
            assert torch.equal(run, f32tc_tile(block, 16, nq))
            for got, want in zip(planes_of_chunk(run, nq), split):
                assert torch.equal(got, want[16 * s:16 * s + 16, 64 * p0:64 * p0 + nq])


def test_pack_at_1024_holds_the_split_pack():
    """A 1000/1020/5 network (skip at layer 3): the f32 pack holds
    ``weights_f32tc1k`` (bf16, each layer segment ``f32tc1k_tile`` of its
    matrix at K and widths padded to 64, in ``layout``'s order, heads -1,
    biases ``layout``'s) beside K2's transposed pack, and not the narrow
    split pack; the bf16 pack and a pack within 512 hold none."""
    params = np_params((1000, 1020, 5, 2), 3)
    tree = params_to_torch(params, "cpu")
    pk = pack_params(tree, "float32")
    assert pk.wide1k and pk.weights_f32tc1k.dtype == torch.bfloat16
    assert pk.weights_f32tc is None and pk.mma_wt is not None
    t = pk.layout_f32tc1k
    assert t.size == pk.layout.size == 3 * fm.MAX_DEPTH + 9
    d = fm.MAX_DEPTH
    assert t[2 * d] == -1 and t[2 * d + 4] == -1                    # the heads: from weights
    assert (t[3 * d + 5:] == pk.layout[3 * d + 5:]).all()           # the biases
    assert (t[5:d] == -1).all() and t[d + 3] >= 0 and (t[d:d + 3] == -1).all()
    nw, nv = 1024, 1024
    shapes = {"dense0": (64, nw), "dense3_enc": (64, nw), "bottleneck": (nw, nw),
              "viewdirs": (nw, nv), "viewdirs_dir": (32, nv)}
    order = [("dense0", 0), ("dense1", 1), ("dense2", 2), ("dense3_enc", d + 3), ("dense3", 3),
             ("dense4", 4), ("bottleneck", 2 * d + 1), ("viewdirs", 2 * d + 2),
             ("viewdirs_dir", 2 * d + 3)]
    end = 0
    for name, slot in order:
        kk, nn = shapes.get(name, (nw, nw))
        off = int(t[slot])
        assert off == end, name
        seg = pk.weights_f32tc1k[off:off + 3 * kk * nn].float()
        assert torch.equal(seg, f32tc1k_tile(pk.mat(name), kk, nn)), name
        end = off + 3 * kk * nn
    assert pk.weights_f32tc1k.numel() == end
    assert pack_params(tree, "bfloat16").weights_f32tc1k is None
    narrow = pack_params(params_to_torch(np_params((512, 256, 8, 4), 3), "cpu"), "float32")
    assert narrow.weights_f32tc1k is None and narrow.layout_f32tc1k is None
