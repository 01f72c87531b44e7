"""PyTorch port, the wide K2's host side (``ops/kernels/fused_mlp.py``): how
a call past width 256 or depth 16 is cut into rounds, the round's
workspace and scratch, the dW kernel's jobs (``wide_dw_jobs``, the table
``csrc/fused_mlp_wide_dw.cu`` reads) and the launches a call makes.

The kernels run only on the card (tests/test_torch_cuda.py). Here the job
table is held to its contract by emulating, in numpy, what the dW kernel
does with it: copy each job's bytes of H and dZ images, multiply the
pieces in fused_mlp.SPLIT_F32_ORDER, sum over the round's tiles and add
the rows and columns the job owns into dweights. Fed a workspace written in the
layout of ``csrc/fused_mlp_wide_dw.cuh``, it must give every segment's
H^T dZ. ``_backward_wide`` runs against a stand-in library that records
its calls. No JAX: the gradients themselves are held to JAX's kernel in
tests/test_torch_wide_bwd.py."""

import numpy as np
import pytest
import torch

from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

torch.set_num_threads(1)

ARCHS = {"264x136x3": ArchConfig(264, 136, 3, 1), "512x256x8": ArchConfig(512, 256, 8, 4),
         "200x264x20": ArchConfig(200, 264, 20, 1), "1024x512x8": ArchConfig(1024, 512, 8, 4),
         "1024x1024x32": ArchConfig(1024, 1024, 32, 10)}
FINE = 4096 * 192           # the training path's fine call
H100_SMS = 132


def packed(arch, dtype):
    net = NerfMLP(init_nerf_params(torch.Generator().manual_seed(0), arch))
    return net.packed(dtype)


def image_offsets(cols):
    """Byte offset of (row, col) in a 64-row image (f32tc::p_off)."""
    r, c = np.arange(64)[:, None], np.arange(cols)[None, :]
    return (c >> 3) * 1024 + (r >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2


def bf16_bits(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def from_bits(b):
    return torch.from_numpy(np.ascontiguousarray(b).view(np.int16)).view(torch.bfloat16).to(
        torch.float32).numpy()


def planes_of(x, n):
    """The n planes the workspace holds of f32 x: bf16 x, or its split."""
    if n == 1:
        return [x]
    return [p.numpy() for p in fm.bf16_split3(torch.from_numpy(np.asarray(x, np.float32)))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_wide_plan_rounds_and_scratch_follow_the_budget(arch, dtype, monkeypatch):
    """At the training path's fine call: a round is grid x the tiles a CTA
    that WIDE_ROUND_BYTES of workspace (and f32 record, or past width 512
    the bf16 view images) hold, at least one; the workspace is 128 x
    planes x the slots' columns a tile; the scratch is the sum of its
    buffers and stays below what the design with per-CTA partials took
    (1.218 GiB bf16, 2.392 GiB f32 at 512/256/8); a budget of one byte
    gives one tile a CTA."""
    pk = packed(ARCHS[arch], dtype)
    assert pk.wide
    plan = fm.wide_plan(pk, FINE, H100_SMS, sigma_only=False)
    planes = 1 if dtype == "bfloat16" else 3
    tile_ws = 128 * planes * sum(fm.wide_slot_cols(pk))
    nv = -(-pk.ldv // 64) * 64
    if dtype == "float32":
        tile_rec = 4 * 64 * (96 + (pk.depth + 1) * pk.ldw + pk.ldv)
    else:
        tile_rec = 128 * nv if pk.wide1k else 0
    per_cta = max(1, fm.WIDE_ROUND_BYTES[dtype] // (H100_SMS * (tile_ws + tile_rec)))
    assert (plan.tiles, plan.grid, plan.planes) == (FINE // 64, H100_SMS, planes)
    assert plan.round_tiles == H100_SMS * per_cta
    assert plan.rounds == -(-plan.tiles // plan.round_tiles)
    assert plan.ws_bytes == tile_ws * plan.round_tiles
    assert plan.record_bytes == tile_rec * plan.round_tiles
    assert plan.part_bytes == 4 * plan.splits * len(plan.jobs) * 128 * 128
    assert plan.small_stride == pk.biases.numel() + pk.ldw + 3 * pk.ldv
    assert plan.scratch_bytes == (plan.ws_bytes + plan.record_bytes + plan.part_bytes
                                  + 4 * H100_SMS * plan.small_stride + plan.de_bytes)
    if arch == "512x256x8":
        assert plan.scratch_bytes < {"bfloat16": 1.218, "float32": 2.392}[dtype] * 2 ** 30
    if pk.wide1k:
        assert plan.de_bytes == 0
    small = fm.wide_plan(pk, 1000, H100_SMS, sigma_only=False)
    assert (small.tiles, small.grid, small.round_tiles, small.rounds) == (16, 16, 16, 1)
    monkeypatch.setitem(fm.WIDE_ROUND_BYTES, dtype, 1)
    one = fm.wide_plan(pk, FINE, H100_SMS, sigma_only=False)
    assert one.round_tiles == H100_SMS and one.rounds == -(-one.tiles // H100_SMS)


@pytest.mark.parametrize("n_jobs, sms, round_tiles", [
    (146, 132, 396), (73, 132, 528), (540, 132, 132), (128, 132, 264), (41, 4, 3), (5, 132, 2)])
def test_wide_dw_splits_fill_the_waves(n_jobs, sms, round_tiles):
    """The fewest slices that fill 85% of whole waves of the SMs with the
    items, or the best share found; never more than the round's tiles."""
    splits = fm.wide_dw_splits(n_jobs, sms, round_tiles)

    def share(s):
        return n_jobs * s / (-(-n_jobs * s // sms) * sms)

    assert 1 <= splits <= min(16, round_tiles)
    fewer = range(1, splits)
    if share(splits) >= 0.85:
        assert all(share(s) < 0.85 for s in fewer)
    else:
        assert all(share(s) <= share(splits) for s in range(1, min(16, round_tiles) + 1))


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_wide_dw_jobs_own_every_weight_once(arch, dtype, sigma_only):
    """The jobs' stored rows and columns cover every entry of every layer
    segment (the color branch's only in full calls) exactly once, and no
    entry of the heads; at most 128 x 128, each starting at a multiple of
    128 of a slot's columns."""
    pk = packed(ARCHS[arch], dtype)
    jobs = fm.wide_dw_jobs(pk, sigma_only)
    assert jobs.shape[1] == fm._DW_JOB_FIELDS
    cols = fm.wide_slot_cols(pk)
    hits = np.zeros(pk.weights.numel(), np.int64)
    for job in jobs:
        a, m0, b, n0, out, ld, m_valid, n_valid = job
        assert 0 < m_valid <= 128 and 0 < n_valid <= 128
        assert m0 % 128 == 0 and n0 % 128 == 0 and m0 < cols[a] and n0 < cols[b]
        rows = out + ld * np.arange(m_valid)[:, None] + np.arange(n_valid)[None, :]
        np.add.at(hits, rows.reshape(-1), 1)
    want = np.zeros_like(hits)
    for name, (off, k, ld) in pk.segments.items():
        if name in ("alpha", "rgb"):
            continue
        if sigma_only and name in ("bottleneck", "viewdirs", "viewdirs_dir"):
            continue
        want[off:off + k * ld] = 1
    assert np.array_equal(hits, want)


def image_start(pk, tiles, s, t, q):
    """Byte offset of plane q of tile t's image of slot s in a workspace of
    `tiles` tiles (csrc/fused_mlp_wide_dw.cuh's DwWs::at): the slots one
    after another, each holding its tiles' images of `planes` planes."""
    planes = fm.wide_planes(pk.dtype)
    cols = fm.wide_slot_cols(pk)
    return 128 * (sum(cols[:s]) * tiles * planes + (t * planes + q) * cols[s])


def write_round(pk, tiles, rng):
    """A workspace of `tiles` tiles in the layout of
    csrc/fused_mlp_wide_dw.cuh, filled with random values, and those values
    by slot: -> (ws bytes, {slot: (64 tiles, padded cols)})."""
    planes = fm.wide_planes(pk.dtype)
    cols = fm.wide_slot_cols(pk)
    ws = np.zeros(128 * planes * tiles * sum(cols), np.uint8)
    values = {}
    for s, width in enumerate(cols):
        x = rng.normal(size=(tiles * 64, width)).astype(np.float32)
        if pk.dtype == "bfloat16":
            x = from_bits(bf16_bits(x))
        values[s] = x
        for t in range(tiles):
            for q, plane in enumerate(planes_of(x[64 * t:64 * t + 64], planes)):
                start = image_start(pk, tiles, s, t, q)
                ws.view(np.uint16)[(start + image_offsets(width)) // 2] = bf16_bits(plane)
    return ws, values


def emulate_dw(pk, jobs, ws, tiles):
    """The dW kernel and its sum as the table drives them, in float64: a
    job's operand is up to 128 columns of its slot from its first column,
    128 bytes a column of an image."""
    planes = fm.wide_planes(pk.dtype)
    pairs = fm.SPLIT_F32_ORDER if planes == 3 else ((0, 0),)
    cols = fm.wide_slot_cols(pk)
    dweights = np.zeros(pk.weights.numel())

    def image(s, c0, t, q):
        n_cols = min(128, cols[s] - c0)
        offs = image_start(pk, tiles, s, t, q) + 128 * c0 + image_offsets(n_cols)
        return from_bits(ws.view(np.uint16)[offs // 2]).astype(np.float64)

    for job in jobs:
        a_slot, m0, b_slot, n0, out, ld, m_valid, n_valid = job
        acc = 0.0
        for t in range(tiles):
            a = [image(a_slot, m0, t, q) for q in range(planes)]
            b = [image(b_slot, n0, t, q) for q in range(planes)]
            for i, j in pairs:
                acc += a[i].T @ b[j]
        rows = out + ld * np.arange(m_valid)[:, None] + np.arange(n_valid)[None, :]
        dweights[rows] += acc[:m_valid, :n_valid]
    return dweights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ARCHS["264x136x3"], ARCHS["200x264x20"],
                                  ArchConfig(1024, 512, 3, 1)],
                         ids=["264x136x3", "200x264x20", "1024x512x3"])
def test_wide_dw_jobs_emulated_give_every_segments_h_transpose_dz(arch, dtype):
    """Every segment's weight gradient from the emulated dW kernel is H^T dZ
    over the round's samples, H and dZ the slots the segment reads (dense0
    and each skip part: the point encode; dense i: trunk output i - 1; the
    bottleneck: the last trunk output; the view layer: the bottleneck's
    output and the dir encode; each with its layer's output gradient): to
    float64's rounding in bf16, within 1e-5 of it in f32 (three split
    pieces, the three smallest products dropped)."""
    pk = packed(arch, dtype)
    tiles = 3
    ws, values = write_round(pk, tiles, np.random.default_rng(1))
    jobs = fm.wide_dw_jobs(pk, sigma_only=False)
    got = emulate_dw(pk, jobs, ws, tiles)
    d = pk.depth
    sources = {"dense0": (0, 3 + d), "bottleneck": (2 + d - 1, 3 + 2 * d),
               "viewdirs": (2 + d, 4 + 2 * d), "viewdirs_dir": (1, 4 + 2 * d)}
    for i in range(1, d):
        sources[f"dense{i}"] = (2 + i - 1, 3 + d + i)
        sources[f"dense{i}_enc"] = (0, 3 + d + i)
    for name, (off, k, ld) in pk.segments.items():
        if name in ("alpha", "rgb"):
            continue
        a, b = sources[name]
        want = values[a][:, :k].astype(np.float64).T @ values[b][:, :ld].astype(np.float64)
        seg = got[off:off + k * ld].reshape(k, ld)
        tol = 1e-12 if dtype == "bfloat16" else 1e-5
        assert np.abs(seg - want).max() <= tol * np.abs(want).max(), name


class Recorder:
    """A stand-in for the kernels' library: each entry point records its
    name and arguments and returns 0 (launched)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_backward_launches_round_by_round(dtype, sigma_only, monkeypatch):
    """``_backward_wide`` launches, per round in order, the f32 record pass
    (f32 only), the per-tile kernel and the dW kernel (over min(splits,
    the round's tiles) slices, counted in
    fused_nerf_mlp_backward.dw_launches), then the small sums once; every
    round's tiles follow the last's and a ragged last round is short."""
    monkeypatch.setitem(fm.WIDE_ROUND_BYTES, dtype, 1)
    pk = packed(ARCHS["264x136x3"], dtype)
    n, sms = 64 * 9 + 5, 4                          # 10 tiles: rounds of 4, 4, 2
    lib = Recorder()
    before = fm.fused_nerf_mlp_backward.dw_launches
    ptrs = (1, 2, n, 1, 3, 4)
    outs = (5, 6, None, None, 0, 0)
    assert fm._backward_wide(lib, pk, ptrs, n, sigma_only, outs, torch.device("cpu"), sms) == 0
    plan = fm.wide_plan(pk, n, sms, sigma_only)
    assert (plan.round_tiles, plan.rounds) == (4, 3)
    per_round = (["nerf_fused_mlp_wide_f32_record", "nerf_wide_bwd_f32_tiles"]
                 if dtype == "float32" else ["nerf_wide_bwd_bf16_tiles"]) + ["nerf_wide_dw"]
    assert [c[0] for c in lib.calls] == per_round * 3 + ["nerf_wide_small_sum"]
    assert fm.fused_nerf_mlp_backward.dw_launches == before + 3
    tile_calls = [args for name, args in lib.calls if name.endswith("_tiles")]
    dw_calls = [args for name, args in lib.calls if name == "nerf_wide_dw"]
    at = (-11, -10, -9) if dtype == "float32" else (-12, -11, -10)   # ws_tiles, tile0, tiles
    assert [tuple(a[i] for i in at) for a in tile_calls] == [(4, 0, 4), (4, 4, 4), (4, 8, 2)]
    # nerf_wide_dw(ws, ws_tiles, jobs, n_jobs, splits, tiles, planes, ldw, ldv, depth, part,
    #              dweights, grid, ...)
    for args, tiles in zip(dw_calls, (4, 4, 2)):
        assert args[1] == plan.round_tiles
        assert args[3] == len(plan.jobs) and args[4] == min(plan.splits, tiles)
        assert args[5] == tiles and args[6] == fm.wide_planes(dtype)
        assert args[7:10] == (pk.ldw, pk.ldv, pk.depth)
        assert args[12] == min(len(plan.jobs) * args[4], sms)
    small = lib.calls[-1][1]
    assert small[1:5] == (plan.grid, plan.small_stride, pk.biases.numel(), pk.ldw)
    assert small[5:7] == (pk.segments["alpha"][0], pk.segments["rgb"][0])


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide1k_backward_launches_round_by_round(dtype, sigma_only, monkeypatch):
    """Past width 512 ``_backward_wide`` launches, per round in order, the
    wide1k forward of the pack's dtype in record mode (f32 over the
    round's rows, its record the plan's; bf16 over its tiles, into the
    workspace and the view images), the half-tile backward
    ``nerf_wide1k_bwd_tiles`` (the transposed pack, the dtype's flag, the
    record or the view images, the round's tiles) and the dW kernel, then
    the small sums once."""
    monkeypatch.setitem(fm.WIDE_ROUND_BYTES, dtype, 1)
    pk = packed(ArchConfig(640, 136, 3, 1), dtype)
    assert pk.wide1k
    n, sms = 64 * 9 + 5, 4                          # 10 tiles: rounds of 4, 4, 2
    lib = Recorder()
    ptrs = (1, 2, n, 1, 3, 4)
    outs = (5, 6, 7, 8, 0, 0)
    assert fm._backward_wide(lib, pk, ptrs, n, sigma_only, outs, torch.device("cpu"), sms) == 0
    plan = fm.wide_plan(pk, n, sms, sigma_only)
    assert (plan.round_tiles, plan.rounds) == (4, 3)
    record = ("nerf_fused_mlp_wide1k_f32tc_record" if dtype == "float32"
              else "nerf_fused_mlp_wide1k_tc_record")
    per_round = [record, "nerf_wide1k_bwd_tiles", "nerf_wide_dw"]
    assert [c[0] for c in lib.calls] == per_round * 3 + ["nerf_wide_small_sum"]
    recs = [args for name, args in lib.calls if name == record]
    tiles_calls = [args for name, args in lib.calls if name == "nerf_wide1k_bwd_tiles"]
    for (rec, bwd), (tile0, tiles) in zip(zip(recs, tiles_calls), ((0, 4), (4, 4), (8, 2))):
        assert rec[:4] == ptrs[:4]
        if dtype == "float32":
            assert rec[13:16] == (int(sigma_only), 64 * tile0, 64 * tiles) and rec[16] == bwd[19]
        else:
            assert rec[11:16] == (int(sigma_only), tile0, tiles, bwd[21], plan.round_tiles)
            assert rec[16] == bwd[20]
        # nerf_wide1k_bwd_tiles(ptrs..., weights, mma_wt, lo_wt, biases, layout, len,
        #                       layout_mma, len, ldw, ldv, depth, sigma_only, bf16, rec, view,
        #                       ws, ws_tiles, tile0, tiles, small, n_b, small_stride, grid,
        #                       dpts, ddirs, device, stream)
        assert bwd[:6] == ptrs
        assert bwd[7] == pk.mma_wt.data_ptr() and bwd[8] == pk.mma_wt.shape[1]
        assert bwd[13] == pk.layout_mma.size == 2 * fm.MAX_DEPTH + 3
        assert bwd[14:19] == (pk.ldw, pk.ldv, pk.depth, int(sigma_only),
                              int(dtype == "bfloat16"))
        assert (bwd[19] is None) == (dtype == "bfloat16") and (bwd[20] is None) == (
            dtype == "float32")
        assert bwd[22:25] == (plan.round_tiles, tile0, tiles)
        assert bwd[26:29] == (pk.biases.numel(), plan.small_stride, plan.grid)
        assert bwd[29:31] == (7, 8)
