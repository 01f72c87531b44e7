"""PyTorch port, the int8 kernels' wide envelope: W8A8 NeRF MLPs with trunk
or view widths above 256 or more than 16 dense layers, up to 512 and 32,
which ``fused_int8_mlp`` serves on the card through the wide int8 kernel
(``csrc/int8_mlp_wide_tc.cu``).

The kernel cannot run here. What a CPU can check: its dataflow, read off
the pack and the 104-entry layout table it reads (the two warpgroups'
halves of each layer's 64-column pieces, the half-row absmax each takes
and the exchange of the two, the heads' integer sums split between the
halves), gives the plain version's outputs bit for bit; and the port's
int8 MLP at 512/256/20 stays within the JAX package's bars. The kernel is
held to the same plain version on the card (``chip_smoke.py`` phase 21,
``tests/test_torch_cuda.py``)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.models import quant as jq
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io.weights import load_nerf_params, params_to_torch
from nerf_rs_tpu_torch.models.encoding import positional_encoding
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops.kernels import int8_mlp
from nerf_rs_tpu_torch.ops.kernels.int8_mlp import (
    fused_int8_mlp,
    fused_int8_mlp_reference,
    kernel_codes,
    pack_int8_params,
)
from test_torch_quant import np_params, points_dirs, within_bars

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LEGO = ROOT / "assets" / "lego_rust"
# Ragged widths (not multiples of 64 or 8), deep, the skip at dense5.
RAGGED_DEEP = ArchConfig(width=300, v_width=72, depth=18, skip_at=4)
PIECE = 64


def widened_lego(net, width, v_width, depth):
    """The lego network ``net`` widened by ``chip_smoke.widen_nerf``, as
    phase 29 renders it (seed 0 coarse, 1 fine), as a torch param tree."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    seed = ("coarse", "fine").index(net)
    return params_to_torch(chip_smoke.widen_nerf(load_nerf_params(LEGO / net), width, v_width,
                                                 depth, seed=seed), "cpu")


def tree_for(source):
    if source == "ragged_300x72x18":
        return params_to_torch(np_params(RAGGED_DEEP, 21), "cpu")
    return widened_lego(*{"lego_fine_512x256x20": ("fine", 512, 256, 20),
                          "lego_coarse_512x256x20": ("coarse", 512, 256, 20)}[source])


def untile(flat, off, k, ld):
    """A (k, ld) code matrix from its int8_tile order at byte ``off``."""
    return flat[off:off + k * ld].view(k // 16, ld // 8, 8, 16).permute(0, 3, 1, 2).reshape(k, ld)


def halves(n):
    """The two warpgroups' columns of a layer n columns wide (n a multiple
    of 64): the first half of its 64-column pieces rounded up, then the
    rest (``Share`` in the kernel)."""
    pieces = n // PIECE
    first = (pieces + 1) // 2
    return slice(0, first * PIECE), slice(first * PIECE, pieces * PIECE)


def emulate_wide_kernel(pk, points, dirs, sigma_only):
    """csrc/int8_mlp_wide_tc.cu's dataflow in plain torch, read off the
    pack through the layout table alone: offsets [0, 32), slots [32, 64),
    skip flags [64, 96), the heads' and the bottleneck's and view layer's
    offsets and slots at 96-103. Each layer's columns split between two
    warpgroups; each takes the absmax of its half of the row (with the
    encode's absmax before a skip layer and the dir encode's before the
    view layer), and the row scale is the larger of the two; the codes of
    the whole input row at that scale (``kernel_codes``: the kernel's
    requantize) times each half's code columns as exact integer sums;
    ((acc sx) sw) + b from the epilogue slots; the heads' integer sums
    over each half's columns, added."""
    L, D = pk.layout, 32
    assert pk.wide and L.size == 3 * D + 8
    flat = pk.weights
    epi = pk.epilogue.view(-1, 4)                     # [sw, sw, b, b] a column pair
    enc_x = torch.nn.functional.pad(positional_encoding(points, 10), (0, 1))
    enc_d = torch.nn.functional.pad(positional_encoding(dirs, 4), (0, 5))

    def absmax(x):
        return torch.amax(torch.abs(x), dim=-1, keepdim=True)

    def sw_b(slot, ld):
        pairs = epi[slot // 2:(slot + ld) // 2]
        return pairs[:, :2].reshape(-1), pairs[:, 2:].reshape(-1)

    def scale(m):
        return torch.clamp_min(m / m.new_full((), 127.0), 1e-12)

    def dense(off, slot, k, n, sx, pieces, floor, extra=None):
        """One layer: -> (outputs (rows, n), the next row scale)."""
        codes = torch.cat([kernel_codes(x, sx) for x in pieces], -1).to(torch.float64)
        w = untile(flat, off, k, n).to(torch.float64)
        sw, b = sw_b(slot, n)
        out, maxima = torch.zeros(codes.shape[0], n), []
        for cols in halves(n):
            acc = codes @ w[:, cols]          # integer sums, exact in float64
            y = acc.to(torch.float32) * sx * sw[cols] + b[cols]
            y = torch.clamp_min(y, floor) if floor is not None else y
            out[:, cols] = y
            m = absmax(y) if y.shape[1] else torch.zeros_like(sx)
            maxima.append(m if extra is None else torch.maximum(m, extra))
        return out, scale(torch.maximum(*maxima))

    def head(off, slot, k, sx, x, rows):
        """The heads' integer sums over each half's columns, added; the
        dequant of the first ``rows`` columns."""
        w = untile(flat, off, k, 8).to(torch.float64)
        codes = kernel_codes(x, sx).to(torch.float64)
        acc = sum(codes[:, cols] @ w[cols, :rows] for cols in halves(k))
        sw, b = sw_b(slot, 8)
        return acc.to(torch.float32) * sx * sw[:rows] + b[:rows]

    ex, ed = absmax(enc_x), absmax(enc_d)
    sx = scale(ex)
    h, pieces = None, [enc_x]
    for i in range(pk.depth):
        skip_next = i + 1 < pk.depth and bool(L[2 * D + i + 1])
        k = 64 if i == 0 else (64 + pk.ldw if L[2 * D + i] else pk.ldw)
        h, sx = dense(int(L[i]), int(L[D + i]), k, pk.ldw, sx, pieces, 0.0,
                      ex if skip_next else None)
        pieces = [enc_x, h] if skip_next else [h]
    sigma = torch.relu(head(int(L[3 * D]), int(L[3 * D + 4]), pk.ldw, sx, h, 1))[:, 0]
    if sigma_only:
        return torch.zeros_like(points), sigma
    bottleneck, sx = dense(int(L[3 * D + 1]), int(L[3 * D + 5]), pk.ldw, pk.ldw, sx, [h], None,
                           ed)
    hv, sx = dense(int(L[3 * D + 2]), int(L[3 * D + 6]), pk.ldw + 32, pk.ldv, sx,
                   [bottleneck, enc_d], 0.0)
    rgb = torch.sigmoid(head(int(L[3 * D + 3]), int(L[3 * D + 7]), pk.ldv, sx, hv, 3))
    return rgb, sigma


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("source", ["lego_fine_512x256x20", "lego_coarse_512x256x20",
                                    "ragged_300x72x18"])
def test_wide_kernel_dataflow_on_the_pack_equals_the_plain_version(source, sigma_only):
    """The wide kernel's layout contract and arithmetic, checked where a
    CPU can: its dataflow read off the pack and the 104-entry table (the N
    split, the exchanged half-row absmax, the split heads, 20 and 18 dense
    layers) gives the plain version's sigma and rgb bit for bit."""
    tree = tree_for(source)
    pk = pack_int8_params(tree)
    assert pk.wide and pk.layout.size == 104
    pts, dirs = (torch.from_numpy(a) for a in points_dirs(1024, 22))
    rgb, sig = emulate_wide_kernel(pk, pts, dirs, sigma_only)
    rgb_w, sig_w = fused_int8_mlp_reference(tree, pts, dirs, sigma_only=sigma_only)
    assert torch.equal(sig, sig_w)
    assert torch.equal(rgb, rgb_w)


def test_wide_pack_layout_table():
    """The 104-entry table of a wide pack: dense offsets and slots for the
    network's layers and -1 past its depth, the skip flag at the skip
    layer alone, the heads' segments and slots; a network within 256 and
    16 keeps the narrow kernel's 56-entry table."""
    tree = params_to_torch(np_params(RAGGED_DEEP, 23), "cpu")
    pk = pack_int8_params(tree)
    L, D = pk.layout, 32
    assert (pk.ldw, pk.ldv, pk.depth) == (320, 128, 18)
    assert [int(L[i]) for i in range(D)] == [pk.segments[f"dense{i}"][0] if i < 18 else -1
                                             for i in range(D)]
    assert [int(L[D + i]) for i in range(D)] == [pk.slots[f"dense{i}"][0] if i < 18 else -1
                                                 for i in range(D)]
    assert [i for i in range(D) if L[2 * D + i]] == [5]
    assert list(L[3 * D:]) == ([pk.segments[n][0] for n in ("alpha", "bottleneck", "viewdirs",
                                                             "rgb")]
                               + [pk.slots[n][0] for n in ("alpha", "bottleneck", "viewdirs",
                                                           "rgb")])
    narrow_tree = params_to_torch(np_params(ArchConfig(width=256, v_width=128, depth=16,
                                                       skip_at=4), 24), "cpu")
    narrow = pack_int8_params(narrow_tree)
    assert not narrow.wide and narrow.layout.size == 56
    assert [i for i in range(16) if narrow.layout[32 + i]] == [5]


@pytest.mark.parametrize("arch, wide", [((256, 256, 16), False), ((257, 128, 8), True),
                                        ((128, 264, 8), True), ((64, 64, 17), True),
                                        ((512, 512, 32), True), ((256, 128, 20), True)])
def test_narrow_and_wide_envelopes(arch, wide):
    """The narrow kernel serves up to 256 and 16; the wide one the rest of
    the envelope, up to 512 and 32, K1's; both serve every such network."""
    assert (int8_mlp.INT8_MAX_WIDTH, int8_mlp.INT8_MAX_DEPTH) == (512, 32)
    assert (int8_mlp.INT8_NARROW_MAX_WIDTH, int8_mlp.INT8_NARROW_MAX_DEPTH) == (256, 16)
    assert int8_mlp.supports_dims(*arch)
    assert int8_mlp.narrow_dims(*arch) is not wide


def test_int8_mlp_512x256x20_matches_jax():
    """The port's int8 MLP (``fused_int8_mlp`` on the CPU: its plain
    version) on the lego fine network widened to 512/256/20, 8192 points,
    against the JAX package's ``int8_nerf_mlp(fake=False)``:
    test_int8_mlp_matches_jax's bars (at least 99.5% of the samples within
    the real-vs-fake bars, every value finite, max |d rgb| <= 0.05)."""
    tree = widened_lego("fine", 512, 256, 20)
    pts, dirs = points_dirs(8192, 2)
    rgb_w, sig_w = (np.asarray(a) for a in jq.int8_nerf_mlp(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree), jnp.asarray(pts),
        jnp.asarray(dirs), fake=False))
    rgb, sig = (a.numpy() for a in fused_int8_mlp(NerfMLP(tree), torch.from_numpy(pts),
                                                  torch.from_numpy(dirs)))
    assert rgb.shape == (8192, 3) and sig.shape == (8192,)
    assert np.isfinite(rgb).all() and np.isfinite(sig).all()
    assert within_bars(rgb, sig, rgb_w, sig_w).mean() >= 0.995
    assert np.abs(rgb - rgb_w).max() <= 0.05
