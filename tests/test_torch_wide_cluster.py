"""PyTorch port, the cluster walk of K1's wide bf16 kernel
(``csrc/fused_mlp_wide_tc.cu``): a persistent grid of thread-block
clusters whose CTAs share one weight stream by multicast, so every CTA of
a cluster must walk the same chunks, on tiles of zeros past the last tile.

The walk is C++ that the CPU cannot run; this replays it as the kernel's
``launch`` and tile loops compute it, with the cluster size read from the
source, and holds it to its contract; and the ring's chunks (a pass's
columns of a segment's rows) as the kernel's table lays them out. The
kernel itself is held to the plain version on the card (``chip_smoke.py``
phases 2 and 29, ``tests/test_torch_cuda.py``)."""

import re
from pathlib import Path

import pytest
import torch

from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

CSRC = Path(fm.__file__).resolve().parent / "csrc"
SMS = 132                                   # an H100 SXM, one CTA an SM


def cluster_size() -> int:
    found = re.search(r"constexpr int kClusterW = (\d+);",
                      (CSRC / "fused_mlp_wide_tc.cu").read_text())
    assert found
    return int(found.group(1))


def cluster_walk(tiles: int, fit: int, cluster: int):
    """The launch and tile walk as ``fused_mlp_wide_tc.cu`` computes them:
    clusters of ``cluster`` CTAs, as many as ``fit`` on the card and the
    tiles need; CTA rank r of cluster q takes tiles base + r, base from q
    ``cluster`` in steps of the grid. -> (grid, {(q, r): its tiles, those
    past the last included})."""
    need = -(-tiles // cluster)
    grid = min(need, fit) * cluster
    walks = {}
    for q in range(grid // cluster):
        for r in range(cluster):
            walks[(q, r)] = [base + r for base in range(q * cluster, tiles, grid)]
    return grid, walks


@pytest.mark.parametrize("tiles", [1, 2, 3, 65, 66, 67, 131, 133, 24576, 24577])
def test_cluster_walk_covers_every_tile_once(tiles):
    """The grid is a whole number of clusters within the card; every tile
    is walked exactly once; the CTAs of a cluster walk equally many tiles
    (the ring's chunks stay in step), those past the last being zero tiles
    whose stores the kernel masks, fewer than a cluster's CTAs."""
    cluster = cluster_size()
    grid, walks = cluster_walk(tiles, SMS // cluster, cluster)
    assert grid % cluster == 0 and 0 < grid <= SMS
    assert sorted(t for walk in walks.values() for t in walk if t < tiles) == list(range(tiles))
    for q in range(grid // cluster):
        assert len({len(walks[(q, r)]) for r in range(cluster)}) == 1
        assert sum(t >= tiles for r in range(cluster) for t in walks[(q, r)]) < cluster


def pass_k() -> int:
    found = re.search(r"constexpr int kPassK = (\d+);",
                      (CSRC / "fused_mlp_wide_tc.cuh").read_text())
    assert found
    return int(found.group(1))


@pytest.mark.parametrize("n", [512, 448, 320, 256, 192, 128, 64])
def test_pass_chunks_are_tc_tiles_of_the_pass(n):
    """The wide bf16 forward's ring chunks (``wide::layer_chunks`` in
    csrc/fused_mlp_wide_tc.cuh, which K1's producer and K2's recompute
    table walk): a layer's 64-column pieces in passes of at most four, each
    pass's columns of kPassK K-rows a chunk, copied as one run of ``nh *
    16`` bytes a k-group of 8 rows from element ``c n + 512 pp`` of the
    segment, ``8 n`` elements apart, laid end to end; each chunk must be
    ``tc_tile`` of that (rows x nh) block (the consumers' descriptors read
    it with an LBO of ``nh * 16``), fill at most a 32 KB ring stage, and the
    passes must cover every column once, each warpgroup of a pass taking
    at most two pieces (``wide::Share``)."""
    k, rows = 96, pass_k()
    m = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    flat = fm.tc_tile(m, k, n)
    pieces, covered = n // 64, []
    for pp in range(0, pieces, 4):
        pc = min(pieces - pp, 4)
        assert max((pc + 1) // 2, pc // 2) <= 2
        nh, col0 = 64 * pc, 64 * pp
        covered += list(range(col0, col0 + nh))
        for c in range(0, k, rows):
            kc = min(rows, k - c)
            assert kc * nh * 2 <= 32768
            off = c * n + 512 * pp
            runs = [flat[off + r * 8 * n:off + r * 8 * n + 8 * nh] for r in range(kc // 8)]
            assert torch.equal(torch.cat(runs), fm.tc_tile(m[c:c + kc, col0:col0 + nh], kc, nh))
    assert covered == list(range(n))
