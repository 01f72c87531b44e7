"""PyTorch port, the cluster walk of K1's wide bf16 kernel
(``csrc/fused_mlp_wide_tc.cu``): a persistent grid of thread-block
clusters whose CTAs share one weight stream by multicast, so every CTA of
a cluster must walk the same chunks, on tiles of zeros past the last tile.

The walk is C++ that the CPU cannot run; this replays it as the kernel's
``launch`` and tile loops compute it, with the cluster size read from the
source, and holds it to its contract. The kernel itself is held to the
plain version on the card (``chip_smoke.py`` phases 2 and 29,
``tests/test_torch_cuda.py``), and bit for bit to the unclustered kernel
(``tools/torch_k1_parent_ab.py``)."""

import re
from pathlib import Path

import pytest

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
