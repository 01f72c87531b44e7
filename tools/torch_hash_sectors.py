#!/usr/bin/env python3
"""How many 32-byte table sectors the hash encode must fetch, reckoned on
the CPU from the port's own corner rows (``ops.kernels.hash_encode._Corners``)
for points as the render hands them: the 256x256 golden camera's rays from
the 800x800 frame chunk's rows, 192 stratified samples a ray over [near,
far], the paper config (16 levels of 2^17 rows, F = 2).

    python3 tools/torch_hash_sectors.py [--rays 1024]

Prints, for f32 (8-byte rows) and bf16 (4-byte rows):

- sectors a (sample, level) summed over the 8 corner load instructions of
  a warp, each instruction's distinct sectors shared by its 32 lanes: the
  first kernel's mapping (a warp = 2 samples x 16 levels) against the
  level-major one (a warp = 32 consecutive samples of one level);
- the distinct sectors a sample once per tile, the least an L1 that merges
  every reuse inside a CTA's tile passes to L2: tiles of 1, 16 (the first
  kernel's CTA) and 64 consecutive samples of a ray (the level-major CTA),
  and tiles of R neighbouring rays x 64 / R samples (what a kernel told the
  samples a ray could take).

Counts only; no time. Needs no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SAMPLES = 192


def corner_rows(n_rays: int):
    """(rays, SAMPLES, L, 8) absolute table rows of every corner."""
    import torch

    from nerf_rs_tpu_torch.config import HashGridConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import _Corners, _lattice
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.ops.sampling import stratified_samples

    cam = camera_from_golden(load_golden(find_lego_assets() / "tf_reference_samples.json"))
    side = 256
    _, dirs = camera_rays(cam, side, side, "cpu")
    first = (side // 2 - 16384 // side // 2) * side + 8 * side
    dirs = dirs.reshape(-1, 3)[first:first + n_rays]
    ids = torch.arange(first, first + n_rays)
    t = stratified_samples(random.fold_in(random.key(0, "cpu"), ids), torch.tensor(cam.near),
                           torch.tensor(cam.far), SAMPLES, (n_rays,))
    pts = (torch.as_tensor(cam.position) + dirs[:, None, :] * t[..., None]).reshape(-1, 3)
    cfg = HashGridConfig()
    corners = _Corners(_lattice(pts, cfg), cfg, 1 << cfg.table_log2, "cpu")
    rows = torch.stack([corners(c)[0] for c in range(8)], -1)
    return rows.reshape(n_rays, SAMPLES, cfg.levels, 8)


def distinct(groups):
    """Distinct values along the last axis, per leading index."""
    s = groups.sort(-1).values
    return 1 + (s[..., 1:] != s[..., :-1]).sum(-1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rays", type=int, default=1024, help="rays (a multiple of 256)")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    rows = corner_rows(args.rays)
    rays, samples, levels, _ = rows.shape
    n = rays * samples
    for name, row_bytes in (("f32", 8), ("bf16", 4)):
        sector = rows * row_bytes // 32
        flat = sector.reshape(n, levels, 8)
        # First kernel: lanes = 2 consecutive samples x 16 levels, one load
        # instruction a corner.
        first = flat.reshape(n // 2, 2 * levels, 8).transpose(1, 2)
        first_per = float(distinct(first).sum()) / (n * levels)
        # Level-major: lanes = 32 consecutive samples of one level.
        major = flat.reshape(n // 32, 32, levels, 8).permute(0, 2, 3, 1)
        major_per = float(distinct(major).sum()) / (n * levels)
        print(f"{name}: sectors a (sample, level) over the 8 corner instructions: first "
              f"kernel's warps {first_per:.2f}, level-major warps {major_per:.2f}")
        for tile in (1, 16, 64):
            per_level = distinct(flat.reshape(n // tile, tile, levels, 8).transpose(1, 2)
                                 .reshape(n // tile, levels, tile * 8)).sum(0).double() / n
            print(f"{name}: distinct sectors a sample, tiles of {tile} samples of a ray: "
                  f"{float(per_level.sum()):.2f}; by level "
                  + " ".join(f"{v:.2f}" for v in per_level.tolist()))
        for r in (4, 8, 16):
            k = 64 // r
            tiles = (sector.reshape(rays // r, r, samples // k, k, levels, 8)
                     .permute(0, 2, 4, 1, 3, 5).reshape(-1, levels, r * k * 8))
            per_level = distinct(tiles).sum(0).double() / n
            print(f"{name}: distinct sectors a sample, tiles of {r} neighbouring rays x {k} "
                  f"samples: {float(per_level.sum()):.2f}; finest level {float(per_level[-1]):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
