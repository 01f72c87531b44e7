"""Occupancy-grid empty-space skipping (NerfAcc-style acceleration).

Bakes a conservative max-sigma voxel grid from the pretrained network
(one-time cost), then renders with empty coarse samples skipped and fine
samples past the transmittance-termination point culled. Opt-in: pass the
grid to render_*; the exact path stays the default. Reports PSNR of the
accelerated render vs the exact one.

On the card the grid's sweep runs the fused kernel K1 in bfloat16,
sigma-only (``accel.build_scene_grid``'s default); on the CPU (``--cpu``)
it runs the plain float32 oracle, as the JAX script does off the TPU.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--resolution", type=int, default=64, help="grid voxels/axis")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    import numpy as np

    from nerf_rs_tpu_torch.accel import build_scene_grid, suggest_capacities
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    pc = as_module(load_nerf_params(assets / "coarse"), device)
    pf = as_module(load_nerf_params(assets / "fine"), device)
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=2048)
    key = random.key(0, device)

    t0 = time.perf_counter()
    kw = {}
    if device.type != "cuda":
        # Off the card, sweep with the float32 oracle, as the JAX script
        # does off the TPU.
        from nerf_rs_tpu_torch.models.mlp import nerf_mlp

        kw = dict(mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
                  chunk=args.resolution ** 3)
    # A slightly tight AABB and higher threshold keep the grid selective
    # while dilation keeps it conservative (tests/test_accel.py config).
    grid = build_scene_grid(pc, pf, resolution=args.resolution,
                            aabb=(-1.8, 1.8), sigma_threshold=0.1, **kw)
    occ = float(grid.occ.to(torch.float32).mean())
    print(f"grid: {args.resolution}^3 in {time.perf_counter() - t0:.1f}s, "
          f"{occ:.1%} occupied")

    def frame(c, g=None):
        return render_image(pc, pf, camera, args.size, args.size, key, c, grid=g).cpu().numpy()

    def psnr(a, b):
        return -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-12))

    exact = frame(cfg)

    # The default accel mode: mask-only culling — dense evaluation with
    # occupancy-zeroed sigma.
    fast = frame(cfg, grid)
    print(f"accelerated vs exact: {psnr(exact, fast):.1f} dB PSNR "
          f"(>40 dB means visually identical)")

    # Ray-level packing: background rays (about half the lego frame) are
    # composited without rendering — bitwise identical to the render above.
    packed = frame(cfg.replace(accel_cull_rays=True), grid)
    print(f"ray-culled render bitwise equal: {bool((packed == fast).all())}")

    # Per-sample compaction, for comparison (needs capacities sized to this
    # camera so overflow cannot silently zero real samples).
    ccfg = suggest_capacities(grid, camera, args.size, args.size,
                              cfg.replace(accel_compact="scatter"))
    print(f"compaction A/B capacities: coarse {ccfg.accel_coarse_capacity:.2f}, "
          f"fine {ccfg.accel_fine_capacity:.2f}")
    compact = frame(ccfg, grid)
    print(f"compaction vs exact: {psnr(exact, compact):.1f} dB PSNR")


if __name__ == "__main__":
    main()
