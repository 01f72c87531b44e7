"""Occupancy-culled (NerfAcc-style) training.

Distills from the pretrained teacher with the occupancy grid culling MLP
evaluations inside the differentiable render: culled samples get zero
weight and zero gradient (mask-only culling, the default
``accel_compact="none"``). In a real run the grid is rebuilt from the
student as it trains (``python -m nerf_rs_tpu_torch train --accel-every
N``); here the teacher's grid shows the step-level API, and the script
prints the measured throughput of dense and culled steps and their ratio.
Mask-only culling still evaluates every sample, so it is not expected to
be faster; the card's times are printed beside its name and power limit.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-rays", type=int, default=256)
    ap.add_argument("--resolution", type=int, default=48)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state, train_step
    from nerf_rs_tpu_torch.utils.profiling import device_label

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    teacher = {net: as_module(load_nerf_params(assets / net), device)
               for net in ("coarse", "fine")}

    kw = {}
    if device.type != "cuda":
        from nerf_rs_tpu_torch.models.mlp import nerf_mlp

        kw = dict(mlp_fn=lambda p, x, d: nerf_mlp(p, x, d),
                  chunk=args.resolution ** 3)
    grid = build_scene_grid(teacher["coarse"], teacher["fine"],
                            resolution=args.resolution,
                            aabb=(-1.8, 1.8), sigma_threshold=0.1, **kw)
    occ = float(grid.occ.to(torch.float32).mean())
    print(f"teacher grid: {args.resolution}^3, {occ:.1%} occupied")

    small = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=args.batch_rays)
    cfg = TrainConfig(batch_rays=args.batch_rays, render=small)
    data = DistillationDataset(teacher, cfg=small, device=device)

    def run(steps, grid):
        # Each run starts from the same fresh state.
        s, t0 = create_train_state(torch.Generator(device).manual_seed(0), cfg), None
        for step, batch in zip(range(steps), data.batches(cfg.batch_rays)):
            s, m = train_step(s, batch, random.key(step, device), cfg, grid=grid)
            float(m["loss"])                      # wait for the step
            if step == 0:
                t0 = time.perf_counter()          # skip first-use costs
        dt = time.perf_counter() - t0
        return m, (steps - 1) * cfg.batch_rays / dt

    m, dense_rps = run(args.steps, None)
    print(f"dense: {dense_rps:,.0f} rays/s fwd+bwd, "
          f"loss {float(m['loss']):.4f}")
    m, accel_rps = run(args.steps, grid)
    print(f"accel: {accel_rps:,.0f} rays/s fwd+bwd, "
          f"loss {float(m['loss']):.4f}, compaction load "
          f"{float(m['live_frac_coarse']):.2f}/{float(m['live_frac_fine']):.2f}")
    print(f"culled/dense throughput: {accel_rps / dense_rps:.2f}x "
          f"(measured on {device_label(device)})")


if __name__ == "__main__":
    main()
