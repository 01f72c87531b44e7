"""Student-architecture distillation (the ArchConfig model family).

The reference ships exactly one MLP. This package spans a parametric
family: smaller *student* networks distilled from the pretrained teacher
cut MLP FLOPs roughly quadratically in width — the second work-reduction
axis after occupancy culling. This example trains a small student for a
few steps through the plain PyTorch MLP (``impl="xla"``, as the JAX
script does), evaluates its PSNR vs the teacher on a held-out view, and
prints its training throughput beside the card's name and power limit.

Equivalent CLI: python -m nerf_rs_tpu_torch train --width 128 --v-width 64
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-rays", type=int, default=256)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--v-width", type=int, default=64)
    ap.add_argument("--eval-size", type=int, default=32)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    import numpy as np

    from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.golden import camera_from_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_scene_assets
    from nerf_rs_tpu_torch.models.mlp import as_module, count_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image
    from nerf_rs_tpu_torch.train import create_train_state, train_step
    from nerf_rs_tpu_torch.utils.profiling import device_label

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    trees, golden = load_scene_assets(assets)
    teacher = {net: as_module(tree, device) for net, tree in trees.items()}
    camera = camera_from_golden(golden)

    arch = ArchConfig(width=args.width, v_width=args.v_width)
    small = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=args.batch_rays,
                         impl="xla")
    cfg = TrainConfig(batch_rays=args.batch_rays, render=small, arch=arch)
    state = create_train_state(torch.Generator(device).manual_seed(0), cfg)
    n_student = sum(count_params(m) for m in state.params.values())
    n_teacher = sum(count_params(m) for m in teacher.values())
    print(f"student {arch}: {n_student:,} params (teacher: {n_teacher:,})")

    data = DistillationDataset(teacher, cfg=small, device=device)
    t0 = None
    for step, batch in zip(range(args.steps), data.batches(cfg.batch_rays)):
        state, m = train_step(state, batch, random.key(step, device), cfg)
        loss = float(m["loss"])
        if step == 0:
            t0 = time.perf_counter()   # skip first-use costs
        if step % 5 == 0:
            print(f"step {step}: loss {loss:.4f} psnr {float(m['psnr']):.2f}")
    if args.steps > 1:
        rps = (args.steps - 1) * cfg.batch_rays / (time.perf_counter() - t0)
        print(f"student train throughput: {rps:,.0f} rays/s fwd+bwd on {device_label(device)}")

    # Held-out view: PSNR vs the teacher's render (the golden camera is
    # never a training view — DistillationDataset samples random
    # hemisphere poses).
    key = random.key(7, device)
    s = args.eval_size
    ref = render_image(teacher["coarse"], teacher["fine"], camera, s, s, key,
                       small).cpu().numpy()
    img = render_image(state.params["coarse"], state.params["fine"], camera, s, s, key,
                       small).cpu().numpy()
    mse = float(np.mean((img - ref) ** 2))
    print(f"student PSNR vs teacher @{s}px after {args.steps} steps: "
          f"{-10.0 * np.log10(max(mse, 1e-12)):.2f} dB "
          "(a real run trains tens of thousands of steps)")


if __name__ == "__main__":
    main()
