"""Train a NeRF by distilling the pretrained teacher, with checkpoints.

The reference renderer cannot train at all; here the same render path is
differentiable end to end. This script runs a short distillation loop
(teacher renders supervise a fresh student), saves a checkpoint in the
port's format (``io/checkpoint.py``), and exports the result to the
reference's shapes.txt/.bin weight format, which the reference renderer
and both packages load. The training configuration keeps the plain
PyTorch MLP (``impl="xla"``, RenderConfig's default). Runs on the CUDA card
unless ``--cpu`` is given.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-rays", type=int, default=256)
    ap.add_argument("--ckpt", default="/tmp/nerf_ckpt")
    ap.add_argument("--export", default=None,
                    help="directory for reference-format weight export")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    from nerf_rs_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.checkpoint import (
        export_reference_format,
        latest_checkpoint,
        save_checkpoint,
    )
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state, train_step

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    teacher = {"coarse": load_nerf_params(assets / "coarse"),
               "fine": load_nerf_params(assets / "fine")}
    small = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=args.batch_rays)
    cfg = TrainConfig(batch_rays=args.batch_rays, render=small)
    data = DistillationDataset(teacher, cfg=small, device=device)
    state = create_train_state(torch.Generator(device).manual_seed(cfg.seed), cfg)

    for step, batch in zip(range(args.steps), data.batches(cfg.batch_rays)):
        state, metrics = train_step(state, batch, random.key(step, device), cfg)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"psnr {float(metrics['psnr']):.2f} dB")

    path = save_checkpoint(args.ckpt, state)
    print(f"checkpoint: {path} (latest: {latest_checkpoint(args.ckpt)})")
    if args.export:
        export_reference_format(args.export, state.params)
        print(f"reference-format weights: {args.export}")


if __name__ == "__main__":
    main()
