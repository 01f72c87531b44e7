"""Hash-grid NeRF (the Instant-NGP model family).

The reference's single fixed MLP costs ~590 K MACs per sample. The
multiresolution hash encoding (``models/hashgrid.py``, Mueller et al.
2022) replaces it with L table gathers and a tiny MLP — orders of
magnitude less math per sample. On the card the encode is the port's
hand-written CUDA kernel (``ops/kernels/csrc/hash_encode.cu``). This
example distills the pretrained teacher into a hash-grid field for a few
steps, evaluates PSNR vs the teacher on a held-out view, and renders an
image with it.

Equivalent CLI: python -m nerf_rs_tpu_torch train --model hashgrid
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-rays", type=int, default=256)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--table-log2", type=int, default=14)
    ap.add_argument("--res-max", type=int, default=256)
    ap.add_argument("--eval-size", type=int, default=32)
    ap.add_argument("--out", default="/tmp/hashgrid.png")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    import numpy as np

    from nerf_rs_tpu_torch.config import HashGridConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.golden import camera_from_golden
    from nerf_rs_tpu_torch.io.image import save_png
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_scene_assets
    from nerf_rs_tpu_torch.models.mlp import as_module, count_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image
    from nerf_rs_tpu_torch.train import create_train_state, split_params, train_step
    from nerf_rs_tpu_torch.utils.profiling import device_label

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    trees, golden = load_scene_assets(assets)
    teacher = {net: as_module(tree, device) for net, tree in trees.items()}
    camera = camera_from_golden(golden)

    hcfg = HashGridConfig(levels=args.levels, table_log2=args.table_log2,
                          res_max=args.res_max)
    small = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=args.batch_rays,
                         model="hashgrid", hash=hcfg)
    # The Instant-NGP recipe: one shared network for both passes, higher
    # lr, tiny Adam eps (table gradients are minute).
    cfg = TrainConfig(batch_rays=args.batch_rays, render=small,
                      lr_init=1e-2, lr_final=1e-4, adam_eps=1e-15)
    state = create_train_state(torch.Generator(device).manual_seed(0), cfg)
    n_field = sum(p.numel() for p in state.params["shared"].parameters())
    print(f"hashgrid {hcfg.levels} levels x 2^{hcfg.table_log2} entries: "
          f"{n_field:,} params, one shared network "
          f"(teacher MLPs: {sum(count_params(m) for m in teacher.values()):,})")

    # Teacher renders use the canonical MLP model.
    data = DistillationDataset(teacher, cfg=small.replace(model="mlp"), device=device)
    t0 = None
    for step, batch in zip(range(args.steps), data.batches(cfg.batch_rays)):
        state, m = train_step(state, batch, random.key(step, device), cfg)
        if step == 0:
            float(m["loss"])
            t0 = time.perf_counter()   # skip first-use costs
        if step % 10 == 0:
            print(f"step {step}: loss {float(m['loss']):.4f} "
                  f"psnr {float(m['psnr']):.2f}")
    if args.steps > 1:
        float(m["loss"])
        rps = (args.steps - 1) * cfg.batch_rays / (time.perf_counter() - t0)
        print(f"hashgrid train throughput: {rps:,.0f} rays/s fwd+bwd on {device_label(device)}")

    # Held-out view (the golden camera is never a training pose).
    pc, pf = split_params(state.params)
    key = random.key(7, device)
    s = args.eval_size
    ref = render_image(teacher["coarse"], teacher["fine"], camera, s, s, key,
                       small.replace(model="mlp")).cpu().numpy()
    img = render_image(pc, pf, camera, s, s, key, small).cpu().numpy()
    mse = float(np.mean((img - ref) ** 2))
    print(f"hashgrid PSNR vs teacher @{s}px after {args.steps} steps: "
          f"{-10.0 * np.log10(max(mse, 1e-12)):.2f} dB "
          "(a real run distills thousands of steps)")
    save_png(args.out, img, s, s)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
