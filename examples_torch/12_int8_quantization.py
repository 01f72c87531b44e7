"""Int8 W8A8 quantization: PTQ serving + QAT distillation (``models/quant.py``).

Symmetric per-output-channel int8 weights and per-row dynamic int8
activations, int32 sums dequantized by rank-1 scales. On the card
``impl="int8"`` runs the port's hand-written W8A8 kernel
(``ops/kernels/csrc/int8_mlp_tc.cu``, s8 ``wgmma``); on the CPU its plain
PyTorch version. The path's value is 4x smaller serving weights and a
quantization-aware training story.

This example:
  1. renders a frame with the f32 exact path and with ``impl="int8"``
     (post-training quantization) and reports the PSNR between them — the
     PTQ quality cost;
  2. runs a few QAT steps (``impl="int8qat"``: straight-through-estimator
     gradients through the quantizer) and shows the loss is finite and
     moving — the training loop a real int8 distill runs.

Equivalent CLI:
    python -m nerf_rs_tpu_torch render --impl int8 -o int8.png
    python -m nerf_rs_tpu_torch train --impl int8qat --width 128 --v-width 64
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-rays", type=int, default=128)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    import numpy as np

    from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    params_c = as_module(load_nerf_params(assets / "coarse"), device)
    params_f = as_module(load_nerf_params(assets / "fine"), device)
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    key = random.key(0, device)
    s = args.size

    base = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)
    exact = render_image(params_c, params_f, camera, s, s, key,
                         base.replace(impl="xla")).cpu().numpy()
    quant = render_image(params_c, params_f, camera, s, s, key,
                         base.replace(impl="int8")).cpu().numpy()
    mse = float(np.mean((exact - quant) ** 2))
    print(f"PTQ int8 vs f32 exact at {s}x{s}: "
          f"{-10 * np.log10(max(mse, 1e-12)):.1f} dB PSNR")

    # --- QAT: a few STE steps on a small student -------------------------
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.train import create_train_state, train_step

    cfg = TrainConfig(
        batch_rays=args.batch_rays, n_steps=args.steps,
        arch=ArchConfig(width=64, v_width=32, depth=4, skip_at=2),
        render=RenderConfig(n_coarse=8, n_fine=16,
                            ray_chunk=args.batch_rays, impl="int8qat"),
    )
    state = create_train_state(torch.Generator(device).manual_seed(0), cfg)
    teacher = {"coarse": params_c, "fine": params_f}
    small = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=args.batch_rays)
    ds = DistillationDataset(teacher, cfg=small, device=device)
    for i, batch in zip(range(args.steps), ds.batches(cfg.batch_rays)):
        state, metrics = train_step(state, batch, random.fold_in(key, torch.tensor(i)), cfg)
        print(f"QAT step {i}: loss {float(metrics['loss']):.5f} "
              f"psnr {float(metrics['psnr']):.2f}")
    print("QAT forward trains through the quantizer; a full distill "
          "serves losslessly under --impl int8.")


if __name__ == "__main__":
    main()
