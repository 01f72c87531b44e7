"""Single-pass serving: the vendored student behind the serving presets.

The reference renders every frame hierarchically — a coarse pass, an
importance resample, and a fine pass over the merged samples. This package
also serves a SINGLE-PASS preset: a student fine-tuned so that 64
probe-placed samples integrate the scene in one MLP sweep (no resample, no
second network pass):

  1. an occupancy grid built from the student's own field,
  2. per-ray sample ranges refined to each ray's occupied run
     (stride-subsampled probes, conservatively pooled),
  3. background rays culled before any MLP work,
  4. one fused-kernel pass over 64 samples/ray.

The vendored artifact is assets/trained/student128_sp29 (width 128,
v_width 64), fine-tuned with the placement-aware recipe in
assets/trained/README.md. On the card the grid's sweep and the frame run
the port's K1 kernel in bfloat16 on the tensor cores
(``ops/kernels/csrc/fused_mlp_tc.cu``); with ``--cpu`` the frame runs the
plain float32 MLP, as the JAX script does off the TPU. The frame time is
printed beside the card's name and power limit; ``chip_smoke.py`` phase 28
measures this preset at 800x800 and holds its PSNR against the teacher.

Equivalent CLI (box placement; the ``evaluate`` line adds the 128-probe
placement and the PSNR against the teacher):
  python -m nerf_rs_tpu_torch render --weights assets/trained/student128_sp29 \\
      --coarse-samples 64 --fine-samples 0 --dtype bfloat16 \\
      --accel --accel-aabb --accel-compact off --accel-cull-rays
  python -m nerf_rs_tpu_torch evaluate --weights-dir assets/trained/student128_sp29 \\
      --coarse-samples 64 --fine-samples 0 --ref-samples 64,128 --accel-probes 128
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--accel-res", type=int, default=64)
    ap.add_argument("-o", "--output", default="single_pass.png")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import save_png
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image
    from nerf_rs_tpu_torch.utils.profiling import device_label

    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    student = _os.path.join(repo, "assets", "trained", "student128_sp29")
    if not _os.path.isdir(student):
        print(f"vendored single-pass student not found at {student}")
        return
    pc = as_module(load_nerf_params(_os.path.join(student, "coarse")), device)
    pf = as_module(load_nerf_params(_os.path.join(student, "fine")), device)
    camera = camera_from_golden(
        load_golden(find_lego_assets() / "tf_reference_samples.json"))

    # The grid comes from the student's own field — serving needs no
    # access to the teacher at all.
    grid = build_scene_grid(pc, pf, resolution=args.accel_res)
    occ = float(grid.occ.to(torch.float32).mean())
    print(f"occupancy grid {args.accel_res}^3: {occ:.1%} occupied")

    on_card = device.type == "cuda"
    cfg = RenderConfig(
        n_coarse=args.samples, n_fine=0,            # single pass
        impl="pallas" if on_card else "xla",
        dtype="bfloat16" if on_card else "float32",
        ray_chunk=min(16384, args.size * args.size),
        accel_compact="off",                        # placement/cull only
        accel_sample_aabb=True, accel_aabb_probes=128,
        accel_range_stride=4, accel_cull_rays=True,
    )
    key = random.key(0, device)
    render_image(pc, pf, camera, args.size, args.size, key, cfg, grid=grid).cpu()
    t0 = time.perf_counter()
    img = render_image(pc, pf, camera, args.size, args.size,
                       random.fold_in(key, torch.tensor(1)), cfg, grid=grid)
    arr = img.cpu().numpy()                         # waits for the frame
    dt = time.perf_counter() - t0
    rays = args.size * args.size
    print(f"{args.size}x{args.size} single-pass {args.samples} samples: "
          f"{dt * 1e3:.0f} ms -> {rays / dt / 1e3:.0f} K rays/s on {device_label(device)}")
    save_png(args.output, arr, args.size, args.size)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
