"""Turntable sweep: render N novel views orbiting the lego scene.

The networks are moved to the device (and, with ``--impl pallas``, packed
for the kernel) once, and every frame reuses them; only the camera
changes, which is how an interactive viewer serves a moving camera.
Frames are written as frame_000.png... ; stitch them with any tool, e.g.
``ffmpeg -i frame_%03d.png turntable.gif``. The steady-state frame time is
printed beside the card's name and power limit.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--outdir", default="turntable")
    ap.add_argument("--impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    import numpy as np

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import save_png
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.rays import orbit_camera
    from nerf_rs_tpu_torch.render import render_image
    from nerf_rs_tpu_torch.utils.profiling import device_label

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    params = {net: as_module(load_nerf_params(assets / net), device)
              for net in ("coarse", "fine")}
    base = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    cfg = RenderConfig(n_coarse=32, n_fine=64, ray_chunk=args.size ** 2,
                       impl=args.impl)

    _os.makedirs(args.outdir, exist_ok=True)
    t0 = None
    for i in range(args.frames):
        cam = orbit_camera(base, 2.0 * np.pi * i / args.frames)
        img = render_image(params["coarse"], params["fine"], cam,
                           args.size, args.size, random.key(0, device), cfg).cpu().numpy()
        path = _os.path.join(args.outdir, f"frame_{i:03d}.png")
        save_png(path, img, args.size, args.size)
        if i == 0:
            t0 = time.perf_counter()  # frame 0 pays the first-use costs
            print(f"{path} (first frame)")
        else:
            print(f"{path}")
    if args.frames > 1:
        per = (time.perf_counter() - t0) / (args.frames - 1)
        print(f"{per * 1e3:,.0f} ms/frame steady-state "
              f"({args.size}x{args.size}, {cfg.n_coarse}+{cfg.n_fine} samples, "
              f"impl={args.impl}, PNG write included; {device_label(device)})")


if __name__ == "__main__":
    main()
