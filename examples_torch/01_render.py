"""Render the pretrained lego scene to a PNG (and optionally PPM).

The minimal end-to-end path: weights -> camera -> render_image -> file,
the reference's native CLI run. ``--impl pallas`` runs the field network
through the port's hand-written CUDA kernel (K1, ``fused_mlp_f32tc.cu``
in float32, ``fused_mlp_tc.cu`` with ``--dtype bfloat16``); the default
``--impl xla`` is the plain PyTorch MLP. Runs on the CUDA card unless
``--cpu`` is given.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default="lego.png")
    ap.add_argument("--ppm", default=None, help="also write a PPM here")
    ap.add_argument("--impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import save_png, save_ppm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    cfg = RenderConfig(impl=args.impl, dtype=args.dtype, ray_chunk=8192)

    img = render_image(
        load_nerf_params(assets / "coarse"), load_nerf_params(assets / "fine"),
        camera, args.size, args.size, random.key(0, device), cfg,
    )
    img = img.cpu().numpy()
    save_png(args.out, img, args.size, args.size)
    print(f"wrote {args.out} ({args.size}x{args.size}, impl={args.impl}, on {device.type})")
    if args.ppm:
        save_ppm(args.ppm, img, args.size, args.size)
        print(f"wrote {args.ppm}")


if __name__ == "__main__":
    main()
