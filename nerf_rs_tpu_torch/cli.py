"""Command-line front-end of the PyTorch port.

    python -m nerf_rs_tpu_torch render --device cuda --width 256 --height 256 -o out.ppm

Only ``render`` is ported so far; the other subcommands of the JAX
package's CLI are ROADMAP queue 1, item 10.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def cmd_render(args) -> int:
    import torch

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import save_png, save_ppm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    assets = Path(args.weights) if args.weights else find_lego_assets()
    if assets is None:
        sys.exit("error: no weight assets found (set --weights or $NERF_RS_TPU_ASSETS)")
    camera_json = Path(args.camera) if args.camera else assets / "tf_reference_samples.json"
    if not camera_json.exists():
        sys.exit(f"error: {camera_json} not found — pass --camera <json>")
    device = torch.device(args.device)
    coarse = load_nerf_params(assets / "coarse")
    fine = load_nerf_params(assets / "fine")
    camera = camera_from_golden(load_golden(camera_json))
    cfg = RenderConfig(n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                       ray_chunk=args.ray_chunk, impl=args.impl, dtype=args.dtype)
    print(f"Rendering {args.width}x{args.height} with {cfg.n_coarse} coarse and "
          f"{cfg.n_fine} fine samples per ray ({cfg.impl}/{cfg.dtype} on {device})")
    t0 = time.perf_counter()
    img = render_image(coarse, fine, camera, args.height, args.width,
                       random.key(args.seed, device), cfg, device=device).cpu().numpy()
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if out.suffix.lower() == ".ppm":
        save_ppm(out, img, args.height, args.width)
    else:
        save_png(out, img, args.height, args.width)
    print(f"Wrote {out}")
    rays = args.width * args.height
    print(f"Rendering completed in {dt:.2f} seconds ({rays / dt:,.0f} rays/s, "
          f"includes the kernel build on first use)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nerf_rs_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("render", help="render an image")
    p.add_argument("--weights", "--weights-dir", dest="weights",
                   help="weight directory with coarse/ and fine/ (default: auto-discover)")
    p.add_argument("--camera", help="camera JSON (default: the weight directory's golden JSON)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on, e.g. cuda, cuda:1 or cpu")
    p.add_argument("--impl", default="pallas", choices=["xla", "pallas"],
                   help="MLP: 'pallas' = the fused CUDA kernel, 'xla' = plain PyTorch")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--coarse-samples", type=int, default=64)
    p.add_argument("--fine-samples", type=int, default=128)
    p.add_argument("--ray-chunk", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("-o", "--output", default="output.ppm")
    p.set_defaults(fn=cmd_render)
    args = parser.parse_args(argv)
    return args.fn(args)
