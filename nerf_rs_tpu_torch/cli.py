"""Command-line front-end of the PyTorch port.

    python -m nerf_rs_tpu_torch render --device cuda --width 256 --height 256 -o out.ppm
    python -m nerf_rs_tpu_torch train --device cuda --impl pallas --steps 20

``render`` and ``train`` (distillation from the pretrained lego networks)
are ported; the other subcommands of the JAX package's CLI are ROADMAP
queue 1, item 10.
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


_ACCEL_FLAGS = ("every", "res", "warmup", "explore", "probes", "pad")


def _refuse_unported(args) -> None:
    """Exit non-zero, naming the ROADMAP item, for train flags the port
    does not serve yet."""
    refused = [
        (args.data is not None, "--data (the nerf_synthetic dataset)", 10),
        (args.checkpoint_dir is not None, "--checkpoint-dir", 10),
        (args.init_weights is not None, "--init-weights", 10),
        (args.accel_aabb or any(getattr(args, f"accel_{f}") is not None for f in _ACCEL_FLAGS),
         "--accel-* (occupancy-culled training)", 7),
        (args.model == "hashgrid", "--model hashgrid", 12),
        (args.impl in ("int8", "int8qat"), f"--impl {args.impl}", 12),
    ]
    for hit, what, item in refused:
        if hit:
            sys.exit(f"error: {what} is not ported yet (ROADMAP item {item})")


def cmd_train(args) -> int:
    import torch

    from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state, train_step

    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"error: --device {args.device} but torch.cuda.is_available() is false")
    assets = Path(args.weights) if args.weights else find_lego_assets()
    if assets is None:
        sys.exit("error: no weight assets found (set --weights or $NERF_RS_TPU_ASSETS)")
    arch = ArchConfig(width=args.width, v_width=args.v_width, depth=args.depth,
                      skip_at=args.skip_at)
    render_cfg = RenderConfig(n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                              ray_chunk=args.batch_rays, impl=args.impl, dtype=args.dtype)
    cfg = TrainConfig(batch_rays=args.batch_rays, n_steps=args.steps, seed=args.seed,
                      arch=arch, render=render_cfg)
    if args.lr is not None:
        cfg = cfg.replace(lr_init=args.lr, lr_final=min(cfg.lr_final, args.lr))
    state = create_train_state(torch.Generator(device=device).manual_seed(cfg.seed), cfg)
    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")

    teacher = {net: load_nerf_params(assets / net) for net in ("coarse", "fine")}
    teacher_cfg = render_cfg
    if args.teacher_samples:
        tc, tf = (int(v) for v in args.teacher_samples.split(","))
        teacher_cfg = teacher_cfg.replace(n_coarse=tc, n_fine=tf)
    dataset = DistillationDataset(teacher, cfg=teacher_cfg, seed=cfg.seed, device=device)
    print("no --data given: distilling from the pretrained lego networks"
          + (f" (teacher targets at {teacher_cfg.n_coarse}+{teacher_cfg.n_fine} samples)"
             if args.teacher_samples else ""))

    key = random.key(cfg.seed + 1, device)
    t0 = time.perf_counter()
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    for step, batch in enumerate(batches):
        if step >= cfg.n_steps:
            break
        state, metrics = train_step(state, batch, random.fold_in(key, torch.tensor(step)), cfg)
        if step % args.log_every == 0 or step + 1 == cfg.n_steps:
            m = {k: float(v) for k, v in metrics.items()}
            rays_s = cfg.batch_rays * (step + 1) / (time.perf_counter() - t0)
            print(f"step {step}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                  f"({rays_s:,.0f} rays/s fwd+bwd)", flush=True)
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

    p = sub.add_parser("train", help="train coarse+fine networks, distilling from the "
                                     "pretrained lego networks")
    p.add_argument("--weights", "--weights-dir", dest="weights",
                   help="teacher weight directory with coarse/ and fine/ (default: auto-discover)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on, e.g. cuda, cuda:1 or cpu")
    p.add_argument("--impl", default="pallas", choices=["xla", "pallas", "int8", "int8qat"],
                   help="MLP: 'pallas' = the fused CUDA kernels, 'xla' = plain PyTorch")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--model", default="mlp", choices=["mlp", "hashgrid"])
    p.add_argument("--lr", type=float, default=None, help="initial learning rate (default 5e-4)")
    p.add_argument("--width", type=int, default=256, help="trunk width")
    p.add_argument("--v-width", type=int, default=128, help="view-branch width")
    p.add_argument("--depth", type=int, default=8, help="dense trunk layers")
    p.add_argument("--skip-at", type=int, default=4,
                   help="encoded input re-concatenated before dense{skip_at+1}")
    p.add_argument("--coarse-samples", type=int, default=64)
    p.add_argument("--fine-samples", type=int, default=128)
    p.add_argument("--teacher-samples", metavar="NC,NF",
                   help="render the teacher targets at these sample counts instead of "
                        "the student's")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-rays", type=int, default=4096)
    p.add_argument("--log-every", type=int, default=20)
    # Accepted so that they can be refused by name (_refuse_unported).
    p.add_argument("--data")
    p.add_argument("--checkpoint-dir")
    p.add_argument("--init-weights")
    for flag in _ACCEL_FLAGS:
        p.add_argument(f"--accel-{flag}", type=float)
    p.add_argument("--accel-aabb", action="store_true")
    p.set_defaults(fn=cmd_train)
    args = parser.parse_args(argv)
    return args.fn(args)
