"""Command-line front-end of the PyTorch port.

    python -m nerf_rs_tpu_torch render --device cuda --width 256 --height 256 -o out.ppm
    python -m nerf_rs_tpu_torch render --accel --sampling-impl pallas --device cuda
    python -m nerf_rs_tpu_torch train --device cuda --impl pallas --steps 20
    python -m nerf_rs_tpu_torch train --device cuda --model hashgrid --steps 300

``render`` (with the occupancy-grid flags and the depth and opacity maps)
and ``train`` (distillation from the pretrained lego networks, of an MLP
student or a hash-grid field) are ported;
the viewer is ``python -m nerf_rs_tpu_torch.serve``. The other
subcommands of the JAX package's CLI, and render's ``--orbit``,
``--checkpoint``, ``--sharded`` and ``--trace-dir``, are ROADMAP queue 1,
items 10 and 11.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def _build_accel(args, cfg, params, camera, device):
    """The occupancy grid and the accel config of ``render --accel``:
    capacities for the compaction modes from the camera's geometry, or
    measured by one render (``--accel-calibrate``, and always with
    ``--accel-aabb``)."""
    import torch

    from nerf_rs_tpu_torch.accel import build_scene_grid, calibrate_capacities, suggest_capacities
    from nerf_rs_tpu_torch.ops import random

    t0 = time.perf_counter()
    cfg = cfg.replace(accel_compact=args.accel_compact)
    if args.accel_aabb:
        cfg = cfg.replace(accel_sample_aabb=True)
    if args.accel_cull_rays:
        cfg = cfg.replace(accel_cull_rays=True)
    grid = build_scene_grid(params["coarse"], params["fine"], resolution=args.accel_res,
                            device=device)
    note = ("packing/placement only (no per-sample culling)" if cfg.accel_compact == "off"
            else "mask-only (no capacities)")
    if cfg.accel_compact not in ("none", "off"):
        if args.accel_calibrate or cfg.accel_sample_aabb:
            # Box placement concentrates samples in occupied cells, which the
            # geometry-only suggestion undershoots: measure instead.
            cfg = calibrate_capacities(params["coarse"], params["fine"], grid, camera,
                                       args.height, args.width, random.key(args.seed, device),
                                       cfg)
        else:
            cfg = suggest_capacities(grid, camera, args.height, args.width, cfg)
        note = f"capacities {cfg.accel_coarse_capacity:.2f}/{cfg.accel_fine_capacity:.2f}"
    frac = float(grid.occ.to(torch.float32).mean())
    print(f"occupancy grid {args.accel_res}^3 built in {time.perf_counter() - t0:.2f}s "
          f"({100 * frac:.1f}% occupied; {note})")
    return cfg, grid


def cmd_render(args) -> int:
    import numpy as np
    import torch

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import save_png, save_ppm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_scene_assets
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image, render_image_aux

    assets = Path(args.weights) if args.weights else find_lego_assets()
    if assets is None:
        sys.exit("error: no weight assets found (set --weights or $NERF_RS_TPU_ASSETS)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"error: --device {args.device} but torch.cuda.is_available() is false")
    trees, golden = load_scene_assets(assets)
    if args.camera:
        golden = load_golden(Path(args.camera))
    camera = camera_from_golden(golden)
    params = {net: as_module(trees[net], device) for net in ("coarse", "fine")}
    cfg = RenderConfig(n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                       ray_chunk=args.ray_chunk, impl=args.impl, dtype=args.dtype,
                       sampling_impl=args.sampling_impl)
    print(f"Rendering {args.width}x{args.height} with {cfg.n_coarse} coarse and "
          f"{cfg.n_fine} fine samples per ray ({cfg.impl}/{cfg.dtype}, sampling "
          f"{cfg.sampling_impl}, on {device})")
    if args.accel_aabb and not args.accel:
        print("note: --accel-aabb implies --accel")
        args.accel = True
    grid = None
    if args.accel:
        cfg, grid = _build_accel(args, cfg, params, camera, device)

    def save(path, img):
        path = Path(path)
        if path.suffix.lower() == ".ppm":
            save_ppm(path, img, args.height, args.width)
        else:
            save_png(path, img, args.height, args.width)
        print(f"Wrote {path}")

    key = random.key(args.seed, device)
    t0 = time.perf_counter()
    if args.depth_output or args.acc_output:
        rgb, depth, acc = (x.cpu().numpy() for x in render_image_aux(
            params["coarse"], params["fine"], camera, args.height, args.width, key, cfg,
            device=device, grid=grid))
        if args.depth_output:
            # Depth normalized to [near, far], near = white.
            d = (depth - camera.near) / (camera.far - camera.near)
            save(args.depth_output, np.repeat(1.0 - np.clip(d, 0, 1)[..., None], 3, -1))
        if args.acc_output:
            save(args.acc_output, np.repeat(np.clip(acc, 0, 1)[..., None], 3, -1))
    else:
        rgb = render_image(params["coarse"], params["fine"], camera, args.height, args.width,
                           key, cfg, device=device, grid=grid).cpu().numpy()
    dt = time.perf_counter() - t0
    save(args.output, rgb)
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
        (args.impl in ("int8", "int8qat"), f"--impl {args.impl}", 12),
    ]
    for hit, what, item in refused:
        if hit:
            sys.exit(f"error: {what} is not ported yet (ROADMAP item {item})")


def cmd_train(args) -> int:
    import torch

    from nerf_rs_tpu_torch.config import ArchConfig, HashGridConfig, RenderConfig, TrainConfig
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
    if args.model == "hashgrid":
        # One field for both passes; the paper's recipe: a higher lr and a
        # tiny Adam eps (table gradients are minute under the default).
        hcfg = HashGridConfig(levels=args.hash_levels, table_log2=args.hash_table_log2,
                              res_max=args.hash_res_max, features=args.hash_features,
                              aabb=(-args.hash_extent, args.hash_extent))
        lr = args.lr if args.lr is not None else 1e-2
        cfg = cfg.replace(lr_init=lr, lr_final=lr * 1e-2, adam_eps=1e-15,
                          render=render_cfg.replace(model="hashgrid", hash=hcfg))
    elif args.lr is not None:
        cfg = cfg.replace(lr_init=args.lr, lr_final=min(cfg.lr_final, args.lr))
    state = create_train_state(torch.Generator(device=device).manual_seed(cfg.seed), cfg)
    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")

    teacher = {net: load_nerf_params(assets / net) for net in ("coarse", "fine")}
    # The teacher is the lego MLP on --impl, whatever the student's family.
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
    p.add_argument("--sampling-impl", default="xla", choices=["xla", "pallas"],
                   help="resampling chain: 'pallas' = the fused CUDA kernel, 'xla' = plain "
                        "PyTorch")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--coarse-samples", type=int, default=64)
    p.add_argument("--fine-samples", type=int, default=128)
    p.add_argument("--ray-chunk", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("-o", "--output", default="output.ppm")
    p.add_argument("--accel", action="store_true",
                   help="occupancy-grid empty-space skipping (fast mode)")
    p.add_argument("--accel-res", type=int, default=128,
                   help="occupancy grid resolution per axis")
    p.add_argument("--accel-calibrate", action="store_true",
                   help="measure capacities with one instrumented render "
                        "(tighter than the default geometry estimate)")
    p.add_argument("--accel-aabb", action="store_true",
                   help="clamp each ray's sample range to the occupied-box intersection "
                        "(same sample count, denser on the object; implies --accel-calibrate)")
    p.add_argument("--accel-compact", default="none",
                   choices=("off", "none", "scatter", "gather"),
                   help="per-sample culling: 'off' (grid steers ray packing + placement "
                        "only; rendered rays stay exact), 'none' (mask-only: dense eval, "
                        "zeroed sigma), or fixed-capacity compaction")
    p.add_argument("--accel-cull-rays", action="store_true",
                   help="pack away rays that miss the occupied cells and composite them "
                        "to background without rendering")
    p.add_argument("--depth-output",
                   help="also write the depth map (expected t, near = white) as PNG/PPM here")
    p.add_argument("--acc-output", help="also write the accumulated-opacity map here")
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
    p.add_argument("--model", default="mlp", choices=["mlp", "hashgrid"],
                   help="student family: the reference MLP and its ArchConfig students, or "
                        "the multiresolution hash grid (one field for both passes)")
    p.add_argument("--lr", type=float, default=None,
                   help="initial learning rate (default 5e-4 for mlp, 1e-2 for hashgrid)")
    p.add_argument("--hash-levels", type=int, default=16, help="hashgrid: resolution levels")
    p.add_argument("--hash-table-log2", type=int, default=17,
                   help="hashgrid: log2 of the table rows per level")
    p.add_argument("--hash-res-max", type=int, default=1024,
                   help="hashgrid: finest grid resolution")
    p.add_argument("--hash-features", type=int, default=2,
                   help="hashgrid: feature channels per table row")
    p.add_argument("--hash-extent", type=float, default=2.0,
                   help="hashgrid: scene AABB half-width (+-extent)")
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
