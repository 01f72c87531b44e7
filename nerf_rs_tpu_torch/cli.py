"""Command-line front-end of the PyTorch port.

    python -m nerf_rs_tpu_torch render --width 256 --height 256 -o out.ppm
    python -m nerf_rs_tpu_torch render --accel --sampling-impl pallas
    python -m nerf_rs_tpu_torch render --orbit 36 --trace-dir trace/ -o turn.png
    python -m nerf_rs_tpu_torch train --steps 20
    python -m nerf_rs_tpu_torch train --data lego/ --checkpoint-dir ck --steps 5000
    python -m nerf_rs_tpu_torch train --init-weights assets/lego_rust --fine-samples 0 \
        --teacher-samples 64,128 --accel-every 25 --accel-aabb --accel-probes 128
    python -m nerf_rs_tpu_torch train --model hashgrid --steps 300
    python -m nerf_rs_tpu_torch train --impl int8qat --steps 50
    python -m nerf_rs_tpu_torch render --checkpoint ck/step_00005000 -o trained.ppm
    python -m nerf_rs_tpu_torch evaluate --checkpoint-dir ck
    python -m nerf_rs_tpu_torch verify --image
    python -m nerf_rs_tpu_torch extract -o lego.ply
    python -m nerf_rs_tpu_torch export --checkpoint ck/step_00005000 -o weights/
    python -m nerf_rs_tpu_torch pack -o scene.npz
    python -m nerf_rs_tpu_torch serve --checkpoint ck/step_00005000
    python -m nerf_rs_tpu_torch info
    python -m torch.distributed.run --nproc-per-node 8 -m nerf_rs_tpu_torch train
    python -m torch.distributed.run --nproc-per-node 8 -m nerf_rs_tpu_torch render --sharded

Every subcommand runs on the CUDA card unless ``--device cpu`` is given.
``render`` takes the occupancy-grid flags, the depth and opacity maps,
turntable frames (``--orbit``), a ``torch.profiler`` trace
(``--trace-dir``), the W8A8 ``--impl int8`` / ``int8qat`` and a training
checkpoint of any family. ``train`` distills from the pretrained lego
networks, or learns a nerf_synthetic scene (``--data``); it writes
checkpoints in the port's own format (``io/checkpoint.py``), resumes from
them, stops cleanly on SIGTERM or SIGINT, can start from exported weights
(``--init-weights``), and culls and places its samples by an occupancy grid
it rebuilds from the student (``--accel-*``). ``verify`` checks the
networks against the golden samples and frames, ``extract`` writes the
field's iso-surface as a PLY mesh.

Launched by torchrun (``python -m torch.distributed.run``), one process a
device, ``train`` takes every step as a data-parallel step over the ranks
(``parallel/train_sharded.py``; NCCL between cards, gloo with ``--device
cpu``) and ``render --sharded`` splits each frame's rays over them
(``parallel/render_sharded.py``); only rank 0 prints and writes files.
Without torchrun both run as a world of 1. Not ported: ``benchmark``,
which wraps the repository's ``bench.py`` (ROADMAP item 8).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from pathlib import Path


def _build_accel(args, cfg, params, camera, device, chunk=None):
    """The occupancy grid and the accel config of ``render --accel``:
    capacities for the compaction modes from the camera's geometry, or
    measured by one render (``--accel-calibrate``, and always with
    ``--accel-aabb``), for the render's chunks (``chunk``: the sharded
    render's; default the single-device render's)."""
    import torch

    from nerf_rs_tpu_torch.accel import (
        build_scene_grid,
        calibrate_capacities,
        hashgrid_grid_kwargs,
        suggest_capacities,
    )
    from nerf_rs_tpu_torch.ops import random

    t0 = time.perf_counter()
    cfg = cfg.replace(accel_compact=args.accel_compact)
    if args.accel_aabb:
        cfg = cfg.replace(accel_sample_aabb=True)
    if args.accel_cull_rays:
        cfg = cfg.replace(accel_cull_rays=True)
    grid_kw = hashgrid_grid_kwargs(cfg) if cfg.model == "hashgrid" else {}
    grid = build_scene_grid(params["coarse"], params["fine"], resolution=args.accel_res,
                            device=device, **grid_kw)
    note = ("packing/placement only (no per-sample culling)" if cfg.accel_compact == "off"
            else "mask-only (no capacities)")
    if cfg.accel_compact not in ("none", "off"):
        if args.accel_calibrate or cfg.accel_sample_aabb:
            # Box placement concentrates samples in occupied cells, which the
            # geometry-only suggestion undershoots: measure instead.
            cfg = calibrate_capacities(params["coarse"], params["fine"], grid, camera,
                                       args.height, args.width, random.key(args.seed, device),
                                       cfg, chunk=chunk)
        else:
            cfg = suggest_capacities(grid, camera, args.height, args.width, cfg, chunk=chunk)
        note = f"capacities {cfg.accel_coarse_capacity:.2f}/{cfg.accel_fine_capacity:.2f}"
    frac = float(grid.occ.to(torch.float32).mean())
    print(f"occupancy grid {args.accel_res}^3 built in {time.perf_counter() - t0:.2f}s "
          f"({100 * frac:.1f}% occupied; {note})")
    return cfg, grid


def _impl_for_params(cfg, width: int, v_width: int, depth: int):
    """The front ends' check (render, evaluate, verify, extract): the
    forward kernel K1 serves the network, or ``impl="pallas"`` runs the
    plain MLP instead, with a note, as the JAX CLI does. ``impl="int8"``
    for a network beyond the int8 kernel's envelope renders the same
    real-int8 arithmetic without the kernel on the card
    (``render.get_mlp_fn`` picks it per network), with a note."""
    from nerf_rs_tpu_torch.ops.kernels import int8_mlp
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import MAX_DEPTH, MAX_WIDTH, supports_dims

    if cfg.impl == "pallas" and not supports_dims(width, v_width, depth):
        print(f"note: the network is outside the fused kernels' range (width, v_width <= "
              f"{MAX_WIDTH}, depth <= {MAX_DEPTH}) — running impl='xla'")
        return cfg.replace(impl="xla")
    if cfg.impl == "int8" and not int8_mlp.supports_dims(width, v_width, depth):
        print(f"note: the network is outside the int8 kernel's range (width, v_width <= "
              f"{int8_mlp.INT8_MAX_WIDTH}, depth <= {int8_mlp.INT8_MAX_DEPTH}) — running the "
              "plain int8 MLP (models.quant.int8_nerf_mlp)")
    return cfg


def _train_impl_for_params(cfg, width: int, v_width: int, depth: int):
    """The training check: ``impl="pallas"`` trains through the fused
    backward K2, whose envelope is K1's (width 1024, depth 32); a student
    beyond it trains on the plain MLP, with a note."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        MAX_DEPTH,
        MAX_WIDTH,
        supports_backward_dims,
    )

    if cfg.impl == "pallas" and not supports_backward_dims(width, v_width, depth):
        print(f"note: the network is outside the fused kernels' range for training (the "
              f"fused backward K2 serves width, v_width <= {MAX_WIDTH}, depth <= "
              f"{MAX_DEPTH}) — running impl='xla'")
        return cfg.replace(impl="xla")
    return cfg


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"error: --device {name} but torch.cuda.is_available() is false")
    return device


@contextlib.contextmanager
def _world(device):
    """The data-parallel world of a run launched by torchrun, else a world
    of 1 on ``device``: joins it (``parallel.multihost.initialize``),
    keeps standard output to rank 0, and leaves it at the end. Yields the
    ``parallel.Mesh``."""
    from nerf_rs_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(device=device)
    try:
        mesh = make_mesh(device)
        with contextlib.ExitStack() as stack:
            if mesh.rank != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            yield mesh
    finally:
        multihost.shutdown()


def _load_scene(args):
    """(param trees, camera, golden JSON) of ``--weights`` (default: the
    lego assets): a weight directory with its golden JSON or an ``.npz``
    bundle, or a bare export (``coarse/`` + ``fine/``, as ``export``
    writes), whose camera comes from ``--camera``, else from the lego
    assets."""
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params, load_scene_assets

    assets = Path(args.weights) if getattr(args, "weights", None) else find_lego_assets()
    if assets is None:
        sys.exit("error: no weight assets found (set --weights or $NERF_RS_TPU_ASSETS)")
    camera_json = getattr(args, "camera", None)
    try:
        trees, golden = load_scene_assets(assets)
    except FileNotFoundError:
        trees = {net: load_nerf_params(assets / net) for net in ("coarse", "fine")}
        if not camera_json:
            camera_json = (find_lego_assets() or assets) / "tf_reference_samples.json"
            if not Path(camera_json).exists():
                sys.exit(f"error: {assets} has no tf_reference_samples.json — pass --camera <json>")
    if camera_json:
        golden = load_golden(Path(camera_json))
    return trees, camera_from_golden(golden), golden


def _restore_params(path):
    """``io.checkpoint.restore_params``, exiting with its message where
    ``path`` is no checkpoint of the port (an orbax one among them)."""
    from nerf_rs_tpu_torch.io.checkpoint import restore_params

    try:
        return restore_params(path)
    except (FileNotFoundError, ValueError) as e:
        sys.exit(f"error: {e}")


def _checkpoint_networks(params, path, cfg, device, hint: str = ""):
    """``io.checkpoint.checkpoint_networks``, exiting with its message
    (and ``hint``) where a hash-grid checkpoint has no sidecar; an MLP
    student the kernels do not serve runs ``impl="xla"`` with a note."""
    from nerf_rs_tpu_torch.io.checkpoint import checkpoint_networks
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import infer_arch

    try:
        coarse, fine, cfg = checkpoint_networks(params, path, cfg, device)
    except FileNotFoundError as e:
        sys.exit(f"error: {e}{hint}")
    if cfg.model == "mlp":
        cfg = _impl_for_params(cfg, *infer_arch(params["coarse"])[:3])
    return coarse, fine, cfg


def cmd_render(args) -> int:
    if not args.sharded:
        return _render(args, _device(args.device), None)
    with _world(_device(args.device)) as mesh:
        return _render(args, mesh.device, mesh)


def _render(args, device, mesh) -> int:
    """``render`` on ``device``, or with its rays split over ``mesh``'s
    ranks (``--sharded``), where only rank 0 writes the files."""
    import numpy as np

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.image import save_png, save_ppm
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import infer_arch
    from nerf_rs_tpu_torch.ops.rays import orbit_camera
    from nerf_rs_tpu_torch.render import render_image, render_image_aux
    from nerf_rs_tpu_torch.utils.profiling import device_trace

    trees, camera, _ = _load_scene(args)
    cfg = RenderConfig(n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                       ray_chunk=args.ray_chunk, impl=args.impl, dtype=args.dtype,
                       sampling_impl=args.sampling_impl)
    if args.checkpoint:
        # A trained checkpoint of any family; the camera stays the scene's.
        ckpt, step = _restore_params(args.checkpoint)
        coarse, fine, cfg = _checkpoint_networks(ckpt, args.checkpoint, cfg, device)
        params = {"coarse": coarse, "fine": fine}
        print(f"rendering checkpoint {args.checkpoint} (step {step})")
    else:
        params = {net: as_module(trees[net], device) for net in ("coarse", "fine")}
        cfg = _impl_for_params(cfg, *infer_arch(trees["coarse"])[:3])
    label = cfg.impl if cfg.model == "mlp" else cfg.model
    print(f"Rendering {args.width}x{args.height} with {cfg.n_coarse} coarse and "
          f"{cfg.n_fine} fine samples per ray ({label}/{cfg.dtype}, sampling "
          f"{cfg.sampling_impl}, on {device}"
          + (f", rays split over {mesh.size} rank(s))" if mesh else ")"))
    if args.accel_aabb and not args.accel:
        print("note: --accel-aabb implies --accel")
        args.accel = True
    grid = None
    if args.accel:
        chunk = None
        if mesh:
            from nerf_rs_tpu_torch.parallel.render_sharded import effective_chunk

            chunk = effective_chunk(args.height * args.width, mesh.size, cfg)
        cfg, grid = _build_accel(args, cfg, params, camera, device, chunk)
    if mesh:
        from nerf_rs_tpu_torch.parallel.render_sharded import (
            render_image_aux_sharded,
            render_image_sharded,
        )

        def render_rgb(*a):
            return render_image_sharded(*a, mesh=mesh, grid=grid)

        def render_aux(*a):
            return render_image_aux_sharded(*a, mesh=mesh, grid=grid)
    else:
        def render_rgb(*a):
            return render_image(*a, device=device, grid=grid)

        def render_aux(*a):
            return render_image_aux(*a, device=device, grid=grid)
    writer = mesh is None or mesh.rank == 0

    def save(path, img):
        if not writer:
            return
        path = Path(path)
        if path.suffix.lower() == ".ppm":
            save_ppm(path, img, args.height, args.width)
        else:
            save_png(path, img, args.height, args.width)
        print(f"Wrote {path}")

    # --orbit N: N turntable frames about the scene's z-axis, named
    # <stem>_000..; the capacities stay those tuned on the base view (the
    # orbit keeps the camera's distance).
    n_frames = max(1, args.orbit)

    def frame_path(base, fi):
        p = Path(base)
        return p if n_frames == 1 else p.with_name(f"{p.stem}_{fi:03d}{p.suffix}")

    t0 = time.perf_counter()
    with device_trace(args.trace_dir if writer else None):
        for fi in range(n_frames):
            cam_i = camera if n_frames == 1 else orbit_camera(camera, 2.0 * np.pi * fi / n_frames)
            key = random.key(args.seed, device)
            if args.depth_output or args.acc_output:
                rgb, depth, acc = (x.cpu().numpy() for x in render_aux(
                    params["coarse"], params["fine"], cam_i, args.height, args.width, key, cfg))
                if args.depth_output:
                    # Depth normalized to [near, far], near = white.
                    d = (depth - camera.near) / (camera.far - camera.near)
                    save(frame_path(args.depth_output, fi),
                         np.repeat(1.0 - np.clip(d, 0, 1)[..., None], 3, -1))
                if args.acc_output:
                    save(frame_path(args.acc_output, fi),
                         np.repeat(np.clip(acc, 0, 1)[..., None], 3, -1))
            else:
                rgb = render_rgb(params["coarse"], params["fine"], cam_i, args.height,
                                 args.width, key, cfg).cpu().numpy()
            save(frame_path(args.output, fi), rgb)
    dt = time.perf_counter() - t0
    rays = args.width * args.height * n_frames
    print(f"Rendering completed in {dt:.2f} seconds ({rays / dt:,.0f} rays/s, "
          f"includes the kernel build on first use)")
    return 0


def _model_info(args, cfg) -> dict:
    """The ``model.json`` sidecar of a run: the family, and the hash grid's
    hyper-parameters, normalized through JSON (tuples become lists, as in a
    sidecar read back)."""
    import dataclasses
    import json

    info = {"model": args.model}
    if args.model == "hashgrid":
        info["hash"] = dataclasses.asdict(cfg.render.hash)
    return json.loads(json.dumps(info))


def _structural(info):
    """A sidecar without ``grad_impl``: which gradient computes the table's
    does not shape the params, so a change of it must not strand a
    checkpoint directory."""
    import json

    if info is None or "hash" not in info:
        return info
    info = json.loads(json.dumps(info))
    info["hash"].pop("grad_impl", None)
    return info


def _resume(args, arch, want_info, device):
    """The state of the newest checkpoint in ``--checkpoint-dir`` after the
    JAX CLI's guards, read from metadata alone, or None where there is no
    checkpoint yet; exits on a family, sidecar or architecture mismatch."""
    from nerf_rs_tpu_torch.io.checkpoint import (
        checkpoint_kernel_shapes,
        checkpoint_param_keys,
        latest_checkpoint,
        load_model_config,
        restore_checkpoint,
    )
    from nerf_rs_tpu_torch.models.mlp import arch_shapes

    ckpt = latest_checkpoint(args.checkpoint_dir)
    if ckpt is None:
        return None
    try:
        got_keys = checkpoint_param_keys(ckpt)
    except ValueError as e:
        sys.exit(f"error: {e}")
    want_keys = {"shared"} if args.model == "hashgrid" else {"coarse", "fine"}
    if got_keys != want_keys:
        sys.exit(f"error: checkpoint {ckpt} holds params {sorted(got_keys)} but --model "
                 f"{args.model} trains {sorted(want_keys)} — match the --model flag to the "
                 "checkpoint or use a fresh --checkpoint-dir.")
    have_info = load_model_config(Path(args.checkpoint_dir))
    if have_info is not None and _structural(have_info) != _structural(want_info):
        sys.exit(f"error: {args.checkpoint_dir}/model.json holds a different model config "
                 f"than the flags request.\n  checkpoint: {have_info}\n  requested:  "
                 f"{want_info}\nMatch the flags or use a fresh --checkpoint-dir.")
    if args.model != "hashgrid":
        want, got = arch_shapes(arch), checkpoint_kernel_shapes(ckpt)
        if got != want:
            sys.exit(f"error: checkpoint {ckpt} holds a different architecture than the "
                     f"requested --width/--v-width/--depth/--skip-at ({arch}).\n  checkpoint "
                     f"layers: {sorted(got.items())}\n  requested layers:  "
                     f"{sorted(want.items())}\nMatch the flags to the checkpoint or use a fresh "
                     "--checkpoint-dir.")
    state = restore_checkpoint(ckpt, device)
    print(f"resumed from {ckpt} at step {state.step}")
    return state


def _init_weights(args, arch, device):
    """``--init-weights``: a state at step 0 with fresh Adam moments from a
    reference-format directory or an ``.npz`` bundle, both networks checked
    against the requested architecture."""
    from nerf_rs_tpu_torch.io.weights import load_bundle, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import arch_shapes
    from nerf_rs_tpu_torch.train import train_state_from_params

    if args.model == "hashgrid":
        sys.exit("error: --init-weights supports the MLP family only "
                 "(hashgrid checkpoints resume via --checkpoint-dir)")
    iw = Path(args.init_weights)
    if iw.suffix == ".npz":
        trees, _ = load_bundle(iw)
    else:
        trees = {net: load_nerf_params(iw / net) for net in ("coarse", "fine")}
    want = arch_shapes(arch)
    for net in ("fine", "coarse"):
        got = {name: tuple(layer["kernel"].shape) for name, layer in trees[net].items()}
        if got != want:
            sys.exit(f"error: --init-weights {iw} {net}/ holds a different architecture than "
                     f"the requested flags ({arch}).\n  weights layers:   "
                     f"{sorted(got.items())}\n  requested layers: {sorted(want.items())}")
    print(f"initialized params from {iw} (fresh optimizer, step 0)")
    return train_state_from_params(trees, device)


def cmd_train(args) -> int:
    with _world(_device(args.device)) as mesh:
        return _train(args, mesh)


def _train(args, mesh) -> int:
    """``train`` over ``mesh``'s ranks: every rank draws the global batch
    and the data-parallel step keeps its rows; every step is
    ``parallel.train_sharded.sharded_train_step``, which in a world of 1
    without a process group is ``train.train_step``. Rank 0 alone writes
    the checkpoints; a resumed state is read by every rank, then rank 0's
    is broadcast. A stop request (SIGTERM, SIGINT) rides in the step's
    all-reduce and is read after the next step is queued, so that every
    rank stops after the same step without a wait at every step."""
    import signal

    import torch
    import torch.distributed as dist

    from nerf_rs_tpu_torch.accel import field_grid_kwargs
    from nerf_rs_tpu_torch.config import ArchConfig, HashGridConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.io.checkpoint import save_checkpoint, save_model_config
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel import replicate
    from nerf_rs_tpu_torch.parallel.train_sharded import (
        create_sharded_train_state,
        sharded_train_step,
    )
    from nerf_rs_tpu_torch.train import refresh_grid

    device = mesh.device
    writer = mesh.rank == 0
    arch = ArchConfig(width=args.width, v_width=args.v_width, depth=args.depth,
                      skip_at=args.skip_at)
    render_cfg = RenderConfig(n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                              ray_chunk=args.batch_rays, impl=args.impl, dtype=args.dtype)
    cfg = TrainConfig(batch_rays=args.batch_rays, n_steps=args.steps, seed=args.seed,
                      checkpoint_every=args.checkpoint_every, arch=arch, render=render_cfg)
    if args.model == "hashgrid":
        # One field for both passes; the paper's recipe: a higher lr and a
        # tiny Adam eps (table gradients are minute under the default).
        hcfg = HashGridConfig(levels=args.hash_levels, table_log2=args.hash_table_log2,
                              res_max=args.hash_res_max, features=args.hash_features,
                              aabb=(-args.hash_extent, args.hash_extent))
        lr = args.lr if args.lr is not None else 1e-2
        cfg = cfg.replace(lr_init=lr, lr_final=lr * 1e-2, adam_eps=1e-15,
                          render=render_cfg.replace(model="hashgrid", hash=hcfg))
    else:
        if args.impl == "int8":
            # Real-int8 forwards carry no gradient through the int8 values;
            # QAT is the trainable form of the same arithmetic.
            sys.exit("error: --impl int8 is inference-only; train with "
                     "--impl int8qat (same quantized values, STE gradients)")
        # A student the fused backward does not serve trains on the plain
        # MLP; the teacher stays on --impl.
        cfg = cfg.replace(render=_train_impl_for_params(render_cfg, arch.width, arch.v_width,
                                                        arch.depth))
        if args.lr is not None:
            cfg = cfg.replace(lr_init=args.lr, lr_final=min(cfg.lr_final, args.lr))
    if args.accel_probes or args.accel_aabb:
        # Placement-aware training: the batches' samples are placed in each
        # ray's occupied range, as the serving presets place them, from the
        # grid the loop refreshes from the student.
        if not args.accel_every:
            sys.exit("error: --accel-aabb/--accel-probes need --accel-every "
                     "(the placement ranges come from the occupancy grid)")
        cfg = cfg.replace(render=cfg.render.replace(
            accel_sample_aabb=True, accel_aabb_probes=int(args.accel_probes or 0),
            accel_pad_probes=float(args.accel_pad or 1.0)))
    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")
    print(f"mesh: {mesh.size} rank(s)"
          + (f" ({dist.get_backend(mesh.group)})" if mesh.group is not None else ""))

    state = None
    if args.checkpoint_dir:
        # The guards read existing checkpoints only, so a stale sidecar of
        # a run that died before its first checkpoint does not block a
        # retry; rank 0 writes the sidecar once every rank's guards passed.
        want_info = _model_info(args, cfg)
        state = _resume(args, arch, want_info, device)
        if mesh.group is not None:
            dist.barrier(group=mesh.group)
        if writer:
            save_model_config(Path(args.checkpoint_dir), want_info)
    if state is None and args.init_weights:
        state = _init_weights(args, arch, device)
    if state is None:
        _, state = create_sharded_train_state(
            torch.Generator(device=device).manual_seed(cfg.seed), cfg, mesh)
    else:
        replicate(mesh, state)

    if args.data:
        from nerf_rs_tpu_torch.data import BlenderDataset

        t0 = time.perf_counter()
        dataset = BlenderDataset(args.data, device=device)
        print(f"loaded {args.data}: {len(dataset):,} rays of {dataset.height}x{dataset.width} "
              f"images in {time.perf_counter() - t0:.2f}s")
    else:
        from nerf_rs_tpu_torch.data import DistillationDataset

        teacher, _, _ = _load_scene(args)
        # The teacher is the lego MLP on --impl, whatever the student's
        # family or arch, except for the quantized impls: the student
        # distills toward the exact f32 teacher through the fused kernel.
        teacher_cfg = (render_cfg.replace(impl="pallas") if args.impl in ("int8", "int8qat")
                       else render_cfg)
        if args.teacher_samples:
            tc, tf = (int(v) for v in args.teacher_samples.split(","))
            teacher_cfg = teacher_cfg.replace(n_coarse=tc, n_fine=tf)
        dataset = DistillationDataset(teacher, cfg=teacher_cfg, seed=cfg.seed, device=device)
        print("no --data given: distilling from the pretrained lego networks"
              + (f" (teacher targets at {teacher_cfg.n_coarse}+{teacher_cfg.n_fine} samples)"
                 if args.teacher_samples else ""))

    # SIGTERM and SIGINT finish the step in flight, checkpoint and exit 0,
    # so that a restarted job resumes from the same directory. Across ranks
    # the request rides in the step's all-reduce and is read one step late
    # (after the next step is queued, so that the loop does not wait for
    # each step): every rank reads the same pooled value after the same
    # step, and all stop one step after it.
    stop = []
    stopped = False
    pooled_stop = None

    def request_stop(signum, frame):
        print(f"received signal {signum}: checkpointing and stopping", flush=True)
        stop.append(signum)

    old_handlers = {s: signal.signal(s, request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    key = random.key(cfg.seed + 1, device)
    start_step = state.step
    t0 = time.perf_counter()
    try:
        # A resumed run draws fresh batches (the seed folds in the resume
        # step) and keys by the absolute step; Adam's restored count carries
        # the learning-rate schedule on.
        # Occupancy-culled training (--accel-every): the grid is rebuilt
        # from the student every N steps after the warm-up, and at a
        # resumed run's first step, so that a resumed run does not train
        # without its grid (and its placement) until the next boundary.
        grid, step_cfg = None, cfg
        sweep_kw = field_grid_kwargs(cfg.render) if args.accel_every else None
        batches = dataset.batches(cfg.batch_rays, seed=cfg.seed + start_step)
        for step, batch in enumerate(batches, start=start_step):
            if step >= cfg.n_steps or stopped or (mesh.group is None and stop):
                break
            if (args.accel_every and step >= args.accel_warmup
                    and (step % args.accel_every == 0 or (step == start_step and grid is None))):
                grid, step_cfg, line = refresh_grid(state.params, cfg, step,
                                                    resolution=args.accel_res,
                                                    explore=args.accel_explore, sweep_kw=sweep_kw)
                print(line, flush=True)
            state, metrics = sharded_train_step(
                mesh, state, batch, random.fold_in(key, torch.tensor(step)), step_cfg, grid=grid,
                stop=bool(stop) if mesh.group is not None else None)
            if mesh.group is not None:
                # Pooled over the ranks: above 0 on every rank when any asked.
                # The last step's flag was copied to the host behind its
                # step; waiting for that copy leaves this step queued.
                if pooled_stop is not None:
                    flag, copied = pooled_stop
                    if copied is not None:
                        copied.synchronize()
                    stopped = float(flag) > 0.0
                flag = metrics.pop("stop").to("cpu", non_blocking=True)
                copied = torch.cuda.Event() if device.type == "cuda" else None
                if copied is not None:
                    copied.record()
                pooled_stop = (flag, copied)
            if step % args.log_every == 0 or step + 1 == cfg.n_steps:
                m = {k: float(v) for k, v in metrics.items()}
                rays_s = cfg.batch_rays * (step - start_step + 1) / (time.perf_counter() - t0)
                extra = ""
                if "live_frac_coarse" in m:
                    extra = f" accel-load {m['live_frac_coarse']:.2f}/{m['live_frac_fine']:.2f}"
                    if m["accel_overflow"] > 0.0:
                        extra += " OVERFLOW (raise accel capacities)"
                print(f"step {step}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                      f"({rays_s:,.0f} rays/s fwd+bwd){extra}", flush=True)
            if writer and args.checkpoint_dir and (step + 1) % cfg.checkpoint_every == 0:
                print(f"checkpointed {save_checkpoint(args.checkpoint_dir, state)}", flush=True)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if writer and args.checkpoint_dir:
            print(f"final checkpoint {save_checkpoint(args.checkpoint_dir, state)}", flush=True)
    return 0


def cmd_evaluate(args) -> int:
    """Render a view with a checkpoint's (or an export's) networks and
    report its PSNR against the pretrained teacher's render of the view."""
    import numpy as np

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.checkpoint import latest_checkpoint
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import infer_arch
    from nerf_rs_tpu_torch.render import render_image

    if args.checkpoint is None and args.checkpoint_dir is None and args.weights_dir is None:
        sys.exit("error: pass --checkpoint, --checkpoint-dir, or --weights-dir")
    device = _device(args.device)
    teacher, camera, _ = _load_scene(args)
    cfg = RenderConfig(n_coarse=args.coarse_samples, n_fine=args.fine_samples,
                       ray_chunk=args.ray_chunk, impl=args.impl, dtype=args.dtype,
                       sampling_impl=args.sampling_impl)
    if args.weights_dir:
        # Exported .bin weights of any ArchConfig member (assets/trained/*).
        wd = Path(args.weights_dir)
        params = {net: load_nerf_params(wd / net) for net in ("coarse", "fine")}
        step, ckpt = -1, wd
    else:
        ckpt = args.checkpoint or latest_checkpoint(args.checkpoint_dir)
        if ckpt is None:
            sys.exit("error: no checkpoint found (--checkpoint or --checkpoint-dir)")
        params, step = _restore_params(ckpt)
    # The reference is the exact teacher: --impl int8 says how the
    # checkpoint renders, not how the reference does.
    teacher_cfg = cfg.replace(impl="pallas") if cfg.impl in ("int8", "int8qat") else cfg
    if args.ref_samples:
        rc, rf = (int(v) for v in args.ref_samples.split(","))
        teacher_cfg = teacher_cfg.replace(n_coarse=rc, n_fine=rf)
    teacher_cfg = _impl_for_params(teacher_cfg, *infer_arch(teacher["coarse"])[:3])
    pc, pf, cfg = _checkpoint_networks(
        params, ckpt, cfg, device, hint=" — re-run train with --checkpoint-dir to write one")
    grid = None
    if args.accel_probes:
        # The checkpoint under the serving preset's probe-refined placement,
        # on a grid of its own field.
        from nerf_rs_tpu_torch.accel import build_scene_grid, hashgrid_grid_kwargs

        grid_kw = hashgrid_grid_kwargs(cfg) if cfg.model == "hashgrid" else {}
        grid = build_scene_grid(pc, pf, resolution=args.accel_res, device=device, **grid_kw)
        cfg = cfg.replace(accel_sample_aabb=True, accel_compact="off",
                          accel_aabb_probes=args.accel_probes,
                          accel_range_stride=args.accel_stride or 1)
    key = random.key(args.seed, device)
    ref = render_image(teacher["coarse"], teacher["fine"], camera, args.size, args.size, key,
                       teacher_cfg, device=device).cpu().numpy()
    img = render_image(pc, pf, camera, args.size, args.size, key, cfg, device=device,
                       grid=grid).cpu().numpy()
    mse = float(np.mean((img - ref) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    print(f"step {step}: {args.size}x{args.size} PSNR vs teacher {psnr:.2f} dB (mse {mse:.3e})")
    return 0


def cmd_verify(args) -> int:
    """The golden-sample check of both networks (the reference's unit
    test: every example ray's sigma and rgb within ``--tolerance`` of the
    TF values) through ``--impl`` (``pallas``: the fused kernel K1 in
    ``--dtype``; otherwise the plain f32 MLP), and with ``--image`` /
    ``--image-full`` the frames against the committed golden renders.
    Exits 1 when any check fails."""
    import numpy as np
    import torch

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import golden_examples
    from nerf_rs_tpu_torch.io.image import load_ppm
    from nerf_rs_tpu_torch.models.mlp import as_module, nerf_mlp
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    device = _device(args.device)
    trees, camera, golden = _load_scene(args)
    params = {net: as_module(trees[net], device) for net in ("coarse", "fine")}
    if args.impl == "pallas":
        from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp

        def mlp(p, pts, dirs):
            return fused_nerf_mlp(p, pts, dirs, dtype=args.dtype)
    else:
        mlp = nerf_mlp

    worst, ok = 0.0, True
    with torch.no_grad():
        for net in ("coarse", "fine"):
            for ex in golden_examples(golden):
                pts = ex["ray_o"][None] + ex["ray_d"][None] * ex["z_vals"][:, None]
                dirs = np.broadcast_to(ex["viewdir_unit"], pts.shape)
                rgb, sigma = mlp(params[net], torch.as_tensor(pts, device=device),
                                 torch.as_tensor(np.ascontiguousarray(dirs), device=device))
                err = max(float(np.abs(sigma.cpu().numpy() - ex[f"{net}_sigma"]).max()),
                          float(np.abs(rgb.cpu().numpy() - ex[f"{net}_rgb"]).max()))
                worst = max(worst, err)
                ok &= err < args.tolerance
                print(f"{net} pixel {ex['pixel']}: max abs err {err:.2e} "
                      f"[{'OK' if err < args.tolerance else 'FAIL'}]")
    print(f"worst error {worst:.2e} (tolerance {args.tolerance})")

    goldens = Path(__file__).resolve().parent.parent / "tests" / "goldens"
    checks = []
    if args.image:
        # The 64x64, 16+32, key-0 render tests/test_render.py pins.
        checks.append(("image vs committed golden", "image check SKIPPED: golden render",
                       Path(args.image_golden) if args.image_golden
                       else goldens / "lego_64x64_16c32f_key0.ppm", 64, 16, 32, 1024))
    if args.image_full:
        checks.append(("full image (256x256, 64+128) vs committed golden",
                       "full-image check SKIPPED: golden",
                       goldens / "lego_256x256_64c128f_key0.ppm", 256, 64, 128, 8192))
    for label, skipped, ref_path, size, nc, nf, chunk in checks:
        if not ref_path.exists():
            print(f"{skipped} not found ({ref_path})")
            return 0 if ok else 1
        cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=chunk, impl=args.impl,
                           dtype=args.dtype, sampling_impl=args.sampling_impl)
        img = render_image(params["coarse"], params["fine"], camera, size, size,
                           random.key(0, device), cfg, device=device).cpu().numpy()
        mse = float(np.mean((img - load_ppm(ref_path)) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        # The golden's 8-bit quantization caps agreement near 50 dB; bf16
        # costs more.
        bar = 45.0 if cfg.dtype == "float32" else 38.0
        ok &= psnr > bar
        print(f"{label}: {psnr:.1f} dB [{'OK' if psnr > bar else 'FAIL'}] (bar {bar:.0f} dB, "
              f"{cfg.impl}/{cfg.dtype})")
    return 0 if ok else 1


def cmd_extract(args) -> int:
    """The fine field's iso-surface as a PLY mesh (geometry export)."""
    from nerf_rs_tpu_torch.extract import extract_scene_mesh, save_ply, vertex_colors
    from nerf_rs_tpu_torch.models.mlp import as_module

    device = _device(args.device)
    trees, _, _ = _load_scene(args)
    coarse, fine = (as_module(trees[net], device) for net in ("coarse", "fine"))
    t0 = time.perf_counter()
    verts, faces = extract_scene_mesh(coarse, fine, resolution=args.resolution,
                                      aabb=(-args.extent, args.extent), iso=args.iso)
    if len(faces) == 0:
        sys.exit(f"error: no surface at iso={args.iso} — try a lower --iso")
    colors = None if args.no_color else vertex_colors(fine, verts, faces)
    save_ply(args.output, verts, faces, colors=colors)
    print(f"wrote {args.output}: {len(verts):,} vertices, {len(faces):,} triangles"
          f"{' (vertex colors)' if colors is not None else ''} ({args.resolution}^3 lattice, "
          f"iso {args.iso}, {time.perf_counter() - t0:.1f}s)")
    return 0


def cmd_export(args) -> int:
    """A checkpoint's networks in the reference ``.bin`` format (any
    ArchConfig member; ``shapes.txt`` records the dims)."""
    from nerf_rs_tpu_torch.io.checkpoint import export_reference_format

    params, step = _restore_params(args.checkpoint)
    if "shared" in params:
        sys.exit("error: hashgrid checkpoints have no reference .bin equivalent (the reference "
                 "loader consumes dense-MLP layers only, src/lib.rs:108-174) — use "
                 "evaluate/render with --checkpoint instead")
    export_reference_format(args.output, params)
    print(f"exported step {step} params to {args.output} (reference shapes.txt + .bin format)")
    return 0


def cmd_pack(args) -> int:
    """The scene (both networks and the golden JSON) as one ``.npz``
    bundle, loadable through ``--weights``, ``api.init_renderer`` and
    ``$NERF_RS_TPU_ASSETS`` in both packages."""
    import json

    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_scene_assets, save_bundle

    assets = Path(args.weights) if args.weights else find_lego_assets()
    if assets is None:
        sys.exit("error: no weight assets found (set --weights or $NERF_RS_TPU_ASSETS)")
    params, golden = load_scene_assets(assets)
    save_bundle(args.output, params["coarse"], params["fine"], json.dumps(golden))
    size_mb = Path(args.output).stat().st_size / 1e6
    print(f"packed {assets} -> {args.output} ({size_mb:.1f} MB, coarse + fine + camera/golden "
          "JSON)")
    return 0


def cmd_info(args) -> int:
    """The torch and CUDA versions, the cards (name, count, power limit)
    and the lego assets."""
    import torch

    from nerf_rs_tpu_torch.io.weights import find_lego_assets
    from nerf_rs_tpu_torch.utils.profiling import device_label

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"devices ({n}): " + "; ".join(
            device_label(torch.device("cuda", i), timeout=args.device_timeout) for i in range(n)))
    else:
        print("devices: no CUDA card (torch.cuda.is_available() is false)")
    if "WORLD_SIZE" in os.environ:
        print(f"world: rank {os.environ.get('RANK', '?')} of {os.environ['WORLD_SIZE']} "
              f"(torchrun; local rank {os.environ.get('LOCAL_RANK', '?')}): train and render "
              "--sharded split their rays over the ranks, NCCL between cards, gloo with "
              "--device cpu")
    else:
        print("world: 1 process (not launched by torchrun: train and render --sharded run on "
              "one device)")
    print(f"lego assets: {find_lego_assets()}")
    return 0


def cmd_serve(args) -> int:
    from nerf_rs_tpu_torch import serve

    return serve.main(["--port", str(args.port), "--host", args.host, "--device", args.device]
                      + (["--warmup"] if args.warmup else [])
                      + (["--accel", "--accel-res", str(args.accel_res)] if args.accel else [])
                      + (["--checkpoint", args.checkpoint] if args.checkpoint else []))


def _add_common(p):
    """The render flags that evaluate shares with the JAX CLI's
    ``_add_common``, and the port's ``--device``."""
    p.add_argument("--weights",
                   help="teacher weight directory or .npz bundle (default: auto-discover)")
    p.add_argument("--camera", help="camera JSON (default: the weight directory's golden JSON)")
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    p.add_argument("--impl", default="pallas", choices=["xla", "pallas", "int8", "int8qat"],
                   help="MLP: 'pallas' = the fused CUDA kernel, 'xla' = plain PyTorch, "
                        "'int8' = real W8A8 inference through the int8 CUDA kernel, "
                        "'int8qat' = the QAT fake-quant forward")
    p.add_argument("--sampling-impl", default="xla", choices=["xla", "pallas"],
                   help="resampling chain: 'pallas' = the fused CUDA kernel, 'xla' = plain "
                        "PyTorch")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--coarse-samples", type=int, default=64)
    p.add_argument("--fine-samples", type=int, default=128)
    p.add_argument("--ray-chunk", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0)

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
    p.add_argument("--impl", default="pallas", choices=["xla", "pallas", "int8", "int8qat"],
                   help="MLP: 'pallas' = the fused CUDA kernel, 'xla' = plain PyTorch, "
                        "'int8' = real W8A8 inference through the int8 CUDA kernel, "
                        "'int8qat' = the QAT fake-quant forward")
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
    p.add_argument("--sharded", action="store_true",
                   help="split each frame's rays over the ranks of a torchrun launch (one "
                        "process a device; a world of 1 without torchrun); rank 0 writes")
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
    p.add_argument("--checkpoint",
                   help="render a training checkpoint (any model family) instead of the "
                        "pretrained weights; the camera stays the scene's")
    p.add_argument("--orbit", type=int, default=0,
                   help="render N turntable frames rotating the camera about the scene's z-axis "
                        "(the outputs get _000.. suffixes; accel capacities are tuned on the "
                        "base view, the orbit keeps the camera's distance)")
    p.add_argument("--trace-dir",
                   help="write a torch.profiler Chrome trace (CPU and CUDA activity) of the "
                        "frames here")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("train", help="train coarse+fine networks on a nerf_synthetic scene, "
                                     "or distilling from the pretrained lego networks")
    p.add_argument("--weights", "--weights-dir", dest="weights",
                   help="teacher weight directory with coarse/ and fine/ (default: auto-discover)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on, e.g. cuda, cuda:1 or cpu")
    p.add_argument("--impl", default="pallas", choices=["xla", "pallas", "int8", "int8qat"],
                   help="MLP: 'pallas' = the fused CUDA kernels, 'xla' = plain PyTorch, "
                        "'int8qat' = quantization-aware distillation of a W8A8 student "
                        "(served with render --impl int8); 'int8' is inference-only")
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
    p.add_argument("--data", help="nerf_synthetic scene directory (default: distill)")
    p.add_argument("--checkpoint-dir",
                   help="write checkpoints here, and resume from the newest one it holds")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--init-weights",
                   help="start from exported weights (a coarse/ + fine/ .bin directory, as "
                        "export writes, or an .npz bundle) of the same --width/--v-width/"
                        "--depth/--skip-at, with a fresh optimizer at step 0; ignored when "
                        "--checkpoint-dir already holds a checkpoint. MLP family only")
    p.add_argument("--camera",
                   help="camera JSON of a bare --weights export (the teacher's scene assets)")
    p.add_argument("--sampling-impl", default="xla", choices=["xla", "pallas"],
                   help="accepted as the JAX CLI accepts it and not used: training runs the "
                        "plain resampling chain, which is differentiable")
    p.add_argument("--ray-chunk", type=int, default=16384,
                   help="accepted as the JAX CLI accepts it and not used: a training batch "
                        "renders in one chunk of --batch-rays rays")
    p.add_argument("--accel-every", type=int, default=0,
                   help="occupancy-culled training: rebuild the grid from the student every N "
                        "steps (0 = off)")
    p.add_argument("--accel-res", type=int, default=128,
                   help="occupancy grid resolution per axis")
    p.add_argument("--accel-warmup", type=int, default=256,
                   help="train dense for this many steps before the first grid refresh "
                        "(density must form somewhere first)")
    p.add_argument("--accel-explore", type=float, default=0.01,
                   help="fraction of cells randomly re-opened at each grid refresh, so regions "
                        "the student wrongly zeroed keep receiving gradient (0 = off)")
    p.add_argument("--accel-aabb", action="store_true",
                   help="placement-aware training: clamp each training ray's sample range to "
                        "its occupied span (needs --accel-every), as the serving presets place "
                        "samples, when fine-tuning for a reduced-sample or single-pass config")
    p.add_argument("--accel-probes", type=int, default=0,
                   help="refine each ray's range to its own occupied run via this many grid "
                        "probes (serving presets use 128); implies --accel-aabb")
    p.add_argument("--accel-pad", type=float, default=1.0,
                   help="with --accel-probes: pad each training ray's range by this many probe "
                        "intervals per side (serving pools ranges over stride blocks, so about "
                        "4 matches the stride-4 serving preset)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="checkpoint PSNR vs the pretrained teacher")
    _add_common(p)
    p.add_argument("--checkpoint", help="checkpoint path (default: the newest in the dir)")
    p.add_argument("--checkpoint-dir")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--weights-dir",
                   help="evaluate an exported weight directory (coarse/ + fine/ .bin) instead "
                        "of a checkpoint, e.g. assets/trained/*")
    p.add_argument("--ref-samples", metavar="NC,NF",
                   help="render the teacher reference at these sample counts instead of the "
                        "checkpoint's")
    p.add_argument("--accel-probes", type=int, default=0,
                   help="render the checkpoint under the serving preset's probe placement "
                        "(a grid of its own field) instead of uniform [near, far] sampling")
    p.add_argument("--accel-stride", type=int, default=4,
                   help="with --accel-probes: probe a stride-subsampled ray grid")
    p.add_argument("--accel-res", type=int, default=128,
                   help="with --accel-probes: occupancy grid resolution")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("verify", help="golden-sample verification")
    _add_common(p)
    p.add_argument("--tolerance", type=float, default=1e-2)
    p.add_argument("--image", action="store_true",
                   help="also render the 64x64 16+32 key-0 frame against the committed golden "
                        "render")
    p.add_argument("--image-golden",
                   help="path to a golden PPM for --image (default: the committed "
                        "tests/goldens one)")
    p.add_argument("--image-full", action="store_true",
                   help="also render the full-quality 256x256 64+128 key-0 frame against its "
                        "committed golden (under a second on the card, minutes on a CPU)")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("extract", help="trained field -> PLY surface mesh (geometry export)")
    p.add_argument("--weights",
                   help="scene assets directory or .npz bundle (default: the pretrained lego)")
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    p.add_argument("-o", "--output", required=True, help="output .ply path")
    p.add_argument("--resolution", type=int, default=128,
                   help="density lattice resolution per axis")
    p.add_argument("--iso", type=float, default=10.0,
                   help="density iso level treated as the surface")
    p.add_argument("--extent", type=float, default=2.0,
                   help="half-width of the sampled cube (aabb +-extent)")
    p.add_argument("--no-color", action="store_true",
                   help="skip baking vertex colors (the fine network queried along the inward "
                        "normal)")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("export", help="checkpoint -> reference .bin format")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("pack", help="scene -> single self-contained .npz bundle")
    p.add_argument("--weights", help="weight directory (default: auto-discover)")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("serve", help="HTTP browser viewer (python -m nerf_rs_tpu_torch.serve)")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda")
    p.add_argument("--warmup", action="store_true")
    p.add_argument("--accel", action="store_true",
                   help="serve through the occupancy-grid fast path")
    p.add_argument("--accel-res", type=int, default=128)
    p.add_argument("--checkpoint", help="serve a training checkpoint (any model family)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("info", help="versions, cards and assets")
    p.add_argument("--device-timeout", type=float, default=60.0,
                   help="seconds to wait for nvidia-smi")
    p.set_defaults(fn=cmd_info)
    args = parser.parse_args(argv)
    return args.fn(args)
