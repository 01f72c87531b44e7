#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's two main paths and holds them to the repository's own
bars: the render path — the pretrained lego coarse and fine networks
rendering a 256x256 frame with 64 stratified + 128 importance samples on
white, through ``nerf_rs_tpu_torch.render.render_image`` — and the training
path — the JAX CLI's default job, a full-width 8x256 student distilled from
the lego networks at 4096 rays and 64 + 128 samples, through
``nerf_rs_tpu_torch.train.train_step`` and ``data.DistillationDataset``.
Phases, each reported on its own line:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the fused MLP kernels K1 and K2 are compiled from the checkout's
   sources (one nvcc per source, in parallel);
3. K1 against its plain PyTorch version at the render's shapes (8192 rays
   x 64 samples sigma-only, 8192 x 192 full), f32 and bf16;
4. the f32 frame with K1: PSNR against the committed golden > 45 dB, and
   2 K1 launches per ray chunk;
5. the bf16 frame against the f32 frame, at BF16_FRAME_BAR_DB;
6. the plain-PyTorch f32 frame against the kernel frame, >= 60 dB;
7. K1 and plain times at the phase-3 shapes, and the frame times;
8. K2 against its plain version on what the training path hands it (the
   lego networks as students: coarse at 4096 x 64 and fine at 4096 x 192,
   both full), f32 and bf16: every leaf's gradient, d(points) and d(dirs),
   and two calls bitwise equal;
9. one training step from the same state and batch, kernels against the
   plain MLP: losses and parameters after the step;
10. 50 kernel steps from a random init: the loss falls, K2 launches twice
    a step and K1 four times (teacher and student, coarse and fine);
11. K2 and plain backward times at the fine shape, and ms per step and
    rays/s for the kernel and the plain training paths.

Any failed phase exits non-zero. The line before the last is a JSON
summary of the kernels; the last line is the JSON device record.
Never imports JAX.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H = W = 256
N_COARSE, N_FINE = 64, 128
RAY_CHUNK = 8192
GOLDEN_PPM = REPO / "tests" / "goldens" / "lego_256x256_64c128f_key0.ppm"
GOLDEN_BAR_DB = 45.0           # tests/test_render.py's bar for this golden
PLAIN_BAR_DB = 60.0
# The JAX package's own bf16 drift, measured once on the CPU: its XLA path
# rendered the lego at 64x64 with 16+32 samples, seed 0, in bfloat16 and in
# float32, 33.90 dB apart. This bar is that value less 3 dB.
BF16_FRAME_BAR_DB = 30.9
# Kernel against plain version. f32: only the summation order differs.
# bf16: the bars tests/test_fused_mlp.py sets for two bf16 orderings.
TOLERANCES = {
    "float32": {"rgb_atol": 1e-4, "sigma_atol": 1e-3, "sigma_rtol": 1e-4},
    "bfloat16": {"rgb_atol": 2e-2, "sigma_atol": 2e-2, "sigma_rtol": 2e-2},
}
# K2 against its plain version, per gradient (every leaf, d(points),
# d(dirs)), as ||g_k - g_p|| / ||g_p||. bf16: 3e-2, where the sums' order
# flips the bf16 rounding of a layer's output gradient. f32: the two differ
# by summation order only, but on the fine network's training inputs f32
# itself is that coarse — each lies ~2.5e-4 from the same function in
# float64 (measured on an H100 80GB HBM3; PERF.md) — so each gradient of K2 is held to the
# float64 evaluation instead: within 1e-4 of it, or no further from it
# than F32_VS_PLAIN times the plain version is.
BWD_BARS = {"float32": 1e-4, "bfloat16": 3e-2}
F32_VS_PLAIN = 1.5
TRAIN_RAYS = 4096              # the JAX CLI's train defaults (nerf_rs_tpu/cli.py)
TRAIN_STEPS = 50


class PhaseFailure(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return -10.0 * math.log10(max(mse, 1e-20))


def timed_ms(fn, reps: int = 3) -> float:
    """Median wall time of ``reps`` runs after one warm-up, each run
    bracketed by device synchronizations."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise PhaseFailure("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise PhaseFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("1 device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), device 0: {name}")
    print(card, flush=True)
    return name, card


def phase_build():
    from nerf_rs_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    names = ", ".join(src.name for src in _build.sources())
    say("2 build", f"{names} built and loaded in {secs:.1f} s ({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            entry = re.search(r"entry function '.*?(fused_mlp_bwd_kernel|fused_mlp_kernel|"
                              r"reduce_partials)(I\w*?Lb[01]E)?", line)
            if entry:
                say("2 build", "ptxas: " + "".join(g for g in entry.groups() if g))
            elif "registers" in line or "spill" in line:
                say("2 build", "ptxas: " + line.strip())


def main_path_inputs(cam, dev):
    """The main path's MLP inputs for 8192 rays of the frame's center rows:
    stratified samples at the coarse width (64) and at the fine width
    (64 + 128 = 192) per ray."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.ops.sampling import stratified_samples

    _, dirs = camera_rays(cam, H, W, dev)
    first = (H // 2 - RAY_CHUNK // W // 2) * W
    dirs = dirs.reshape(-1, 3)[first:first + RAY_CHUNK].contiguous()
    ids = torch.arange(first, first + RAY_CHUNK, device=dev)
    k_c, k_f = random.split(random.key(0, dev))
    near = torch.as_tensor(cam.near, device=dev)
    far = torch.as_tensor(cam.far, device=dev)
    origin = torch.as_tensor(cam.position, device=dev)
    t_c = stratified_samples(random.fold_in(k_c, ids), near, far, N_COARSE, (RAY_CHUNK,))
    t_f = stratified_samples(random.fold_in(k_f, ids), near, far, N_COARSE + N_FINE, (RAY_CHUNK,))
    pts_c = (origin + dirs[:, None, :] * t_c[..., None]).contiguous()
    pts_f = (origin + dirs[:, None, :] * t_f[..., None]).contiguous()
    return pts_c, pts_f, dirs[:, None, :]


def phase_kernel_vs_plain(coarse, fine, cam, dev):
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_reference

    pts_c, pts_f, vd = main_path_inputs(cam, dev)
    cases = {"coarse": (coarse, pts_c, True), "fine": (fine, pts_f, False)}
    f32_err = 0.0
    timings = []
    with torch.no_grad():
        for dtype, tol in TOLERANCES.items():
            for name, (net, pts, sigma_only) in cases.items():
                kw = dict(dtype=dtype, sigma_only=sigma_only)
                torch.cuda.synchronize()
                rgb_k, sig_k = fused_nerf_mlp(net, pts, vd, **kw)
                torch.cuda.synchronize()
                rgb_r, sig_r = fused_nerf_mlp_reference(net, pts, vd, **kw)
                torch.cuda.synchronize()
                shape = tuple(pts.shape[:-1])
                if tuple(sig_k.shape) != shape or tuple(rgb_k.shape) != (*shape, 3):
                    raise PhaseFailure(f"{name}/{dtype}: output shapes {tuple(rgb_k.shape)}, "
                                       f"{tuple(sig_k.shape)} for input {tuple(pts.shape)}")
                if not (torch.isfinite(rgb_k).all() and torch.isfinite(sig_k).all()):
                    raise PhaseFailure(f"{name}/{dtype}: non-finite kernel output")
                rgb_err = float((rgb_k - rgb_r).abs().max())
                sig_err = float((sig_k - sig_r).abs().max())
                sig_excess = float(((sig_k - sig_r).abs()
                                    - tol["sigma_rtol"] * sig_r.abs()).max())
                ok = rgb_err <= tol["rgb_atol"] and sig_excess <= tol["sigma_atol"]
                say("3 kernel", f"{name} {tuple(pts.shape[:-1])} sigma_only={sigma_only} "
                    f"{dtype}: max|d rgb| {rgb_err:.3e} (atol {tol['rgb_atol']}), "
                    f"max|d sigma| {sig_err:.3e} (atol {tol['sigma_atol']}, rtol "
                    f"{tol['sigma_rtol']}), sigma range [{float(sig_r.min()):.3g}, "
                    f"{float(sig_r.max()):.3g}] -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailure(f"kernel disagrees with its plain version: {name}/{dtype}")
                if dtype == "float32":
                    f32_err = max(f32_err, rgb_err, sig_err)
                timings.append((name, dtype, net, pts, sigma_only))
    return f32_err, timings, vd


def render(coarse, fine, cam, dev, impl: str, dtype: str, size: int = 0):
    import torch

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=RAY_CHUNK, impl=impl,
                       dtype=dtype)
    size = size or H
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_image(coarse, fine, cam, size, size, random.key(0, dev), cfg, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if tuple(img.shape) != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise PhaseFailure(f"{impl}/{dtype} frame: shape {tuple(img.shape)} or non-finite values")
    return img.cpu().numpy(), ms


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-300))


def main_path_backward_inputs(dev):
    """What the training path hands K2: one nerf_loss backward of the lego
    networks, trained as students, on a distillation batch of TRAIN_RAYS
    rays with 64 + 128 samples, with K2's wrapper recording its inputs.
    -> {"coarse": (net, points, viewdirs, g_rgb, g_sigma), "fine": ...}."""
    import torch

    import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import nerf_loss

    _, dataset, cfg, key = distill_setup(dev, "pallas")
    nets = {net: NerfMLP(load_nerf_params(find_lego_assets() / net), device=dev,
                         requires_grad=True) for net in ("coarse", "fine")}
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    seen = []
    real = fm.fused_nerf_mlp_backward

    def record(pk, points, viewdirs, g_rgb, g_sigma, **kw):
        seen.append((points, viewdirs, g_rgb, g_sigma))
        return real(pk, points, viewdirs, g_rgb, g_sigma, **kw)

    record.launches = real.launches       # the wrapper counts through its module name
    fm.fused_nerf_mlp_backward = record
    try:
        loss, _ = nerf_loss(nets, batch, random.fold_in(key, torch.tensor(0)), cfg)
        loss.backward()
    finally:
        fm.fused_nerf_mlp_backward = real
        real.launches = record.launches
    by_samples = {args[0].shape[-2]: args for args in seen}
    return {"coarse": (nets["coarse"], *by_samples[N_COARSE]),
            "fine": (nets["fine"], *by_samples[N_COARSE + N_FINE])}


def phase_backward_vs_plain(dev):
    """K2 against its plain version on what the training path hands it."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
        unpack_grads,
    )

    inputs = main_path_backward_inputs(dev)
    f32_err = 0.0
    for name, (net, *args) in inputs.items():
        for dtype, bar in BWD_BARS.items():
            got = fused_nerf_mlp_backward(net, *args, dtype=dtype)
            again = fused_nerf_mlp_backward(net, *args, dtype=dtype)
            want = fused_nerf_mlp_backward_reference(net, *args, dtype=dtype)
            exact = (fused_nerf_mlp_backward_reference(net, *(a.double() for a in args),
                                                       dtype=dtype)
                     if dtype == "float32" else None)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in got):
                raise PhaseFailure(f"K2 {name}/{dtype}: non-finite gradient")
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            pk = net.packed(dtype)

            def gradients(out):
                leaves = unpack_grads(pk, out[0], out[1])
                grads = {f"{layer}/{part}": leaves[layer][part]
                         for layer in leaves for part in ("kernel", "bias")}
                grads["d(points)"] = out[2]
                grads["d(dirs)"] = out[3].sum(1)             # one dir per ray
                return grads

            gk, gp = gradients(got), gradients(want)
            vs_plain = {k: rel_err(gk[k], gp[k]) for k in gp}
            worst = max(vs_plain, key=vs_plain.get)
            line = (f"K2 {name} {tuple(args[0].shape[:-1])} {dtype}: worst ||g_k - g_p|| / "
                    f"||g_p|| {vs_plain[worst]:.3e} ({worst}) over {len(gp)} gradients")
            if exact is None:
                ok = vs_plain[worst] <= bar
                line += f" (bar {bar})"
            else:
                g64 = gradients(exact)
                margin = {k: rel_err(gk[k], g64[k]) / max(bar, F32_VS_PLAIN * rel_err(gp[k], g64[k]))
                          for k in g64}
                tight = max(margin, key=margin.get)
                ok = margin[tight] <= 1.0
                line += (f"; against float64, tightest {tight}: kernel "
                         f"{rel_err(gk[tight], g64[tight]):.3e}, plain "
                         f"{rel_err(gp[tight], g64[tight]):.3e} (bar max({bar}, "
                         f"{F32_VS_PLAIN} x plain))")
                f32_err = max(f32_err, *(float((a - b).abs().max())     # parameter gradients
                                         for a, b in zip(got[:2], want[:2])))
            ok = ok and bitwise
            say("8 backward", f"{line}; two calls bitwise equal: {bitwise} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"K2 disagrees with its plain version or is not "
                                   f"deterministic: {name}/{dtype}")
    return f32_err, inputs["fine"]


def distill_setup(dev, impl: str):
    """The training job's state, dataset, config and step key, as
    ``python -m nerf_rs_tpu_torch train`` builds them."""
    import torch

    from nerf_rs_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state

    cfg = TrainConfig(batch_rays=TRAIN_RAYS, render=RenderConfig(
        n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=TRAIN_RAYS, impl=impl))
    state = create_train_state(torch.Generator(device=dev).manual_seed(cfg.seed), cfg)
    assets = find_lego_assets()
    teacher = {net: load_nerf_params(assets / net) for net in ("coarse", "fine")}
    dataset = DistillationDataset(teacher, cfg=cfg.render.replace(impl="pallas"), seed=cfg.seed,
                                  device=dev)
    return state, dataset, cfg, random.key(cfg.seed + 1, dev)


def phase_step_vs_plain(dev):
    """One training step from the same state and batch: the kernels
    (impl="pallas") against the plain MLP (impl="xla"), f32."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    results = {}
    batch = None
    for impl in ("pallas", "xla"):
        state, dataset, cfg, key = distill_setup(dev, impl)
        if batch is None:
            batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
        state, metrics = train_step(state, batch, random.fold_in(key, torch.tensor(0)), cfg)
        torch.cuda.synchronize()
        results[impl] = (float(metrics["loss"]), state, cfg, metrics)
    (loss_k, state_k, cfg, m_k), (loss_p, state_p, _, m_p) = results["pallas"], results["xla"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    parts = ", ".join(f"{name} rel {abs(float(m_k[name]) - float(m_p[name])) / float(m_p[name]):.2e}"
                      for name in ("mse_coarse", "mse_fine"))
    diffs = {(net, name): (p.detach() - state_p.params[net].weights[name].detach()).abs()
             for net in ("coarse", "fine") for name, p in state_k.params[net].weights.items()}
    worst_max = max(float(d.max()) for d in diffs.values())
    share = (sum(int((d > 1e-5).sum()) for d in diffs.values())
             / sum(d.numel() for d in diffs.values()))
    leaf, leaf_share = max(((k, float((d > 1e-5).float().mean())) for k, d in diffs.items()),
                           key=lambda kv: kv[1])
    # tests/test_train.py's bound, over all entries of both networks: Adam's
    # first step is about lr * sign(g), so an entry moves by more than 1e-5
    # only where the two gradients straddle zero. The coarse samples are
    # the same in both steps; the fine samples move with the coarse sigmas'
    # last bits (importance sampling), so the fine network's first layers
    # hold most of those entries.
    ok = loss_rel <= 1e-5 and worst_max < 2 * cfg.lr_init and share < 1e-3
    say("9 step", f"one f32 step, kernels vs plain MLP: loss {loss_k:.7f} vs {loss_p:.7f} "
        f"(rel {loss_rel:.2e}, bar 1e-5; {parts}); params after the step: max |d| {worst_max:.3e} "
        f"(bar < {2 * cfg.lr_init:g}), share of entries > 1e-5 {share:.2e} (bar < 1e-3; "
        f"largest in {leaf[0]}/{leaf[1]}: {leaf_share:.2e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the kernel training step disagrees with the plain step")


def phase_train(dev):
    """The training path: TRAIN_STEPS kernel steps from a random init,
    with the launch counts set to 0 just before and read just after."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "pallas")
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    fused_nerf_mlp.launches = fused_nerf_mlp_backward.launches = 0
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    secs = time.perf_counter() - t0
    launches = {"fused_nerf_mlp": fused_nerf_mlp.launches,
                "fused_nerf_mlp_backward": fused_nerf_mlp_backward.launches}
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    ok = (all(math.isfinite(v) for v in losses) and last < first
          and launches["fused_nerf_mlp_backward"] == 2 * TRAIN_STEPS
          and launches["fused_nerf_mlp"] == 4 * TRAIN_STEPS)
    say("10 train", f"{TRAIN_STEPS} kernel steps, 8x256 student, {TRAIN_RAYS} rays, "
        f"{N_COARSE}+{N_FINE} samples: loss {losses[0]:.5f} -> {losses[-1]:.5f}, mean of the "
        f"first 10 {first:.5f}, of the last 10 {last:.5f}; launches K1 "
        f"{launches['fused_nerf_mlp']} (expected {4 * TRAIN_STEPS}), K2 "
        f"{launches['fused_nerf_mlp_backward']} (expected {2 * TRAIN_STEPS}); "
        f"{secs:.1f} s with the teacher batches -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("training did not reduce the loss, or went around the kernels")
    return launches


def time_steps(dev, impl: str) -> float:
    """Median ms of a train step (student forward, backward and Adam) on one
    fixed batch, after a warm-up step."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, impl)
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    step_key = random.fold_in(key, torch.tensor(0))
    return timed_ms(lambda: train_step(state, batch, step_key, cfg))


def main() -> int:
    import torch

    name, card = phase_device()
    sys.path.insert(0, str(REPO))
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import load_ppm, save_ppm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp,
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
        fused_nerf_mlp_reference,
    )

    phase_build()

    dev = torch.device("cuda", 0)
    assets = find_lego_assets()
    if assets is None:
        raise PhaseFailure("lego weights not found (assets/lego_rust)")
    coarse = NerfMLP(load_nerf_params(assets / "coarse"), device=dev)
    fine = NerfMLP(load_nerf_params(assets / "fine"), device=dev)
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))

    f32_err, timing_cases, vd = phase_kernel_vs_plain(coarse, fine, cam, dev)

    # One small frame per configuration first, so that the timed frames
    # below pay no first-use costs (allocator growth, library handles).
    for impl, dtype in (("pallas", "float32"), ("pallas", "bfloat16"), ("xla", "float32")):
        render(coarse, fine, cam, dev, impl, dtype, size=32)

    fused_nerf_mlp.launches = fused_nerf_mlp_backward.launches = 0
    img_f32, ms_f32 = render(coarse, fine, cam, dev, "pallas", "float32")
    render_launches = fused_nerf_mlp.launches
    n_chunks = -(-H * W // RAY_CHUNK)
    out_dir = Path(tempfile.mkdtemp(prefix="nerf_rs_tpu_torch_smoke_"))
    save_ppm(out_dir / "lego_256x256_64c128f_key0_f32.ppm", img_f32, H, W)
    golden_db = psnr(img_f32, load_ppm(GOLDEN_PPM))
    say("4 frame", f"f32 kernel frame {H}x{W} {N_COARSE}+{N_FINE}: PSNR vs committed golden "
        f"{golden_db:.2f} dB (bar > {GOLDEN_BAR_DB}), {render_launches} K1 launches for "
        f"{n_chunks} chunks, written to {out_dir}")
    if not golden_db > GOLDEN_BAR_DB:
        raise PhaseFailure(f"f32 frame PSNR {golden_db:.2f} dB <= {GOLDEN_BAR_DB}")
    if render_launches != 2 * n_chunks or fused_nerf_mlp_backward.launches != 0:
        raise PhaseFailure(f"{render_launches} K1 launches (expected {2 * n_chunks}) and "
                           f"{fused_nerf_mlp_backward.launches} K2 launches (expected 0)")

    img_bf16, ms_bf16 = render(coarse, fine, cam, dev, "pallas", "bfloat16")
    bf16_db = psnr(img_bf16, img_f32)
    say("5 bf16", f"bf16 kernel frame vs f32 kernel frame: {bf16_db:.2f} dB "
        f"(bar >= {BF16_FRAME_BAR_DB})")
    if not bf16_db >= BF16_FRAME_BAR_DB:
        raise PhaseFailure(f"bf16 frame PSNR {bf16_db:.2f} dB < {BF16_FRAME_BAR_DB}")

    img_plain, ms_plain = render(coarse, fine, cam, dev, "xla", "float32")
    plain_db = psnr(img_plain, img_f32)
    say("6 plain", f"plain f32 frame vs kernel f32 frame: {plain_db:.2f} dB "
        f"(bar >= {PLAIN_BAR_DB})")
    if not plain_db >= PLAIN_BAR_DB:
        raise PhaseFailure(f"plain frame PSNR {plain_db:.2f} dB < {PLAIN_BAR_DB}")

    times = {}
    with torch.no_grad():
        for case, dtype, net, pts, sigma_only in timing_cases:
            kw = dict(dtype=dtype, sigma_only=sigma_only)
            saved = fused_nerf_mlp.launches
            k_ms = timed_ms(lambda: fused_nerf_mlp(net, pts, vd, **kw))
            fused_nerf_mlp.launches = saved       # comparison launches do not count
            p_ms = timed_ms(lambda: fused_nerf_mlp_reference(net, pts, vd, **kw))
            times[(case, dtype)] = (k_ms, p_ms)
            say("7 times", f"{card}: {case} {tuple(pts.shape[:-1])} {dtype}: kernel "
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (median of 3)")
    say("7 times", f"{card}: frame {H}x{W} {N_COARSE}+{N_FINE}: kernel f32 {ms_f32:.1f} ms, "
        f"kernel bf16 {ms_bf16:.1f} ms, plain f32 {ms_plain:.1f} ms (one run each)")

    # The training path: K2 against its plain version, one step against the
    # plain MLP's step, then the path itself.
    bwd_err, (net, pts, vd_f, g_rgb, g_sigma) = phase_backward_vs_plain(dev)
    phase_step_vs_plain(dev)
    launches = phase_train(dev)

    # As the training path calls them: parameter gradients only.
    saved = fused_nerf_mlp_backward.launches
    kb_ms = timed_ms(lambda: fused_nerf_mlp_backward(net, pts, vd_f, g_rgb, g_sigma,
                                                     input_grads=False))
    fused_nerf_mlp_backward.launches = saved       # comparison launches do not count
    pb_ms = timed_ms(lambda: fused_nerf_mlp_backward_reference(net, pts, vd_f, g_rgb, g_sigma,
                                                               input_grads=False))
    say("11 times", f"{card}: K2 fine {tuple(pts.shape[:-1])} float32, parameter gradients: "
        f"kernel {kb_ms:.3f} ms, plain {pb_ms:.3f} ms (median of 3)")
    saved = (fused_nerf_mlp.launches, fused_nerf_mlp_backward.launches)
    step_ms = {impl: time_steps(dev, impl) for impl in ("pallas", "xla")}
    fused_nerf_mlp.launches, fused_nerf_mlp_backward.launches = saved
    for impl, label in (("pallas", "kernels"), ("xla", "plain MLP")):
        say("11 times", f"{card}: train step ({label}), {TRAIN_RAYS} rays {N_COARSE}+{N_FINE}, "
            f"f32: {step_ms[impl]:.1f} ms, {TRAIN_RAYS / step_ms[impl] * 1e3:,.0f} rays/s "
            f"fwd+bwd (median of 3, teacher batch excluded)")

    k_ms, p_ms = times[("fine", "float32")]
    print(json.dumps({"kernels": [{
        "name": "fused_nerf_mlp",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
        "replaces": "nerf_rs_tpu/ops/kernels/fused_mlp.py:779",
        "launches": launches["fused_nerf_mlp"],
        "max_abs_err": f32_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "fused_nerf_mlp_backward",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/ops/kernels/csrc/fused_mlp_bwd.cu",
        "replaces": "nerf_rs_tpu/ops/kernels/fused_mlp.py:663",
        "launches": launches["fused_nerf_mlp_backward"],
        "max_abs_err": bwd_err,
        "ms": kb_ms,
        "plain_ms": pb_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
