#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's five main paths and holds them to the repository's own
bars: the render path — the pretrained lego coarse and fine networks
rendering a 256x256 frame with 64 stratified + 128 importance samples on
white, through ``nerf_rs_tpu_torch.render.render_image`` — the training
path — the JAX CLI's default job, a full-width 8x256 student distilled from
the lego networks at 4096 rays and 64 + 128 samples, through
``nerf_rs_tpu_torch.train.train_step`` and ``data.DistillationDataset`` —
and the accelerated render and serving path — bench.py's default: a 128^3
occupancy grid swept through K1, probe culling (32 probes, stride 4,
``accel_compact="off"``), ray packing, and the fused resampler K3, through
``render_image(grid=...)`` and the HTTP viewer (``api``, ``serve``) — and
the hash-grid family — the paper config (16 levels of 2^17 rows, F = 2,
resolutions 16-1024), distilled from the lego networks as ``train --model
hashgrid`` does, then rendered dense and through a grid of its own sigma,
through the hash-encode kernel — and the int8 W8A8 family — the lego
networks quantized after training and rendered through the int8 MLP kernel
(``render --impl int8``), and an 8x256 student distilled through the QAT
forward (``train --impl int8qat``). Phases, each reported on its own line:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the fused MLP kernels K1 and K2 (both on the tensor cores, f32
   and bf16), the fused resampler K3, the hash encode and the int8 MLP
   kernel are compiled from the checkout's sources (one nvcc per source, in
   parallel); ``cuobjdump --dump-sass`` must show HGMMA (``wgmma``)
   instructions in both variants (sigma_only or not) of K1 f32 and bf16,
   of K1 f32's record mode (K2 f32's recompute) and of K2's bf16 kernel,
   HMMA (``mma.sync``) instructions, every one tf32, in both variants
   of K2's f32 kernel, and IGMMA (s8 ``wgmma``) instructions in both
   variants of the int8 kernel; ptxas's registers and spills of the hash
   encode's four instances and K3's seven are printed, and a spill fails;
3. K1 against its plain PyTorch version at the render's shapes (8192 rays
   x 64 samples sigma-only, 8192 x 192 full), f32 and bf16, two calls
   bitwise equal; the kernel's and the plain version's f32 distance from
   the float64 evaluation (reported); bf16 sigma held to the float64
   evaluation, no further from it than the plain version
   (``fused_mlp.bf16_sigma_agrees``);
4. the f32 frame with K1: PSNR against the committed golden > 45 dB, and
   2 K1 launches per ray chunk, every one on the tensor cores;
5. the bf16 frame against the f32 frame, at BF16_FRAME_BAR_DB, every K1
   launch (2 a chunk) on the tensor cores;
6. the plain-PyTorch f32 frame against the kernel frame, >= 60 dB;
7. K1, plain and library-yardstick (``models.mlp.nerf_mlp`` in the same
   dtype) times at the phase-3 shapes, f32 and bf16, their shares of
   their bounds, and the 256x256 frame times (medians of 3) with the
   kernels and plain, f32 and bf16;
8. K2 against its plain version on what the training path hands it (the
   lego networks as students: coarse at 4096 x 64 and fine at 4096 x 192,
   both full), f32 and bf16: every leaf's gradient, d(points) and d(dirs),
   and two calls bitwise equal;
9. one training step from the same state and batch, kernels against the
   plain MLP: losses and parameters after the step;
10. 50 kernel steps from a random init: the loss falls, K2 launches twice
    a step and K1 four times (teacher and student, coarse and fine); then
    BF16_STEPS steps of the bf16 training path (``train --dtype
    bfloat16``): the loss stays finite, every K2 launch is bf16, two a step;
11. K2 times at the fine shape in both modes against their plain versions
    and their library yardsticks (autograd through ``models.mlp.nerf_mlp``
    in the same dtype), K1 f32 on the same samples (the f32 recompute's
    code alone), K2's peak scratch and its bounds by route,
    ms per step and rays/s for the kernel and the plain training paths,
    and one kernel step under ``torch.profiler`` (idle share, top kernels);
12. K3 against its plain version on what the render hands it (the f32
    coarse pass of RAY_CHUNK golden-camera rays), at (64, 128) and
    (32, 64), with the scalar far and with the per-ray far of
    ``accel_sample_aabb``: rows sorted, every entry within a coarse bin
    of the plain version, 99% within 5e-5 + 1e-5 |t|, two calls bitwise
    equal;
13. the 256x256 f32 accel frame: PSNR against the committed golden
    > 45 dB, K3 once and K1 twice per rendered chunk, every hit ray
    bitwise the unpacked accel frame's;
14. the 800x800 frames (bench.py's size, 16384-ray chunks): f32 accel+K3
    against f32 dense >= 40 dB (bench.py's accel bar), bf16 accel+K3
    against f32 accel+K3 at BF16_FRAME_BAR_DB, and the share of rays
    packed away;
15. serving: the port's HTTP handler on a loopback port answers three
    256x256 /render requests with the bytes of ``render_image`` for each
    seed, and a bad size with 400;
16. times: K3 and the plain chain per call at 16384 x (64, 128), the grid
    build, the 800x800 f32 frames dense, accel with the plain chain and
    accel with K3, the 800x800 bf16 accel+K3 frame, and the device idle
    shares of the accel+K3 frames;
17. the hash encode against its plain version on the render's points
    (16384 golden-camera rays x 64 and x 192), tables U(-1, 1), at the
    paper config and at L = 4, F = 8, f32 and bf16: f32 within 1e-5 x
    max |table|, bf16 within 2 bf16 ulps of max |feature|, two calls
    bitwise equal;
18. one hash-grid step with the kernel against one with the plain encode
    (loss and parameters, phase 9's bars), then HASH_STEPS distillation
    steps from a random init at 4096 rays, 64 + 128, f32, the teacher
    through K1: the loss falls, the encode launches twice a step;
19. frames of the trained field: 256x256 and 800x800 f32 dense with the
    kernel against the plain encode (>= 60 dB), bf16 against f32 (>=
    BF16_FRAME_BAR_DB), the 800x800 accel+K3 frame on a 128^3 grid from
    ``accel.hashgrid_grid_kwargs`` against the dense frame (>= 40 dB),
    PSNR against the lego teacher's frames (reported); two encode
    launches per rendered chunk;
20. times: the encode kernel, its plain version, its bound and one
    ``index_select`` of the same rows (the library yardstick) per call at
    the main path's four shapes — the training step's 4096 rays x 64 and
    x 192 along its own rays, the 800x800 frame's 16384 x 64 and x 192 a
    chunk — f32 and bf16, rows gathered per second; the train step with
    the kernel and with the plain encode, the 800x800 frames dense and
    accel+K3 with their idle shares and top device kernels;
21. the int8 kernel against its plain version on phase 3's inputs (coarse
    sigma-only at 8192 x 64, fine full at 8192 x 192): sigma bitwise
    equal, rgb within 2e-6, two calls bitwise equal;
22. the post-training int8 256x256 frame: against the f32 K1 frame (> 25
    dB), against the plain int8 frame (>= 60 dB), two int8 launches per
    chunk and no K1; the int8 accel+K3 frame on phase 12's grid against
    the dense int8 frame (>= 40 dB);
23. QAT_STEPS int8qat distillation steps from a random init (8x256, 4096
    rays, 64 + 128, the teacher through K1): the loss falls, K1 launches
    only for the teacher, K2 and the int8 kernel never; the trained
    student's int8 kernel frame against its int8qat frame (>= 40 dB), and
    against the lego teacher's (reported);
24. times: the int8 kernel, its plain version and ``torch._int_mm`` of the
    same layers at the phase-21 shapes, the int8 frame with the kernel and
    the plain version, the int8 frame under ``torch.profiler`` (device busy,
    idle share, top kernels), the int8qat step and its peak memory.

Any failed phase exits non-zero. The line before the last is a JSON
summary of the kernels, each with its bound (the larger of its bytes over
the memory rate and its operations over the peak for their type through
the kernel's route — K1 f32 six bf16 passes a product (split-f32), bf16
for K1 bf16 and K2's bf16 mode, K2's f32 mode its recompute as K1 f32
and its dW and W dz as 3xTF32 at the tf32 peak (the f32 entries also
carry their all-CUDA-core bound), f32 on the CUDA cores for K3 and the
hash encode, int8 for the int8 kernel — from this run's shapes; the hash
encode's entry also lists its four shapes in both dtypes); the last line
is the JSON device record.
Never imports JAX.
"""

from __future__ import annotations

import contextlib
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
# bf16: the bars tests/test_fused_mlp.py sets for two bf16 orderings; every
# rgb within its bar, sigma as ``fused_mlp.bf16_sigma_agrees`` holds it (a
# bar on every sample holds only for the plain version's own summation
# order: its f32 sums already leave samples of phase 3's inputs outside
# these bars of the same function evaluated in float64; PERF.md).
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
BF16_STEPS = 10                # the bf16 training path, K2's bf16 mode
# The accel path as bench.py runs it by default (bench.py:536-543).
BENCH_SIZE, BENCH_CHUNK = 800, 16384
GRID_RES, PROBES, STRIDE = 128, 32, 4
ACCEL_BAR_DB = 40.0            # bench.py's accel frame against the dense frame
# K3 against its plain version: tests/test_resample.py's bars.
K3_ATOL, K3_RTOL, K3_SHARE = 5e-5, 1e-5, 0.99


class PhaseFailure(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return -10.0 * math.log10(max(mse, 1e-20))


def timed_ms(fn, reps: int = 3, inner: int = 1, warm: bool = True) -> float:
    """Median wall time of ``reps`` runs after one warm-up (unless the
    caller has just run ``fn``), each run ``inner`` calls bracketed by
    device synchronizations; per call."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
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
        injected = 0
        for line in log.read_text().splitlines():
            entry = re.search(r"entry function '.*?(fused_mlp_bwd_tc_kernel|fused_mlp_tc_kernel|"
                              r"fused_mlp_bwd_bf16_kernel|"
                              r"fused_mlp_f32tc_kernel|reduce_partials|resample_kernel|"
                              r"hash_encode_kernel|int8_mlp_tc_kernel)"
                              r"(I\w*?Lb[01]E)?", line)
            if "(C7519)" in line:              # an arrive ptxas adds before a wgmma
                injected += 1
            elif entry:
                say("2 build", "ptxas: " + "".join(g for g in entry.groups() if g))
            elif "registers" in line or "spill" in line or "wgmma" in line:
                say("2 build", "ptxas: " + line.strip())
        say("2 build", f"ptxas: {injected} warpgroup.arrive injected before wgmmas (C7519)")
        usage = ptxas_usage(log.read_text(), GATHER_KERNELS)
        say("2 build", "ptxas, the hash encode and K3: " + "; ".join(
            f"{name} {regs} registers, spill stores {st} B, loads {ld} B"
            for name, (regs, st, ld) in sorted(usage.items())))
        spilled = [name for name, (_, st, ld) in usage.items() if st or ld]
        if len(usage) != 4 + 7 or spilled:
            raise PhaseFailure(f"the hash encode (4 instances) and K3 (7) as built: "
                               f"{sorted(usage)}; spilled: {spilled}")
    sass = tensor_core_instructions(_build)
    say("2 build", "tensor-core instructions in the SASS: " + ", ".join(
        f"{re.search(TC_KERNEL, fn).group(0)} {count} {kind}"
        for (fn, kind), count in sass.items() if count))
    # K1 (f32 forward and record mode, bf16) and K2 bf16: HGMMA in every
    # instance (sigma_only or not); K2 f32: HMMA in both, every one .TF32.
    hgmma = {kernel: [count for (fn, kind), count in sass.items()
                      if kind == "HGMMA" and re.search(kernel, fn)]
             for kernel in ("fused_mlp_f32tc_kernelILb[01]ELb0E",   # K1 f32
                            "fused_mlp_f32tc_kernelILb[01]ELb1E",   # its record mode
                            "fused_mlp_tc_kernel", "fused_mlp_bwd_bf16_kernel")}
    k2 = {fn: count for (fn, kind), count in sass.items()
          if kind == "HMMA" and "fused_mlp_bwd_tc_kernel" in fn}
    k2_ok = len(k2) == 2 and all(count and sass.get((fn, "TF32"), 0) == count
                                 for fn, count in k2.items())
    for kernel, counts in hgmma.items():
        if len(counts) != 2 or not all(counts):
            raise PhaseFailure(f"{kernel} (both variants) has no HGMMA instructions in the built "
                               f"library")
    if not k2_ok:
        raise PhaseFailure("K2's f32 kernel (fused_mlp_bwd_tc_kernel, both variants) lacks HMMA "
                           "instructions, or has some that are not tf32")
    # The int8 kernel: IGMMA (integer wgmma) in both instances.
    igmma = [count for (fn, kind), count in sass.items()
             if kind == "IGMMA" and re.search(INT8_KERNEL, fn)]
    if len(igmma) != 2 or not all(igmma):
        raise PhaseFailure("int8_mlp_tc_kernel (both variants) has no IGMMA instructions in the "
                           "built library")


# The hash encode's instances (f32, bf16 x paired or generic) and K3's (K
# values a lane: 1, 2, ..., 64), as ptxas names them.
GATHER_KERNELS = r"(hash_encode_kernel|resample_kernel)(I\w+?E)E?v"


def ptxas_usage(log: str, pattern: str) -> dict:
    """{kernel instance: (registers, spill store bytes, spill load bytes)}
    from ``ptxas -v`` output, for the entry functions matching ``pattern``
    (named by its two groups)."""
    usage, fn = {}, None
    for line in log.splitlines():
        head = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if head:
            found = re.search(pattern, head.group(1))
            fn = "".join(found.groups()) if found else None
            continue
        if fn is None:
            continue
        entry = usage.setdefault(fn, [0, 0, 0])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            entry[1:] = [int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            entry[0] = int(regs.group(1))
    return {fn: tuple(v) for fn, v in usage.items()}


MLP_KERNEL = r"fused_mlp(?:_bwd)?_(?:tc|bf16|f32tc)_kernel(?:I(?:Lb[01]E)+)?"
INT8_KERNEL = r"int8_mlp_tc_kernelILb[01]E"
TC_KERNEL = rf"(?:{MLP_KERNEL}|{INT8_KERNEL})"


def tensor_core_instructions(build) -> dict:
    """{(function, kind): count} from ``cuobjdump --dump-sass`` of the built
    library: HGMMA, HMMA and IGMMA (integer ``wgmma``) instructions of each
    instance of the fused MLP kernels and the int8 kernel (TC_KERNEL), the
    HMMA ones also counted by operand type (kind "TF32" or "BF16")."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        raise PhaseFailure(f"cuobjdump failed: {sass.stderr.strip()[-500:]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1) if re.search(TC_KERNEL, head.group(1)) else None
            if fn:
                counts[(fn, "HGMMA")] = counts[(fn, "HMMA")] = counts[(fn, "IGMMA")] = 0
            continue
        for op in ("HGMMA", "HMMA", "IGMMA"):
            if fn and re.search(rf"\b{op}\.", line):
                counts[(fn, op)] += 1
                for kind in ("TF32", "BF16"):
                    if op == "HMMA" and f".{kind}" in line:
                        counts[(fn, kind)] = counts.get((fn, kind), 0) + 1
    return counts


def main_path_inputs(cam, dev, n_rays: int = RAY_CHUNK):
    """The main path's field inputs for ``n_rays`` rays of the frame's
    center rows: stratified samples at the coarse width (64) and at the
    fine width (64 + 128 = 192) per ray."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.ops.sampling import stratified_samples

    _, dirs = camera_rays(cam, H, W, dev)
    first = (H // 2 - n_rays // W // 2) * W
    dirs = dirs.reshape(-1, 3)[first:first + n_rays].contiguous()
    ids = torch.arange(first, first + n_rays, device=dev)
    k_c, k_f = random.split(random.key(0, dev))
    near = torch.as_tensor(cam.near, device=dev)
    far = torch.as_tensor(cam.far, device=dev)
    origin = torch.as_tensor(cam.position, device=dev)
    t_c = stratified_samples(random.fold_in(k_c, ids), near, far, N_COARSE, (n_rays,))
    t_f = stratified_samples(random.fold_in(k_f, ids), near, far, N_COARSE + N_FINE, (n_rays,))
    pts_c = (origin + dirs[:, None, :] * t_c[..., None]).contiguous()
    pts_f = (origin + dirs[:, None, :] * t_f[..., None]).contiguous()
    return pts_c, pts_f, dirs[:, None, :]


def phase_kernel_vs_plain(coarse, fine, cam, dev):
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        bf16_sigma_agrees,
        fused_nerf_mlp,
        fused_nerf_mlp_reference,
    )

    pts_c, pts_f, vd = main_path_inputs(cam, dev)
    cases = {"coarse": (coarse, pts_c, True), "fine": (fine, pts_f, False)}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    timings = []
    saved = save_counts()
    with torch.no_grad():
        for dtype, tol in TOLERANCES.items():
            for name, (net, pts, sigma_only) in cases.items():
                kw = dict(dtype=dtype, sigma_only=sigma_only)
                torch.cuda.synchronize()
                rgb_k, sig_k = fused_nerf_mlp(net, pts, vd, **kw)
                rgb_2, sig_2 = fused_nerf_mlp(net, pts, vd, **kw)
                torch.cuda.synchronize()
                rgb_r, sig_r = fused_nerf_mlp_reference(net, pts, vd, **kw)
                torch.cuda.synchronize()
                shape = tuple(pts.shape[:-1])
                if tuple(sig_k.shape) != shape or tuple(rgb_k.shape) != (*shape, 3):
                    raise PhaseFailure(f"{name}/{dtype}: output shapes {tuple(rgb_k.shape)}, "
                                       f"{tuple(sig_k.shape)} for input {tuple(pts.shape)}")
                if not (torch.isfinite(rgb_k).all() and torch.isfinite(sig_k).all()):
                    raise PhaseFailure(f"{name}/{dtype}: non-finite kernel output")
                bitwise = torch.equal(rgb_k, rgb_2) and torch.equal(sig_k, sig_2)
                rgb_err = float((rgb_k - rgb_r).abs().max())
                sig_err = float((sig_k - sig_r).abs().max())
                sig_excess = float(((sig_k - sig_r).abs()
                                    - tol["sigma_rtol"] * sig_r.abs()).max())
                line = (f"{name} {shape} sigma_only={sigma_only} {dtype}: max|d rgb| "
                        f"{rgb_err:.3e} (atol {tol['rgb_atol']}), max|d sigma| {sig_err:.3e} "
                        f"(atol {tol['sigma_atol']}, rtol {tol['sigma_rtol']}), sigma range "
                        f"[{float(sig_r.min()):.3g}, {float(sig_r.max()):.3g}]")
                if dtype == "float32":
                    ok = rgb_err <= tol["rgb_atol"] and sig_excess <= tol["sigma_atol"]
                    rgb_64, sig_64 = fused_nerf_mlp_reference(net, pts.double(), vd.double(), **kw)

                    def dist(x, ref):
                        return float((x.double() - ref).abs().max())

                    line += (f"; max distance from the float64 evaluation: kernel rgb "
                             f"{dist(rgb_k, rgb_64):.3e} sigma {dist(sig_k, sig_64):.3e}, plain "
                             f"rgb {dist(rgb_r, rgb_64):.3e} sigma {dist(sig_r, sig_64):.3e}")
                    del rgb_64, sig_64
                else:
                    _, sig_64 = fused_nerf_mlp_reference(net, pts.double(), vd.double(), **kw)
                    sig_ok, counts = bf16_sigma_agrees(sig_k, sig_r, sig_64)
                    ok = rgb_err <= tol["rgb_atol"] and sig_ok
                    line += (f"; sigma samples outside the bars of {sig_k.numel()}: kernel vs "
                             f"plain {counts['kernel_vs_plain']} (bar 4 + 5e-5 n), vs float64 "
                             f"kernel {counts['kernel_vs_exact']}, plain "
                             f"{counts['plain_vs_exact']} (bar: kernel <= 2 plain + 2)")
                ok = ok and bitwise
                say("3 kernel", f"{line}; two calls bitwise equal: {bitwise} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailure(f"kernel disagrees with its plain version: {name}/{dtype}")
                errs[dtype] = max(errs[dtype], rgb_err, sig_err)
                timings.append((name, dtype, net, pts, sigma_only))
    restore_counts(saved)                      # comparison launches do not count
    return errs, timings, vd


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

    # The wrapper counts through its module name.
    record.launches, record.bf16_launches = real.launches, real.bf16_launches
    fm.fused_nerf_mlp_backward = record
    try:
        loss, _ = nerf_loss(nets, batch, random.fold_in(key, torch.tensor(0)), cfg)
        loss.backward()
    finally:
        fm.fused_nerf_mlp_backward = real
        real.launches, real.bf16_launches = record.launches, record.bf16_launches
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
    errs = {dtype: 0.0 for dtype in BWD_BARS}
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
            errs[dtype] = max(errs[dtype], *(float((a - b).abs().max())   # parameter gradients
                                             for a, b in zip(got[:2], want[:2])))
            ok = ok and bitwise
            say("8 backward", f"{line}; two calls bitwise equal: {bitwise} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"K2 disagrees with its plain version or is not "
                                   f"deterministic: {name}/{dtype}")
    return errs, inputs["fine"]


def distill_setup(dev, impl: str, dtype: str = "float32"):
    """The training job's state, dataset, config and step key, as
    ``python -m nerf_rs_tpu_torch train`` builds them (``--dtype``)."""
    import torch

    from nerf_rs_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state

    cfg = TrainConfig(batch_rays=TRAIN_RAYS, render=RenderConfig(
        n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=TRAIN_RAYS, impl=impl, dtype=dtype))
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


def phase_train_bf16(dev):
    """The training path in bf16 (``train --dtype bfloat16``): BF16_STEPS
    kernel steps from a random init, counts set to 0 just before and read
    just after; every K2 launch is a bf16 one, two a step."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "pallas", "bfloat16")
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    for step in range(BF16_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    ok = (all(math.isfinite(v) for v in losses)
          and counts["fused_nerf_mlp_backward_bf16"] == 2 * BF16_STEPS
          and counts["fused_nerf_mlp_backward"] == 2 * BF16_STEPS)
    say("10 train", f"{BF16_STEPS} bf16 kernel steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"K2 launches {counts['fused_nerf_mlp_backward']}, bf16 "
        f"{counts['fused_nerf_mlp_backward_bf16']} (expected {2 * BF16_STEPS} each) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("bf16 training went around the bf16 K2 or gave a non-finite loss")
    return counts


def library_backward_ms(net, pts, viewdirs, g_rgb, g_sigma, dtype: str = "float32") -> float:
    """K2's library yardstick: the forward of ``models.mlp.nerf_mlp`` in
    ``dtype`` (cuBLAS products, TF32 off; bf16 on a bf16 tree and inputs, as
    ``library_mlp_ms``) with grad on, and ``torch.autograd.grad`` of
    sum(g_rgb rgb) + sum(g_sigma sigma) to the parameters, the function K2
    computes (parameter gradients, recompute included); median ms. The
    port's kernel path never calls it."""
    import torch

    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tree = {layer: {k: v.detach().to(dt).clone().requires_grad_() for k, v in p.items()}
            for layer, p in net.tree().items()}
    leaves = [t for p in tree.values() for t in p.values()]
    p, d, gr, gs = (x.to(dt) for x in (pts, viewdirs, g_rgb, g_sigma))

    def run():
        rgb, sigma = nerf_mlp(tree, p, d)
        loss = (rgb * gr.reshape(rgb.shape)).sum() + (sigma * gs.reshape(sigma.shape)).sum()
        return torch.autograd.grad(loss, leaves)

    return timed_ms(run)


def profile_step(dev):
    """(wall ms, device busy ms, top device kernels) of one kernel train
    step (student forward, backward and Adam) on a fixed batch, warmed up."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "pallas")
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    step_key = random.fold_in(key, torch.tensor(0))
    train_step(state, batch, step_key, cfg)
    return profile_frame(lambda: train_step(state, batch, step_key, cfg))


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


def accel_cfg(dtype: str = "float32", sampling: str = "pallas", cull: bool = True,
              chunk: int = RAY_CHUNK):
    """bench.py's default accel render: probe culling without per-sample
    masks, ray packing, K1 and K3."""
    from nerf_rs_tpu_torch.config import RenderConfig

    return RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=chunk, impl="pallas",
                        dtype=dtype, sampling_impl=sampling, accel_compact="off",
                        accel_aabb_probes=PROBES, accel_range_stride=STRIDE,
                        accel_cull_rays=cull)


def resample_inputs(coarse, cam, dev, n_rays: int, nc: int, nf: int, grid=None):
    """What render_rays hands K3 for ``n_rays`` center rays of the 256x256
    golden camera, key 0: t_c and sigma_c of the f32 K1 sigma-only coarse
    pass, u from the fine keys, and far — the camera's, or with ``grid``
    the per-ray far_w of ``accel_sample_aabb`` (t_c drawn over each ray's
    occupied range, 32 probes) -> (t_c, sigma_c, u, far, coarse bin width)."""
    import torch

    from nerf_rs_tpu_torch.accel import ray_occupied_range
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.ops.sampling import _batched_uniform, stratified_samples

    _, dirs = camera_rays(cam, H, W, dev)
    first = (H // 2 - n_rays // W // 2) * W
    dirs = dirs.reshape(-1, 3)[first:first + n_rays].contiguous()
    ids = torch.arange(first, first + n_rays, device=dev)
    k_c, k_f = random.split(random.key(0, dev))
    near = torch.as_tensor(cam.near, device=dev)
    far = torch.as_tensor(cam.far, device=dev)
    origin = torch.as_tensor(cam.position, device=dev)
    t_lo, t_hi, far_w = near, far, far
    if grid is not None:
        t_lo, t_hi = ray_occupied_range(grid, origin, dirs, near, far, probes=PROBES)
        far_w = torch.minimum(far, t_hi + (t_hi - t_lo) / nc)
    t_c = stratified_samples(random.fold_in(k_c, ids), t_lo, t_hi, nc, (n_rays,))
    pts = (origin + dirs[:, None, :] * t_c[..., None]).contiguous()
    saved = fused_nerf_mlp.launches
    with torch.no_grad():
        _, sigma = fused_nerf_mlp(coarse, pts, dirs[:, None, :], sigma_only=True)
    fused_nerf_mlp.launches = saved                   # set-up launches do not count
    u = _batched_uniform(random.fold_in(k_f, ids), (n_rays,), nf)
    return t_c, sigma, u, far_w, float(cam.far - cam.near) / nc


def phase_resample_vs_plain(coarse, cam, dev, grid):
    """K3 against its plain version on the render's inputs."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample, fused_resample_reference

    worst = 0.0
    saved = fused_resample.launches
    for nc, nf in ((N_COARSE, N_FINE), (32, 64)):
        for far_kind, g in (("scalar far", None), ("per-ray far", grid)):
            t_c, sigma, u, far, bin_width = resample_inputs(coarse, cam, dev, RAY_CHUNK, nc, nf, g)
            got = fused_resample(t_c, sigma, u, far)
            again = fused_resample(t_c, sigma, u, far)
            want = fused_resample_reference(t_c, sigma, u, far)
            torch.cuda.synchronize()
            err = (got - want).abs()
            share = float((err <= K3_ATOL + K3_RTOL * want.abs()).float().mean())
            max_err = float(err.max())
            ok = (tuple(got.shape) == (RAY_CHUNK, nc + nf) and bool(torch.isfinite(got).all())
                  and bool((got[:, 1:] >= got[:, :-1]).all()) and max_err <= bin_width
                  and share >= K3_SHARE and torch.equal(got, again))
            say("12 resample", f"K3 ({nc}, {nf}) {far_kind} x {RAY_CHUNK} rays: max |d t| "
                f"{max_err:.3e} (bar: a coarse bin, {bin_width:.4f}), share within "
                f"{K3_ATOL:g} + {K3_RTOL:g} |t| {share:.6f} (bar >= {K3_SHARE}), rows sorted "
                f"{bool((got[:, 1:] >= got[:, :-1]).all())}, two calls bitwise equal "
                f"{torch.equal(got, again)} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"K3 disagrees with its plain version: ({nc}, {nf}), {far_kind}")
            worst = max(worst, max_err)
    fused_resample.launches = saved                   # comparison launches do not count
    return worst


def rendered_chunks(grid, cam, size: int, cfg, dev):
    """(hit rays, chunks the packed render renders) for a size x size frame."""
    import torch

    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.render import _image_ray_ranges

    _, dirs = camera_rays(cam, size, size, dev)
    (t0, t1), _, n_hit = _image_ray_ranges(
        grid, torch.as_tensor(cam.position, device=dev), dirs,
        torch.as_tensor(cam.near, device=dev), torch.as_tensor(cam.far, device=dev), cfg)
    hit = (t1 > t0).reshape(size, size)
    n = size * size
    return hit, min(-(-max(int(n_hit), 1) // cfg.ray_chunk), -(-n // cfg.ray_chunk))


def render_accel(coarse, fine, cam, dev, cfg, grid, size: int, key: int = 0):
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_image(coarse, fine, cam, size, size, random.key(key, dev), cfg, device=dev,
                       grid=grid)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if tuple(img.shape) != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise PhaseFailure(f"accel frame: shape {tuple(img.shape)} or non-finite values")
    return img, ms


def phase_accel_frame(coarse, fine, cam, dev, grid):
    """The accel path's main run: the 256x256 f32 frame with K1 and K3,
    with the launch counts set to 0 just before and read just after."""
    import torch

    from nerf_rs_tpu_torch.io.image import load_ppm
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample

    cfg = accel_cfg()
    hit, chunks = rendered_chunks(grid, cam, H, cfg, dev)
    torch.cuda.synchronize()
    fused_nerf_mlp.launches = fused_nerf_mlp_backward.launches = fused_resample.launches = 0
    packed, ms = render_accel(coarse, fine, cam, dev, cfg, grid, H)
    launches = {"fused_nerf_mlp": fused_nerf_mlp.launches, "fused_resample": fused_resample.launches,
                "fused_nerf_mlp_backward": fused_nerf_mlp_backward.launches}
    unpacked, _ = render_accel(coarse, fine, cam, dev, cfg.replace(accel_cull_rays=False), grid, H)
    golden_db = psnr(packed.cpu().numpy(), load_ppm(GOLDEN_PPM))
    bitwise = torch.equal(packed[hit], unpacked[hit])
    ok = (golden_db > GOLDEN_BAR_DB and launches["fused_resample"] == chunks
          and launches["fused_nerf_mlp"] == 2 * chunks
          and launches["fused_nerf_mlp_backward"] == 0 and bitwise)
    say("13 accel", f"f32 accel frame {H}x{W} (grid {GRID_RES}^3, {PROBES} probes, stride "
        f"{STRIDE}, packing, K3): PSNR vs committed golden {golden_db:.2f} dB (bar > "
        f"{GOLDEN_BAR_DB}); {int(hit.sum())} of {H * W} rays hit, {chunks} chunks rendered; "
        f"launches K3 {launches['fused_resample']} (expected {chunks}), K1 "
        f"{launches['fused_nerf_mlp']} (expected {2 * chunks}); hit rays bitwise equal to "
        f"the unpacked accel frame: {bitwise}; {ms:.1f} ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the accel frame misses the golden bar, went around K1/K3, or packing "
                           "changed a hit ray")
    return launches


def phase_bench_frames(coarse, fine, cam, dev, grid, card):
    """The 800x800 frames of bench.py's default run."""
    from nerf_rs_tpu_torch.config import RenderConfig

    size = BENCH_SIZE
    dense_cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=BENCH_CHUNK,
                             impl="pallas")
    dense, dense_ms = render_accel(coarse, fine, cam, dev, dense_cfg, None, size)
    cfg = accel_cfg(chunk=BENCH_CHUNK)
    fast, fast_ms = render_accel(coarse, fine, cam, dev, cfg, grid, size)
    fast_bf16, bf16_ms = render_accel(coarse, fine, cam, dev, accel_cfg("bfloat16", chunk=BENCH_CHUNK),
                                      grid, size)
    accel_db = psnr(fast.cpu().numpy(), dense.cpu().numpy())
    bf16_db = psnr(fast_bf16.cpu().numpy(), fast.cpu().numpy())
    hit, chunks = rendered_chunks(grid, cam, size, cfg, dev)
    n = size * size
    ok = accel_db >= ACCEL_BAR_DB and bf16_db >= BF16_FRAME_BAR_DB
    say("14 800", f"{size}x{size} 16384-ray chunks: f32 accel+K3 vs f32 dense {accel_db:.2f} dB "
        f"(bar >= {ACCEL_BAR_DB}); bf16 accel+K3 vs f32 accel+K3 {bf16_db:.2f} dB (bar >= "
        f"{BF16_FRAME_BAR_DB}); rays that miss {1 - float(hit.float().mean()):.4f}, packed away "
        f"(not rendered) {1 - chunks * BENCH_CHUNK / n:.4f} ({chunks} of {-(-n // BENCH_CHUNK)} "
        f"chunks); first frames (with first-use costs) dense {dense_ms:.1f} ms, accel f32 "
        f"{fast_ms:.1f} ms, accel bf16 {bf16_ms:.1f} ms on {card} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the 800x800 accel frames miss their bars")
    return dense_cfg, cfg, dense.cpu().numpy()


def phase_serve(dev):
    """The viewer: the port's HTTP handler on a loopback port, serving the
    accel path with K1 and K3."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from nerf_rs_tpu_torch import api, serve
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.image import pixels_to_rgba
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    api._state.clear()
    api.init_renderer(accel=True, device=dev, cfg=RenderConfig(
        ray_chunk=16384, accel_cull_rays=True, impl="pallas", sampling_impl="pallas"))
    state = dict(api._state)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        same = []
        for seed in range(3):
            t0 = time.perf_counter()
            body = urllib.request.urlopen(f"{base}/render?width=256&height=256&seed={seed}",
                                          timeout=300).read()
            ms = (time.perf_counter() - t0) * 1e3
            want = pixels_to_rgba(render_image(
                state["params"]["coarse"], state["params"]["fine"], state["camera"], 256, 256,
                random.key(seed, dev), state["cfg"], device=dev, grid=state["grid"]))
            same.append(body == want.tobytes())
            say("15 serve", f"GET /render 256x256 seed {seed}: {len(body)} bytes in {ms:.1f} ms, "
                f"equal to render_image's bytes: {same[-1]}")
        try:
            urllib.request.urlopen(f"{base}/render?width=0&height=256", timeout=60)
            bad = None
        except urllib.error.HTTPError as e:
            bad = e.code
    finally:
        srv.shutdown()
        srv.server_close()
        api._state.clear()
    ok = all(same) and bad == 400
    say("15 serve", f"bad size answered {bad} (expected 400) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the viewer's frames differ from render_image, or a bad size was not "
                           "refused")


def profile_frame(fn):
    """(wall ms, device busy ms, the top device kernels by time) of one
    run of ``fn`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall, sum(by_name.values()), top


def phase_accel_times(coarse, fine, cam, dev, grid, card, dense_cfg, cfg):
    """K3 and the plain chain per call, the grid build, the 800x800 frames
    (f32 dense and accel, bf16 accel) and the accel+K3 frames' device idle
    shares."""
    import torch

    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample, fused_resample_reference

    saved = save_counts()
    t_c, sigma, u, far, _ = resample_inputs(coarse, cam, dev, BENCH_CHUNK, N_COARSE, N_FINE)
    k3_ms = timed_ms(lambda: fused_resample(t_c, sigma, u, far), inner=20)
    plain_ms = timed_ms(lambda: fused_resample_reference(t_c, sigma, u, far), inner=20)
    say("16 times", f"{card}: K3 {BENCH_CHUNK} x ({N_COARSE}, {N_FINE}): kernel {k3_ms:.4f} ms, "
        f"plain chain {plain_ms:.4f} ms per call (median of 3 runs of 20 calls)")
    grid_ms = timed_ms(lambda: build_scene_grid(coarse, fine, resolution=GRID_RES))
    say("16 times", f"{card}: grid build, two {GRID_RES}^3 sweeps through K1 (bf16, "
        f"sigma-only, tensor cores): {grid_ms:.1f} ms (median of 3)")
    size = BENCH_SIZE
    frames = {}
    for label, c, g, warm in (("f32 dense", dense_cfg, None, False),
                              ("f32 accel, plain chain", cfg.replace(sampling_impl="xla"), grid,
                               True),
                              ("f32 accel, K3", cfg, grid, False),
                              ("bf16 accel, K3", cfg.replace(dtype="bfloat16"), grid, True)):
        frames[label] = timed_ms(lambda: render_accel(coarse, fine, cam, dev, c, g, size),
                                 warm=warm)
        say("16 times", f"{card}: {size}x{size} frame, {label}: {frames[label]:.1f} ms, "
            f"{size * size / frames[label] * 1e3:,.0f} rays/s (median of 3)")
    for label, c in (("f32 accel+K3", cfg), ("bf16 accel+K3", cfg.replace(dtype="bfloat16"))):
        wall, busy, top = profile_frame(lambda: render_accel(coarse, fine, cam, dev, c, grid, size))
        if busy > 0:
            kernels = "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top)
            say("16 times", f"{card}: {label} {size}x{size} frame under torch.profiler: wall "
                f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share {1 - busy / wall:.4f}; "
                f"top: {kernels}")
        else:
            say("16 times", f"{card}: torch.profiler saw no device time: idle share not measured")
    restore_counts(saved)                      # timing launches do not count
    return k3_ms, plain_ms


# The hash-grid family (phases 17-20): the paper config, distilled from the
# lego networks with the JAX CLI's hash-grid recipe (nerf_rs_tpu/cli.py:384-402).
HASH_STEPS = 300
HASH_RECIPE = dict(lr_init=1e-2, lr_final=1e-4, adam_eps=1e-15)
HASH_WIDE = dict(levels=4, features=8)          # train --hash-levels 4 --hash-features 8
# One H100 SXM's data-sheet peaks at 700 W, for the bounds of the kernels line.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12           # dense tf32 tensor-core peak
BF16_FLOP_S = 989e12           # dense bf16 tensor-core peak
SPLIT_F32_PASSES = 6           # bf16 products an f32 product takes on K1 f32's route
# The acceptance bar of the tensor-core K1: a bf16 fine call at most a
# quarter of the CUDA-core bf16 kernel's 64.741 ms (PERF.md, PR 5).
BF16_FINE_TARGET_MS = 16.0


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def bound(n_bytes: float, ops: float, peak_ops: float):
    """(ms, "bytes" or "operations"): the least time for ``n_bytes`` moved
    at the memory rate and ``ops`` done at ``peak_ops``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlp_bound(net, pts, viewdirs, peak_ops: float, weight_bytes: int, passes: int = 1):
    """K1's bound for one full call of ``net`` at these inputs: points,
    dirs and the weights (``weight_bytes`` each, f32 biases) read once,
    rgb and sigma written once; the products at ``peak_ops``, ``passes``
    operations a product operation (SPLIT_F32_PASSES for split-f32)."""
    n, rays = pts.numel() // 3, viewdirs.numel() // 3
    w = sum(int(p["kernel"].numel()) * weight_bytes + 4 * int(p["bias"].numel())
            for p in net.tree().values())
    return bound(4 * (n * 7 + rays * 3) + w, passes * mlp_flops(net, False) * n, peak_ops)


def backward_bounds(net, pts, viewdirs, g_rgb, g_sigma) -> dict:
    """K2's bounds for one full call at these inputs, (ms, "bytes" or
    "operations") by route: points, dirs and cotangents read once, the
    weights read and their gradients written once (4 or 2 bytes a weight);
    three forwards of products. "float32" is the f32 mode's route: the
    recompute as K1 f32 (six bf16 passes a product) and the dW and W dz
    products as 3xTF32 (three tf32 products each); "cuda_cores" all three
    forwards on the CUDA cores; "bfloat16" all three in bf16."""
    n = pts.numel() // 3
    fwd = mlp_flops(net, False) * n
    io = 4 * (pts.numel() + viewdirs.numel() + g_rgb.numel() + g_sigma.numel())
    n_w = sum(int(p.numel()) for p in net.parameters())

    def at(n_bytes, ms):
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= ms else (ms, "operations")

    return {"float32": at(io + 8 * n_w, (SPLIT_F32_PASSES * fwd / BF16_FLOP_S
                                         + 3 * 2 * fwd / TF32_FLOP_S) * 1e3),
            "cuda_cores": at(io + 8 * n_w, 3 * fwd / F32_FLOP_S * 1e3),
            "bfloat16": at(io + 6 * n_w, 3 * fwd / BF16_FLOP_S * 1e3)}


def library_mlp_ms(net, pts, viewdirs, dtype: str, sigma_only: bool) -> float:
    """The library yardstick: ``models.mlp.nerf_mlp`` (cuBLAS products,
    torch's encode and elementwise ops) in ``dtype`` on inputs and weights
    already in it, median ms of a call. The port's kernel path never calls
    it."""
    import torch

    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tree = {layer: {k: v.detach().to(dt) for k, v in p.items()} for layer, p in net.tree().items()}
    p, d = pts.to(dt), viewdirs.to(dt)
    return timed_ms(lambda: nerf_mlp(tree, p, d, sigma_only=sigma_only))


def mlp_flops(net, sigma_only: bool) -> int:
    """Forward FLOPs per sample of a NeRF MLP: two per weight of the layers
    it runs (the encode and the activations are a few hundred more)."""
    skip = ("bottleneck", "viewdirs", "rgb") if sigma_only else ()
    return 2 * sum(int(p["kernel"].numel()) for layer, p in net.tree().items()
                   if layer not in skip)


@contextlib.contextmanager
def plain_encode():
    """The hash encode's plain version on CUDA tensors, inside the same
    autograd function and backward: the comparison side of phases 18-20."""
    import nerf_rs_tpu_torch.ops.kernels.hash_encode as he

    real = he._forward
    he._forward = he.hash_encode_reference
    try:
        yield
    finally:
        he._forward = real


def counters():
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample

    return (fused_nerf_mlp, fused_nerf_mlp_backward, fused_resample, fused_hash_encode,
            fused_int8_mlp)


def save_counts():
    """Every launch count: each wrapper's, then K1's tensor-core count and
    K2's bf16 count."""
    fns = counters()
    return [fn.launches for fn in fns] + [fns[0].tc_launches, fns[1].bf16_launches]


def restore_counts(saved) -> None:
    fns = counters()
    for fn, n in zip(fns, saved):
        fn.launches = n
    fns[0].tc_launches, fns[1].bf16_launches = saved[-2:]


def zero_counts() -> None:
    restore_counts([0] * (len(counters()) + 2))


def read_counts() -> dict:
    fns = counters()
    return {**{fn.__name__: fn.launches for fn in fns}, "fused_nerf_mlp_tc": fns[0].tc_launches,
            "fused_nerf_mlp_backward_bf16": fns[1].bf16_launches}


def phase_hash_vs_plain(cam, dev):
    """The encode kernel against its plain version at the paper config and
    the wide-F config, on the points the render hands it (16384 golden
    camera rays at 64 coarse and 192 fine samples), tables U(-1, 1)."""
    import torch

    from nerf_rs_tpu_torch.config import HashGridConfig
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode, hash_encode_reference

    pts_c, pts_f, _ = main_path_inputs(cam, dev, BENCH_CHUNK)
    saved = save_counts()
    worst = 0.0
    for name, cfg in (("paper", HashGridConfig()), ("wide F=8", HashGridConfig(**HASH_WIDE))):
        gen = torch.Generator(device=dev).manual_seed(17)
        t32 = torch.rand((cfg.levels, 1 << cfg.table_log2, cfg.features), generator=gen,
                         device=dev) * 2.0 - 1.0
        top = float(t32.abs().max())
        for dtype in (torch.float32, torch.bfloat16):
            tables = t32.to(dtype)
            for label, pts in (("coarse", pts_c), ("fine", pts_f)):
                got = fused_hash_encode(tables, pts, cfg)
                again = fused_hash_encode(tables, pts, cfg)
                want = hash_encode_reference(tables, pts, cfg)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.float32:
                    bar, what = 1e-5 * top, "1e-5 x max|table|"
                    worst = max(worst, err)
                else:
                    bar, what = 2 * bf16_ulp(float(want.float().abs().max())), \
                        "2 bf16 ulps of max|feature|"
                shape = (*pts.shape[:-1], cfg.levels * cfg.features)
                ok = (tuple(got.shape) == shape and got.dtype == dtype
                      and bool(torch.isfinite(got).all()) and err <= bar
                      and torch.equal(got, again))
                say("17 hash", f"{name} (L={cfg.levels}, T=2^{cfg.table_log2}, F={cfg.features}) "
                    f"{str(dtype)[6:]} {label} {tuple(pts.shape[:-1])}: max |kernel - plain| "
                    f"{err:.3e} (bar {bar:.3e}, {what}), exactly equal "
                    f"{torch.equal(got.float(), want.float())}, two calls bitwise equal "
                    f"{torch.equal(got, again)} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailure(f"the hash encode disagrees with its plain version: "
                                       f"{name}/{dtype}/{label}")
                del got, again, want
    restore_counts(saved)                      # comparison launches do not count
    return worst


def hash_setup(dev):
    """The hash-grid training job, as ``train --model hashgrid`` builds it
    at its defaults: the paper field, 4096 rays, 64 + 128 samples, the
    recipe above, the lego teacher through K1."""
    import torch

    from nerf_rs_tpu_torch.config import HashGridConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state

    rcfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=TRAIN_RAYS, impl="pallas",
                        model="hashgrid", hash=HashGridConfig())
    cfg = TrainConfig(batch_rays=TRAIN_RAYS, render=rcfg, **HASH_RECIPE)
    state = create_train_state(torch.Generator(device=dev).manual_seed(cfg.seed), cfg)
    teacher = {net: load_nerf_params(find_lego_assets() / net) for net in ("coarse", "fine")}
    dataset = DistillationDataset(teacher, cfg=rcfg.replace(model="mlp"), seed=cfg.seed,
                                  device=dev)
    return state, dataset, cfg, random.key(cfg.seed + 1, dev)


def phase_hash_step_vs_plain(dev):
    """One hash-grid step from the same state and batch, the encode kernel
    against its plain version (same backward): loss and parameters."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    saved = save_counts()
    results, batch = {}, None
    for label in ("kernel", "plain"):
        state, dataset, cfg, key = hash_setup(dev)
        if batch is None:
            batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
        with plain_encode() if label == "plain" else contextlib.nullcontext():
            state, metrics = train_step(state, batch, random.fold_in(key, torch.tensor(0)), cfg)
        torch.cuda.synchronize()
        results[label] = (float(metrics["loss"]), state.params["shared"])
    restore_counts(saved)                      # comparison launches do not count
    (loss_k, field_k), (loss_p, field_p) = results["kernel"], results["plain"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    diffs = {name: (p.detach() - field_p.weights[name].detach()).abs()
             for name, p in field_k.weights.items()}
    worst = max(float(d.max()) for d in diffs.values())
    share = sum(int((d > 1e-5).sum()) for d in diffs.values()) / sum(d.numel() for d in diffs.values())
    same = all(torch.equal(p, field_p.weights[n]) for n, p in field_k.weights.items())
    ok = loss_rel <= 1e-5 and worst < 2 * cfg.lr_init and share < 1e-3
    say("18 hash step", f"one f32 hash-grid step, encode kernel vs plain encode: loss {loss_k:.7f} "
        f"vs {loss_p:.7f} (rel {loss_rel:.2e}, bar 1e-5); params after the step: max |d| "
        f"{worst:.3e} (bar < {2 * cfg.lr_init:g}), share of entries > 1e-5 {share:.2e} (bar < "
        f"1e-3), bitwise equal {same} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the hash-grid step with the kernel disagrees with the plain step")


def phase_hash_train(dev):
    """The hash-grid training path: HASH_STEPS steps from a random init,
    with the launch counts set to 0 just before and read just after."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = hash_setup(dev)
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for step in range(HASH_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    secs = time.perf_counter() - t0
    launches = read_counts()
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    ok = (all(math.isfinite(v) for v in losses) and last < first
          and launches["fused_hash_encode"] == 2 * HASH_STEPS
          and launches["fused_nerf_mlp"] == 2 * HASH_STEPS
          and launches["fused_nerf_mlp_backward"] == 0)
    say("18 hash train", f"{HASH_STEPS} steps, paper hash grid (L=16, T=2^17, F=2), {TRAIN_RAYS} "
        f"rays, {N_COARSE}+{N_FINE} samples, lr 1e-2 -> 1e-4, eps 1e-15: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, mean of the first 10 {first:.5f}, of the last 10 {last:.5f}; launches "
        f"hash encode {launches['fused_hash_encode']} (expected {2 * HASH_STEPS}), K1 (teacher) "
        f"{launches['fused_nerf_mlp']} (expected {2 * HASH_STEPS}), K2 "
        f"{launches['fused_nerf_mlp_backward']} (expected 0); {secs:.1f} s with the teacher "
        f"batches -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("hash-grid training did not reduce the loss, or went around the encode "
                           "kernel")
    return state, cfg, launches


def hash_render_cfg(hcfg, dtype: str = "float32"):
    from nerf_rs_tpu_torch.config import RenderConfig

    return RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=BENCH_CHUNK,
                        model="hashgrid", hash=hcfg, dtype=dtype)


def phase_hash_frames(field, hcfg, cam, dev, lego_256, lego_800, card):
    """Frames of the trained field: dense with the kernel and with the
    plain encode at 256x256 and 800x800, bf16, the 800x800 accel+K3 frame
    on a grid swept through the field, and PSNR against the lego teacher."""
    import torch

    from nerf_rs_tpu_torch.accel import build_scene_grid, hashgrid_grid_kwargs

    def frame(size, cfg, grid=None, plain=False):
        with plain_encode() if plain else contextlib.nullcontext():
            img, ms = render_accel(field, field, cam, dev, cfg, grid, size)
        return img.cpu().numpy(), ms

    dense = hash_render_cfg(hcfg)
    out = {}
    for size in (H, BENCH_SIZE):
        chunks = -(-size * size // BENCH_CHUNK)
        torch.cuda.synchronize()
        zero_counts()
        out[size], ms = frame(size, dense)
        launches = read_counts()
        plain, plain_ms = frame(size, dense, plain=True)
        plain_db = psnr(plain, out[size])
        teacher_db = psnr(out[size], lego_256 if size == H else lego_800)
        ok = (plain_db >= PLAIN_BAR_DB and launches["fused_hash_encode"] == 2 * chunks
              and launches["fused_nerf_mlp"] == 0)
        say("19 hash frames", f"{size}x{size} f32 dense, {chunks} chunks: encode launches "
            f"{launches['fused_hash_encode']} (expected {2 * chunks}); plain-encode frame vs "
            f"kernel frame {plain_db:.2f} dB (bar >= {PLAIN_BAR_DB}); vs the lego teacher's frame "
            f"{teacher_db:.2f} dB (reported); first frames {ms:.1f} ms kernel, {plain_ms:.1f} ms "
            f"plain on {card} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"the {size}x{size} hash-grid frame went around the kernel or "
                               f"differs from the plain encode's")
    bf16, _ = frame(BENCH_SIZE, hash_render_cfg(hcfg, "bfloat16"))
    bf16_db = psnr(bf16, out[BENCH_SIZE])
    grid_cfg = hash_render_cfg(hcfg)
    t0 = time.perf_counter()
    grid = build_scene_grid(field, field, resolution=GRID_RES, **hashgrid_grid_kwargs(grid_cfg))
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    acfg = accel_cfg(chunk=BENCH_CHUNK).replace(model="hashgrid", hash=hcfg)
    hit, chunks = rendered_chunks(grid, cam, BENCH_SIZE, acfg, dev)
    torch.cuda.synchronize()
    zero_counts()
    fast, fast_ms = frame(BENCH_SIZE, acfg, grid)
    launches = read_counts()
    accel_db = psnr(fast, out[BENCH_SIZE])
    ok = (bf16_db >= BF16_FRAME_BAR_DB and accel_db >= ACCEL_BAR_DB
          and launches["fused_hash_encode"] == 2 * chunks
          and launches["fused_resample"] == chunks)
    say("19 hash frames", f"{BENCH_SIZE}x{BENCH_SIZE}: bf16 dense vs f32 dense {bf16_db:.2f} dB (bar "
        f">= {BF16_FRAME_BAR_DB}); grid {GRID_RES}^3 swept through the field in {grid_ms:.1f} ms, "
        f"{float(grid.occ.float().mean()):.4f} of the cells occupied; f32 accel+K3 ({PROBES} "
        f"probes, stride {STRIDE}, packing) vs f32 dense {accel_db:.2f} dB (bar >= "
        f"{ACCEL_BAR_DB}); {chunks} chunks rendered, launches encode "
        f"{launches['fused_hash_encode']} (expected {2 * chunks}), K3 "
        f"{launches['fused_resample']} (expected {chunks}); rays that miss "
        f"{1 - float(hit.float().mean()):.4f}; first accel frame {fast_ms:.1f} ms -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the hash-grid bf16 or accel frames miss their bars, or went around the "
                           "kernels")
    return grid, dense, acfg


def step_points(batch, samples: int, dev):
    """Points along a training batch's own rays: ``samples`` stratified t
    a ray over [near, far] (the coarse pass's layout, and at 192 the fine
    pass's count), ray-ordered as the step hands them to the encode."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.sampling import stratified_samples

    rays = batch["origins"].shape[0]
    keys = random.fold_in(random.key(0, dev), torch.arange(rays, device=dev))
    t = stratified_samples(keys, batch["near"], batch["far"], samples, (rays,))
    return (batch["origins"][:, None, :] + batch["dirs"][:, None, :] * t[..., None]).contiguous()


def encode_bound(hc, n: int, rows: int, element_bytes: int):
    """The encode's bound for ``n`` samples: the points read once, the
    ``rows`` distinct table rows the samples' corners touch read once, the
    output written once; its operations at the f32 peak."""
    return bound(12 * n + element_bytes * hc.features * (rows + n * hc.levels),
                 n * hc.levels * (3 * 6 + 8 * 3 + 8 * 2 * hc.features), F32_FLOP_S)


def phase_hash_times(field, cfg, cam, dev, grid, dense, acfg, card):
    """The encode kernel, its plain version, its bound and one index_select
    of the same rows per call at the main path's four shapes (the training
    step's 4096 rays x 64 and x 192 along its own rays, the 800x800 frame's
    16384 x 64 and x 192 a chunk), f32 and bf16; train-step times with the
    kernel and the plain encode; the 800x800 frames with their idle
    shares."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import (
        _Corners,
        _lattice,
        fused_hash_encode,
        hash_encode_reference,
    )
    from nerf_rs_tpu_torch.train import train_step

    hcfg = cfg.render.hash
    saved = save_counts()
    state, dataset, cfg, key = hash_setup(dev)
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    pts_c, pts_f, _ = main_path_inputs(cam, dev, BENCH_CHUNK)
    shapes = {(TRAIN_RAYS, N_COARSE): step_points(batch, N_COARSE, dev),
              (TRAIN_RAYS, N_COARSE + N_FINE): step_points(batch, N_COARSE + N_FINE, dev),
              (BENCH_CHUNK, N_COARSE): pts_c, (BENCH_CHUNK, N_COARSE + N_FINE): pts_f}
    tables32 = field.weights["hash_tables"].detach()
    table_rows = hcfg.levels * (1 << hcfg.table_log2)
    times = {}
    for (rays, samples), pts in shapes.items():
        n = pts.numel() // 3
        corners = _Corners(_lattice(pts, hcfg), hcfg, 1 << hcfg.table_log2, dev)
        idx = torch.cat([corners(c)[0].reshape(-1) for c in range(8)])
        touched = torch.zeros(table_rows, dtype=torch.bool, device=dev)
        touched[idx] = True
        rows = int(touched.sum())
        for dtype in (torch.float32, torch.bfloat16):
            tables = tables32.to(dtype)
            flat = tables.reshape(-1, hcfg.features)
            k_ms = timed_ms(lambda: fused_hash_encode(tables, pts, hcfg), inner=10)
            p_ms = timed_ms(lambda: hash_encode_reference(tables, pts, hcfg), inner=2)
            lib_ms = timed_ms(lambda: flat.index_select(0, idx), inner=10)
            bnd = encode_bound(hcfg, n, rows, tables.element_size())
            times[(rays, samples, dtype)] = dict(shape=[rays, samples], dtype=str(dtype)[6:],
                                                 ms=k_ms, plain_ms=p_ms, bound_ms=bnd[0],
                                                 bound_by=bnd[1], library_ms=lib_ms)
            say("20 hash times", f"{card}: hash encode {rays} x {samples} {str(dtype)[6:]} "
                f"(L={hcfg.levels}, F={hcfg.features}): kernel {k_ms:.4f} ms, plain {p_ms:.3f} "
                f"ms, index_select of the same {idx.numel()} rows {lib_ms:.4f} ms per call "
                f"(medians of 3); bound {bnd[0]:.4f} ms ({bnd[1]}; {rows} distinct rows), "
                f"{bnd[0] / k_ms:.1%} of it; {n * hcfg.levels * 8 / k_ms * 1e3:.4g} rows "
                f"gathered per s")
        del idx, corners, touched
    step_key = random.fold_in(key, torch.tensor(0))
    step_ms = {"kernel": timed_ms(lambda: train_step(state, batch, step_key, cfg))}
    with plain_encode():
        step_ms["plain"] = timed_ms(lambda: train_step(state, batch, step_key, cfg))
    for label in ("kernel", "plain"):
        say("20 hash times", f"{card}: hash-grid train step ({label} encode), {TRAIN_RAYS} rays "
            f"{N_COARSE}+{N_FINE}, f32: {step_ms[label]:.1f} ms, "
            f"{TRAIN_RAYS / step_ms[label] * 1e3:,.0f} rays/s fwd+bwd (median of 3, teacher batch "
            f"excluded)")
    size = BENCH_SIZE
    for label, c, g in (("dense", dense, None), ("accel, K3", acfg, grid)):
        ms = timed_ms(lambda: render_accel(field, field, cam, dev, c, g, size), warm=False)
        wall, busy, top = profile_frame(lambda: render_accel(field, field, cam, dev, c, g, size))
        line = (f"{card}: hash-grid {size}x{size} f32 frame, {label}: {ms:.1f} ms, "
                f"{size * size / ms * 1e3:,.0f} rays/s (median of 3)")
        if busy > 0:
            kernels = "; ".join(f"{name[:60]} {t:.1f} ms" for name, t in top)
            line += (f"; under torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
                     f"idle share {1 - busy / wall:.4f}; top: {kernels}")
        else:
            line += "; torch.profiler saw no device time: idle share not measured"
        say("20 hash times", line)
    restore_counts(saved)                      # timing launches do not count
    return times


# The int8 W8A8 family (phases 21-24): the lego networks quantized after
# training (render --impl int8), and a student distilled through the QAT
# forward as the JAX CLI's train defaults with --impl int8qat do.
QAT_STEPS = 50
INT8_RGB_ATOL = 2e-6           # only the kernel's expf may differ from torch.sigmoid's
INT8_VS_F32_BAR_DB = 25.0      # tests/test_quant.py:76, post-training int8 vs exact frame
QAT_BAR_DB = 40.0              # the trained student's kernel frame vs its fake-quant frame
INT8_OPS_S = 1979e12           # one H100 SXM's dense int8 tensor-core peak (data sheet, 700 W)


@contextlib.contextmanager
def plain_int8():
    """The int8 kernel's plain version on CUDA tensors, wherever the render
    path asks for the kernel: the comparison side of phases 22 and 24."""
    import nerf_rs_tpu_torch.ops.kernels.int8_mlp as im

    real = im.fused_int8_mlp
    im.fused_int8_mlp = im.fused_int8_mlp_reference
    try:
        yield
    finally:
        im.fused_int8_mlp = real


def phase_int8_vs_plain(coarse, fine, cam, dev):
    """The int8 kernel against its plain version on phase 3's inputs: the
    coarse network sigma-only at RAY_CHUNK x 64, the fine one full at
    RAY_CHUNK x 192. Sigma bitwise, rgb within INT8_RGB_ATOL, two calls
    bitwise equal."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, fused_int8_mlp_reference

    pts_c, pts_f, vd = main_path_inputs(cam, dev)
    saved = save_counts()
    worst, cases = 0.0, []
    with torch.no_grad():
        for name, net, pts, sigma_only in (("coarse", coarse, pts_c, True),
                                           ("fine", fine, pts_f, False)):
            rgb, sig = fused_int8_mlp(net, pts, vd, sigma_only=sigma_only)
            rgb2, sig2 = fused_int8_mlp(net, pts, vd, sigma_only=sigma_only)
            rgb_r, sig_r = fused_int8_mlp_reference(net, pts, vd, sigma_only=sigma_only)
            torch.cuda.synchronize()
            shape = tuple(pts.shape[:-1])
            finite = bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(sig).all())
            same_sigma = torch.equal(sig, sig_r)
            rgb_err = float((rgb - rgb_r).abs().max())
            sig_err = float((sig - sig_r).abs().max())
            bitwise = torch.equal(rgb, rgb2) and torch.equal(sig, sig2)
            ok = (tuple(sig.shape) == shape and tuple(rgb.shape) == (*shape, 3) and finite
                  and same_sigma and rgb_err <= INT8_RGB_ATOL and bitwise)
            say("21 int8", f"{name} {shape} sigma_only={sigma_only}: sigma bitwise equal "
                f"{same_sigma} ({int((sig != sig_r).sum())} samples differ, max |d sigma| "
                f"{sig_err:.3e}), max |d rgb| {rgb_err:.3e} (atol {INT8_RGB_ATOL}), two calls "
                f"bitwise equal {bitwise} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"the int8 kernel disagrees with its plain version: {name}")
            worst = max(worst, rgb_err, sig_err)
            cases.append((name, net, pts, sigma_only))
    restore_counts(saved)                      # comparison launches do not count
    return worst, cases, vd


def phase_int8_frames(coarse, fine, cam, dev, img_f32, grid):
    """The int8 render path's main run: the post-training W8A8 256x256
    frame through the kernel, with the counts set to 0 just before and read
    just after; against the f32 K1 frame and the plain int8 frame; then
    the same frame on the accel path (phase 12's grid, K3)."""
    import torch

    n_chunks = -(-H * W // RAY_CHUNK)
    torch.cuda.synchronize()
    zero_counts()
    img, ms = render(coarse, fine, cam, dev, "int8", "float32")
    launches = read_counts()
    with plain_int8():
        plain, plain_ms = render(coarse, fine, cam, dev, "int8", "float32")
    f32_db, plain_db = psnr(img, img_f32), psnr(plain, img)
    ok = (f32_db > INT8_VS_F32_BAR_DB and plain_db >= PLAIN_BAR_DB
          and launches["fused_int8_mlp"] == 2 * n_chunks and launches["fused_nerf_mlp"] == 0
          and launches["fused_nerf_mlp_backward"] == 0)
    say("22 int8 frames", f"post-training int8 frame {H}x{W} {N_COARSE}+{N_FINE}: vs the f32 K1 "
        f"frame {f32_db:.2f} dB (bar > {INT8_VS_F32_BAR_DB}); plain int8 frame vs kernel frame "
        f"{plain_db:.2f} dB (bar >= {PLAIN_BAR_DB}); launches int8 {launches['fused_int8_mlp']} "
        f"(expected {2 * n_chunks}), K1 {launches['fused_nerf_mlp']} (expected 0); first frames "
        f"{ms:.1f} ms kernel, {plain_ms:.1f} ms plain -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the int8 frame misses its bars or went around the int8 kernel")
    cfg = accel_cfg().replace(impl="int8")
    hit, chunks = rendered_chunks(grid, cam, H, cfg, dev)
    torch.cuda.synchronize()
    zero_counts()
    fast, fast_ms = render_accel(coarse, fine, cam, dev, cfg, grid, H)
    accel = read_counts()
    accel_db = psnr(fast.cpu().numpy(), img)
    ok = (accel_db >= ACCEL_BAR_DB and accel["fused_int8_mlp"] == 2 * chunks
          and accel["fused_resample"] == chunks and accel["fused_nerf_mlp"] == 0)
    say("22 int8 frames", f"int8 accel frame {H}x{W} (grid {GRID_RES}^3, {PROBES} probes, stride "
        f"{STRIDE}, packing, K3) vs the dense int8 frame {accel_db:.2f} dB (bar >= "
        f"{ACCEL_BAR_DB}); {chunks} chunks rendered, launches int8 {accel['fused_int8_mlp']} "
        f"(expected {2 * chunks}), K3 {accel['fused_resample']} (expected {chunks}); "
        f"{fast_ms:.1f} ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the int8 accel frame misses its bar or went around the kernels")
    return launches


def phase_qat(cam, dev, img_f32):
    """QAT_STEPS int8qat distillation steps from a random init (the 8x256
    student, TRAIN_RAYS rays, 64 + 128, f32, the teacher through K1), with
    the counts set to 0 just before and read just after; then the trained
    student rendered through the int8 kernel and through the fake-quant
    forward."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "int8qat")
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for step in range(QAT_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    secs = time.perf_counter() - t0
    launches = read_counts()
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    ok = (all(math.isfinite(v) for v in losses) and last < first
          and launches["fused_nerf_mlp"] == 2 * QAT_STEPS
          and launches["fused_nerf_mlp_backward"] == 0 and launches["fused_int8_mlp"] == 0)
    say("23 qat", f"{QAT_STEPS} int8qat steps, 8x256 student, {TRAIN_RAYS} rays, "
        f"{N_COARSE}+{N_FINE} samples: loss {losses[0]:.5f} -> {losses[-1]:.5f}, mean of the first "
        f"10 {first:.5f}, of the last 10 {last:.5f}; launches K1 (teacher) "
        f"{launches['fused_nerf_mlp']} (expected {2 * QAT_STEPS}), K2 "
        f"{launches['fused_nerf_mlp_backward']} (expected 0), int8 {launches['fused_int8_mlp']} "
        f"(expected 0); {secs:.1f} s with the teacher batches -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("QAT did not reduce the loss, or the student's steps went through a "
                           "kernel")
    student = (state.params["coarse"], state.params["fine"])
    real, _ = render(*student, cam, dev, "int8", "float32")
    fake, _ = render(*student, cam, dev, "int8qat", "float32")
    qat_db, teacher_db = psnr(real, fake), psnr(real, img_f32)
    ok = qat_db >= QAT_BAR_DB
    say("23 qat", f"trained student {H}x{W}: int8 kernel frame vs int8qat frame {qat_db:.2f} dB "
        f"(bar >= {QAT_BAR_DB}); vs the lego teacher's f32 frame {teacher_db:.2f} dB (reported) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the QAT student's int8 frame differs from its fake-quant frame")


def int_mm_ms(net, n: int, sigma_only: bool) -> float:
    """The library yardstick: torch._int_mm of int8 codes layer by layer at
    the network's shapes for n samples, each layer's K and N padded to
    multiples of 8 as it requires, summed over the layers (the products
    only: no encode, requantize or dequant)."""
    import torch

    dev = next(net.parameters()).device
    skip = ("bottleneck", "viewdirs", "rgb") if sigma_only else ()
    acts, total = {}, 0.0
    for layer, p in net.tree().items():
        if layer in skip:
            continue
        k, m = (-(-int(d) // 8) * 8 for d in p["kernel"].shape)
        if k not in acts:
            acts[k] = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        total += timed_ms(lambda: torch._int_mm(acts[k], w.t()), inner=5)
    return total


def phase_int8_times(cases, vd, cam, dev, card):
    """The int8 kernel, its plain version and _int_mm at the phase-21
    shapes; the int8 256x256 frame with the kernel and with the plain
    version; the QAT step and its peak memory."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, fused_int8_mlp_reference
    from nerf_rs_tpu_torch.train import train_step

    saved = save_counts()
    times = {}
    with torch.no_grad():
        for name, net, pts, sigma_only in cases:
            kw = dict(sigma_only=sigma_only)
            k_ms = timed_ms(lambda: fused_int8_mlp(net, pts, vd, **kw))
            p_ms = timed_ms(lambda: fused_int8_mlp_reference(net, pts, vd, **kw))
            lib_ms = int_mm_ms(net, pts.numel() // 3, sigma_only)
            times[name] = (k_ms, p_ms, lib_ms)
            say("24 int8 times", f"{card}: {name} {tuple(pts.shape[:-1])} sigma_only={sigma_only}: "
                f"int8 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, torch._int_mm of the same "
                f"layers {lib_ms:.3f} ms (medians of 3)")
    coarse, fine = cases[0][1], cases[1][1]
    frame_ms = {"kernel": timed_ms(lambda: render(coarse, fine, cam, dev, "int8", "float32"))}
    with plain_int8():
        frame_ms["plain"] = timed_ms(lambda: render(coarse, fine, cam, dev, "int8", "float32"))
    say("24 int8 times", f"{card}: int8 frame {H}x{W} {N_COARSE}+{N_FINE}: kernel "
        f"{frame_ms['kernel']:.1f} ms, plain {frame_ms['plain']:.1f} ms (medians of 3)")
    wall, busy, top = profile_frame(lambda: render(coarse, fine, cam, dev, "int8", "float32"))
    if busy > 0:
        kernels = "; ".join(f"{name[:60]} {t:.1f} ms" for name, t in top)
        say("24 int8 times", f"{card}: int8 frame under torch.profiler: wall {wall:.1f} ms, device "
            f"busy {busy:.1f} ms, idle share {1 - busy / wall:.4f}; top: {kernels}")
    else:
        say("24 int8 times", f"{card}: torch.profiler saw no device time: idle share not measured")
    state, dataset, cfg, key = distill_setup(dev, "int8qat")
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    step_key = random.fold_in(key, torch.tensor(0))
    train_step(state, batch, step_key, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = timed_ms(lambda: train_step(state, batch, step_key, cfg), warm=False)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    say("24 int8 times", f"{card}: int8qat train step, {TRAIN_RAYS} rays {N_COARSE}+{N_FINE}: "
        f"{step_ms:.1f} ms, {TRAIN_RAYS / step_ms * 1e3:,.0f} rays/s fwd+bwd (median of 3, "
        f"teacher batch excluded), peak device memory {peak:.2f} GiB")
    restore_counts(saved)                      # timing launches do not count
    return times


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

    k1_errs, timing_cases, vd = phase_kernel_vs_plain(coarse, fine, cam, dev)

    # One small frame per configuration first, so that the timed frames
    # below pay no first-use costs (allocator growth, library handles).
    frame_kinds = (("pallas", "float32"), ("pallas", "bfloat16"), ("xla", "float32"),
                   ("xla", "bfloat16"))
    for impl, dtype in frame_kinds:
        render(coarse, fine, cam, dev, impl, dtype, size=32)

    n_chunks = -(-H * W // RAY_CHUNK)
    torch.cuda.synchronize()
    zero_counts()
    img_f32, _ = render(coarse, fine, cam, dev, "pallas", "float32")
    f32_counts = read_counts()
    out_dir = Path(tempfile.mkdtemp(prefix="nerf_rs_tpu_torch_smoke_"))
    save_ppm(out_dir / "lego_256x256_64c128f_key0_f32.ppm", img_f32, H, W)
    golden_db = psnr(img_f32, load_ppm(GOLDEN_PPM))
    say("4 frame", f"f32 kernel frame {H}x{W} {N_COARSE}+{N_FINE}: PSNR vs committed golden "
        f"{golden_db:.2f} dB (bar > {GOLDEN_BAR_DB}), {f32_counts['fused_nerf_mlp']} K1 launches "
        f"({f32_counts['fused_nerf_mlp_tc']} on the tensor cores) for {n_chunks} chunks, written "
        f"to {out_dir}")
    if not golden_db > GOLDEN_BAR_DB:
        raise PhaseFailure(f"f32 frame PSNR {golden_db:.2f} dB <= {GOLDEN_BAR_DB}")
    if (f32_counts["fused_nerf_mlp"] != 2 * n_chunks
            or f32_counts["fused_nerf_mlp_tc"] != 2 * n_chunks
            or f32_counts["fused_nerf_mlp_backward"] != 0):
        raise PhaseFailure(f"K1 launches {f32_counts} (expected {2 * n_chunks} K1, every one on "
                           f"the tensor cores, no K2)")

    # The bf16 render path's main run: every K1 launch on the tensor cores.
    torch.cuda.synchronize()
    zero_counts()
    img_bf16, _ = render(coarse, fine, cam, dev, "pallas", "bfloat16")
    bf16_counts = read_counts()
    img_plain_bf16, _ = render(coarse, fine, cam, dev, "xla", "bfloat16")
    bf16_db, plain_bf16_db = psnr(img_bf16, img_f32), psnr(img_plain_bf16, img_bf16)
    ok = (bf16_db >= BF16_FRAME_BAR_DB and bf16_counts["fused_nerf_mlp"] == 2 * n_chunks
          and bf16_counts["fused_nerf_mlp_tc"] == 2 * n_chunks)
    say("5 bf16", f"bf16 kernel frame vs f32 kernel frame: {bf16_db:.2f} dB (bar >= "
        f"{BF16_FRAME_BAR_DB}); K1 launches {bf16_counts['fused_nerf_mlp']}, on the tensor cores "
        f"{bf16_counts['fused_nerf_mlp_tc']} (expected {2 * n_chunks} each); plain bf16 frame vs "
        f"kernel bf16 frame {plain_bf16_db:.2f} dB (reported) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the bf16 frame misses its bar or went around the tensor-core K1")

    img_plain, _ = render(coarse, fine, cam, dev, "xla", "float32")
    plain_db = psnr(img_plain, img_f32)
    say("6 plain", f"plain f32 frame vs kernel f32 frame: {plain_db:.2f} dB "
        f"(bar >= {PLAIN_BAR_DB})")
    if not plain_db >= PLAIN_BAR_DB:
        raise PhaseFailure(f"plain frame PSNR {plain_db:.2f} dB < {PLAIN_BAR_DB}")

    times = {}
    saved = save_counts()
    with torch.no_grad():
        for case, dtype, net, pts, sigma_only in timing_cases:
            kw = dict(dtype=dtype, sigma_only=sigma_only)
            k_ms = timed_ms(lambda: fused_nerf_mlp(net, pts, vd, **kw))
            p_ms = timed_ms(lambda: fused_nerf_mlp_reference(net, pts, vd, **kw))
            lib_ms = library_mlp_ms(net, pts, vd, dtype, sigma_only)
            times[(case, dtype)] = (k_ms, p_ms, lib_ms)
            say("7 times", f"{card}: {case} {tuple(pts.shape[:-1])} {dtype}: kernel "
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, models.mlp.nerf_mlp in {dtype} (library "
                f"yardstick) {lib_ms:.3f} ms (medians of 3)")
    frame_ms = {kind: timed_ms(lambda: render(coarse, fine, cam, dev, *kind)) for kind in frame_kinds}
    restore_counts(saved)                          # timing launches do not count
    say("7 times", f"{card}: frame {H}x{W} {N_COARSE}+{N_FINE} (medians of 3): " + ", ".join(
        f"{'kernel' if impl == 'pallas' else 'plain'} {dtype} {frame_ms[(impl, dtype)]:.1f} ms"
        for impl, dtype in frame_kinds))
    f32_fine = times[("fine", "float32")]
    f32_pts = next(c[3] for c in timing_cases if c[:2] == ("fine", "float32"))
    f32_bound = mlp_bound(fine, f32_pts, vd, BF16_FLOP_S, 4, passes=SPLIT_F32_PASSES)
    f32_cc_bound = mlp_bound(fine, f32_pts, vd, F32_FLOP_S, 4)
    say("7 times", f"{card}: f32 fine call {f32_fine[0]:.3f} ms: {f32_bound[0] / f32_fine[0]:.1%} "
        f"of its {f32_bound[0]:.3f} ms bound through its route ({f32_bound[1]}; six bf16 passes "
        f"a product at {BF16_FLOP_S / 1e12:g} TFLOP/s), {f32_cc_bound[0] / f32_fine[0]:.1%} of "
        f"the {f32_cc_bound[0]:.3f} ms CUDA-core bound; {f32_fine[0] / f32_fine[2]:.2f}x the "
        f"library yardstick's time")
    bf16_fine = times[("fine", "bfloat16")]
    bf16_bound = mlp_bound(fine, next(c[3] for c in timing_cases if c[:2] == ("fine", "bfloat16")),
                           vd, BF16_FLOP_S, 2)
    say("7 times", f"{card}: bf16 fine call {bf16_fine[0]:.3f} ms (target <= {BF16_FINE_TARGET_MS} "
        f"ms: {'met' if bf16_fine[0] <= BF16_FINE_TARGET_MS else 'missed'}), "
        f"{bf16_bound[0] / bf16_fine[0]:.1%} of its {bf16_bound[0]:.3f} ms bound "
        f"({bf16_bound[1]}), {bf16_fine[0] / bf16_fine[2]:.2f}x the library yardstick's time; "
        f"bf16 kernel frame {'faster' if frame_ms[('pallas', 'bfloat16')] < frame_ms[('xla', 'bfloat16')] else 'NOT faster'} "
        f"than the plain bf16 frame")

    # The training path: K2 against its plain version, one step against the
    # plain MLP's step, then the path itself.
    bwd_errs, (net, pts, vd_f, g_rgb, g_sigma) = phase_backward_vs_plain(dev)
    phase_step_vs_plain(dev)
    launches = phase_train(dev)
    bf16_train_counts = phase_train_bf16(dev)

    # K2 as the training path calls it (parameter gradients only) in both
    # modes, its plain version, its library yardstick, its peak scratch;
    # K1 f32 on the same samples, the arithmetic of K2's f32 recompute.
    saved = save_counts()
    k2_ms, lib_bwd_ms = {}, {}
    for dtype in ("float32", "bfloat16"):
        args = (net, pts, vd_f, g_rgb, g_sigma)
        k2_ms[dtype] = (
            timed_ms(lambda: fused_nerf_mlp_backward(*args, dtype=dtype, input_grads=False)),
            timed_ms(lambda: fused_nerf_mlp_backward_reference(*args, dtype=dtype,
                                                               input_grads=False)))
        lib_bwd_ms[dtype] = library_backward_ms(*args, dtype=dtype)
    with torch.no_grad():
        k1_same_ms = timed_ms(lambda: fused_nerf_mlp(net, pts, vd_f))
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_nerf_mlp_backward(net, pts, vd_f, g_rgb, g_sigma, input_grads=False)
    torch.cuda.synchronize()
    scratch_gib = (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 30
    restore_counts(saved)                          # timing launches do not count
    kb_ms, pb_ms = k2_ms["float32"]
    kt2_ms, pt2_ms = k2_ms["bfloat16"]
    say("11 times", f"{card}: K2 fine {tuple(pts.shape[:-1])}, parameter gradients (median of 3): "
        f"float32 kernel {kb_ms:.3f} ms, plain {pb_ms:.3f} ms, library yardstick (autograd "
        f"through models.mlp.nerf_mlp, f32, TF32 off) {lib_bwd_ms['float32']:.3f} ms -> the "
        f"kernel is {'faster' if kb_ms < min(pb_ms, lib_bwd_ms['float32']) else 'NOT faster'} "
        f"than both; bfloat16 kernel {kt2_ms:.3f} ms, plain {pt2_ms:.3f} ms, library yardstick "
        f"(the same in bf16) {lib_bwd_ms['bfloat16']:.3f} ms; peak scratch of a float32 call "
        f"{scratch_gib:.3f} GiB")
    say("11 times", f"{card}: K1 f32 forward on the same samples (K2 f32's recompute runs its "
        f"code) {k1_same_ms:.3f} ms: {k1_same_ms / kb_ms:.1%} of the f32 K2 call; the rest, "
        f"{kb_ms - k1_same_ms:.3f} ms, holds the 3xTF32 dW and W dz products, the heads, the "
        f"workspace and the partials")
    k2_bounds = backward_bounds(net, pts, vd_f, g_rgb, g_sigma)
    say("11 times", f"{card}: K2 bounds from this call's shapes: float32 through its route (the "
        f"recompute as six bf16 passes at {BF16_FLOP_S / 1e12:g} TFLOP/s, dW and W dz as 3xTF32 "
        f"at {TF32_FLOP_S / 1e12:g}) {k2_bounds['float32'][0]:.3f} ms "
        f"({k2_bounds['float32'][1]}), {k2_bounds['float32'][0] / kb_ms:.1%} of it; all on the "
        f"CUDA cores {k2_bounds['cuda_cores'][0]:.3f} ms; bfloat16 "
        f"{k2_bounds['bfloat16'][0]:.3f} ms ({k2_bounds['bfloat16'][1]}), "
        f"{k2_bounds['bfloat16'][0] / kt2_ms:.1%} of it")
    saved = save_counts()
    step_ms = {impl: time_steps(dev, impl) for impl in ("pallas", "xla")}
    restore_counts(saved)
    for impl, label in (("pallas", "kernels"), ("xla", "plain MLP")):
        say("11 times", f"{card}: train step ({label}), {TRAIN_RAYS} rays {N_COARSE}+{N_FINE}, "
            f"f32: {step_ms[impl]:.1f} ms, {TRAIN_RAYS / step_ms[impl] * 1e3:,.0f} rays/s "
            f"fwd+bwd (median of 3, teacher batch excluded)")
    saved = save_counts()
    step_wall, step_busy, step_top = profile_step(dev)
    restore_counts(saved)
    say("11 times", f"{card}: one kernel train step under torch.profiler: {step_wall:.1f} ms wall, "
        f"device busy {step_busy:.1f} ms, idle {1 - step_busy / step_wall:.2%}; top device "
        f"kernels: " + ", ".join(f"{name[:40]} {ms:.1f} ms" for name, ms in step_top))

    # The accelerated render and serving path: K3 against its plain
    # version, the path itself, the bench-size frames, the viewer, times.
    from nerf_rs_tpu_torch.accel import build_scene_grid

    grid = build_scene_grid(coarse, fine, resolution=GRID_RES)
    say("12 resample", f"grid {GRID_RES}^3 built: {float(grid.occ.float().mean()):.4f} of the "
        f"cells occupied")
    k3_err = phase_resample_vs_plain(coarse, cam, dev, grid)
    accel_launches = phase_accel_frame(coarse, fine, cam, dev, grid)
    dense_cfg, bench_cfg, lego_800 = phase_bench_frames(coarse, fine, cam, dev, grid, card)
    phase_serve(dev)
    k3_ms, k3_plain_ms = phase_accel_times(coarse, fine, cam, dev, grid, card, dense_cfg,
                                           bench_cfg)

    # The hash-grid family: the encode kernel against its plain version, the
    # distillation path, the trained field's frames, times.
    hash_err = phase_hash_vs_plain(cam, dev)
    phase_hash_step_vs_plain(dev)
    hstate, hcfg, hash_launches = phase_hash_train(dev)
    field = hstate.params["shared"]
    hgrid, hdense, hacfg = phase_hash_frames(field, hcfg.render.hash, cam, dev, img_f32, lego_800,
                                             card)
    hash_times = phase_hash_times(field, hcfg, cam, dev, hgrid, hdense, hacfg, card)

    # The int8 family: the kernel against its plain version, the
    # post-training int8 frames, QAT distillation, times.
    int8_err, int8_cases, int8_vd = phase_int8_vs_plain(coarse, fine, cam, dev)
    int8_launches = phase_int8_frames(coarse, fine, cam, dev, img_f32, grid)
    phase_qat(cam, dev, img_f32)
    int8_times = phase_int8_times(int8_cases, int8_vd, cam, dev, card)

    # Bounds from this run's shapes (bytes: each input read once, each
    # output written once; operations at the peak of their type).
    k_ms, p_ms, lib_ms = times[("fine", "float32")]
    kt_ms, pt_ms, libt_ms = times[("fine", "bfloat16")]
    # K3's work a ray, whatever implements it: the weights and CDF (about
    # 10 operations a coarse sample), a bin search a fine sample, and one
    # merge of the two sorted lists (Nc + Nf comparisons).
    k3_bound = bound(4 * BENCH_CHUNK * (3 * N_COARSE + 2 * N_FINE),
                     BENCH_CHUNK * (10 * N_COARSE + N_FINE * math.ceil(math.log2(N_COARSE))
                                    + N_COARSE + N_FINE), F32_FLOP_S)
    h_main = hash_times[(BENCH_CHUNK, N_COARSE + N_FINE, torch.float32)]
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import pack_int8_params

    _, q_net, q_pts, _ = int8_cases[1]                             # fine, full
    q_n, q_rays = q_pts.numel() // 3, int8_vd.numel() // 3
    q_pk = pack_int8_params(q_net.tree())
    q_bytes = sum(t.numel() * t.element_size() for t in (q_pk.weights, q_pk.epilogue))
    q_bound = bound(4 * (q_n * 7 + q_rays * 3) + q_bytes, mlp_flops(q_net, False) * q_n,
                    INT8_OPS_S)
    q_ms, q_plain_ms, q_lib_ms = int8_times["fine"]

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bnd, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"nerf_rs_tpu_torch/ops/kernels/csrc/{source}",
                "replaces": replaces, "launches": n_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, **extra}

    print(json.dumps({"kernels": [
        entry("fused_nerf_mlp", "fused_mlp_f32tc.cu", "nerf_rs_tpu/ops/kernels/fused_mlp.py:779",
              launches["fused_nerf_mlp"], k1_errs["float32"], k_ms, p_ms, f32_bound, lib_ms,
              bound_ms_cuda_cores=f32_cc_bound[0]),
        entry("fused_nerf_mlp_bf16", "fused_mlp_tc.cu", "nerf_rs_tpu/ops/kernels/fused_mlp.py:779",
              bf16_counts["fused_nerf_mlp_tc"], k1_errs["bfloat16"], kt_ms, pt_ms, bf16_bound,
              libt_ms),
        entry("fused_nerf_mlp_backward", "fused_mlp_bwd_tc.cu",
              "nerf_rs_tpu/ops/kernels/fused_mlp.py:663", launches["fused_nerf_mlp_backward"],
              bwd_errs["float32"], kb_ms, pb_ms, k2_bounds["float32"], lib_bwd_ms["float32"],
              bound_ms_cuda_cores=k2_bounds["cuda_cores"][0]),
        entry("fused_nerf_mlp_backward_bf16", "fused_mlp_bwd_bf16.cu",
              "nerf_rs_tpu/ops/kernels/fused_mlp.py:663",
              bf16_train_counts["fused_nerf_mlp_backward_bf16"], bwd_errs["bfloat16"],
              kt2_ms, pt2_ms, k2_bounds["bfloat16"], lib_bwd_ms["bfloat16"],
              bound_ms_cuda_cores=k2_bounds["cuda_cores"][0]),
        entry("fused_resample", "resample.cu", "nerf_rs_tpu/ops/kernels/resample.py:207",
              accel_launches["fused_resample"], k3_err, k3_ms, k3_plain_ms, k3_bound, None),
        entry("hash_encode", "hash_encode.cu", "tools/pallas_gather_probe.py:81",
              hash_launches["fused_hash_encode"], hash_err, h_main["ms"], h_main["plain_ms"],
              (h_main["bound_ms"], h_main["bound_by"]), h_main["library_ms"],
              shapes=list(hash_times.values())),
        entry("int8_mlp", "int8_mlp_tc.cu", "tools/pallas_int8_probe.py:66",
              int8_launches["fused_int8_mlp"], int8_err, q_ms, q_plain_ms, q_bound, q_lib_ms),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
