#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — the pretrained lego coarse and fine networks
rendering a 256x256 frame with 64 stratified + 128 importance samples on
white — through ``nerf_rs_tpu_torch.render.render_image``, and holds it to
the repository's own bars. Phases, each reported on its own line:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the fused MLP kernel is compiled from the checkout's sources;
3. kernel against its plain PyTorch version at the main path's shapes
   (8192 rays x 64 samples sigma-only, 8192 x 192 full), f32 and bf16;
4. the f32 frame with the kernel: PSNR against the committed golden
   > 45 dB, and 2 kernel launches per ray chunk;
5. the bf16 frame against the f32 frame, at BF16_FRAME_BAR_DB;
6. the plain-PyTorch f32 frame against the kernel frame, >= 60 dB;
7. kernel and plain times at the phase-3 shapes, and the frame times.

Any failed phase exits non-zero. The line before the last is a JSON
summary of the kernels; the last line is the JSON device record.
Never imports JAX.
"""

from __future__ import annotations

import json
import math
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
    say("2 build", f"fused_mlp.cu built and loaded in {secs:.1f} s ({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
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


def main() -> int:
    import torch

    name, card = phase_device()
    sys.path.insert(0, str(REPO))
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import load_ppm, save_ppm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_reference

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

    fused_nerf_mlp.launches = 0
    img_f32, ms_f32 = render(coarse, fine, cam, dev, "pallas", "float32")
    launches = fused_nerf_mlp.launches
    n_chunks = -(-H * W // RAY_CHUNK)
    out_dir = Path(tempfile.mkdtemp(prefix="nerf_rs_tpu_torch_smoke_"))
    save_ppm(out_dir / "lego_256x256_64c128f_key0_f32.ppm", img_f32, H, W)
    golden_db = psnr(img_f32, load_ppm(GOLDEN_PPM))
    say("4 frame", f"f32 kernel frame {H}x{W} {N_COARSE}+{N_FINE}: PSNR vs committed golden "
        f"{golden_db:.2f} dB (bar > {GOLDEN_BAR_DB}), {launches} kernel launches for "
        f"{n_chunks} chunks, written to {out_dir}")
    if not golden_db > GOLDEN_BAR_DB:
        raise PhaseFailure(f"f32 frame PSNR {golden_db:.2f} dB <= {GOLDEN_BAR_DB}")
    if launches != 2 * n_chunks:
        raise PhaseFailure(f"{launches} kernel launches, expected {2 * n_chunks}")

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

    k_ms, p_ms = times[("fine", "float32")]
    print(json.dumps({"kernels": [{
        "name": "fused_nerf_mlp",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/ops/kernels/csrc/fused_mlp.cu",
        "replaces": "nerf_rs_tpu/ops/kernels/fused_mlp.py:779",
        "launches": launches,
        "max_abs_err": f32_err,
        "ms": k_ms,
        "plain_ms": p_ms,
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
