#!/usr/bin/env python3
"""bf16 K1 against its plain version on every input the serving presets'
main path hands it, on one card.

    python3 tools/torch_k1_bf16_witness.py

For the lego teacher frame and each of bench.py's frontier presets
(``chip_smoke.PRESETS``), exactly as ``chip_smoke.py`` phase 28 renders
them at 800x800 (the grid sweeps of both networks, then the frame), every
call of ``fused_nerf_mlp`` is recorded, and afterwards each recorded call
is run again through the kernel, through its plain version and through
the plain version in float64. For each network and mode it prints the
calls, the rows, and the summed counts of ``fused_mlp.bf16_sigma_agrees``
(sigma samples outside the bf16 bars: kernel vs plain, kernel vs float64,
plain vs float64), the same counts for rgb values outside 2e-2, the calls
whose own counts miss that function's witness or whose rgb leaves 2e-2 of
the plain version's, and the largest rgb deviation. Prints the card's
name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.parse_args()

    import torch

    import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm
    from chip_smoke import (BENCH_CHUNK, BENCH_SIZE, GRID_RES, N_COARSE, N_FINE, PRESET_REPS,
                            PRESETS, PROBES, REPO, STRIDE, phase_device)
    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    _, card = phase_device()
    dev = torch.device("cuda", 0)
    cam = camera_from_golden(load_golden(REPO / "assets/lego_rust/tf_reference_samples.json"))
    size = BENCH_SIZE
    key = random.fold_in(random.key(0, dev), torch.tensor(PRESET_REPS - 1))
    real = fm.fused_nerf_mlp
    tol = {"rgb_atol": 2e-2}

    def recorded(run):
        """The K1 calls ``run()`` makes: (params, points, viewdirs, kwargs)."""
        seen = []

        def record(params, points, viewdirs, **kw):
            seen.append((params, points, viewdirs, kw))
            return real(params, points, viewdirs, **kw)

        # The wrapper counts through its module name.
        names = ("launches", "tc_launches", "wide_launches", "wide1k_launches")
        for name in names:
            setattr(record, name, getattr(real, name))
        fm.fused_nerf_mlp = record
        try:
            with torch.no_grad():
                run()
            torch.cuda.synchronize()
        finally:
            fm.fused_nerf_mlp = real
            for name in names:
                setattr(real, name, getattr(record, name))
        return seen

    def report(name, nets, seen):
        rows = defaultdict(lambda: [0, 0, 0, 0, 0, 0, 0.0, 0, 0, 0])

        def outside(got, want):
            got, want = got.double().reshape(-1), want.double().reshape(-1)
            return int(((got - want).abs() > tol["rgb_atol"]).sum())

        labels = {id(net): label for label, net in nets.items()}
        with torch.no_grad():
            for params, pts, vd, kw in seen:
                rgb_k, sig_k = real(params, pts, vd, **kw)
                rgb_r, sig_r = fm.fused_nerf_mlp_reference(params, pts, vd, **kw)
                rgb_64, sig_64 = fm.fused_nerf_mlp_reference(params, pts.double(), vd.double(),
                                                             **kw)
                ok, counts = fm.bf16_sigma_agrees(sig_k, sig_r, sig_64)
                rgb_err = float((rgb_k - rgb_r).abs().max())
                r = rows[(labels.get(id(params), "?"), bool(kw.get("sigma_only")))]
                r[0] += 1
                r[1] += sig_k.numel()
                r[2] += counts["kernel_vs_plain"]
                r[3] += counts["kernel_vs_exact"]
                r[4] += counts["plain_vs_exact"]
                r[5] += 0 if ok and rgb_err <= tol["rgb_atol"] else 1
                r[6] = max(r[6], rgb_err)
                r[7] += outside(rgb_k, rgb_r)
                r[8] += outside(rgb_k, rgb_64)
                r[9] += outside(rgb_r, rgb_64)
                del rgb_k, sig_k, rgb_r, sig_r, rgb_64, sig_64
        for (label, sigma_only), (calls, n, kp, ke, pe, missed, rgb, rkp, rke, rpe) in sorted(
                rows.items()):
            print(f"{card}: {name} {label} sigma_only={sigma_only}: {calls} calls, {n:,} rows; "
                  f"sigma samples outside the bf16 bars: kernel vs plain {kp}, kernel vs float64 "
                  f"{ke}, plain vs float64 {pe}; calls missing the witness {missed}; max |d rgb| "
                  f"{rgb:.3e}; rgb values outside 2e-2: kernel vs plain {rkp}, kernel vs float64 "
                  f"{rke}, plain vs float64 {rpe}", flush=True)

    lego = {net: NerfMLP(load_nerf_params(REPO / "assets/lego_rust" / net), device=dev)
            for net in ("coarse", "fine")}
    teacher_cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=min(BENCH_CHUNK, 16384),
                               impl="pallas", dtype="bfloat16")
    report("teacher frame", lego, recorded(
        lambda: render_image(lego["coarse"], lego["fine"], cam, size, size, key, teacher_cfg)))
    for name, weights, nc, nf, aabb, _ in PRESETS:
        nets = {net: NerfMLP(load_nerf_params(REPO / "assets/trained" / weights / net), device=dev)
                for net in ("coarse", "fine")}
        cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=BENCH_CHUNK, impl="pallas",
                           dtype="bfloat16", accel_compact="off", accel_sample_aabb=aabb,
                           accel_aabb_probes=PROBES, accel_range_stride=STRIDE,
                           accel_cull_rays=True)
        grid = []
        report(f"{name} grid sweep", nets, recorded(
            lambda: grid.append(build_scene_grid(nets["coarse"], nets["fine"],
                                                 resolution=GRID_RES))))
        report(f"{name} frame", nets, recorded(
            lambda: render_image(nets["coarse"], nets["fine"], cam, size, size, key, cfg,
                                 grid=grid[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
