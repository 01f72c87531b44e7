#!/usr/bin/env python3
"""Where the vendored networks' serving presets spend an 800x800 frame on
one card: bench.py's three frontier presets (``chip_smoke.PRESETS``:
tsp_s64x0_probe, sp29_s64x0_probe, student30_800q) with bench.py's accel
defaults, as ``chip_smoke.py`` phase 28 renders them.

    python3 tools/torch_preset_profile.py [--reps 10]

For each preset, after a warm-up frame:

- ``--reps`` frames, device synced: their median, least and most;
- one frame under ``torch.profiler``: wall, device busy and idle share,
  kernels launched, the host's ``cudaLaunchKernel`` time, and the top host
  operators by self CPU time.

Prints the card's name and power limit, and the host's name and load
average. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import socket
import statistics
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (BENCH_CHUNK, BENCH_SIZE, GRID_RES, PRESETS, PROBES, REPO, STRIDE,
                            phase_device)
    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    _, card = phase_device()
    print(f"host {socket.gethostname()}: {os.cpu_count()} CPUs, load average "
          f"{', '.join(f'{v:.2f}' for v in os.getloadavg())}, {threading.active_count()} threads "
          f"in this process", flush=True)
    dev = torch.device("cuda", 0)
    cam = camera_from_golden(load_golden(REPO / "assets/lego_rust/tf_reference_samples.json"))
    size = BENCH_SIZE
    key = random.key(0, dev)
    for name, weights, nc, nf, aabb, _ in PRESETS:
        nets = [NerfMLP(load_nerf_params(REPO / "assets/trained" / weights / net), device=dev)
                for net in ("coarse", "fine")]
        cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=BENCH_CHUNK, impl="pallas",
                           dtype="bfloat16", accel_compact="off", accel_sample_aabb=aabb,
                           accel_aabb_probes=PROBES, accel_range_stride=STRIDE,
                           accel_cull_rays=True)
        grid = build_scene_grid(*nets, resolution=GRID_RES)

        def frame():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_image(*nets, cam, size, size, key, cfg, grid=grid)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        frame()
        times = [frame() for _ in range(args.reps)]
        median = statistics.median(times)
        print(f"{card}: {name} {size}x{size}: frame {median:.1f} ms (median of {args.reps}; "
              f"{min(times):.1f}-{max(times):.1f}), {size * size / median * 1e3:,.0f} rays/s",
              flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = frame()
        busy, kernels = 0.0, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                busy += e.time_range.elapsed_us() / 1e3
                kernels += 1
        ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU]
        launch = next((a for a in ops if a.key == "cudaLaunchKernel"), None)
        top = sorted((a for a in ops if a.key.startswith("aten::")),
                     key=lambda a: -a.self_cpu_time_total)[:8]
        print(f"{card}: {name} under torch.profiler: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms, idle share {1 - busy / wall:.4f}, {kernels} device kernels"
              + (f", cudaLaunchKernel {launch.count} calls {launch.self_cpu_time_total / 1e3:.1f} "
                 f"ms" if launch else "") + "; top host ops by self CPU time: "
              + ", ".join(f"{a.key} x{a.count} {a.self_cpu_time_total / 1e3:.1f} ms" for a in top),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
