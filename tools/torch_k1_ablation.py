#!/usr/bin/env python3
"""What holds K1's f32 kernel back: times a fine call of the PyTorch
port's split-f32 forward (``csrc/fused_mlp_f32tc.cu`` and the device code
it shares with K2, ``csrc/fused_mlp_f32tc.cuh``) with parts of its work
taken out, each from a patched copy of those sources built beside the
port's own library (``tools/torch_k2_ablation.py``'s ``build_variants``). The answers
of the patched kernels are wrong; only their times are read.

    python3 tools/torch_k1_ablation.py

Needs one CUDA card and nvcc. The shape is the render's fine call (the
lego fine network, 8192 rays x 192 samples, rgb and sigma); each line
gives the median of 5 calls beside the card's name and power limit, and
the ptxas lines of the patched kernel (registers, spills, wgmma
serialization). Removing work changes the data the later layers see, so a
variant's time is read as what that work costs, not as a new design.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = "fused_mlp_f32tc.cu"
HEADER = "fused_mlp_f32tc.cuh"
# (name, [(file, text, replacement), ...]); every text must occur.
VARIANTS = [
    ("as built", []),
    ("five small products a k-step out (one bf16 pass left)", [
        (HEADER, "      if (j < 5) {", "      if (j < 5 && n < 0) {")]),
    ("chunk copies a third as large (L2 traffic / 3)", [
        (HEADER, "    return static_cast<uint32_t>(kPlanes * kStepK * segs[i].n * 2);",
         "    return static_cast<uint32_t>(kStepK * segs[i].n * 2);")]),
    ("encode planes not filled (no sincosf)", [
        (HEADER, "  for (int i = threadIdx.x; i < 64 * (kEncX + kEncD) / 2; i += kConsumers) {",
         "  for (int i = threadIdx.x; i < 0; i += kConsumers) {")]),
    ("epilogue plane stores out", [
        (SOURCE, "        act.put(r, col, v);", "        if (col < 0) act.put(r, col, v);")]),
    ("layer barriers out", [
        (HEADER, "  consumers_barrier();   // every wgmma of the block has read its A\n", ""),
        (HEADER, "  consumers_barrier();   // the block's outputs, whole, for what reads them "
                 "next\n", "")]),
    ("copies issued as stages are released, up to three ahead", [
        (HEADER, "      if (ahead == 0 && ch.valid()) put(false);\n", ""),
        (HEADER, "      q.phase ^= 1;\n    }\n  }\n",
         "      q.phase ^= 1;\n    }\n    if (threadIdx.x == 0) {\n"
         "      for (int a0 = -1; ahead < S && ch.valid() && ahead != a0;) {\n"
         "        a0 = ahead;\n        put(false);\n      }\n    }\n    __syncwarp();\n  }\n")]),
    ("head sums out", [
        (HEADER, "  for (int i = i0; i < i0 + h; ++i) acc = fmaf(",
         "  for (int i = i0; i < i0 + 0 * h; ++i) acc = fmaf(")]),
]


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    from torch_k2_ablation import build_variants

    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_variants(_build.BUILD_DIR / "ablation_k1", SOURCE, VARIANTS)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    net = NerfMLP(load_nerf_params(find_lego_assets() / "fine"), device=dev)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-1.6, 1.6, (8192, 192, 3)).astype(np.float32)).to(dev)
    dirs = rng.normal(size=(8192, 1, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).to(dev)

    real = _build.load_library
    try:
        for name, (so, ptxas) in libs.items():
            lib = _build.declare(ctypes.CDLL(str(so)))
            _build.load_library = lambda lib=lib: lib

            def call():
                with torch.no_grad():
                    fused_nerf_mlp(net, pts, dirs)

            call()
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            print(f"{card}: K1 f32 fine (8192, 192), {name}: {statistics.median(times):.3f} ms "
                  f"(median of 5); ptxas: {' | '.join(ptxas)}", flush=True)
    finally:
        _build.load_library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
