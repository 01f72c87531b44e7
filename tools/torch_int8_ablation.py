#!/usr/bin/env python3
"""What holds the int8 W8A8 MLP kernel back: times a fine and a coarse
call of the PyTorch port's int8 forward (``csrc/int8_mlp_tc.cu``) with
parts of its work taken out, each from a patched copy of that source built
beside the port's own library (``tools/torch_k2_ablation.py``'s
``build_variants``). The answers of the patched kernels are wrong; only
their times are read.

    python3 tools/torch_int8_ablation.py

Needs one CUDA card and nvcc. The shapes are the render's int8 calls (the
lego fine network at 8192 rays x 192 samples, rgb and sigma; the coarse one
at 8192 x 64, sigma only); each line gives the median of 5 calls beside the
card's name and power limit, and the ptxas lines of the patched kernel
(registers, spills, wgmma serialization). Removing work changes the data
the later layers see, so a variant's time is read as what that work costs,
not as a new design.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = "int8_mlp_tc.cu"
# (name, [(text, replacement), ...]) applied to SOURCE; every text must occur.
VARIANTS = [
    ("as built", []),
    ("products out (no wgmma)", [
        ("    for (int p = 0; p < NP; ++p) wgmma_s8<0>(",
         "    for (int p = 0; p < NP * 0; ++p) wgmma_s8<0>("),
        ("      for (int p = 0; p < NP; ++p) {\n        wgmma_s8<1>(",
         "      for (int p = 0; p < NP * 0; ++p) {\n        wgmma_s8<1>(")]),
    ("every requantize through __fdiv_rn (the first design)", [
        ("  float q = __fmul_rn(x, sc.rs);\n"
         "  q = __fmaf_rn(__fmaf_rn(-sc.s, q, x), sc.rs, q);\n"
         "  q = __fmaf_rn(__fmaf_rn(-sc.s, q, x), sc.rs, q);\n",
         "  const float q = __fdiv_rn(x, sc.s);\n")]),
    ("code plane stores out", [
        ("        *reinterpret_cast<uint16_t*>(out + plane_off(",
         "        if (j < 0) *reinterpret_cast<uint16_t*>(out + plane_off(")]),
    ("head sums out", [
        ("  for (int col = 2 * (threadIdx.x & 3); col < n; col += 8) {",
         "  for (int col = 2 * (threadIdx.x & 3); col < 0; col += 8) {")]),
    ("encode out (no sinf/cosf)", [
        ("      const float sv = sinf(x), cv = cosf(x);", "      const float sv = x, cv = x;")]),
    ("layer barriers out", [
        ("      wg_barrier(g);   // the layer's codes, whole, before the next layer's wgmmas read "
         "them\n", "")]),
    ("copies a quarter as large (L2 traffic / 4)", [
        ("      const uint32_t bytes = static_cast<uint32_t>(min(kChunkK, k - c) * nn);",
         "      const uint32_t bytes = static_cast<uint32_t>(min(kChunkK, k - c) * nn / 4);")]),
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
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_variants(_build.BUILD_DIR / "ablation_int8", SOURCE, VARIANTS)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(8192, 1, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).to(dev)
    cases = []
    for net, samples, sigma_only in (("fine", 192, False), ("coarse", 64, True)):
        module = NerfMLP(load_nerf_params(find_lego_assets() / net), device=dev)
        pts = rng.uniform(-1.6, 1.6, (8192, samples, 3)).astype(np.float32)
        cases.append((net, module, torch.from_numpy(pts).to(dev), sigma_only))

    real = _build.load_library
    try:
        for name, (so, ptxas) in libs.items():
            lib = _build.declare(ctypes.CDLL(str(so)))
            _build.load_library = lambda lib=lib: lib
            ms = []
            for net, module, pts, sigma_only in cases:
                def call():
                    with torch.no_grad():
                        fused_int8_mlp(module, pts, dirs, sigma_only=sigma_only)

                call()
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
                ms.append(f"{net} {tuple(pts.shape[:-1])} {statistics.median(times):.3f} ms")
            print(f"{card}: int8 kernel, {name}: {', '.join(ms)} (medians of 5); ptxas: "
                  f"{' | '.join(ptxas)}", flush=True)
    finally:
        _build.load_library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
