#!/usr/bin/env python3
"""What holds K2's bf16 kernel back: times a fine call of the PyTorch
port's bf16 backward (``csrc/fused_mlp_bwd_bf16.cu``) with parts of its
work taken out, each from a patched copy of that source built beside the
port's own library. The answers of the patched kernels are wrong; only
their times are read.

    python3 tools/torch_k2_ablation.py

Needs one CUDA card and nvcc. The shape is the training path's fine call
(the lego fine network, 4096 rays x 192 samples, parameter gradients);
each line gives the median of 5 calls beside the card's name and power
limit, and the ptxas lines of the patched kernel (registers, spills,
wgmma serialization).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = "fused_mlp_bwd_bf16.cu"
# (name, [(text, replacement), ...]) applied to SOURCE; every text must occur.
VARIANTS = [
    ("as built", []),
    ("dW reductions out", [
        ("        atomicAdd(reinterpret_cast<float4*>(row + col), v);",
         "        if (ld < 0) atomicAdd(reinterpret_cast<float4*>(row + col), v);")]),
    ("dW products and reductions out", [
        ("        atomicAdd(reinterpret_cast<float4*>(row + col), v);",
         "        if (ld < 0) atomicAdd(reinterpret_cast<float4*>(row + col), v);"),
        ("    mma_dw<NP>(acc, a, m0, dz);\n", "    fence_acc<NP>(acc);\n")]),
    ("workspace round trip out", [
        ("  for (int i = t; i < n * 8; i += 128) {", "  for (int i = t; i < 0 * n; i += 128) {")]),
    ("CUDA-core head and bias sums out", [
        ("  for (int c = threadIdx.x; c < n; c += kConsumers) {",
         "  for (int c = threadIdx.x; c < 0 * n; c += kConsumers) {"),
        ("    for (int k = tid; k < ldw; k += kConsumers) {",
         "    for (int k = tid; k < 0 * ldw; k += kConsumers) {"),
        ("      for (int idx = tid; idx < 3 * ldv; idx += kConsumers) {",
         "      for (int idx = tid; idx < 0 * ldv; idx += kConsumers) {")]),
]


def build_variants(build_dir: Path, source: str = SOURCE, variants=VARIANTS):
    """{name: (library path, ptxas lines)}: the unchanged sources compiled
    once, ``source`` once per variant, all nvcc processes at once. A
    variant's patches are (text, replacement) pairs for ``source`` or
    (file, text, replacement) triples for a header it includes; the
    patched files are written to a directory of the variant's own, where
    the compiler finds them before the checkout's."""
    from nerf_rs_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in _build.sources():
        if src.name != source:
            obj = build_dir / f"{src.stem}.o"
            jobs[obj] = subprocess.Popen([nvcc, *_build.COMPILE_FLAGS, "-c", "-o", str(obj),
                                          str(src)], stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
    variant_objs = {}
    for k, (name, patches) in enumerate(variants):
        texts = {source: (_build.CSRC / source).read_text()}
        for patch in patches:
            file, old, new = patch if len(patch) == 3 else (source, *patch)
            texts.setdefault(file, (_build.CSRC / file).read_text())
            if old not in texts[file]:
                raise RuntimeError(f"variant {name!r}: {old!r} not in {file}")
            texts[file] = texts[file].replace(old, new)
        vdir = build_dir / f"variant{k}"
        vdir.mkdir(exist_ok=True)
        for file, text in texts.items():
            (vdir / file).write_text(text)
        obj = build_dir / f"variant{k}.o"
        variant_objs[name] = obj
        jobs[obj] = subprocess.Popen([nvcc, *_build.COMPILE_FLAGS, "-I", str(_build.CSRC), "-c",
                                      "-o", str(obj), str(vdir / source)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for obj, proc in jobs.items():
        out, _ = proc.communicate()
        logs[obj] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{out[-3000:]}")
    common = [obj for obj in jobs if obj not in variant_objs.values()]
    libs = {}
    for k, (name, obj) in enumerate(variant_objs.items()):
        so = build_dir / f"variant{k}.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(so), *map(str, common),
                        str(obj)], check=True, capture_output=True, text=True)
        ptxas = [line.strip() for line in logs[obj].splitlines()
                 if "spill" in line or "Used" in line or "serialized" in line]
        libs[name] = (so, ptxas)
    return libs


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp_backward

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_variants(_build.BUILD_DIR / "ablation")
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    net = NerfMLP(load_nerf_params(find_lego_assets() / "fine"), device=dev)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-1.6, 1.6, (4096, 192, 3)).astype(np.float32)).to(dev)
    dirs = rng.normal(size=(4096, 1, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).to(dev)
    g_rgb = torch.from_numpy(rng.normal(size=(4096, 192, 3)).astype(np.float32) * 1e-3).to(dev)
    g_sig = torch.from_numpy(rng.normal(size=(4096, 192)).astype(np.float32) * 1e-4).to(dev)

    real = _build.load_library
    try:
        for name, (so, ptxas) in libs.items():
            lib = _build.declare(ctypes.CDLL(str(so)))
            _build.load_library = lambda lib=lib: lib

            def call():
                fused_nerf_mlp_backward(net, pts, dirs, g_rgb, g_sig, dtype="bfloat16",
                                        input_grads=False)

            call()
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            print(f"{card}: K2 bf16 fine (4096, 192), {name}: {statistics.median(times):.3f} ms "
                  f"(median of 5); ptxas: {' | '.join(ptxas)}", flush=True)
    finally:
        _build.load_library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
