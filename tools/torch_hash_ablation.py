#!/usr/bin/env python3
"""Where the hash encode and the resampler K3 spend their time: times the
PyTorch port's two kernels (``csrc/hash_encode.cu``, ``csrc/resample.cu``)
with parts of their work taken out, each from a patched copy of the source
built beside the port's own library. The answers of the patched kernels
are wrong; only their times are read.

    python3 tools/torch_hash_ablation.py [--parent DIR]

``--parent DIR`` names a directory holding another version of the two
sources (``hash_encode.cu`` and ``resample.cu``, for example the parent
commit's, unpacked with ``git archive``). Both are then built as one more
variant, timed beside the checkout's kernels in turns (parent, change,
change, parent) and held to them bit for bit: the encode at 16384 x 192
on ray-ordered points and on scattered points with NaN and inf rows, f32
and bf16; K3 on what the render hands it (``chip_smoke.py`` phase 12's
inputs).

Needs one CUDA card and nvcc. Shapes: the encode at the main path's four
(the training step's 4096 rays x 64 and x 192, the 800x800 frame's 16384
x 64 and x 192 a chunk; points from ``chip_smoke.main_path_inputs``,
tables U(-1, 1) at the paper config), K3 at 16384 x (64, 128). Each line
gives a median over 5 runs of 20 launches (CUDA events) beside the card's
name and power limit, and the ptxas lines of the kernel (registers,
spills).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ENCODE, K3 = "hash_encode.cu", "resample.cu"
# (name, source, [(text, replacement), ...]) applied to the source; every
# text must occur.
VARIANTS = [
    ("encode as built", ENCODE, []),
    ("encode as built (again, for the spread)", ENCODE, []),
    ("encode: table loads out", ENCODE, [
        ("    q[p] = load_pair_if(pair, level, ia, policy);",
         "    q[p] = {make_float2(ia, ib), make_float2(ib, ia)};"),
        ("    own_a[p] = load_row_if(!pair, level, ia, policy);",
         "    own_a[p] = make_float2(ib, ia);"),
        ("    own_b[p] = load_row_if(!pair, level, ib, policy);",
         "    own_b[p] = make_float2(ia, ib);")]),
    ("encode: hashed levels' loads out", ENCODE, [
        ("        gather_pairs<false>(level, idx, policy, v);",
         "#pragma unroll\n        for (int c = 0; c < 8; ++c) v[c] = make_float2(idx[c], 0.f);")]),
    ("encode: pairs out (each corner its own row)", ENCODE, [
        ("    const bool pair = (ia ^ ib) == 1;\n    q[p]",
         "    const bool pair = false;\n    q[p]"),
        ("    const bool pair = (ia ^ ib) == 1;\n    v[ca]",
         "    const bool pair = false;\n    v[ca]")]),
    ("encode: the first corner always loads its aligned pair", ENCODE, [
        ("    q[p] = load_pair_if(pair, level, ia, policy);\n"
         "    own_a[p] = load_row_if(!pair, level, ia, policy);",
         "    q[p] = load_pair_if(true, level, ia, policy);"),
        ("    v[ca] = pair ? (ia & 1 ? q[p].odd : q[p].even) : own_a[p];",
         "    v[ca] = ia & 1 ? q[p].odd : q[p].even;")]),
    ("encode: f32 L2 evict-last hints out", ENCODE, [
        ('"@p ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%3], %4;',
         '"@p ld.global.nc.v2.f32 {%0, %1}, [%3];'),
        ('"@p ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%5], %6;',
         '"@p ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%5];')]),
    ("encode: bf16 with L2 evict-last hints", ENCODE, [
        ('"@p ld.global.nc.b32 %0, [%2];', '"@p ld.global.nc.L2::cache_hint.b32 %0, [%2], %3;'),
        ('"@p ld.global.nc.v2.b32 {%0, %1}, [%3];',
         '"@p ld.global.nc.L2::cache_hint.v2.b32 {%0, %1}, [%3], %4;'),
        ('"l"(t + 2 * static_cast<size_t>(row)));',
         '"l"(t + 2 * static_cast<size_t>(row)), "l"(policy));'),
        ('"l"(t + 2 * static_cast<size_t>(row & ~1u)));',
         '"l"(t + 2 * static_cast<size_t>(row & ~1u)), "l"(policy));')]),
    ("encode: table loads bypass L1 (.cg)", ENCODE, [('"@p ld.global.nc.', '"@p ld.global.cg.')]),
    ("encode: streaming stores out (write-back)", ENCODE, [
        ("      __stcs(reinterpret_cast<float4*>(dst) + i,",
         "      __stwb(reinterpret_cast<float4*>(dst) + i,")]),
    ("encode: staging out (each lane stores its own values)", ENCODE, [
        ("      store_pair(reinterpret_cast<Scalar*>(tile + s * pitch) + 2 * l, a0, a1);",
         "      if (s < rows) store_pair(out + (s0 + s) * (2 * levels) + 2 * l, a0, a1);"),
        ("  if (!kPair) return;", "  return;")]),
    ("encode: output stores out", ENCODE, [
        ("    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {",
         "    for (int i = threadIdx.x; i < rows * chunks * 0; i += kThreads) {")]),
    ("encode: normalization redone each (sample, level)", ENCODE, [
        ("      const float pos = __fmul_rn(res, xs[s * 3 + a]);",
         "      float xn = s < rows ? __fdiv_rn(__fsub_rn(points[(s0 + s) * 3 + a], lo), span)"
         " : 0.f;\n      xn = isnan(xn) ? 0.f : fminf(fmaxf(xn, 0.f), 1.f);\n"
         "      const float pos = __fmul_rn(res, xn);")]),
    ("encode: two coarsest levels' loads out (bound on keeping them in shared memory)", ENCODE, [
        ("      if (direct) {\n        gather_pairs<true>(level, idx, policy, v);",
         "      if (l < 2) {\n#pragma unroll\n        for (int c = 0; c < 8; ++c) "
         "v[c] = make_float2(idx[c], 0.f);\n      } else if (direct) {\n"
         "        gather_pairs<true>(level, idx, policy, v);")]),
    ("encode: 128-sample tiles", ENCODE, [
        ("constexpr int kTile = 64;", "constexpr int kTile = 128;")]),
    ("encode: 4 warps a CTA", ENCODE, [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")]),
    ("K3 as built", K3, []),
    ("K3: launch bounds without the one-CTA minimum", K3, [
        ("__global__ void __launch_bounds__(kWarps * 32, 1)\nresample_kernel(",
         "__global__ void __launch_bounds__(kWarps * 32)\nresample_kernel(")]),
    ("K3: 8 rays a CTA", K3, [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    ("K3: 4 searches a lane in flight", K3, [
        ("constexpr int kBatch = 8;", "constexpr int kBatch = 4;")]),
    ("K3: fine sort out", K3, [("  warp_sort_into<K>(fs, nf, fs);\n", "")]),
    ("K3: coarse sort on every ray (an unsorted t_c)", K3, [
        ("  if (!__all_sync(kFull, sorted)) {", "  if (__all_sync(kFull, sorted) || true) {")]),
    ("K3: merge searches out", K3, [
        ("    ranks<false>(cs, nc, x, below);",
         "#pragma unroll\n    for (int b = 0; b < B; ++b) below[b] = 0;"),
        ("    ranks<true>(fs, nf, x, below);",
         "#pragma unroll\n    for (int b = 0; b < B; ++b) below[b] = 0;")]),
    ("K3: CDF searches out", K3, [
        ("    for (int step = top_bin; step > 0; step >>= 1) {",
         "    for (int step = 0; step > 0; step >>= 1) {")]),
    ("K3: warp scans out", K3, [
        ("  warp_scan(c, nc, 1.f, Mul());", ""), ("  warp_scan(row, n_bins, 0.f, Add());", "")]),
]
PARENT = "parent"


def build_libraries(build_dir: Path, variants, parent=None):
    """{name: (library path, ptxas lines)}: each source's variants built by
    ``tools/torch_k2_ablation.py``'s ``build_variants`` (the other sources
    as in the checkout), and with ``parent`` one more variant of each
    source, its text replaced whole by the parent's copy."""
    from torch_k2_ablation import build_variants

    from nerf_rs_tpu_torch.ops.kernels import _build

    libs = {}
    for source in dict.fromkeys(source for _, source, _ in variants):
        own = [(name, patches) for name, src, patches in variants if src == source]
        if parent is not None:
            own.append((f"{PARENT} {source}", [((_build.CSRC / source).read_text(),
                                                 (Path(parent) / source).read_text())]))
        libs.update(build_variants(build_dir / Path(source).stem, source, own))
    return libs


def event_ms(fn, inner: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``inner`` calls, timed with CUDA events;
    per call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


class Swap:
    """Route the port's wrappers to one built library while in use."""

    def __init__(self, so):
        from nerf_rs_tpu_torch.ops.kernels import _build

        self.build, self.lib = _build, _build.declare(ctypes.CDLL(str(so)))

    def __enter__(self):
        self.real = self.build.load_library
        self.build.load_library = lambda: self.lib

    def __exit__(self, *exc):
        self.build.load_library = self.real


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="directory with another version of hash_encode.cu and resample.cu")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import chip_smoke as smoke

    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import HashGridConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_libraries(_build.BUILD_DIR / "ablation_hash", VARIANTS, args.parent)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    assets = find_lego_assets()
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    cfg = HashGridConfig()
    gen = torch.Generator(device=dev).manual_seed(17)
    t32 = torch.rand((cfg.levels, 1 << cfg.table_log2, cfg.features), generator=gen,
                     device=dev) * 2.0 - 1.0
    tables = {"float32": t32, "bfloat16": t32.to(torch.bfloat16)}
    shapes = {}
    for rays in (smoke.TRAIN_RAYS, smoke.BENCH_CHUNK):
        pts_c, pts_f, _ = smoke.main_path_inputs(cam, dev, rays)
        shapes[(rays, smoke.N_COARSE)], shapes[(rays, smoke.N_COARSE + smoke.N_FINE)] = pts_c, pts_f
    big = shapes[(smoke.BENCH_CHUNK, smoke.N_COARSE + smoke.N_FINE)]

    coarse = NerfMLP(load_nerf_params(assets / "coarse"), device=dev)
    fine = NerfMLP(load_nerf_params(assets / "fine"), device=dev)
    k3_timed = smoke.resample_inputs(coarse, cam, dev, smoke.BENCH_CHUNK, smoke.N_COARSE,
                                     smoke.N_FINE)[:4]

    def encode_ms(dtype, pts):
        return event_ms(lambda: fused_hash_encode(tables[dtype], pts, cfg))

    def k3_ms():
        return event_ms(lambda: fused_resample(*k3_timed))

    for name, (so, ptxas) in libs.items():
        if name.startswith(PARENT):
            continue
        with Swap(so):
            if name.startswith("encode"):
                line = ", ".join(f"{dtype} {encode_ms(dtype, big):.4f} ms"
                                 for dtype in ("float32", "bfloat16"))
                print(f"{card}: {name}: 16384 x 192 {line} (medians of 5 x 20); ptxas: "
                      f"{' | '.join(ptxas)}", flush=True)
            else:
                print(f"{card}: {name}: 16384 x (64, 128) {k3_ms():.4f} ms (median of 5 x 20); "
                      f"ptxas: {' | '.join(ptxas)}", flush=True)
    if args.parent is None:
        return 0

    # The parent's kernels against the checkout's: times in turns, then bit
    # for bit on the same inputs.
    order = [(PARENT, libs[f"{PARENT} {ENCODE}"][0]), ("change", libs["encode as built"][0])]
    k3_order = [(PARENT, libs[f"{PARENT} {K3}"][0]), ("change", libs["K3 as built"][0])]
    times = {}
    for label, so in order + order[::-1]:
        with Swap(so):
            for (rays, samples), pts in shapes.items():
                for dtype in ("float32", "bfloat16"):
                    times.setdefault((label, rays, samples, dtype), []).append(
                        encode_ms(dtype, pts))
    for (rays, samples) in shapes:
        for dtype in ("float32", "bfloat16"):
            p = times[(PARENT, rays, samples, dtype)]
            c = times[("change", rays, samples, dtype)]
            print(f"{card}: encode {rays} x {samples} {dtype}: parent {p[0]:.4f} / {p[1]:.4f} ms, "
                  f"change {c[0]:.4f} / {c[1]:.4f} ms (parent, change, change, parent; medians "
                  f"of 5 x 20)", flush=True)
    k3 = {}
    for label, so in k3_order + k3_order[::-1]:
        with Swap(so):
            k3.setdefault(label, []).append(k3_ms())
    print(f"{card}: K3 16384 x (64, 128): parent {k3[PARENT][0]:.4f} / {k3[PARENT][1]:.4f} ms, "
          f"change {k3['change'][0]:.4f} / {k3['change'][1]:.4f} ms (parent, change, change, "
          f"parent; medians of 5 x 20)", flush=True)

    rng = np.random.default_rng(20)
    scattered = rng.uniform(-2.2, 2.2, (big.numel() // 3, 3)).astype(np.float32)
    scattered[:3] = [[np.nan, 0.1, 0.2], [np.inf, -0.5, 0.0], [-np.inf, np.nan, 1.0]]
    scattered = torch.from_numpy(scattered).to(dev)
    same = True
    for label, pts in (("ray-ordered", big), ("scattered, NaN and inf rows", scattered)):
        for dtype in ("float32", "bfloat16"):
            outs = []
            for _, so in order:
                with Swap(so):
                    outs.append(fused_hash_encode(tables[dtype], pts, cfg))
            torch.cuda.synchronize()
            equal = torch.equal(outs[0], outs[1])
            same = same and equal
            print(f"{card}: encode 16384 x 192 {dtype}, {label} points: change bitwise the "
                  f"parent's {equal}", flush=True)
    grid = build_scene_grid(coarse, fine, resolution=smoke.GRID_RES)
    for nc, nf in ((smoke.N_COARSE, smoke.N_FINE), (32, 64)):
        for far_kind, g in (("scalar far", None), ("per-ray far", grid)):
            inputs = smoke.resample_inputs(coarse, cam, dev, smoke.RAY_CHUNK, nc, nf, g)[:4]
            outs = []
            for _, so in k3_order:
                with Swap(so):
                    outs.append(fused_resample(*inputs))
            torch.cuda.synchronize()
            equal = torch.equal(outs[0], outs[1])
            same = same and equal
            print(f"{card}: K3 {smoke.RAY_CHUNK} x ({nc}, {nf}), {far_kind} (phase 12's inputs): "
                  f"change bitwise the parent's {equal}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
