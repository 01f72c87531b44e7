#!/usr/bin/env python3
"""Where wide K1's time goes: the wide forward pair (bf16
``csrc/fused_mlp_wide_tc.cu``, f32 ``csrc/fused_mlp_wide_f32.cu``) at
phase 29's random 512/256/8 network (``chip_smoke.WIDE_RANDOM``), and the
wide1k split-f32 kernel (``csrc/fused_mlp_wide1k_f32tc.cu``) at phase 29
(e)'s random 1024/512/8 (``chip_smoke.WIDE1K_RANDOM``), on the render's
calls (``chip_smoke.main_path_inputs``: 8192 rays x 192 samples full, x
64 sigma-only).

    python3 tools/torch_wide_k1_profile.py [--parent DIR] [--only TEXT]

Each kernel is built as it is and with one part of its work taken out or
changed at a time (patched copies of its sources, each built beside the
other sources, all ``nvcc`` processes at once), and each library is timed
on the same calls through the port's wrappers (CUDA events, median of 5
runs of 3 calls): what a part's removal saves is that part's share. The
patched kernels' answers are wrong where a part is taken out; only their
times are read. Parts of this checkout's bf16 kernel: the cluster size (1,
2, 4 CTAs sharing the weight stream), the ring (8 stages of 16 KB, chunks
of 32 K-rows), a stage released one chunk behind, the tensor-core
products, the chunks' f32 sums, the weight copies (each run's bytes cut
to 16). Of the wide1k split-f32 kernel: the products, the staging of
the layer input, the weight copies (16 bytes a chunk), the barrier of
each k-step. With ``--parent DIR`` (a
``csrc/`` of the kernels before clusters, e.g. ``git archive 7f4632f
nerf_rs_tpu_torch/ops/kernels/csrc`` unpacked into ``scratch_checkout/``),
the same for its wide pair (bf16 on ``wgmma``, f32 on the CUDA cores): as
built, products out, weight copies out.

Then one wide K2 f32 call (the lego fine widened to 512/256/8 at the
training path's fine inputs, parameter gradients) under
``torch.profiler``: each kernel's device time, the record pass among them.
Every line names the card and its power limit. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

BF16 = "fused_mlp_wide_tc.cu"
WIDE1K_F32 = "fused_mlp_wide1k_f32tc.cu"
COPIES_OUT = [
    ("fused_mlp_cluster.cuh", "    mbar_expect_tx(bars + 8 * stage, run_bytes * runs);",
     "    mbar_expect_tx(bars + 8 * stage, 16u * runs);"),
    ("fused_mlp_cluster.cuh",
     "                          static_cast<const uint8_t*>(src) + r * stride, run_bytes,",
     "                          static_cast<const uint8_t*>(src) + r * stride, 16u,")]
# (target, name, [(file, text, replacement), ...]): every text must occur in file.
PARTS = [
    (BF16, "as built (clusters of 2)", []),
    (BF16, "clusters of 1 (no sharing)", [
        (BF16, "constexpr int kClusterW = 2;", "constexpr int kClusterW = 1;")]),
    (BF16, "clusters of 4", [
        (BF16, "constexpr int kClusterW = 2;", "constexpr int kClusterW = 4;")]),
    (BF16, "8 stages of 16 KB, chunks of 32 K-rows", [
        (BF16, "constexpr int kStagesW = 4;", "constexpr int kStagesW = 8;"),
        (BF16, "kStagesW * kStageBytesW", "kStagesW * (kStageBytesW / 2)"),
        (BF16, "ClusterProducer<kStagesW, kStageBytesW,", "ClusterProducer<kStagesW, kStageBytesW / 2,"),
        (BF16, "ClusterPipe<kStagesW, kStageBytesW,", "ClusterPipe<kStagesW, kStageBytesW / 2,"),
        ("fused_mlp_wide_tc.cuh", "constexpr int kPassK = 64;", "constexpr int kPassK = 32;"),
        ("fused_mlp_wide_tc.cuh", "static_assert(kPassK * kPassPieces * kPiece * 2 == kStageBytesW,",
         "static_assert(2 * kPassK * kPassPieces * kPiece * 2 == kStageBytesW,")]),
    (BF16, "released one chunk behind (tc::Pipe's)", [
        ("fused_mlp_cluster.cuh", "  uint32_t ring, bars;\n  int stage;\n  uint32_t phase;\n",
         "  uint32_t ring, bars;\n  int stage;\n  uint32_t phase;\n  int pending = -1;\n"),
        ("fused_mlp_cluster.cuh",
         "    wgmma_wait<0>();\n    free_stage(stage);\n    next();",
         "    if (pending >= 0) {\n      wgmma_wait<1>();\n      free_stage(pending);\n    }\n"
         "    pending = stage;\n    next();"),
        ("fused_mlp_cluster.cuh", "  __device__ __forceinline__ void release() {}",
         "  __device__ __forceinline__ void release() {\n    free_stage(pending);\n"
         "    pending = -1;\n  }")]),
    (BF16, "products out", [
        ("fused_mlp_wide_tc.cuh",
         "            wgmma_64<0, 0>(acc[p], da,\n"
         "                           desc(b + (pw + p) * 1024 + (s >> 3) * (nh * 16), nh * 16, 128),\n"
         "                           s ? 1 : 0);",
         "            (void)da;")]),
    (BF16, "chunk sums out", [
        ("fused_mlp_wide_tc.cuh", "          for (int i = 0; i < 32; ++i) run[p][i] += acc[p][i];",
         "          for (int i = 0; i < 32; ++i) run[p][i] = acc[p][i];")]),
    (BF16, "weight copies out", COPIES_OUT),
    (WIDE1K_F32, "as built", []),
    (WIDE1K_F32, "products out", [
        (WIDE1K_F32, "          if (j < 5) {\n"
                     "            wgmma_64<0, 0>(small[p], da, db, (t == 0 && j == 0) ? 0 : 1);\n"
                     "          } else {\n"
                     "            wgmma_64<0, 0>(big[p], da, db, 0);\n"
                     "          }",
         "          (void)da;\n          (void)db;")]),
    (WIDE1K_F32, "staging out", [
        (WIDE1K_F32, "    if (next) stage_load(first ? s1 : s2, (first ? t + 1 : t + 1 - steps1) * "
                     "kStepK, in, v);", "    (void)first;"),
        (WIDE1K_F32, "      stage_store(v, a_stages + ((t + 1) & 1) * 3 * kPlaneA);", "")]),
    (WIDE1K_F32, "weight copies out", [
        (WIDE1K_F32, "    mbar_expect_tx(full, sg.bytes);", "    mbar_expect_tx(full, 16u);"),
        (WIDE1K_F32, "              sg.bytes, full);", "              16u, full);")]),
    (WIDE1K_F32, "k-step barrier out", [
        (WIDE1K_F32, "    consumers_barrier();   // the next stage written; this one's wgmmas retired",
         "")]),
]
PARENT_BF16, PARENT_F32 = "fused_mlp_wide_tc.cu", "fused_mlp_wide_f32.cu"
PARENT_PARTS = [
    (PARENT_BF16, "as built", []),
    (PARENT_BF16, "products out", [
        ("fused_mlp_wide_tc.cuh",
         "          wgmma_64<0, 0>(acc[p], da, desc(b + (p0 + p) * 1024 + (s >> 3) * (n * 16), "
         "n * 16, 128),\n                         first ? 0 : 1);",
         "          (void)da;")]),
    (PARENT_BF16, "weight copies out", [
        ("fused_mlp_wide_tc.cuh",
         "      mbar_expect_tx(bars + 8 * stage, bytes);\n"
         "      bulk_copy(ring + stage * kStageBytesW, w + off + static_cast<long long>(c) * nn, "
         "bytes,",
         "      mbar_expect_tx(bars + 8 * stage, 16u);\n"
         "      bulk_copy(ring + stage * kStageBytesW, w + off + static_cast<long long>(c) * nn, "
         "16u,")]),
    (PARENT_F32, "as built", []),
    (PARENT_F32, "products out", [
        (PARENT_F32, "#pragma unroll\n          for (int r = 0; r < 8; ++r) {\n"
                     "            acc[r][4 * j] = fmaf(av[r], bv.x, acc[r][4 * j]);",
         "#pragma unroll\n          for (int r = 0; r < 8 * (col < 0); ++r) {\n"
         "            acc[r][4 * j] = fmaf(av[r], bv.x, acc[r][4 * j]);")]),
    (PARENT_F32, "weight copies out", [
        (PARENT_F32, "    mbar_expect_tx(bars + 8 * stage, bytes);",
         "    mbar_expect_tx(bars + 8 * stage, 16u);"),
        (PARENT_F32, "              bytes, bars + 8 * stage);",
         "              16u, bars + 8 * stage);")]),
]


def event_ms(fn, inner: int = 3, reps: int = 5) -> float:
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


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="a csrc/ of the wide pair before clusters")
    parser.add_argument("--only", action="append", default=[],
                        help="time only the parts whose name holds this text (repeatable)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from torch_k1_parent_ab import launching
    from torch_wide_k2_profile import build

    from nerf_rs_tpu_torch.config import ArchConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    assets = find_lego_assets()
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    pts_c, pts_f, vd = smoke.main_path_inputs(cam, dev)
    nets = {}
    for target, arch in ((BF16, smoke.WIDE_RANDOM[1]), (WIDE1K_F32, smoke.WIDE1K_RANDOM[0])):
        gen = torch.Generator(device=dev).manual_seed(29)
        nets[target] = arch, NerfMLP(init_nerf_params(gen, ArchConfig(*arch)), device=dev)
    calls = [("full", pts_f, False), ("sigma-only", pts_c, True)]

    def time_parts(src_dir: Path, parts, label: str):
        parts = [p for p in parts if not args.only or any(o in p[1] for o in args.only)]
        with tempfile.TemporaryDirectory(prefix="wide_k1_profile_") as tmp:
            libs = build(src_dir, Path(tmp), parts)
            for target, name, _ in parts:
                lib = _build.declare(libs[(target, name)])
                dtype = "bfloat16" if target == BF16 else "float32"
                arch, net = nets.get(target, nets[BF16])
                for kind, pts, so in calls:
                    with launching(lib), torch.no_grad():
                        ms = event_ms(lambda: fused_nerf_mlp(net, pts, vd, dtype=dtype,
                                                             sigma_only=so))
                    print(f"{card}: {label} wide K1 {dtype} at {arch[:3]}, "
                          f"{tuple(pts.shape[:-1])} {kind}, {name}: {ms:.3f} ms", flush=True)

    csrc = REPO / "nerf_rs_tpu_torch" / "ops" / "kernels" / "csrc"
    time_parts(csrc, PARTS, "this checkout's")
    if args.parent is not None:
        time_parts(args.parent.resolve(), PARENT_PARTS, f"{args.parent}'s")

    # Wide K2 f32 and its record pass, under the profiler.
    wide = NerfMLP(smoke.widen_nerf(load_nerf_params(assets / "fine"), 512, 256, 8), device=dev)
    k2_args = smoke.main_path_backward_inputs(dev)["fine"][1:]

    def k2():
        fused_nerf_mlp_backward(wide, *k2_args, dtype="float32", input_grads=False)

    ms = event_ms(k2, inner=1, reps=3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        k2()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.device_time_total for e in events)
    print(f"{card}: wide K2 f32 on the lego widened to 512/256/8, "
          f"{tuple(k2_args[0].shape[:-1])} fine, parameter gradients: {ms:.3f} ms a call (median "
          f"of 3); device time by kernel (one call, {busy / 1e3:.3f} ms busy):", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total):
        print(f"    {e.device_time_total / 1e3:9.3f} ms {e.device_time_total / busy:7.2%} "
              f"x{e.count:<4d} {e.key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
