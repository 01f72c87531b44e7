#!/usr/bin/env python3
"""Where the wide K2's time goes, at the lego fine network widened to
512/256/8 (``chip_smoke.widen_nerf``) on the training path's fine call
(4096 rays x 192 samples, ``chip_smoke.main_path_backward_inputs``),
parameter gradients, f32 and bf16.

    python3 tools/torch_wide_k2_profile.py [--per-cta K ...] [--parent DIR]

(a) This checkout: one call per dtype under ``torch.profiler``, each
kernel's device time and share of the call's (the f32 record pass, the
per-tile kernel, the dW kernel and its sum, the small sums), and the
call's time with CUDA events (median of 3), with the round sized by
``fused_mlp.WIDE_ROUND_BYTES`` and then, for each K given, at K tiles a
CTA a round (the budget set to hold exactly that many); each line gives
the round's tiles, its workspace and the call's peak scratch.

(b) With ``--parent DIR``: DIR holds a version of ``csrc/`` whose wide K2
still sums dW per tile into per-CTA partials (entry points
``nerf_fused_mlp_wide_backward_bf16`` and ``nerf_fused_mlp_wide_backward``,
before the dW kernel; for example ``git archive <rev>
nerf_rs_tpu_torch/ops/kernels/csrc`` unpacked into ``scratch_checkout/``).
Its wide pair is built as it is and with one part of its work taken out
at a time (patched copies of its sources, each built beside DIR's other
sources, all ``nvcc`` processes at once), and each library is timed on the
same call through DIR's own C interface (median of 3 with CUDA events):
what a part's removal saves is that part's share. The patched kernels'
answers are wrong; only their times are read. Parts: the partial adds, the
dW products with them, W dz, the recompute's products (bf16; in f32 the
record pass is a kernel of its own, read from the profile), the workspace
copies, the head and bias sums.

Every line names the card and its power limit. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BF16 = "fused_mlp_wide_bwd_bf16.cu"
F32 = "fused_mlp_wide_bwd_tc.cu"
# (name, [(file, text, replacement), ...]): every text must occur in file.
BF16_PARTS = [
    ("as built", []),
    ("partial adds out", [
        ("fused_mlp_bwd_bf16.cuh",
         "        atomicAdd(reinterpret_cast<float4*>(row + col0 + c4), v);",
         "        if (ld < 0) atomicAdd(reinterpret_cast<float4*>(row + col0 + c4), v);")]),
    ("dW products and partial adds out", [
        ("fused_mlp_bwd_bf16.cuh",
         "        atomicAdd(reinterpret_cast<float4*>(row + col0 + c4), v);",
         "        if (ld < 0) atomicAdd(reinterpret_cast<float4*>(row + col0 + c4), v);"),
        ("fused_mlp_bwd_bf16.cuh", "    mma_dw<NP>(acc, a, m0, dz + pg * 8 * kGroup);",
         "    fence_acc<NP>(acc);")]),
    ("W dz products out", [
        (BF16,
         "        if (full) {\n          wgmma_64<0, 1>(acc[p], da, db, s > 0 ? 1 : 0);\n"
         "        } else if (h == 0) {\n          wgmma_32<0, 1, 0>(acc[p], da, db, s > 0 ? 1 : 0);\n"
         "        } else {\n          wgmma_32<0, 1, 1>(acc[p], da, db, s > 0 ? 1 : 0);\n        }",
         "        (void)da; (void)db; (void)full;")]),
    ("recompute products out", [
        ("fused_mlp_wide_tc.cuh",
         "          wgmma_64<0, 0>(acc[p], da, desc(b + (p0 + p) * 1024 + (s >> 3) * (n * 16), "
         "n * 16, 128),\n                         first ? 0 : 1);",
         "          (void)da;")]),
    ("workspace copies out", [
        (BF16, "  for (int i = threadIdx.x; i < n * 8; i += kConsumers) {",
         "  for (int i = threadIdx.x; i < 0 * n; i += kConsumers) {")]),
    ("head and bias sums out", [
        (BF16, "    for (int k = tid; k < ldw; k += kConsumers) {",
         "    for (int k = tid; k < 0 * ldw; k += kConsumers) {"),
        (BF16, "      for (int idx = tid; idx < 3 * ldv; idx += kConsumers) {",
         "      for (int idx = tid; idx < 0 * ldv; idx += kConsumers) {"),
        ("fused_mlp_bwd_bf16.cuh", "    for (int c = threadIdx.x; c < n; c += kConsumers) {",
         "    for (int c = threadIdx.x; c < 0 * n; c += kConsumers) {")]),
]
F32_PARTS = [
    ("as built", []),
    ("partial adds out", [
        ("fused_mlp_bwd_tc.cuh", "      if (o < ld) {\n        atomicAdd(dst",
         "      if (o < ld && ld < 0) {\n        atomicAdd(dst")]),
    ("dW products and partial adds out", [
        ("fused_mlp_bwd_tc.cuh",
         "      cols_mma(acc, X, ld, m0, ws, f);\n      add_dw(acc, f >> 3, m0, ld, dst);",
         "      (void)ws; (void)dst;")]),
    ("W dz products out", [
        ("fused_mlp_bwd_tc.cuh", "    rows_mma(acc, X, kSx, k_red, w, lo, n8);", "    (void)lo;")]),
    ("workspace copies out", [
        ("fused_mlp_bwd_tc.cuh",
         "    for (int i = threadIdx.x; i < kRows * ld; i += kThreadsBwd) {",
         "    for (int i = threadIdx.x; i < 0 * ld; i += kThreadsBwd) {")]),
    ("head and bias sums out", [
        ("fused_mlp_bwd_tc.cuh", "    for (int k = tid; k < ldw; k += kThreadsBwd) {",
         "    for (int k = tid; k < 0 * ldw; k += kThreadsBwd) {"),
        ("fused_mlp_bwd_tc.cuh", "      for (int idx = tid; idx < 3 * ldv; idx += kThreadsBwd) {",
         "      for (int idx = tid; idx < 0 * ldv; idx += kThreadsBwd) {"),
        ("fused_mlp_bwd_tc.cuh", "    for (int c = threadIdx.x; c < n; c += kThreadsBwd) {",
         "    for (int c = threadIdx.x; c < 0 * n; c += kThreadsBwd) {")]),
]


def build(src_dir: Path, out_dir: Path, variants) -> dict:
    """{(source, name): library}: src_dir's sources compiled once, each
    variant's target source once more with its patched files (written to a
    directory of its own, searched before src_dir), all at once."""
    from nerf_rs_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(src_dir.glob("*.cu")):
        obj = out_dir / f"{src.stem}.o"
        procs[obj] = subprocess.Popen([nvcc, *_build.COMPILE_FLAGS, "-c", "-o", str(obj),
                                       str(src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    objs = {}
    for k, (target, name, patches) in enumerate(variants):
        if not patches:
            continue
        texts = {target: (src_dir / target).read_text()}
        for file, old, new in patches:
            texts.setdefault(file, (src_dir / file).read_text())
            if old not in texts[file]:
                raise RuntimeError(f"{name!r}: {old!r} is not in {src_dir / file}")
            texts[file] = texts[file].replace(old, new)
        vdir = out_dir / f"variant{k}"
        vdir.mkdir(exist_ok=True)
        for file, text in texts.items():
            (vdir / file).write_text(text)
        obj = out_dir / f"variant{k}.o"
        objs[(target, name)] = obj
        procs[obj] = subprocess.Popen([nvcc, *_build.COMPILE_FLAGS, "-I", str(src_dir), "-c",
                                       "-o", str(obj), str(vdir / target)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{out[-3000:]}")
    libs = {}
    for k, (target, name, patches) in enumerate(variants):
        base = [out_dir / f"{src.stem}.o" for src in sorted(src_dir.glob("*.cu"))]
        if patches:
            base = [o for o in base if o.stem != Path(target).stem] + [objs[(target, name)]]
        so = out_dir / f"lib{k}.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(so), *map(str, base)],
                       check=True, capture_output=True, text=True)
        libs[(target, name)] = ctypes.CDLL(str(so))
    return libs


def old_wide_backward(lib, pk, args, dtype: str):
    """A call of the per-tile-partials wide K2 through its own C interface
    (the wrapper of that design for wide packs), parameter gradients only."""
    import torch

    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import _kernel_inputs

    pts, vd, g_rgb, g_sig = args
    dev = pts.device
    vd, dir_div, _, n = _kernel_inputs(pk, pts, vd)
    g_rgb, g_sig = g_rgb.reshape(n, 3).contiguous(), g_sig.reshape(n).contiguous()
    n_w, n_b = pk.weights.numel(), pk.biases.numel()
    tiles = -(-n // 64)
    grid = min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    partials = torch.zeros(grid * (n_w + n_b), device=dev)
    dw, db = torch.zeros(n_w, device=dev), torch.zeros(n_b, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (pts.data_ptr(), vd.data_ptr(), n, dir_div, g_rgb.data_ptr(), g_sig.data_ptr())
    if dtype == "bfloat16":
        fn = lib.nerf_fused_mlp_wide_backward_bf16
        fn.argtypes = [p, p, ll, ll, p, p, p, p, p, p, i, i, i, i, i, p, p, ll, ll, i, p, p, p, p,
                       i, p]
        nw = -(-pk.ldw // 64) * 64
        ws = torch.empty(grid * 64 * ((pk.depth + 1) * nw + 2 * 64), dtype=torch.bfloat16,
                         device=dev)
        err = fn(*head, pk.weights_tc.data_ptr(), pk.biases.data_ptr(), pk.layout_tc.ctypes.data,
                 pk.layout.ctypes.data, pk.layout.size, pk.ldw, pk.ldv, pk.depth, 0,
                 ws.data_ptr(), partials.data_ptr(), n_w, n_b, grid, dw.data_ptr(),
                 db.data_ptr(), None, None, 0, stream)
    else:
        rec, bwd, bsum = (lib.nerf_fused_mlp_wide_f32_record, lib.nerf_fused_mlp_wide_backward,
                          lib.nerf_fused_mlp_backward_sum)
        rec.argtypes = [p, p, ll, ll, p, p, p, i, i, i, i, i, ll, ll, p, i, p]
        bwd.argtypes = [p, p, ll, ll, p, p, p, p, ll, p, p, i, p, i, i, i, i, i, p, ll, i, p, ll,
                        ll, i, p, p, i, p]
        bsum.argtypes = [p, i, ll, ll, p, p, i, p]
        per_round = grid * 8
        ws = torch.empty(min(tiles, per_round) * 64
                         * (96 + (pk.depth + 1) * pk.ldw + pk.ldv), device=dev)
        err = 0
        for tile0 in range(0, tiles, per_round):
            rows = min(tiles - tile0, per_round) * 64
            err = err or rec(pts.data_ptr(), vd.data_ptr(), n, dir_div, pk.weights.data_ptr(),
                             pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size, pk.ldw,
                             pk.ldv, pk.depth, 0, tile0 * 64, rows, ws.data_ptr(), 0, stream)
            err = err or bwd(*head, pk.weights.data_ptr(), pk.mma_wt.data_ptr(),
                             pk.mma_wt.shape[1], pk.biases.data_ptr(), pk.layout.ctypes.data,
                             pk.layout.size, pk.layout_mma.ctypes.data, pk.layout_mma.size,
                             pk.ldw, pk.ldv, pk.depth, 0, ws.data_ptr(), tile0, 8,
                             partials.data_ptr(), n_w, n_b, grid, None, None, 0, stream)
        err = err or bsum(partials.data_ptr(), grid, n_w, n_b, dw.data_ptr(), db.data_ptr(), 0,
                          stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return dw, db


def event_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="a csrc/ whose wide K2 sums per-tile partials")
    parser.add_argument("--per-cta", type=int, nargs="*", default=[],
                        help="also time rounds of K tiles a CTA")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp_backward

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    net = NerfMLP(smoke.widen_nerf(load_nerf_params(find_lego_assets() / "fine"), 512, 256, 8),
                  device=dev)
    call_args = smoke.main_path_backward_inputs(dev)["fine"][1:]
    shape = tuple(call_args[0].shape[:-1])
    n = call_args[0].numel() // 3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in ("float32", "bfloat16"):
        def call():
            fused_nerf_mlp_backward(net, *call_args, dtype=dtype, input_grads=False)

        default = fm.WIDE_ROUND_BYTES[dtype]
        plan = fm.wide_plan(net.packed(dtype), n, sms, sigma_only=False)
        tile_bytes = (plan.ws_bytes + plan.record_bytes) // plan.round_tiles
        for per_cta in [None, *args.per_cta]:
            if per_cta is not None:
                fm.WIDE_ROUND_BYTES[dtype] = per_cta * plan.grid * tile_bytes
            rp = fm.wide_plan(net.packed(dtype), n, sms, sigma_only=False)
            ms = event_ms(call)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            fm.WIDE_ROUND_BYTES[dtype] = default
            events = [e for e in prof.key_averages() if e.device_time_total > 0]
            busy = sum(e.device_time_total for e in events)
            print(f"{card}: wide K2 {dtype} at 512/256/8, {shape} fine, parameter gradients, "
                  f"rounds of {rp.round_tiles} tiles ({rp.round_tiles // rp.grid} a CTA, "
                  f"{rp.rounds} rounds, workspace {rp.ws_bytes / 2 ** 20:.1f} MiB, scratch "
                  f"{rp.scratch_bytes / 2 ** 30:.3f} GiB): {ms:.3f} ms a call (median of 3); "
                  f"device time by kernel (one call, {busy / 1e3:.3f} ms busy):", flush=True)
            for e in sorted(events, key=lambda e: -e.device_time_total):
                print(f"    {e.device_time_total / 1e3:9.3f} ms {e.device_time_total / busy:7.2%} "
                      f"x{e.count:<4d} {e.key[:100]}", flush=True)
    if args.parent is None:
        return 0
    with tempfile.TemporaryDirectory(prefix="wide_k2_profile_") as tmp:
        variants = ([(BF16, name, patches) for name, patches in BF16_PARTS]
                    + [(F32, name, patches) for name, patches in F32_PARTS])
        libs = build(args.parent.resolve(), Path(tmp), variants)
        for target, parts, dtype in ((F32, F32_PARTS, "float32"), (BF16, BF16_PARTS, "bfloat16")):
            pk = net.packed(dtype)
            base = None
            for name, _ in parts:
                lib = libs[(target, name)]
                ms = event_ms(lambda: old_wide_backward(lib, pk, call_args, dtype))
                base = ms if base is None else base
                print(f"{card}: {args.parent}'s wide K2 {dtype}, {shape} fine, {name}: "
                      f"{ms:.3f} ms" + ("" if ms == base else
                                        f", saves {base - ms:.3f} ms ({(base - ms) / base:.1%})"),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
