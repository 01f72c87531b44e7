#!/usr/bin/env python3
"""K1's narrow kernels against another version of their sources: the lego
networks' K1 calls at the render's shapes, f32 and bf16, timed in turns and
held bit for bit.

    python3 tools/torch_k1_parent_ab.py --parent DIR

``DIR`` holds another version of K1's two narrow sources
(``fused_mlp_f32tc.cu``, ``fused_mlp_tc.cu``) beside the headers they
include (``fused_mlp_common.cuh``, ``fused_mlp_tc.cuh``,
``fused_mlp_f32tc.cuh``): for example the parent commit's, unpacked with
``git archive <rev> nerf_rs_tpu_torch/ops/kernels/csrc`` into a gitignored
directory such as ``scratch_checkout/``. The two sources are built from
``DIR`` into a library of their own, one ``nvcc`` each, as the port builds
its own (``ops/kernels/_build.py``, which builds the checkout's library as
usual); the port's wrapper then launches the one or the other.

Calls: the lego fine network full at 8192 rays x 192 samples and the lego
coarse network sigma-only at 8192 x 64 (``chip_smoke.main_path_inputs``,
the 256x256 frame's center rays), f32 and bf16. Each is timed with CUDA
events (median of 5 runs of 10 launches) in turns, parent, change, change,
parent, ROUNDS times, and the two libraries' outputs are compared bit for
bit. Each line names the card and its power limit. Exit 1 if any output
differs. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("fused_mlp_f32tc.cu", "fused_mlp_tc.cu")
ROUNDS = 3


def build_other(src_dir: Path, out_dir: Path) -> ctypes.CDLL:
    """K1's two narrow sources from ``src_dir`` (headers found beside them)
    as one shared library, with their forward entry points declared."""
    from nerf_rs_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-c", "-o", str(obj), str(src_dir / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for obj, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{out[-3000:]}")
    so = out_dir / "k1_other.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(so),
                    *(str(obj) for obj, _ in jobs)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.nerf_fused_mlp_f32tc_forward.argtypes = [p, p, ll, ll, p, p, p, p, p, i, i, i, i, i, p, p,
                                                 i, p]
    lib.nerf_fused_mlp_tc_forward.argtypes = [p, p, ll, ll, p, p, p, i, i, i, i, i, p, p, i, p]
    for fn in (lib.nerf_fused_mlp_f32tc_forward, lib.nerf_fused_mlp_tc_forward):
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def launching(lib):
    """The port's wrappers launch from ``lib`` inside the block (None: the
    checkout's library)."""
    from nerf_rs_tpu_torch.ops.kernels import _build

    real = _build.load_library
    if lib is not None:
        _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = real


def event_ms(fn, inner: int = 10, reps: int = 5) -> float:
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


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="directory with another version of K1's narrow sources and headers")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.load_library()
    tmp = tempfile.TemporaryDirectory(prefix="k1_parent_ab_")
    other = build_other(args.parent, Path(tmp.name))
    dev = torch.device("cuda", 0)
    assets = find_lego_assets()
    nets = {n: NerfMLP(load_nerf_params(assets / n), device=dev) for n in ("coarse", "fine")}
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    pts_c, pts_f, vd = smoke.main_path_inputs(cam, dev)
    calls = [("fine full", nets["fine"], pts_f, False),
             ("coarse sigma-only", nets["coarse"], pts_c, True)]
    sides = {"parent": other, "change": None}
    same = True
    times = {}
    for label, net, pts, so in calls:
        for dtype in ("float32", "bfloat16"):
            outs = {}
            for side, lib in sides.items():
                with launching(lib), torch.no_grad():
                    outs[side] = fused_nerf_mlp(net, pts, vd, dtype=dtype, sigma_only=so)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["change"]))
            same &= bitwise
            print(f"{label} {tuple(pts.shape[:-1])} {dtype}: parent and change bit for bit: "
                  f"{bitwise}", flush=True)
            for _ in range(ROUNDS):
                for side in ("parent", "change", "change", "parent"):
                    with launching(sides[side]), torch.no_grad():
                        ms = event_ms(lambda: fused_nerf_mlp(net, pts, vd, dtype=dtype,
                                                             sigma_only=so))
                    times.setdefault((label, dtype, side), []).append(ms)
    for label, _, pts, _ in calls:
        for dtype in ("float32", "bfloat16"):
            p, c = (times[(label, dtype, side)] for side in ("parent", "change"))
            print(f"{card}: K1 {dtype} {label} {tuple(pts.shape[:-1])}, in turns (parent, change, "
                  f"change, parent) x {ROUNDS}: parent median {statistics.median(p):.3f} ms "
                  f"({min(p):.3f}-{max(p):.3f}), change median {statistics.median(c):.3f} ms "
                  f"({min(c):.3f}-{max(c):.3f}); change / parent "
                  f"{statistics.median(c) / statistics.median(p):.4f}", flush=True)
    print("every output bit for bit the parent's" if same else "OUTPUTS DIFFER", flush=True)
    tmp.cleanup()
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
