#!/usr/bin/env python3
"""K1's, K2's and the int8 kernels against another version of their
sources: the narrow K1 on the lego networks' render calls, the narrow K2 on
the lego networks' training calls, the wide K1 on a 512-wide network's
render calls and the wide K2 on a 512-wide network's training call, f32
and bf16, the narrow int8 kernel on the lego networks' render calls, and
two bf16 frames of the lego widened to 512/256/8, timed in turns and held
bit for bit.

    python3 tools/torch_k1_parent_ab.py --parent DIR

``DIR`` holds another version of ``csrc/`` (every ``*.cu`` beside the
headers they include): for example the parent commit's, unpacked with
``git archive <rev> nerf_rs_tpu_torch/ops/kernels/csrc`` into a gitignored
directory such as ``scratch_checkout/``. Its sources are built into a
library of their own, one ``nvcc`` each, as the port builds its own
(``ops/kernels/_build.py``, which builds the checkout's library as usual);
the port's wrappers then launch the one or the other. A call whose entry
points ``DIR``'s sources lack (the wide K2 before it existed, or before
its dW kernel: its C interface changed with it) is skipped, and said so;
``tools/torch_wide_k2_profile.py --parent`` times an older wide K2 through
its own interface.

Calls:
- K1 (narrow): the lego fine network full at 8192 rays x 192 samples and
  the lego coarse network sigma-only at 8192 x 64
  (``chip_smoke.main_path_inputs``, the 256x256 frame's center rays);
- K2 (narrow): the lego networks' backward at the training path's inputs
  (``chip_smoke.main_path_backward_inputs``: fine 4096 x 192, coarse 4096
  x 64, and coarse sigma-only), parameter and input gradients;
- wide K1: a random 512/256/8 network (phase 29's) full at 8192 x 192 and
  sigma-only at 8192 x 64;
- wide K2: the lego fine network widened to 512/256/8
  (``chip_smoke.widen_nerf``) at the fine training call's inputs;
- int8 (narrow): the lego fine network full and the coarse one sigma-only
  at K1's render calls, with each side's ``chip_smoke.int8_digest`` of the
  outputs (phase 21 holds the narrow int8 kernel to the parent's digests,
  ``chip_smoke.NARROW_INT8_SHA256``);
- wide int8: the lego networks widened to 512/256/8 (fine full, coarse
  sigma-only) and 384/192/8 (fine full) at the same calls, skipped, and
  said so, where ``DIR``'s sources lack the wide int8 kernel;
- wide1k K1: phase 29 (e)'s random 1024/512/8 network full at 8192 x 192
  and sigma-only at 8192 x 64; where ``DIR``'s sources have no split-f32
  wide1k kernel, their f32 side is the CUDA-core kernel that it replaced
  (``nerf_fused_mlp_wide1k_f32_forward``, called on the f32 pack);
- frames: the lego widened to 512/256/8 (``chip_smoke.py`` phase 29's
  networks), bf16, the 256x256 64+128 frame (``chip_smoke.render``) and
  the 800x800 accel+K3 frame (``chip_smoke.render_accel``, bench.py's
  accel defaults) on one 128^3 grid built once through the checkout's
  kernels, so that both sides render on the same grid.
K1 and K2 each in f32 and bf16, timed with CUDA events (median of 5 runs
of 10 launches; 3 for K2 and wide K1, 1 for wide K2; median of 3 single
calls for wide1k K1 and the frames) in turns, parent, change, change,
parent, ``--rounds`` times (3), and the two libraries' outputs compared
bit for bit; ``--only TEXT`` keeps the calls whose label holds
TEXT. Each line names the card and its power limit. Exit 1 if any output
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
ROUNDS = 3


class _Sink:
    """Takes the signature ``_build.declare`` gives an entry point that a
    library lacks."""


class _Present:
    """A loaded library seen through ``_build.declare``: the entry points
    it lacks are collected in ``missing`` instead of raising."""

    def __init__(self, lib):
        self._lib, self.missing = lib, []

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            self.missing.append(name)
            return _Sink()


def build_other(src_dir: Path, out_dir: Path):
    """Every ``*.cu`` of ``src_dir`` (headers found beside them) as one
    shared library, its entry points declared as ``_build.declare``
    declares the checkout's. -> (library, names of the entry points it
    lacks)."""
    from nerf_rs_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(src_dir.glob("*.cu")):
        obj = out_dir / f"{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for obj, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{out[-3000:]}")
    so = out_dir / "k1_k2_other.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(so),
                    *(str(obj) for obj, _ in jobs)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    seen = _Present(lib)
    _build.declare(seen)
    return lib, seen.missing


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


def cuda_core_wide1k_f32(lib, net, pts, viewdirs, sigma_only: bool):
    """K1 f32 past width 512 through the CUDA-core kernel of sources older
    than the split-f32 one (``nerf_fused_mlp_wide1k_f32_forward`` in
    ``lib``, on the f32 pack's ``weights`` and ``layout``, which that
    kernel read as they are). -> (rgb, sigma)."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd = lib.nerf_fused_mlp_wide1k_f32_forward
    fwd.argtypes = [p, p, ll, ll, p, p, p, i, i, i, i, i, p, p, i, p]
    fwd.restype = ctypes.c_int
    pk = net.packed("float32")
    dirs, dir_div, batch, n = fm._kernel_inputs(pk, pts, viewdirs)
    rgb = torch.empty((*batch, 3), dtype=torch.float32, device=pts.device)
    sigma = torch.empty(batch, dtype=torch.float32, device=pts.device)
    err = fwd(pts.data_ptr(), dirs.data_ptr(), n, dir_div, pk.weights.data_ptr(),
              pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size, pk.ldw, pk.ldv,
              pk.depth, int(sigma_only), rgb.data_ptr(), sigma.data_ptr(),
              pts.device.index or 0, fm._stream(pts.device))
    if err != 0:
        raise RuntimeError(f"the CUDA-core wide1k f32 kernel failed: CUDA error {err}")
    return rgb, sigma


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
                        help="directory with another version of the sources and headers")
    parser.add_argument("--only", action="append", default=[],
                        help="run only the calls whose label holds this text (repeatable)")
    parser.add_argument("--rounds", type=int, default=ROUNDS,
                        help=f"rounds of parent, change, change, parent (default {ROUNDS})")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    from nerf_rs_tpu_torch.config import ArchConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.load_library()
    tmp = tempfile.TemporaryDirectory(prefix="k1_parent_ab_")
    other, missing = build_other(args.parent, Path(tmp.name))
    dev = torch.device("cuda", 0)
    assets = find_lego_assets()
    nets = {n: NerfMLP(load_nerf_params(assets / n), device=dev) for n in ("coarse", "fine")}
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    pts_c, pts_f, vd = smoke.main_path_inputs(cam, dev)
    wide = NerfMLP(init_nerf_params(torch.Generator(device=dev).manual_seed(29),
                                    ArchConfig(*smoke.WIDE_RANDOM[1])), device=dev)
    bwd = smoke.main_path_backward_inputs(dev)

    def k1(net, pts, so):
        return lambda dtype: fused_nerf_mlp(net, pts, vd, dtype=dtype, sigma_only=so)

    def k1_1k(net, pts, so):
        def call(dtype):
            lib = _build.load_library()
            if dtype == "float32" and not hasattr(lib, "nerf_fused_mlp_wide1k_f32tc_forward"):
                return cuda_core_wide1k_f32(lib, net, pts, vd, so)
            return fused_nerf_mlp(net, pts, vd, dtype=dtype, sigma_only=so)
        return call

    wide1k = NerfMLP(init_nerf_params(torch.Generator(device=dev).manual_seed(29),
                                      ArchConfig(*smoke.WIDE1K_RANDOM[0])), device=dev)

    def q8(net, pts, so):
        from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp

        return lambda dtype: fused_int8_mlp(net, pts, vd, sigma_only=so)

    def k2(name, so=False, net=None):
        lego, *inputs = bwd[name]
        return lambda dtype: fused_nerf_mlp_backward(net or lego, *inputs, dtype=dtype,
                                                     sigma_only=so)

    wide_fine = NerfMLP(smoke.widen_nerf(load_nerf_params(assets / "fine"), 512, 256, 8),
                        device=dev)
    widened = {(net, arch): NerfMLP(smoke.widen_nerf(load_nerf_params(assets / net), *arch,
                                                     seed=("coarse", "fine").index(net)),
                                    device=dev)
               for net, arch in (("fine", (512, 256, 8)), ("coarse", (512, 256, 8)),
                                 ("fine", (384, 192, 8)))}
    scene = {}

    def frame(accel: bool):
        def call(dtype):
            if "grid" not in scene:
                from nerf_rs_tpu_torch.accel import build_scene_grid

                with launching(None):
                    scene["grid"] = build_scene_grid(*wide_lego, resolution=smoke.GRID_RES)
            if accel:
                img, _ = smoke.render_accel(*wide_lego, cam, dev, smoke.accel_cfg(dtype=dtype),
                                            scene["grid"], smoke.BENCH_SIZE)
                return (img,)
            img, _ = smoke.render(*wide_lego, cam, dev, "pallas", dtype)
            return (torch.from_numpy(img),)
        return call

    wide_lego = tuple(NerfMLP(smoke.widen_nerf(load_nerf_params(assets / net), 512, 256, 8,
                                               seed=seed), device=dev)
                      for seed, net in enumerate(("coarse", "fine")))
    wide_k2 = ("nerf_fused_mlp_wide_f32_record", "nerf_wide_bwd_f32_tiles",
               "nerf_wide_bwd_bf16_tiles", "nerf_wide_dw", "nerf_wide_small_sum")

    calls = [("K1 fine full", k1(nets["fine"], pts_f, False), tuple(pts_f.shape[:-1]), 10),
             ("K1 coarse sigma-only", k1(nets["coarse"], pts_c, True), tuple(pts_c.shape[:-1]),
              10),
             ("K2 fine", k2("fine"), tuple(bwd["fine"][1].shape[:-1]), 3),
             ("K2 coarse", k2("coarse"), tuple(bwd["coarse"][1].shape[:-1]), 3),
             ("K2 coarse sigma-only", k2("coarse", True), tuple(bwd["coarse"][1].shape[:-1]), 3),
             ("wide K1 512/256/8 full", k1(wide, pts_f, False), tuple(pts_f.shape[:-1]), 3),
             ("wide K1 512/256/8 sigma-only", k1(wide, pts_c, True), tuple(pts_c.shape[:-1]),
              3),
             ("wide K2 lego fine widened to 512/256/8", k2("fine", net=wide_fine),
              tuple(bwd["fine"][1].shape[:-1]), 1),
             ("int8 fine full", q8(nets["fine"], pts_f, False), tuple(pts_f.shape[:-1]), 10),
             ("int8 coarse sigma-only", q8(nets["coarse"], pts_c, True), tuple(pts_c.shape[:-1]),
              10),
             ("int8 wide 512/256/8 full", q8(widened[("fine", (512, 256, 8))], pts_f, False),
              tuple(pts_f.shape[:-1]), 5),
             ("int8 wide 512/256/8 sigma-only", q8(widened[("coarse", (512, 256, 8))], pts_c,
                                                   True), tuple(pts_c.shape[:-1]), 5),
             ("int8 wide 384/192/8 full", q8(widened[("fine", (384, 192, 8))], pts_f, False),
              tuple(pts_f.shape[:-1]), 5),
             ("wide1k K1 1024/512/8 full", k1_1k(wide1k, pts_f, False), tuple(pts_f.shape[:-1]),
              1),
             ("wide1k K1 1024/512/8 sigma-only", k1_1k(wide1k, pts_c, True),
              tuple(pts_c.shape[:-1]), 1),
             ("frame 512/256/8 256x256 64+128", frame(False), (smoke.H, smoke.W), 1),
             ("frame 512/256/8 800x800 accel+K3", frame(True),
              (smoke.BENCH_SIZE, smoke.BENCH_SIZE), 1)]
    calls = [c for c in calls if not args.only or any(o in c[0] for o in args.only)]
    skipped = {c[0]: sorted(set(wide_k2) & set(missing)) for c in calls
               if c[0].startswith("wide K2") and set(wide_k2) & set(missing)}
    if "nerf_int8_mlp_wide_forward" in missing:
        skipped.update({c[0]: ["nerf_int8_mlp_wide_forward"] for c in calls
                        if c[0].startswith("int8 wide")})
    for label, lacks in skipped.items():
        print(f"{label}: skipped, {args.parent}'s sources lack {lacks}", flush=True)
    calls = [c for c in calls if c[0] not in skipped]
    sides = {"parent": other, "change": None}
    same = True
    times = {}
    def dtypes(label):
        if label.startswith("frame"):
            return ("bfloat16",)
        return ("int8",) if label.startswith("int8") else ("float32", "bfloat16")

    for label, call, shape, inner in calls:
        for dtype in dtypes(label):
            outs = {}
            for side, lib in sides.items():
                with launching(lib), torch.no_grad():
                    outs[side] = call(dtype)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["change"]))
            same &= bitwise
            digests = ""
            if dtype == "int8":
                digests = "; sha256 " + ", ".join(
                    f"{side} {smoke.int8_digest(*outs[side])}" for side in sides)
            print(f"{label} {shape} {dtype}: parent and change bit for bit: {bitwise}{digests}",
                  flush=True)
            for _ in range(args.rounds):
                for side in ("parent", "change", "change", "parent"):
                    with launching(sides[side]), torch.no_grad():
                        ms = event_ms(lambda: call(dtype), inner=inner,
                                      reps=3 if label.startswith(("frame", "wide1k")) else 5)
                    times.setdefault((label, dtype, side), []).append(ms)
    for label, _, shape, _ in calls:
        for dtype in dtypes(label):
            p, c = (times[(label, dtype, side)] for side in ("parent", "change"))
            print(f"{card}: {label} {dtype} {shape}, in turns (parent, change, change, parent) x "
                  f"{args.rounds}: parent median {statistics.median(p):.3f} ms ({min(p):.3f}-"
                  f"{max(p):.3f}), change median {statistics.median(c):.3f} ms ({min(c):.3f}-"
                  f"{max(c):.3f}); change / parent "
                  f"{statistics.median(c) / statistics.median(p):.4f}", flush=True)
    print("every output bit for bit the parent's" if same else "OUTPUTS DIFFER", flush=True)
    tmp.cleanup()
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
