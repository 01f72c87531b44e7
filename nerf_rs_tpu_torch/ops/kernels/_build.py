"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with plain C entry points, at first use, into ``_build/`` beside this file
(listed in ``.gitignore``). The sources compile to objects in parallel, one
``nvcc`` each, and one more ``nvcc`` links them. The library's name carries
a hash of every source and header under ``csrc/`` and of the flags, so an
edited source builds anew. A missing ``nvcc`` or a failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the port's "
                       "CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"nerf_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; returns its path.
    The compilers' output (with ``-Xptxas -v``: registers, shared memory
    and spills per kernel) is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = None
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    so.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points' signatures."""
    return declare(ctypes.CDLL(str(build())))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library
    (``c_void_p`` for every pointer and the stream)."""
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd = lib.nerf_fused_mlp_f32tc_forward
    fwd.argtypes = [p, p, ll, ll, p, p, p, p, p, i, i, i, i, i, p, p, i, p]
    fwd.restype = ctypes.c_int
    tc = lib.nerf_fused_mlp_tc_forward
    tc.argtypes = [p, p, ll, ll, p, p, p, i, i, i, i, i, p, p, i, p]
    tc.restype = ctypes.c_int
    rec = lib.nerf_fused_mlp_f32tc_record
    rec.argtypes = [p, p, ll, ll, p, p, p, p, p, i, i, i, i, i, ll, ll, p, i, p]
    rec.restype = ctypes.c_int
    bwd = lib.nerf_fused_mlp_backward
    bwd.argtypes = [p, p, ll, ll, p, p, p, p, ll, p, p, i, p, i, i, i, i, i, p, ll, i, p, ll, ll, i,
                    p, p, i, p]
    bwd.restype = ctypes.c_int
    bsum = lib.nerf_fused_mlp_backward_sum
    bsum.argtypes = [p, i, ll, ll, p, p, i, p]
    bsum.restype = ctypes.c_int
    bwd16 = lib.nerf_fused_mlp_backward_bf16
    bwd16.argtypes = [p, p, ll, ll, p, p, p, p, p, p, i, i, i, i, i, p, p, ll, ll, i, p, p, p, p, i,
                      p]
    bwd16.restype = ctypes.c_int
    f = ctypes.c_float
    res = lib.nerf_fused_resample
    res.argtypes = [p, p, p, p, ll, f, ll, i, i, f, f, f, p, i, p]
    res.restype = ctypes.c_int
    enc = lib.nerf_hash_encode
    enc.argtypes = [p, ll, p, i, ll, i, i, i, p, p, p, f, f, p, i, p]
    enc.restype = ctypes.c_int
    q8 = lib.nerf_int8_mlp_forward
    q8.argtypes = [p, p, ll, ll, p, p, p, i, i, i, i, i, p, p, i, p]
    q8.restype = ctypes.c_int
    return lib
