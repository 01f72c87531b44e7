"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/fused_mlp.cu`` for ``sm_90a`` into a shared library
with a plain C entry point, at first use, into ``_build/`` beside this file
(listed in ``.gitignore``). The library's name carries a hash of the source
and the flags, so an edited source builds anew. A missing ``nvcc`` or a
failed build raises with the compiler's output.
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
_SOURCE = _HERE / "csrc" / "fused_mlp.cu"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the fused "
                       "MLP kernel cannot be built")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fused_mlp_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; returns its path.
    The compiler's output (with ``-Xptxas -v``: registers, shared memory
    and spills per kernel) is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.nerf_fused_mlp_forward
    fn.argtypes = [p, p, ll, ll, p, p, p, i, i, i, i, i, i, p, p, i, p]
    fn.restype = ctypes.c_int
    return lib
