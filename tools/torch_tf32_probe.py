#!/usr/bin/env python3
"""How a tf32 ``wgmma`` reads float32 operands on the card, for a 3xTF32
route that reads its A operand straight from f32 activations in shared
memory and forms the rest in registers (``PERF.md`` §6, PR 18).

    python3 tools/torch_tf32_probe.py

One warpgroup runs single ``wgmma.m64n64k8.f32.tf32.tf32`` instructions
(A a 64 x 8 f32 buffer in the no-swizzle K-major core-matrix order of
4-byte elements; A from registers in the m16n8k8 tf32 fragment layout, one
16-row slab a warp), B the 8 x 64 matrix with ones at (k, k) and zeros
elsewhere, so that output column k < 8 is A's column k as the tensor cores
took it:

1. A read from shared memory as f32 with full mantissas (``wgmma_ss``),
   against A with its low 13 bits cleared (truncation), rounded to nearest
   with ties away (``cvt.rna``) and to nearest even; A holds values whose
   low 13 bits are exactly half a tf32 unit, where the three part;
2. the same A from registers (``wgmma_rs``, that fragment layout,
   raw f32 bits): equal to (1) if the layout is right;
3. A's small part from registers (``small_frag``): hw + small against A;
4. a 3xTF32 k-step (x w.lo and s w.hi into one
   accumulator, x w.hi into another), random A and W, against float64
   and against its emulation (each of the three products' 8 terms summed
   in float64 and rounded once into its f32 accumulator).

Prints each finding and the card beside it; exit 1 if (2) is not (1) or
if the card neither truncates nor rounds as one of the three. Needs one
CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "nerf_rs_tpu_torch" / "ops" / "kernels" / "csrc"

SOURCE = r"""
#include "fused_mlp_tc.cuh"
using namespace nerf;
using namespace nerf::tc;

// (row, col) of a 64-row f32 buffer: core matrices of 8 rows of 4 columns,
// the eight row groups of a 4-column group contiguous, groups 1 KB apart.
__device__ uint32_t t_off(int row, int col) {
  return (col >> 2) * 1024 + (row >> 3) * 128 + (row & 7) * 16 + (col & 3) * 4;
}
__device__ uint32_t rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// Fragment element i: row 16 (warp % 4) + lane / 4 + 8 (i % 2), column
// lane % 4 + 4 (i / 2).
__device__ int frag_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (i & 1);
}
__device__ int frag_col(int i) { return (threadIdx.x & 3) + 4 * (i >> 1); }

#define D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define OUT32(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
    "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

__device__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32 ", %32, %33, p, 1, 1;\n}\n"
               : OUT32(d) : "l"(da), "l"(db), "r"(scale_d));
}
__device__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : OUT32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// The small part of this thread's fragment: x - trunc13(x), rounded to tf32.
__device__ void small_frag(const uint8_t* buf, uint32_t (&a)[4]) {
  for (int i = 0; i < 4; ++i) {
    const float x = *reinterpret_cast<const float*>(buf + t_off(frag_row(i), frag_col(i)));
    a[i] = rna(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u));
  }
}

// mode 0: A from shared memory; 1: A's raw bits from registers; 2: A's
// small part from registers; 3: a 3xTF32 k-step of A and W (hi, lo).
__global__ void probe(const float* a, const float* b_hi, const float* b_lo, int mode,
                      float* out, float* out2) {
  __shared__ __align__(1024) uint8_t sa[64 * 8 * 4];
  __shared__ __align__(1024) float sb[2][8 * 64];
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 8; i += 128) {
    const int row = i / 8, col = i % 8;
    *reinterpret_cast<float*>(sa + t_off(row, col)) = a[i];
  }
  for (int i = t; i < 8 * 64; i += 128) {
    const int k = i / 64, n = i % 64;
    const int at = ((k >> 2) * 8 + (n >> 3)) * 32 + (n & 7) * 4 + (k & 3);
    sb[0][at] = b_hi[i];
    sb[1][at] = b_lo[i];
  }
  fence_async_smem();
  __syncthreads();
  float d[32], e[32];
  for (int i = 0; i < 32; ++i) d[i] = e[i] = 0.f;
  const uint64_t da = desc(smem_u32(sa), 1024, 128);
  const uint64_t hi = desc(smem_u32(sb[0]), 1024, 128), lo = desc(smem_u32(sb[1]), 1024, 128);
  uint32_t r[4];
  if (mode == 1) {
    for (int i = 0; i < 4; ++i) r[i] = __float_as_uint(a[frag_row(i) * 8 + frag_col(i)]);
  } else {
    small_frag(sa, r);
  }
  wgmma_fence();
  if (mode == 0) {
    wgmma_ss(d, da, hi, 0);
  } else if (mode == 3) {
    wgmma_ss(e, da, lo, 0);
    wgmma_rs(e, r, hi, 1);
    wgmma_ss(d, da, hi, 0);
  } else {
    wgmma_rs(d, r, hi, 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  const int lane = t & 31, r0 = (t >> 5) * 16 + (lane >> 2);
  for (int j = 0; j < 8; ++j) {
    for (int rr = 0; rr < 2; ++rr) {
      for (int c = 0; c < 2; ++c) {
        const int row = r0 + 8 * rr, col = 8 * j + 2 * (lane & 3) + c;
        out[row * 64 + col] = d[4 * j + 2 * rr + c];
        out2[row * 64 + col] = e[4 * j + 2 * rr + c];
      }
    }
  }
}

extern "C" int run_probe(const float* a, const float* b_hi, const float* b_lo, int mode,
                         float* out, float* out2) {
  probe<<<1, 128>>>(a, b_hi, b_lo, mode, out, out2);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
"""


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def from_bits(u):
    return np.asarray(u, np.uint32).view(np.float32)


def truncate(x):
    return from_bits(bits(x) & np.uint32(0xFFFFE000))


def round_away(x):
    u = bits(x).astype(np.uint64)
    return from_bits(((u + 0x1000) & 0xFFFFE000).astype(np.uint32))


def round_even(x):
    u = bits(x).astype(np.uint64)
    keep = (u >> 13) & 1
    return from_bits(((u + 0xFFF + keep) & 0xFFFFE000).astype(np.uint32))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from nerf_rs_tpu_torch.ops.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="tf32_probe_") as tmp:
        src, so = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                        "-fPIC", "-shared", "-I", str(CSRC), "-o", str(so), str(src)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        lib.run_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        lib.run_probe.restype = ctypes.c_int
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        a = rng.uniform(-4, 4, (64, 8)).astype(np.float32)
        # Half a tf32 unit in the low 13 bits: with an even and an odd
        # kept bit, where truncation, ties away and ties to even part.
        a[:16] = from_bits((bits(a[:16]) & np.uint32(0xFFFFC000)) | np.uint32(0x1000))
        a[16:32] = from_bits((bits(a[16:32]) & np.uint32(0xFFFFC000)) | np.uint32(0x3000))
        eye = np.zeros((8, 64), np.float32)
        eye[np.arange(8), np.arange(8)] = 1.0

        def run(mode, a_np, hi, lo):
            ins = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (a_np, hi, lo)]
            out = torch.zeros((64, 64), device=dev)
            out2 = torch.zeros((64, 64), device=dev)
            err = lib.run_probe(*(t.data_ptr() for t in ins), mode, out.data_ptr(),
                                out2.data_ptr())
            if err:
                raise RuntimeError(f"probe failed with CUDA error {err}")
            return out.cpu().numpy(), out2.cpu().numpy()

        zeros = np.zeros_like(eye)
        smem = run(0, a, eye, zeros)[0][:, :8]
        regs = run(1, a, eye, zeros)[0][:, :8]
        small = run(2, a, eye, zeros)[0][:, :8]
        kinds = {"truncates": truncate(a), "rounds to nearest, ties away": round_away(a),
                 "rounds to nearest, ties to even": round_even(a)}
        found = [k for k, v in kinds.items() if np.array_equal(smem, v)]
        print(f"{card}: 1. wgmma tf32, A read from shared memory as f32: "
              f"{found[0] if found else 'none of the three'}; off truncation at "
              f"{int((smem != kinds['truncates']).sum())} of 512 entries, off ties-away at "
              f"{int((smem != kinds['rounds to nearest, ties away']).sum())}, off ties-even at "
              f"{int((smem != kinds['rounds to nearest, ties to even']).sum())}", flush=True)
        same = np.array_equal(regs, smem)
        print(f"{card}: 2. A's raw f32 bits from registers (the m16n8k8 tf32 fragment layout) "
              f"equal (1): {same}", flush=True)
        resid = float(np.abs((smem.astype(np.float64) + small) - a).max() / np.abs(a).max())
        print(f"{card}: 3. hw + small part (from registers) against A: max relative error "
              f"{resid:.3g} (2^{np.log2(max(resid, 1e-30)):.1f})", flush=True)
        w = rng.normal(0, 0.3, (8, 64)).astype(np.float32)
        hi = round_away(w)
        lo = round_away(w - hi)
        big, sm = run(3, a, hi, lo)
        got = (big + sm).astype(np.float32)
        exact = a.astype(np.float64) @ w.astype(np.float64)
        x_hw = truncate(a)
        x_s = round_away(a - x_hw)
        f64 = np.float64
        small = np.float32(x_hw.astype(f64) @ lo.astype(f64))
        small = np.float32(small.astype(f64) + x_s.astype(f64) @ hi.astype(f64))
        emul = np.float32(np.float32(x_hw.astype(f64) @ hi.astype(f64)) + small)
        print(f"{card}: 4. one 3xTF32 k-step: max |card - float64| / max |float64| "
              f"{np.abs(got - exact).max() / np.abs(exact).max():.3g}, emulation "
              f"{np.abs(emul - exact).max() / np.abs(exact).max():.3g}; card vs emulation: "
              f"{int((got != emul).sum())} of {got.size} entries differ, max "
              f"{np.abs(got - emul).max():.3g}", flush=True)
        return 0 if (same and found) else 1


if __name__ == "__main__":
    sys.exit(main())
