// The wide backward's round workspace: the contract between the per-tile
// kernels (fused_mlp_wide_bwd_bf16.cu, fused_mlp_wide_bwd_tc.cu), which
// write it, and the dW kernel (fused_mlp_wide_dw.cu), which reads it.
// The layout is defined here only: the host names slots and columns
// (ops/kernels/fused_mlp.py::wide_dw_jobs, in this slot order) and sizes
// the workspace from the slots' widths (wide_slot_cols).
//
// A round holds R tiles of 64 samples. Its slots, in this order: the point
// encode (64 columns), the dir encode (32), the trunk layers' outputs
// h_0 .. h_{depth-1} and the bottleneck's (nw each; with the encodes, the
// inputs H of every layer), then the output gradients dZ of the trunk
// layers dz_0 .. dz_{depth-1} and of the bottleneck (nw each) and of the
// view layer (nv). Per tile, a slot holds `planes` images of its columns
// back to back (1: the bf16 values; 3: the hi, mid and lo bf16 pieces of
// f32 values, f32tc::split3), each 64 rows in wgmma's no-swizzle
// core-matrix order (f32tc::p_off: a group of 8 columns is 1 KB), so that
// columns [c, c + k) of one image are k * 128 contiguous bytes. Tile t's
// images of slot s follow tile t - 1's; slot s starts R * planes * 128 *
// col0(s) bytes in.
#pragma once

#include <stdint.h>

namespace nerf {
namespace wide {

struct DwWs {
  uint8_t* base;
  long long tiles;   // R: the tiles the layout is sized for
  int planes, nw, nv, depth;

  // Slot indices.
  __host__ __device__ static int h(int i) { return 2 + i; }   // i = depth: the bottleneck
  __host__ __device__ int dz(int i) const { return 3 + depth + i; }   // i = depth: the bottleneck
  __host__ __device__ int dz_view() const { return 4 + 2 * depth; }

  __host__ __device__ int cols(int s) const {
    return s == 0 ? 64 : (s == 1 ? 32 : (s == dz_view() ? nv : nw));
  }
  __host__ __device__ long long col0(int s) const {
    return s <= 1 ? 64 * s : 96 + static_cast<long long>(s - 2) * nw;
  }
  // Plane q of tile t's image of slot s.
  __device__ __forceinline__ uint8_t* at(int s, long long t, int q = 0) const {
    return base + 128 * (col0(s) * tiles * planes + (t * planes + q) * cols(s));
  }
};

}  // namespace wide
}  // namespace nerf
