// The device code of K2's narrow bf16 kernel (fused_mlp_bwd_bf16.cu:
// 128-sample tiles, each consumer warpgroup on 64 of them, widths up to
// 256), of which the wide per-tile kernel (fused_mlp_wide_bwd_bf16.cu:
// 64-sample tiles, its dW in fused_mlp_wide_dw.cu) uses the fragment
// coordinates and the bias sums. BwdBf16<kRows> holds, for a tile of kRows
// samples in K-major core-matrix buffers, the dW products over the tile's
// samples and their reductions into the CTA's partial, the bias sums, and
// the launch.

#pragma once

#include "fused_mlp_tc.cuh"

namespace nerf {
namespace bwd16 {

using namespace tc;

constexpr int kDeCols = 64;   // floats a row of the encode gradient in the workspace

// Row and first column of accumulator element 4 j + 2 r (and + 1) of this
// thread: row r0 + 8 r (of the warpgroup's 64), column 8 j + c0 of a piece.
__device__ __forceinline__ int frag_row() {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x & 3); }

template <int kRows_>
struct BwdBf16 {
  static constexpr int kRows = kRows_;
  static constexpr int kGroup = kRows * 16;   // bytes of one 8-column group of a buffer

  // Byte offset of (row, col) in a kRows-row buffer in K-major core-matrix
  // order: 8 x 8 blocks of 16-byte rows, all row groups of one 8-column
  // group contiguous (fused_mlp_tc.cuh's a_off at 128 rows,
  // fused_mlp_f32tc.cuh's p_off at 64).
  static __device__ __forceinline__ uint32_t off(int row, int col) {
    return (col >> 3) * kGroup + (row >> 3) * 128 + (row & 7) * 16 + (col & 7) * 2;
  }

  static __device__ __forceinline__ float ld(const uint8_t* buf, int row, int col) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(buf + off(row, col)));
  }

  // acc = A^T dZ over the tile's samples: A's columns [m0, m0 + 64) (a
  // buffer's features) times NP 64-column pieces of dZ from shared address
  // dz; both read MN-major.
  template <int NP>
  static __device__ __forceinline__ void mma_dw(float (&acc)[4][32], uint32_t a, int m0,
                                                uint32_t dz) {
    fence_acc<NP>(acc);
    wgmma_fence();
#pragma unroll(kRows == 64 ? 4 : 1)
    for (int s = 0; s < kRows; s += 16) {
      const uint64_t da = desc(a + (m0 >> 3) * kGroup + (s >> 3) * 128, 128, kGroup);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_64<1, 1>(acc[p], da, desc(dz + p * 8 * kGroup + (s >> 3) * 128, 128, kGroup),
                       s > 0 ? 1 : 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<NP>(acc);
  }

  // One dW block into the CTA's partial: input rows [m0, m0 + 64) (below
  // k_valid) x the NP output pieces from piece pg; entry (in, out) at
  // dst[in * ld + out], out < ld.
  template <int NP>
  static __device__ __forceinline__ void dw_block(uint32_t a, int m0, int k_valid, uint32_t dz,
                                                  int pg, int ld, float* dst) {
    float acc[4][32];
    mma_dw<NP>(acc, a, m0, dz + pg * 8 * kGroup);
    // Lanes 2 q and 2 q + 1 hold columns 4 q' .. 4 q' + 3 of rows r0 and
    // r0 + 8 between them; one shuffle gives the even lane row r0's four
    // and the odd lane row r0 + 8's, each added with one 16-byte
    // reduction. Rows past k_valid add zeros to row k_valid - 1 (x + 0 =
    // x: the sums keep their bits), so no branch depends on the lane.
    const bool odd = threadIdx.x & 1;
    const int in = m0 + frag_row() + (odd ? 8 : 0);
    const bool valid = in < k_valid;
    float* row = dst + static_cast<long long>(valid ? in : k_valid - 1) * ld;
    const int c4 = 4 * ((threadIdx.x & 3) >> 1);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col0 = (pg + p) * kPiece + 8 * j;
        if (col0 >= ld) continue;   // ld is a multiple of 8
        const float e0 = acc[p][4 * j], e1 = acc[p][4 * j + 1];
        const float e2 = acc[p][4 * j + 2], e3 = acc[p][4 * j + 3];
        const float s0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? e0 : e2, 1);
        const float s1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? e1 : e3, 1);
        float4 v = odd ? make_float4(s0, s1, e2, e3) : make_float4(e0, e1, s0, s1);
        if (!valid) v = make_float4(0.f, 0.f, 0.f, 0.f);
        atomicAdd(reinterpret_cast<float4*>(row + col0 + c4), v);
      }
    }
  }

  // The dW of one segment (k_valid input features in the buffer at a, the
  // gradient's np 64-column pieces of which ld columns are valid): blocks
  // of 64 inputs x up to four pieces, taken in turn by the two warpgroups
  // (`turn` counts blocks across segments). Each block has one owner in
  // every tile, which adds into the partial tile after tile in program
  // order: the sums' order and bits are fixed.
  static __device__ __forceinline__ void dw_segment(uint32_t a, int k_valid, uint32_t dz, int np,
                                                    int ld, float* dst, int& turn, int g) {
    for (int m0 = 0; m0 < k_valid; m0 += 64) {
      for (int pg = 0; pg < np; pg += 4) {
        if ((turn++ & 1) != g) continue;
        switch (min(np - pg, 4)) {
          case 1: dw_block<1>(a, m0, k_valid, dz, pg, ld, dst); break;
          case 2: dw_block<2>(a, m0, k_valid, dz, pg, ld, dst); break;
          case 3: dw_block<3>(a, m0, k_valid, dz, pg, ld, dst); break;
          default: dw_block<4>(a, m0, k_valid, dz, pg, ld, dst); break;
        }
      }
    }
  }

  // dst[c] += sum over the tile's rows of dz[row][c], c < n; one consumer
  // thread a column.
  static __device__ __forceinline__ void add_db(const uint8_t* dz, int n, float* dst) {
    for (int c = threadIdx.x; c < n; c += kConsumers) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += ld(dz, r, c);
      atomicAdd(dst + c, s);
    }
  }

  // The kernel on `grid` CTAs of kThreadsTc threads and smem bytes of
  // dynamic shared memory, then the fixed-order sum of the partials into
  // dweights and dbiases. The workspace: (depth + 1) activation images of
  // kRows x nw bf16 and one kRows x kDeCols f32 encode gradient a CTA.
  template <class Kernel, class LayoutT>
  static cudaError_t launch(Kernel kernel, int smem, const float* pts, const float* dirs,
                            long long n, long long dir_div, const float* g_rgb,
                            const float* g_sigma, const __nv_bfloat16* w, const float* bias,
                            const LayoutT& L, const LayoutT& G, uint8_t* ws, float* partials,
                            long long n_w, long long n_b, int grid, float* dweights,
                            float* dbiases, float* dpts, float* ddirs, cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the pack
    const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
    const long long ws_bytes =
        static_cast<long long>(L.depth + 1) * kRows * nw * 2 + kRows * kDeCols * 4;
    const long long stride = n_w + n_b;
    kernel<<<grid, kThreadsTc, smem, stream>>>(pts, dirs, n, dir_div, g_rgb, g_sigma, w, bias, L,
                                               G, nw, nv, ws, ws_bytes, partials, n_w, stride,
                                               dpts, ddirs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_reduce_partials(partials, grid, stride, n_w, dweights, dbiases, stream);
  }
};

}  // namespace bwd16
}  // namespace nerf
