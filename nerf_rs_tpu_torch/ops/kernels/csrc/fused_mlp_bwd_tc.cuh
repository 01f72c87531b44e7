// The device code of K2's f32 mode (3xTF32 mma.sync, fused_mlp_bwd_tc.cu's
// design notes). BwdTc<kRows, kMaxWidth, kMaxDepth> holds the helpers of
// one configuration: the narrow kernel (fused_mlp_bwd_tc.cu: 128 samples a
// tile, widths up to 256, depth up to 16) runs bwd_tc_tiles, the kernel
// body, at 128 x 256 (kMi 8 m16 x kNt 4 n8 tiles a warp, 128 accumulators
// a thread); the wide per-tile kernel (fused_mlp_wide_bwd_tc.cu: 64
// samples, widths up to 512, depth up to 32) its fragment loads, products
// and sums at 64 x 512, in a body of its own (its dW in
// fused_mlp_wide_dw.cu).

#pragma once

#include "fused_mlp_f32tc.cuh"
#include "fused_mlp_wide_dw.cuh"

namespace nerf {
namespace bwd_tc {

// The B fragments of one n8 tile for one k8 step, split.
struct BFrag {
  uint32_t hi[2], lo[2];        // registers b0, b1
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
// The warp index, uniform across the warp as the compiler sees it.
__device__ __forceinline__ int warp_id() { return __shfl_sync(0xFFFFFFFFu, threadIdx.x >> 5, 0); }

// ---- A fragments, from a row-major shared buffer with row stride s ----

// Rows r0 + g (+ 8), k columns from k0, split into tf32 hi and lo.
__device__ __forceinline__ void a_rows(const float* buf, int s, int r0, int k0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const float* p = buf + (r0 + g) * s + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * s], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * s + 4], hi[3], lo[3]);
}

// The transpose: A[m][k] = buf[k][m], rows m0 + g (+ 8) of A (columns of
// buf; the second eight read 0 unless `second`), k rows of buf from k0.
__device__ __forceinline__ void a_cols(const float* buf, int s, int m0, int k0, bool second,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const float* p = buf + (k0 + t) * s + m0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[4 * s], hi[2], lo[2]);
  hi[1] = lo[1] = hi[3] = lo[3] = 0u;
  if (second) {
    split(p[8], hi[1], lo[1]);
    split(p[4 * s + 8], hi[3], lo[3]);
  }
}

// ---- B fragments ----

// Block (kb, nb) of a pack tiled by fused_mlp.py::mma_tile, n8 blocks a
// k block: its k8 step st (lo: element offset of the lo row).
__device__ __forceinline__ void b_pack(BFrag& b, const float* w, long long lo, int kb, int st,
                                       int n8, int nb) {
  const float* p = w + (static_cast<long long>(kb * n8 + nb) * 32 + lane_id()) * 4 + 2 * st;
  const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
  const uint2 l = __ldg(reinterpret_cast<const uint2*>(p + lo));
  b.hi[0] = h.x;
  b.hi[1] = h.y;
  b.lo[0] = l.x;
  b.lo[1] = l.y;
}

// Workspace slots (f32tc::ws_index's order) hold the tile's samples (k)
// x features (n) in B-fragment order.
using f32tc::ws_index;

// A lane's part of block (kb, nb) of a workspace slot, which this kernel
// wrote: loads through L2 (__ldcg), never the read-only path.
__device__ __forceinline__ float4 ld_block(const float* ws, int n8, int kb, int nb) {
  return __ldcg(reinterpret_cast<const float4*>(ws) + (kb * n8 + nb) * 32 + lane_id());
}

// k8 step st of a loaded block (its samples t + 8 st and t + 8 st + 4).
__device__ __forceinline__ void to_frag(BFrag& b, const float4& v, int st) {
  split(st ? v.z : v.x, b.hi[0], b.lo[0]);
  split(st ? v.w : v.y, b.hi[1], b.lo[1]);
}

// One configuration's helpers: tiles of kRows samples, layers up to
// kMaxWidth columns, offset tables of kMaxDepth layer slots.
template <int kRows_, int kMaxWidth_, int kMaxDepth_>
struct BwdTc {
  static constexpr int kRows = kRows_;       // samples a tile
  static constexpr int kMaxWidth = kMaxWidth_;
  static constexpr int kMaxDepth = kMaxDepth_;
  static constexpr int kWarps = 8;
  static constexpr int kThreadsBwd = 32 * kWarps;
  static constexpr int kMi = kRows / 16;              // m16 tiles: the samples, or kRows rows of a dW pass
  static constexpr int kNt = kMaxWidth / 8 / kWarps;  // n8 tiles a warp owns: nb = warp + 8 j
  // Row strides (floats) of the shared buffers, 4 more than a multiple of
  // 32: a fragment's 32 loads, in either orientation, hit 32 banks.
  static constexpr int kSx = kMaxWidth + 4;
  static constexpr int kSe = kEncX + 4;
  static constexpr int kSd = kEncD + 4;
  static constexpr int kSegs = 2 * kMaxDepth + 3;     // product segments the table holds
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kRows * (kSx + kSe + kSd) + 6 * kRows + kRows + 3 * kRows);
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kNt <= 8 && kNt * 8 * kWarps == kMaxWidth, "a warp owns at most 8 n8 tiles");
  // Indices of the transposed tensor-core pack's table (pack_params'
  // layout_mma): [0, kMaxDepth) dense layer i, [kMaxDepth, 2 kMaxDepth) its
  // encode part (-1 if not a skip layer), then the bottleneck, viewdirs,
  // viewdirs' dir-encode part.
  static constexpr int kBneck = 2 * kMaxDepth, kView = kBneck + 1, kViewDir = kBneck + 2;

  struct LayoutMma {
    long long wt[kSegs];
  };
  using Acc = float[kMi][kNt][4];

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
      }
    }
  }

  // One k step of the products of one A fragment (a row of m16 tiles) with
  // this warp's NT B fragments; each 3xTF32 term is issued for every tile
  // before the next, so no product waits on the one before it.
  template <int NT>
  static __device__ __forceinline__ void mma_row(float (&acc)[kNt][4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4], const BFrag (&b)[kNt]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, b[j].hi[0], b[j].hi[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, b[j].lo[0], b[j].lo[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, b[j].hi[0], b[j].hi[1]);
  }

  // The number of n8 tiles warp `warp` owns of n8 (nb = warp + 8 j).
  static __device__ __forceinline__ int tiles_of(int warp, int n8) {
    return warp < n8 ? min(kNt, (n8 - warp + kWarps - 1) / kWarps) : 0;
  }

  // acc (the tile's kRows samples x this warp's NT n8 tiles) += A (shared,
  // rows = samples, k_valid columns, a multiple of 8) . B (a pack segment
  // of ceil(k_valid / 16) k blocks x n8 n blocks).
  template <int NT>
  static __device__ __forceinline__ void rows_mma_nt(Acc& acc, const float* buf, int s,
                                                     int k_valid, const float* w, long long lo,
                                                     int n8, int warp) {
    // Steps of 8 k; the next step's B is in flight.
    const int steps = (k_valid + 7) / 8;
    BFrag b[kNt], nxt[kNt];
#pragma unroll
    for (int j = 0; j < NT; ++j) b_pack(b[j], w, lo, 0, 0, n8, warp + kWarps * j);
    for (int k = 0; k < steps; ++k) {
      if (k + 1 < steps) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          b_pack(nxt[j], w, lo, (k + 1) >> 1, (k + 1) & 1, n8, warp + kWarps * j);
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        uint32_t ah[4], al[4];
        a_rows(buf, s, 16 * mi, 8 * k, ah, al);
        mma_row<NT>(acc[mi], ah, al, b);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = nxt[j];
    }
  }

  static __device__ __forceinline__ void rows_mma(Acc& acc, const float* buf, int s, int k_valid,
                                                  const float* w, long long lo, int n8) {
    const int warp = warp_id();
    switch (tiles_of(warp, n8)) {
      case 8: if constexpr (kNt >= 8) rows_mma_nt<8>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      case 7: if constexpr (kNt >= 7) rows_mma_nt<7>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      case 6: if constexpr (kNt >= 6) rows_mma_nt<6>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      case 5: if constexpr (kNt >= 5) rows_mma_nt<5>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      case 4: rows_mma_nt<4>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      case 3: rows_mma_nt<3>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      case 2: rows_mma_nt<2>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      case 1: rows_mma_nt<1>(acc, buf, s, k_valid, w, lo, n8, warp); break;
      default: break;
    }
  }

  // The dW products: acc (rows m0 .. m0 + kRows - 1 of dW^T, i.e. output
  // features of the layer, x this warp's NT n8 tiles of its input
  // features) = dZ^T . H over the tile's samples, dZ (shared, n_valid
  // columns) and H (a workspace slot of n8 feature blocks).
  template <int NT>
  static __device__ __forceinline__ void cols_mma_nt(Acc& acc, const float* dz, int n_valid,
                                                     int m0, const float* ws, int n8, int warp) {
    // Block kb + 1 is in flight while block kb is multiplied.
    float4 q[kNt], qn[kNt];
#pragma unroll
    for (int j = 0; j < NT; ++j) q[j] = ld_block(ws, n8, 0, warp + kWarps * j);
#pragma unroll 1
    for (int kb = 0; kb < kRows / 16; ++kb) {
      if (kb + 1 < kRows / 16) {
#pragma unroll
        for (int j = 0; j < NT; ++j) qn[j] = ld_block(ws, n8, kb + 1, warp + kWarps * j);
      }
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        BFrag b[kNt];
#pragma unroll
        for (int j = 0; j < NT; ++j) to_frag(b[j], q[j], st);
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) {
          const int m = m0 + 16 * mi;
          if (m >= n_valid) break;
          uint32_t ah[4], al[4];
          a_cols(dz, kSx, m, 16 * kb + 8 * st, m + 8 < n_valid, ah, al);
          mma_row<NT>(acc[mi], ah, al, b);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) q[j] = qn[j];
    }
  }

  static __device__ __forceinline__ void cols_mma(Acc& acc, const float* dz, int n_valid, int m0,
                                                  const float* ws, int f) {
    const int warp = warp_id(), n8 = f >> 3;
    switch (tiles_of(warp, n8)) {
      case 8: if constexpr (kNt >= 8) cols_mma_nt<8>(acc, dz, n_valid, m0, ws, n8, warp); break;
      case 7: if constexpr (kNt >= 7) cols_mma_nt<7>(acc, dz, n_valid, m0, ws, n8, warp); break;
      case 6: if constexpr (kNt >= 6) cols_mma_nt<6>(acc, dz, n_valid, m0, ws, n8, warp); break;
      case 5: if constexpr (kNt >= 5) cols_mma_nt<5>(acc, dz, n_valid, m0, ws, n8, warp); break;
      case 4: cols_mma_nt<4>(acc, dz, n_valid, m0, ws, n8, warp); break;
      case 3: cols_mma_nt<3>(acc, dz, n_valid, m0, ws, n8, warp); break;
      case 2: cols_mma_nt<2>(acc, dz, n_valid, m0, ws, n8, warp); break;
      case 1: cols_mma_nt<1>(acc, dz, n_valid, m0, ws, n8, warp); break;
      default: break;
    }
  }

  // Calls fn(row, col, v0, v1) for every pair of accumulator entries of
  // this warp's valid n8 tiles (row: 16 mi + g (+ 8); col: 8 nb + 2 t, + 1).
  template <typename Fn>
  static __device__ __forceinline__ void for_pairs(const Acc& acc, int n8, Fn fn) {
    const int warp = warp_id(), g = lane_id() >> 2, t = lane_id() & 3;
    if (warp >= n8) return;
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const int nb = warp + kWarps * j;
        if (nb < n8) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            fn(16 * mi + g + 8 * r, 8 * nb + 2 * t, acc[mi][j][2 * r], acc[mi][j][2 * r + 1]);
          }
        }
      }
    }
  }

  // dW^T rows m0.. into the CTA's partial of a (K, ld) segment: entry (k,
  // o) at dst[k * ld + o], o < ld.
  static __device__ __forceinline__ void add_dw(const Acc& acc, int n8, int m0, int ld,
                                                float* dst) {
    for_pairs(acc, n8, [&](int row, int col, float v0, float v1) {
      const int o = m0 + row;
      if (o < ld) {
        atomicAdd(dst + static_cast<long long>(col) * ld + o, v0);
        atomicAdd(dst + static_cast<long long>(col + 1) * ld + o, v1);
      }
    });
  }

  // dst[c] += sum over the tile's samples of buf[s][c], c < n.
  static __device__ __forceinline__ void add_db(const float* buf, int n, float* dst) {
    for (int c = threadIdx.x; c < n; c += kThreadsBwd) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += buf[r * kSx + c];
      atomicAdd(dst + c, s);
    }
  }

  // X (rows 0 .. kRows - 1, columns < ld) from a workspace slot of ld / 8
  // feature blocks; ends behind a barrier.
  static __device__ __forceinline__ void x_from_slot(float* X, const float* slot, int ld) {
    for (int i = threadIdx.x; i < kRows * ld; i += kThreadsBwd) {
      const int r = i / ld, c = i % ld;
      X[r * kSx + c] = __ldcg(slot + ws_index(r, c, ld >> 3));
    }
    __syncthreads();
  }

  // One input-gradient product, acc = X . w (X: the output gradient, k_red
  // columns; w: a transposed segment, n8 blocks of the input), then either
  // into X (after a barrier): plus gs[row] * w_alpha[col] first unless
  // w_alpha is null, masked by a workspace slot's values > 0 (n8 feature
  // blocks) unless `mask` is null; or, with `out` not null, added into out
  // (row stride s_out).
  static __device__ __forceinline__ void din_layer(Acc& acc, float* X, int k_red, const float* w,
                                                   long long lo, int n8, const float* mask,
                                                   const float* w_alpha, const float* gs,
                                                   float* out, int s_out) {
    zero(acc);
    rows_mma(acc, X, kSx, k_red, w, lo, n8);
    if (out != nullptr) {
      for_pairs(acc, n8, [&](int row, int col, float v0, float v1) {
        float2* p = reinterpret_cast<float2*>(out + row * s_out + col);
        const float2 o = *p;
        *p = make_float2(o.x + v0, o.y + v1);
      });
      return;
    }
    __syncthreads();
    for_pairs(acc, n8, [&](int row, int col, float v0, float v1) {
      if (w_alpha != nullptr) {
        v0 = v0 + gs[row] * load1(w_alpha + col);
        v1 = v1 + gs[row] * load1(w_alpha + col + 1);
      }
      if (mask != nullptr) {
        if (!(__ldcg(mask + ws_index(row, col, n8)) > 0.f)) v0 = 0.f;
        if (!(__ldcg(mask + ws_index(row, col + 1, n8)) > 0.f)) v1 = 0.f;
      }
      *reinterpret_cast<float2*>(X + row * kSx + col) = make_float2(v0, v1);
    });
    __syncthreads();
  }

  // The dW products of one segment (K rows of input features from the
  // workspace slot ws, f = K floats a row; ld output features), in passes
  // of kRows output features.
  static __device__ __forceinline__ void dw_layer(Acc& acc, const float* X, int ld,
                                                  const float* ws, int f, float* dst) {
    for (int m0 = 0; m0 < ld; m0 += kRows) {
      zero(acc);
      cols_mma(acc, X, ld, m0, ws, f);
      add_dw(acc, f >> 3, m0, ld, dst);
    }
  }
};

// The kernel body. One CTA walks tiles tile0 + per_cta b + j, j < per_cta
// (below ntiles), whose workspace (ws_stride floats a tile, from tile0's)
// the record pass has filled, and adds into its partial: n_w
// weight-gradient floats in the packed weight layout, then the bias
// gradients in the packed bias layout (part_stride apart). smem: the
// dynamic shared memory, B::kSmemBytes.
template <class B, class LayoutT, bool kSigmaOnly>
__device__ __forceinline__ void bwd_tc_tiles(
    float* smem, const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
    long long dir_div, const float* __restrict__ g_rgb, const float* __restrict__ g_sigma,
    const float* __restrict__ w, const float* __restrict__ mwt, long long lo_wt,
    const float* __restrict__ bias, const LayoutT& L, const typename B::LayoutMma& M,
    float* ws_all, long long ws_stride, long long tile0, int per_cta, float* partials,
    long long n_w, long long part_stride, long long ntiles, float* __restrict__ dpts,
    float* __restrict__ ddirs) {
  constexpr int kRows = B::kRows, kSx = B::kSx, kSe = B::kSe, kSd = B::kSd;
  constexpr int kThreadsBwd = B::kThreadsBwd;
  float* X = smem;                              // [kRows][kSx] activations, then gradients
  float* E = X + kRows * kSx;                   // [kRows][kSe] point encode gradient
  float* D = E + kRows * kSe;                   // [kRows][kSd] dir encode gradient
  float* xin = D + kRows * kSd;                 // [6][kRows] points, dirs
  float* gs = xin + 6 * kRows;                  // [kRows] sigma cotangent, then d(pre-ReLU)
  float* gr = gs + kRows;                       // [kRows][3] rgb cotangent, then d(pre-sigmoid)
  const int tid = threadIdx.x;
  const int ldw = L.ldw, ldv = L.ldv, depth = L.depth;
  const int nw8 = ldw >> 3;
  const bool want_dx = dpts != nullptr;
  float* dW = partials + static_cast<long long>(blockIdx.x) * part_stride;
  float* dB = dW + n_w;
  const long long t_begin = tile0 + static_cast<long long>(per_cta) * blockIdx.x;
  const long long t_end = min(t_begin + per_cta, ntiles);
  typename B::Acc acc;

  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long base = tile * kRows;
    float* ws = ws_all + (tile - tile0) * ws_stride;
    float* ws_ex = ws;
    float* ws_ed = ws + kRows * kEncX;
    // Slot i: trunk layer i's output; i = depth the bottleneck's, depth + 1
    // the view layer's (ldv columns).
    auto ws_h = [&](int i) { return f32tc::ws_slot(ws, i, ldw, kRows); };
    // Inputs and cotangents; samples past n read zeros.
    for (int idx = tid; idx < 6 * kRows; idx += kThreadsBwd) {
      const int c = idx / kRows, r = idx % kRows;
      const long long s = base + r;
      float v = 0.f;
      if (s < n) v = c < 3 ? pts[s * 3 + c] : dirs[(s / dir_div) * 3 + (c - 3)];
      xin[idx] = v;
    }
    for (int idx = tid; idx < 4 * kRows; idx += kThreadsBwd) {
      const long long s = base + idx / 4;
      const int c = idx % 4;
      float v = 0.f;
      if (s < n) v = c < 3 ? g_rgb[s * 3 + c] : g_sigma[s];
      if (c < 3) {
        gr[(idx / 4) * 3 + c] = v;
      } else {
        gs[idx / 4] = v;
      }
    }
    __syncthreads();   // each encode below reads inputs that other warps loaded
    // The encodes, into the workspace for the dW products (the record
    // pass rebuilt them for its products with the same enc_at).
    for (int idx = tid; idx < kRows * kEncRows; idx += kThreadsBwd) {
      const int r = idx % kRows, j = idx / kRows;
      if (j < kEncX) {
        ws_ex[ws_index(r, j, kEncX / 8)] =
            f32tc::enc_at(xin[r], xin[kRows + r], xin[2 * kRows + r], j, 3 + 6 * tc::kXBands);
      } else {
        ws_ed[ws_index(r, j - kEncX, kEncD / 8)] =
            f32tc::enc_at(xin[3 * kRows + r], xin[4 * kRows + r], xin[5 * kRows + r], j - kEncX,
                          3 + 6 * tc::kDBands);
      }
    }
    B::x_from_slot(X, ws_h(depth - 1), ldw);   // h_last, recorded
    // Sigma head, K1's sum (rows hr and hr + 64): gs becomes d(pre-ReLU
    // sigma); then its dW and db.
    const int hr = f32tc::head_row();
    for (int b0 = 0; b0 < kRows; b0 += 64) {
      auto x_row = [&](int i) { return X[(b0 + hr) * kSx + i]; };
      const float pre =
          f32tc::head_sum(x_row, ldw, w + L.w_alpha, 1, 0) + __ldg(bias + L.b_alpha);
      if (!(tid & 3) && !(pre > 0.f)) gs[b0 + hr] = 0.f;
    }
    __syncthreads();
    for (int k = tid; k < ldw; k += kThreadsBwd) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a = fmaf(X[r * kSx + k], gs[r], a);
      atomicAdd(dW + L.w_alpha + k, a);
    }
    if (tid == 0) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a += gs[r];
      atomicAdd(dB + L.b_alpha, a);
    }

    if (!kSigmaOnly) {
      __syncthreads();   // every read of h_last before X takes the view output
      B::x_from_slot(X, ws_h(depth + 1), ldv);
      // Rgb head, K1's sums: gr becomes d(pre-sigmoid rgb); sigmoid' =
      // sg (1 - sg), with 1 - sg as sigmoid(-pre): no cancellation where it
      // saturates.
      for (int b0 = 0; b0 < kRows; b0 += 64) {
        auto x_row = [&](int i) { return X[(b0 + hr) * kSx + i]; };
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float pre =
              f32tc::head_sum(x_row, ldv, w + L.w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
          const float sg = 1.f / (1.f + expf(-pre));
          const float sg_neg = 1.f / (1.f + expf(pre));
          if (!(tid & 3)) gr[(b0 + hr) * 3 + c] = gr[(b0 + hr) * 3 + c] * sg * sg_neg;
        }
      }
      __syncthreads();
      for (int idx = tid; idx < 3 * ldv; idx += kThreadsBwd) {
        const int k = idx / 3, c = idx % 3;
        float a = 0.f;
        for (int r = 0; r < kRows; ++r) a = fmaf(X[r * kSx + k], gr[r * 3 + c], a);
        atomicAdd(dW + L.w_rgb + idx, a);
      }
      if (tid < 3) {
        float a = 0.f;
        for (int r = 0; r < kRows; ++r) a += gr[r * 3 + tid];
        atomicAdd(dB + L.b_rgb + tid, a);
      }
      __syncthreads();
      // d(view output), masked by the view output, into X in place.
      for (int idx = tid; idx < kRows * ldv; idx += kThreadsBwd) {
        const int r = idx / ldv, k = idx % ldv;
        float v = 0.f;
        if (X[r * kSx + k] > 0.f) {
          v = gr[r * 3] * load1(w + L.w_rgb + k * 3);
          v = fmaf(gr[r * 3 + 1], load1(w + L.w_rgb + k * 3 + 1), v);
          v = fmaf(gr[r * 3 + 2], load1(w + L.w_rgb + k * 3 + 2), v);
        }
        X[r * kSx + k] = v;
      }
      __syncthreads();
      // View layer: inputs the bottleneck and the dir encode (workspace).
      B::dw_layer(acc, X, ldv, ws_h(depth), ldw, dW + L.w_view);
      B::dw_layer(acc, X, ldv, ws_ed, kEncD, dW + L.w_view_dir);
      B::add_db(X, ldv, dB + L.b_view);
      if (want_dx) {   // d(dir encode) into D
        for (int idx = tid; idx < kRows * kSd; idx += kThreadsBwd) D[idx] = 0.f;
        __syncthreads();
        B::din_layer(acc, X, ldv, mwt + M.wt[B::kViewDir], lo_wt, kEncD >> 3, nullptr, nullptr,
                     nullptr, D, kSd);
      }
      // d(bottleneck), no activation.
      B::din_layer(acc, X, ldv, mwt + M.wt[B::kView], lo_wt, nw8, nullptr, nullptr, nullptr,
                   nullptr, 0);
      if (want_dx) {
        for (int idx = tid; idx < 3 * kRows; idx += kThreadsBwd) {
          const int c = idx / kRows, r = idx % kRows;
          const long long s = base + r;
          const float v = encode_vjp(D, kSd, r, c, xin[(3 + c) * kRows + r], 4);
          if (s < n) ddirs[s * 3 + c] = v;
        }
      }
      // Bottleneck: input h_last; then d(h_last) from it and the sigma head.
      B::dw_layer(acc, X, ldw, ws_h(depth - 1), ldw, dW + L.w_bneck);
      B::add_db(X, ldw, dB + L.b_bneck);
      B::din_layer(acc, X, ldw, mwt + M.wt[B::kBneck], lo_wt, nw8, ws_h(depth - 1),
                   w + L.w_alpha, gs, nullptr, 0);
    } else {
      // Sigma head only: d(h_last) = round(gs w_alpha^T masked by h_last).
      __syncthreads();
      for (int idx = tid; idx < kRows * ldw; idx += kThreadsBwd) {
        const int r = idx / ldw, k = idx % ldw;
        const float v = gs[r] * load1(w + L.w_alpha + k);
        X[r * kSx + k] = X[r * kSx + k] > 0.f ? v : 0.f;
      }
      if (want_dx) {
        for (int idx = tid; idx < 3 * kRows; idx += kThreadsBwd) {
          const long long s = base + idx % kRows;
          if (s < n) ddirs[s * 3 + idx / kRows] = 0.f;
        }
      }
      __syncthreads();
    }

    // Trunk, from the last layer down to layer 1; d(point encode) sums in E.
    if (want_dx) {
      for (int idx = tid; idx < kRows * kSe; idx += kThreadsBwd) E[idx] = 0.f;
      __syncthreads();
    }
    for (int i = depth - 1; i >= 1; --i) {
      const bool skip = L.w_skip[i] >= 0;
      B::dw_layer(acc, X, ldw, ws_h(i - 1), ldw, dW + L.w_dense[i]);
      if (skip) B::dw_layer(acc, X, ldw, ws_ex, kEncX, dW + L.w_skip[i]);
      B::add_db(X, ldw, dB + L.b_dense[i]);
      if (want_dx && skip) {
        B::din_layer(acc, X, ldw, mwt + M.wt[B::kMaxDepth + i], lo_wt, kEncX >> 3, nullptr,
                     nullptr, nullptr, E, kSe);
      }
      B::din_layer(acc, X, ldw, mwt + M.wt[i], lo_wt, nw8, ws_h(i - 1), nullptr, nullptr,
                   nullptr, 0);
    }
    // Layer 0: input the point encode.
    B::dw_layer(acc, X, ldw, ws_ex, kEncX, dW + L.w_dense[0]);
    B::add_db(X, ldw, dB + L.b_dense[0]);
    if (want_dx) {
      B::din_layer(acc, X, ldw, mwt + M.wt[0], lo_wt, kEncX >> 3, nullptr, nullptr, nullptr, E,
                   kSe);
      __syncthreads();
      for (int idx = tid; idx < 3 * kRows; idx += kThreadsBwd) {
        const int c = idx / kRows, r = idx % kRows;
        const long long s = base + r;
        const float v = encode_vjp(E, kSe, r, c, xin[c * kRows + r], 10);
        if (s < n) dpts[s * 3 + c] = v;
      }
    }
    __syncthreads();
  }
}

// The table of the transposed pack, checked: false unless every segment a
// network of `depth` layers reads is present.
template <class B>
inline bool parse_mma(const long long* layout_mma, int layout_mma_len, int depth,
                      typename B::LayoutMma* M) {
  if (layout_mma_len != B::kSegs) return false;
  for (int i = 0; i < B::kSegs; ++i) {
    M->wt[i] = layout_mma[i];
    if ((i < depth || i >= 2 * B::kMaxDepth) && M->wt[i] < 0) return false;
  }
  return true;
}

// The wide f32 backwards' workspace (fused_mlp_wide_bwd_tc.cu up to width
// 512, fused_mlp_wide1k_bwd.cu past it): the planes of a layer output (an
// image of `cols` columns of fused_mlp_wide_dw.cuh) from its record slot
// (ws_index order at ld columns, 64 rows), zeros from column ld on: a
// thread takes 4 samples of two features, one float4 load each, the
// block's threads in turn.
__device__ __forceinline__ void put_planes_record(uint8_t* dst, int cols, const float* slot,
                                                  int ld) {
  const int plane = cols * 128, n8 = ld >> 3, groups = cols >> 3;
  for (int u = threadIdx.x; u < 64 * groups; u += blockDim.x) {
    const int k = u & 3, cp = (u >> 2) & 3, cg = (u >> 4) % groups, rb = (u >> 4) / groups;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (cg < n8) {
      const float4* blk = reinterpret_cast<const float4*>(slot + (rb * n8 + cg) * 128);
      a = __ldcg(blk + 8 * cp + k);
      b = __ldcg(blk + 8 * cp + 4 + k);
    }
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 16 * rb + 4 * j + k;
      uint32_t h, m, l;
      f32tc::split3(make_float2(av[j], bv[j]), h, m, l);
      uint8_t* p = dst + cg * 1024 + (row >> 3) * 128 + (row & 7) * 16 + cp * 4;
      __stcg(reinterpret_cast<unsigned int*>(p), h);
      __stcg(reinterpret_cast<unsigned int*>(p + plane), m);
      __stcg(reinterpret_cast<unsigned int*>(p + 2 * plane), l);
    }
  }
}

namespace {

// The layers' outputs in a round's record (tile blockIdx.x, rec_stride
// floats a tile; slot blockIdx.y), split into the workspace's planes: the
// dW products' A. A kernel of its own, many CTAs wide, so that these loads
// and stores, bound by latency in a per-tile kernel's one CTA an SM,
// overlap.
__global__ void __launch_bounds__(256)
record_planes_kernel(const float* __restrict__ rec_all, long long rec_stride,
                     const wide::DwWs D, int ldw) {
  const float* rec = rec_all + blockIdx.x * rec_stride;
  put_planes_record(D.at(wide::DwWs::h(blockIdx.y), blockIdx.x), D.nw,
                    f32tc::ws_slot(const_cast<float*>(rec), blockIdx.y, ldw, 64), ldw);
}

}  // namespace
}  // namespace bwd_tc
}  // namespace nerf
