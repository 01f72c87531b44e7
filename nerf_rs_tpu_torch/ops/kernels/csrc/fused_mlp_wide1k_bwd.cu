// Fused NeRF MLP backward on Hopper (sm_90a) for networks past width 512,
// K2 in both modes: trunk or view widths from 513 up to 1024, up to 32
// dense layers (fused_mlp_wide1k.cuh's tables). Per half tile (32 of a
// 64-sample tile's rows) of a round it backpropagates through the rgb
// head, the view layer, the bottleneck, the sigma head and the trunk with
// its skip layer, and writes every layer's output gradient to the round's
// workspace (fused_mlp_wide_dw.cuh), where the dW kernel
// (fused_mlp_wide_dw.cu) sums the weight gradients over the whole round;
// with input gradients requested, also d(points) and d(dirs) through the
// encode.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t (:663, the
// Pallas call at :675) past width 512, where the wide per-tile kernels
// (fused_mlp_wide_bwd_tc.cu, fused_mlp_wide_bwd_bf16.cu: widths up to 512)
// stop; the JAX kernel trains any width that is a multiple of 128.
//
// - The recompute, before each round: K1's own wide1k kernel in record
//   mode, so the activations and ReLU masks are bit for bit those of the
//   forward that made the loss. f32: fused_mlp_wide1k_f32tc.cu's split-f32
//   wgmma, every layer's f32 output into a record (fused_mlp_f32tc.cuh's
//   ws_index order), which bwd_tc::record_planes_kernel splits into the
//   workspace's planes; bf16: fused_mlp_wide1k_tc.cu's chunk sums, every
//   layer's bf16 image straight into the workspace, the view output into
//   an image of its own.
// - The heads in K1's own order (f32: the four quarters' parts in rank
//   order, as fused_mlp_wide1k_f32tc.cu sums them; bf16: f32tc::head_sum),
//   so that their masks are the forward's too.
// - W dz: mma.sync m16n8k8 tf32, A the half tile's output gradient in
//   shared memory (f32, 32 x 1024: 128 KB), B the transposed pack
//   PackedMLP.mma_wt (fused_mlp.py::mma_tile, tf32 hi and lo rows) from L2.
//   f32: 3xTF32, x.hi w.hi into an accumulator of its own and the cross
//   terms into a second (fused_mlp_wide_bwd_tc.cu's rows_mma2). bf16: the
//   activations, gradients and weights are bf16 values, which tf32 holds
//   exactly, so one tf32 product (hi.hi; the lo rows are zero and not
//   loaded) is the bf16 product, summed in f32, each k8 step's from zero
//   and added to a running sum (rows_mma); each layer's output gradient
//   rounded to bf16 after its mask, as the JAX kernel rounds it. Why half tiles and
//   mma.sync: a 64-sample tile's gradient at width 1024 is 256 KB in f32
//   (128 KB in bf16, two such buffers for wgmma's m64), more than a block
//   may hold, and wgmma's M is 64 rows; 32 rows of f32 fit with the encode
//   gradients (162 KB), and one kernel serves both modes. A clustered
//   per-tile wgmma design (the gradient split across CTAs, exchanged
//   through distributed shared memory) is the faster route left for later.
// - Each layer's output is written to the workspace image (three split
//   planes in f32, one bf16 plane), then read back into shared memory
//   once every warp has read the layer's input (hi + mid + lo is exact).
//
// What bounds it on the H100: operations. At 1024/512/8 a fine sample's
// W dz is 6.0 MFLOP of its 18.1 forward: three tf32 products at 495
// TFLOP/s in f32, one in bf16; the recompute and dW run at the bf16 rate
// (six passes each in f32). The pack (mma_wt, two f32 rows) streams from
// L2 once a half tile.

#include "fused_mlp_bwd_tc.cuh"
#include "fused_mlp_wide1k.cuh"
#include "fused_mlp_wide_dw.cuh"

namespace {

using namespace nerf;
using namespace nerf::wide1k;
using nerf::tc::kPiece;
using nerf::wide::DwWs;

constexpr int kTile = 64;                 // samples a tile (the workspace's images)
constexpr int kRows = 32;                 // rows a half tile: this kernel's block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMi = kRows / 16;           // m16 tiles
constexpr int kSx = kWide1kMaxWidth + 4;  // row strides (floats): 4 past a multiple of 32
constexpr int kSe = kEncX + 4;
constexpr int kSd = kEncD + 4;

// The transposed pack's table (pack_params' layout_mma): [0, 32) dense
// layer i, [32, 64) its encode part (-1 if not a skip layer), then the
// bottleneck, viewdirs, viewdirs' dir-encode part.
struct Mma {
  static constexpr int kMaxDepth = kWideMaxDepth;
  static constexpr int kSegs = 2 * kMaxDepth + 3;
  static constexpr int kBneck = 2 * kMaxDepth, kView = kBneck + 1, kViewDir = kBneck + 2;
  struct LayoutMma {
    long long wt[kSegs];
  };
};

// Shared memory, floats.
constexpr int kXOff = 0;                                // [kRows][kSx] activations, gradients
constexpr int kEOff = kXOff + kRows * kSx;              // [kRows][kSe] point encode gradient
constexpr int kDeOff = kEOff + kRows * kSe;             // [kRows][kSd] dir encode gradient
constexpr int kInOff = kDeOff + kRows * kSd;            // [6][kRows] points, dirs
constexpr int kGsOff = kInOff + 6 * kRows;              // [kRows] sigma cotangent, then d(pre)
constexpr int kGrOff = kGsOff + kRows;                  // [kRows][3] rgb cotangent, then d(pre)
constexpr int kHeadOff = kGrOff + 3 * kRows;            // bf16: alpha [1024], rgb [1024][3]
constexpr size_t kSmemBytes = sizeof(float) * (kHeadOff + 4 * kWide1kMaxWidth);
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

// The number of n8 tiles warp `warp` owns of n8 (nb = warp + 8 j).
__device__ __forceinline__ int tiles_of(int warp, int n8) {
  return warp < n8 ? (n8 - warp + kWarps - 1) / kWarps : 0;
}

// The two bf16 of a word (the lower at the lower address), as floats.
__device__ __forceinline__ float2 pair(unsigned int u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}

// Writes rows r0 .. r0 + 31 of a 64-row image of `cols` columns (P planes
// at dst, plane q at dst + q cols 128; P = 3: the hi, mid and lo pieces of
// f32 values, 1: bf16 values) from get(row, col) -> the f32 pair (col,
// col + 1), zeros from column `valid` on (a multiple of 8).
template <int P, class Get>
__device__ __forceinline__ void put_rows(uint8_t* dst, int cols, int valid, int r0, Get get) {
  const int plane = cols * 128;
  for (int i = threadIdx.x; i < 4 * kRows * (cols >> 3); i += kThreads) {
    const int cp = i & 3, row = (i >> 2) % kRows, cg = (i >> 2) / kRows;
    const int col = 8 * cg + 2 * cp;
    const float2 v = col < valid ? get(row, col) : make_float2(0.f, 0.f);
    uint8_t* p = dst + f32tc::p_off(r0 + row, col);
    if constexpr (P == 3) {
      uint32_t h, m, l;
      f32tc::split3(v, h, m, l);
      __stcg(reinterpret_cast<unsigned int*>(p), h);
      __stcg(reinterpret_cast<unsigned int*>(p + plane), m);
      __stcg(reinterpret_cast<unsigned int*>(p + 2 * plane), l);
    } else {
      __stcg(reinterpret_cast<unsigned int*>(p), f32tc::bits(__floats2bfloat162_rn(v.x, v.y)));
    }
  }
}

// X (the half tile's rows, ld columns) from a layer output: f32, its record
// slot (ws_index order, 64 rows, rows r0 ..); bf16, its image (bf16, rows
// r0 ..). Ends behind a barrier.
template <bool kBf16>
__device__ __forceinline__ void x_from(float* X, const float* slot, const uint8_t* image, int ld,
                                       int r0) {
  for (int i = threadIdx.x; i < kRows * ld; i += kThreads) {
    const int r = i / ld, c = i % ld;
    float v;
    if constexpr (kBf16) {
      v = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(image + f32tc::p_off(r0 + r, c)));
    } else {
      v = __ldcg(slot + f32tc::ws_index(r0 + r, c, ld >> 3));
    }
    X[r * kSx + c] = v;
  }
  __syncthreads();
}

// dst[c] += sum over the half tile's rows of X[r][c], c < n; one thread a
// column, so the per-CTA partial sums in a fixed order.
__device__ __forceinline__ void add_db(const float* X, int n, float* dst) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += X[r * kSx + c];
    dst[c] += s;
  }
}

using Acc4 = float[kMi][4][4];

// k8 steps of a bf16 chunk: summed from zero, then added to the running
// sum in f32. One: every mma's eight products start from zero.
constexpr int kChunkSteps = 1;

// Block (kb, nb)'s B fragments for k8 step st: bwd_tc::b_pack, or in bf16
// the hi row alone (the lo row of a pack of bf16 values is zero).
template <bool kBf16>
__device__ __forceinline__ void b_load(bwd_tc::BFrag& b, const float* w, long long lo, int kb,
                                       int st, int n8, int nb) {
  if constexpr (kBf16) {
    const float* p = w + (static_cast<long long>(kb * n8 + nb) * 32 + bwd_tc::lane_id()) * 4 + 2 * st;
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
    b.hi[0] = h.x;
    b.hi[1] = h.y;
  } else {
    bwd_tc::b_pack(b, w, lo, kb, st, n8, nb);
  }
}

// big and small (the half tile's rows x this warp's NT n8 tiles from its
// tile j0: nb = warp + 8 (j0 + j)) = A (shared X, k_valid columns, a
// multiple of 8) . B (a transposed segment of n8 blocks). f32: per k8 step
// the two cross terms into small and x.hi w.hi into big. bf16: hi.hi only,
// each chunk of kChunkSteps k8 steps summed from zero in small and added
// to big in f32 (rounded to nearest): an mma accumulator that takes all
// of K = 1024 drifts as it adds, as K1's wgmma ones do
// (fused_mlp_wide1k_tc.cu). The next step's B is in flight.
template <bool kBf16, int NT>
__device__ __forceinline__ void rows_mma(Acc4& big, Acc4& small, const float* X, int k_valid,
                                         const float* w, long long lo, int n8, int warp, int j0) {
  const int steps = k_valid >> 3;
  bwd_tc::BFrag b[4], nxt[4];
#pragma unroll
  for (int j = 0; j < NT; ++j) b_load<kBf16>(b[j], w, lo, 0, 0, n8, warp + 8 * (j0 + j));
  for (int k = 0; k < steps; ++k) {
    if (k + 1 < steps) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b_load<kBf16>(nxt[j], w, lo, (k + 1) >> 1, (k + 1) & 1, n8, warp + 8 * (j0 + j));
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
      uint32_t ah[4], al[4];
      bwd_tc::a_rows(X, kSx, 16 * mi, 8 * k, ah, al);
      if constexpr (kBf16) {
#pragma unroll
        for (int j = 0; j < NT; ++j) bwd_tc::mma_tf32(small[mi][j], ah, b[j].hi[0], b[j].hi[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) bwd_tc::mma_tf32(small[mi][j], al, b[j].hi[0], b[j].hi[1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) bwd_tc::mma_tf32(small[mi][j], ah, b[j].lo[0], b[j].lo[1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) bwd_tc::mma_tf32(big[mi][j], ah, b[j].hi[0], b[j].hi[1]);
      }
    }
    if constexpr (kBf16) {
      if ((k + 1) % kChunkSteps == 0 || k + 1 == steps) {
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              big[mi][j][e] += small[mi][j][e];
              small[mi][j][e] = 0.f;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = nxt[j];
  }
}

// What an input-gradient product does with its outputs.
struct Din {
  float* out = nullptr;           // added into out (row stride s_out), unrounded; or else:
  int s_out = 0;
  const float* mask_rec = nullptr;      // f32: masked by a record slot (64 rows, n8 blocks)
  const uint8_t* mask_img = nullptr;    // bf16: masked by a bf16 image (64 rows)
  const float* w_alpha = nullptr;       // plus gs[row] w_alpha[col] first
  const float* gs = nullptr;
  uint8_t* dst = nullptr;               // the layer's output gradient image, `cols` columns
  int cols = 0;
};

// One input-gradient product, X . w (X: the output gradient, k_red
// columns; w: a transposed segment, n8 blocks of the input), in passes of
// four of this warp's n8 tiles. With d.out: added into it. Else: plus
// gs w_alpha^T, masked, rounded to bf16 in bf16 mode, written to the
// image d.dst at rows r0 .., and, once every warp has read X, read back
// into X. Ends behind a barrier.
template <bool kBf16>
__device__ __forceinline__ void din(float* X, int k_red, const float* w, long long lo, int n8,
                                    const Din& d, int r0) {
  const int warp = bwd_tc::warp_id(), g = bwd_tc::lane_id() >> 2, t = bwd_tc::lane_id() & 3;
  const int nt = tiles_of(warp, n8);
  const int plane = d.cols * 128;
#pragma unroll 1
  for (int pass = 0; 4 * pass < nt; ++pass) {
    Acc4 big, small;
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) big[mi][j][e] = small[mi][j][e] = 0.f;
      }
    }
    switch (min(nt - 4 * pass, 4)) {
      case 4: rows_mma<kBf16, 4>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
      case 3: rows_mma<kBf16, 3>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
      case 2: rows_mma<kBf16, 2>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
      default: rows_mma<kBf16, 1>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
    }
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = warp + 8 * (4 * pass + j);
        if (nb >= n8) continue;
        const int col = 8 * nb + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mi + g + 8 * r;
          float v0 = big[mi][j][2 * r], v1 = big[mi][j][2 * r + 1];
          if constexpr (!kBf16) {   // bf16: small is zero, every chunk added to big
            v0 = v0 + small[mi][j][2 * r];
            v1 = v1 + small[mi][j][2 * r + 1];
          }
          if (d.out != nullptr) {
            float2* p = reinterpret_cast<float2*>(d.out + row * d.s_out + col);
            const float2 o = *p;
            *p = make_float2(o.x + v0, o.y + v1);
            continue;
          }
          if (d.w_alpha != nullptr) {
            v0 = v0 + d.gs[row] * d.w_alpha[col];
            v1 = v1 + d.gs[row] * d.w_alpha[col + 1];
          }
          if constexpr (kBf16) {
            if (d.mask_img != nullptr) {
              const float2 m = pair(__ldcg(reinterpret_cast<const unsigned int*>(
                  d.mask_img + f32tc::p_off(r0 + row, col))));
              if (!(m.x > 0.f)) v0 = 0.f;
              if (!(m.y > 0.f)) v1 = 0.f;
            }
            __stcg(reinterpret_cast<unsigned int*>(d.dst + f32tc::p_off(r0 + row, col)),
                   f32tc::bits(__floats2bfloat162_rn(v0, v1)));
          } else {
            if (d.mask_rec != nullptr) {
              if (!(__ldcg(d.mask_rec + f32tc::ws_index(r0 + row, col, n8)) > 0.f)) v0 = 0.f;
              if (!(__ldcg(d.mask_rec + f32tc::ws_index(r0 + row, col + 1, n8)) > 0.f)) v1 = 0.f;
            }
            uint32_t h, m, l;
            f32tc::split3(make_float2(v0, v1), h, m, l);
            uint8_t* p = d.dst + f32tc::p_off(r0 + row, col);
            __stcg(reinterpret_cast<unsigned int*>(p), h);
            __stcg(reinterpret_cast<unsigned int*>(p + plane), m);
            __stcg(reinterpret_cast<unsigned int*>(p + 2 * plane), l);
          }
        }
      }
    }
  }
  if (d.out != nullptr) {
    __syncthreads();
    return;
  }
  __syncthreads();   // every warp has read X and written its outputs
  for (int i = threadIdx.x; i < 4 * kRows * n8; i += kThreads) {   // 4 pairs x 32 rows a group
    const int cp = i & 3, row = (i >> 2) % kRows, cg = (i >> 2) / kRows;
    const unsigned int* p =
        reinterpret_cast<const unsigned int*>(d.dst + f32tc::p_off(r0 + row, 8 * cg + 2 * cp));
    float2 v = pair(__ldcg(p));
    if constexpr (!kBf16) {
      const float2 m = pair(__ldcg(p + plane / 4));
      const float2 l = pair(__ldcg(p + plane / 2));
      v = make_float2((v.x + m.x) + l.x, (v.y + m.y) + l.y);
    }
    *reinterpret_cast<float2*>(X + row * kSx + 8 * cg + 2 * cp) = v;
  }
  __syncthreads();
}

// A head's pre-activation (column c) for row `row` of X, in K1's order.
// f32 (fused_mlp_wide1k_f32tc.cu's head_part and head_total): per quarter
// of the np pieces, its columns below n_valid a quarter each to the row's
// four threads, fmaf in order, (q0 + q1) + (q2 + q3); the quarters' parts
// added in rank order from 0. bf16 (fused_mlp_wide1k_tc.cu):
// f32tc::head_sum over the row's n_valid columns. w: the head's weights,
// f32, column c of row i at w[i * stride + c]. The row's four threads hold
// the same value.
template <bool kBf16>
__device__ __forceinline__ float head_pre(const float* X, int row, int np, int n_valid,
                                          const float* w, int stride, int c) {
  const float* x = X + row * kSx;
  if constexpr (kBf16) {
    return f32tc::head_sum([&](int i) { return x[i]; }, n_valid, w, stride, c);
  } else {
    float total = 0.f;
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const int base = np / 4, rem = np % 4;
      const int p0 = q * base + min(q, rem), count = base + (q < rem ? 1 : 0);
      const int col0 = p0 * kPiece, h = (count * kPiece) >> 2, i0 = (threadIdx.x & 3) * h;
      float acc = 0.f;
      for (int i = i0; i < i0 + h; ++i) {
        if (col0 + i < n_valid) acc = fmaf(x[col0 + i], __ldg(w + (col0 + i) * stride + c), acc);
      }
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
      acc = acc + __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
      total += acc;
    }
    return total;
  }
}

// One CTA walks the round's half tiles u = blockIdx.x, blockIdx.x +
// gridDim.x, ... below 2 tiles (rows 32 (u % 2) .. of tile u / 2 of the
// round, tile tile0 + u / 2 of the call), writes their output gradients
// (and, f32, their encodes) to the workspace D and adds into its small
// partial: every bias gradient in the packed bias layout, then the alpha
// head's ldw weight gradients and the rgb head's 3 ldv, small_stride floats
// a CTA. f32: the record pass filled rec (rec_stride floats a tile, the
// round's tile 0 first); bf16: the record pass wrote the layer inputs'
// images to D and the view outputs' to view (128 nv bytes a tile).
template <bool kBf16, bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_wide1k_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                            long long n, long long dir_div, const float* __restrict__ g_rgb,
                            const float* __restrict__ g_sigma, const void* __restrict__ weights,
                            const float* __restrict__ mwt, long long lo_wt,
                            const float* __restrict__ bias, const WideLayout L,
                            const Mma::LayoutMma M, const float* rec_all, long long rec_stride,
                            const uint8_t* view_all, const DwWs D, long long tile0,
                            long long tiles, float* small_all, long long n_b,
                            long long small_stride, float* __restrict__ dpts,
                            float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* X = sm + kXOff;
  float* E = sm + kEOff;
  float* De = sm + kDeOff;
  float* xin = sm + kInOff;
  float* gs = sm + kGsOff;
  float* gr = sm + kGrOff;
  const int tid = threadIdx.x;
  const int ldw = L.ldw, ldv = L.ldv, depth = L.depth;
  const int nw8 = ldw >> 3;
  const int np_w = D.nw / kPiece, np_v = D.nv / kPiece;
  const bool want_dx = dpts != nullptr;
  constexpr int kPlanes = kBf16 ? 1 : 3;
  float* dB = small_all + static_cast<long long>(blockIdx.x) * small_stride;
  float* dW_alpha = dB + n_b;
  float* dW_rgb = dW_alpha + ldw;
  // The heads' weights as f32: the f32 pack's own, or (bf16) copies of the
  // bf16 pack's in shared memory, zero past the width.
  const float* w_alpha;
  const float* w_rgb;
  if constexpr (kBf16) {
    const auto* wb = static_cast<const __nv_bfloat16*>(weights);
    float* ha = sm + kHeadOff;
    float* hr = ha + kWide1kMaxWidth;
    for (int k = tid; k < kWide1kMaxWidth; k += kThreads) {
      ha[k] = k < ldw ? load1(wb + L.w_alpha + k) : 0.f;
    }
    for (int k = tid; k < 3 * ldv; k += kThreads) hr[k] = load1(wb + L.w_rgb + k);
    w_alpha = ha;
    w_rgb = hr;
  } else {
    const auto* wf = static_cast<const float*>(weights);
    w_alpha = wf + L.w_alpha;
    w_rgb = wf + L.w_rgb;
  }
  __syncthreads();
  auto from_x = [&](int r, int c) { return *reinterpret_cast<const float2*>(X + r * kSx + c); };

  for (long long u = blockIdx.x; u < 2 * tiles; u += gridDim.x) {
    const long long t = u >> 1;
    const int r0 = static_cast<int>(u & 1) * kRows;
    const long long base = (tile0 + t) * kTile + r0;
    float* rec = kBf16 ? nullptr : const_cast<float*>(rec_all) + t * rec_stride;
    // Slot i of the record: trunk layer i's output; i = depth the
    // bottleneck's, depth + 1 the view layer's (ldv columns).
    auto rec_h = [&](int i) { return f32tc::ws_slot(rec, i, ldw, kTile); };
    // Inputs and cotangents; samples past n read zeros.
    for (int idx = tid; idx < 6 * kRows; idx += kThreads) {
      const int c = idx / kRows, r = idx % kRows;
      const long long s = base + r;
      float v = 0.f;
      if (s < n) v = c < 3 ? pts[s * 3 + c] : dirs[(s / dir_div) * 3 + (c - 3)];
      xin[idx] = v;
    }
    for (int idx = tid; idx < 4 * kRows; idx += kThreads) {
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
    __syncthreads();
    if constexpr (!kBf16) {
      // The encodes, split, to the workspace (the record pass computed them
      // with the same enc_at; bf16's record pass wrote its own images).
      put_rows<3>(D.at(0, t), kEncX, kEncX, r0, [&](int r, int j) {
        return make_float2(
            f32tc::enc_at(xin[r], xin[kRows + r], xin[2 * kRows + r], j, 3 + 6 * tc::kXBands),
            f32tc::enc_at(xin[r], xin[kRows + r], xin[2 * kRows + r], j + 1, 3 + 6 * tc::kXBands));
      });
      put_rows<3>(D.at(1, t), kEncD, kEncD, r0, [&](int r, int j) {
        return make_float2(f32tc::enc_at(xin[3 * kRows + r], xin[4 * kRows + r],
                                         xin[5 * kRows + r], j, 3 + 6 * tc::kDBands),
                           f32tc::enc_at(xin[3 * kRows + r], xin[4 * kRows + r],
                                         xin[5 * kRows + r], j + 1, 3 + 6 * tc::kDBands));
      });
    }
    const uint8_t* h_last_img = D.at(DwWs::h(depth - 1), t);
    x_from<kBf16>(X, rec_h(depth - 1), h_last_img, ldw, r0);   // h_last
    // Sigma head, K1's sum (rows tid / 4 of the first 128 threads): gs
    // becomes d(pre-ReLU sigma), rounded in bf16; then its dW and db.
    if (tid < 4 * kRows) {
      const int row = tid >> 2;
      const float pre = head_pre<kBf16>(X, row, np_w, ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha);
      if (!(tid & 3)) gs[row] = round_act<kBf16>(pre > 0.f ? gs[row] : 0.f);
    }
    __syncthreads();
    for (int k = tid; k < ldw; k += kThreads) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a = fmaf(X[r * kSx + k], gs[r], a);
      dW_alpha[k] += a;
    }
    if (tid == 0) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a += gs[r];
      dB[L.b_alpha] += a;
    }

    if constexpr (!kSigmaOnly) {
      __syncthreads();   // every read of h_last before X takes the view output
      x_from<kBf16>(X, rec_h(depth + 1), view_all + t * D.nv * 128, ldv, r0);
      // Rgb head, K1's sums: gr becomes d(pre-sigmoid rgb), rounded in
      // bf16; sigmoid' = sg (1 - sg), with 1 - sg as sigmoid(-pre).
      if (tid < 4 * kRows) {
        const int row = tid >> 2;
#pragma unroll 1
        for (int c = 0; c < 3; ++c) {
          const float pre =
              head_pre<kBf16>(X, row, np_v, ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
          const float sg = 1.f / (1.f + expf(-pre));
          const float sg_neg = 1.f / (1.f + expf(pre));
          if (!(tid & 3)) gr[row * 3 + c] = round_act<kBf16>(gr[row * 3 + c] * sg * sg_neg);
        }
      }
      __syncthreads();
      for (int idx = tid; idx < 3 * ldv; idx += kThreads) {
        const int k = idx / 3, c = idx % 3;
        float a = 0.f;
        for (int r = 0; r < kRows; ++r) a = fmaf(X[r * kSx + k], gr[r * 3 + c], a);
        dW_rgb[idx] += a;
      }
      if (tid < 3) {
        float a = 0.f;
        for (int r = 0; r < kRows; ++r) a += gr[r * 3 + tid];
        dB[L.b_rgb + tid] += a;
      }
      __syncthreads();
      // d(view output), masked by the view output (rounded in bf16), into
      // X in place.
      for (int idx = tid; idx < kRows * ldv; idx += kThreads) {
        const int r = idx / ldv, k = idx % ldv;
        float v = 0.f;
        if (X[r * kSx + k] > 0.f) {
          v = gr[r * 3] * w_rgb[k * 3];
          v = fmaf(gr[r * 3 + 1], w_rgb[k * 3 + 1], v);
          v = fmaf(gr[r * 3 + 2], w_rgb[k * 3 + 2], v);
        }
        X[r * kSx + k] = round_act<kBf16>(v);
      }
      __syncthreads();
      put_rows<kPlanes>(D.at(D.dz_view(), t), D.nv, ldv, r0, from_x);
      add_db(X, ldv, dB + L.b_view);
      if (want_dx) {   // d(dir encode) into De
        for (int idx = tid; idx < kRows * kSd; idx += kThreads) De[idx] = 0.f;
        __syncthreads();
        Din d;
        d.out = De;
        d.s_out = kSd;
        din<kBf16>(X, ldv, mwt + M.wt[Mma::kViewDir], lo_wt, kEncD >> 3, d, r0);
      }
      // d(bottleneck), no activation, to the workspace and X.
      {
        Din d;
        d.dst = D.at(D.dz(depth), t);
        d.cols = D.nw;
        din<kBf16>(X, ldv, mwt + M.wt[Mma::kView], lo_wt, nw8, d, r0);
      }
      if (want_dx) {
        for (int idx = tid; idx < 3 * kRows; idx += kThreads) {
          const int c = idx / kRows, r = idx % kRows;
          const long long s = base + r;
          const float v = encode_vjp(De, kSd, r, c, xin[(3 + c) * kRows + r], tc::kDBands);
          if (s < n) ddirs[s * 3 + c] = v;
        }
      }
      // Bottleneck: d(h_last) from it and the sigma head, masked by h_last.
      add_db(X, ldw, dB + L.b_bneck);
      {
        Din d;
        d.mask_rec = rec_h(depth - 1);
        d.mask_img = h_last_img;
        d.w_alpha = w_alpha;
        d.gs = gs;
        d.dst = D.at(D.dz(depth - 1), t);
        d.cols = D.nw;
        din<kBf16>(X, ldw, mwt + M.wt[Mma::kBneck], lo_wt, nw8, d, r0);
      }
    } else {
      // Sigma head only: d(h_last) = gs w_alpha^T masked by h_last.
      __syncthreads();
      for (int idx = tid; idx < kRows * ldw; idx += kThreads) {
        const int r = idx / ldw, k = idx % ldw;
        const float v = gs[r] * w_alpha[k];
        X[r * kSx + k] = round_act<kBf16>(X[r * kSx + k] > 0.f ? v : 0.f);
      }
      if (want_dx) {
        for (int idx = tid; idx < 3 * kRows; idx += kThreads) {
          const long long s = base + idx % kRows;
          if (s < n) ddirs[s * 3 + idx / kRows] = 0.f;
        }
      }
      __syncthreads();
      put_rows<kPlanes>(D.at(D.dz(depth - 1), t), D.nw, ldw, r0, from_x);
    }

    // Trunk, from the last layer down to layer 1; d(point encode) sums in E.
    if (want_dx) {
      for (int idx = tid; idx < kRows * kSe; idx += kThreads) E[idx] = 0.f;
      __syncthreads();
    }
    for (int i = depth - 1; i >= 1; --i) {
      add_db(X, ldw, dB + L.b_dense[i]);
      if (want_dx && L.w_skip[i] >= 0) {
        Din d;
        d.out = E;
        d.s_out = kSe;
        din<kBf16>(X, ldw, mwt + M.wt[Mma::kMaxDepth + i], lo_wt, kEncX >> 3, d, r0);
      }
      Din d;
      d.mask_rec = rec_h(i - 1);
      d.mask_img = D.at(DwWs::h(i - 1), t);
      d.dst = D.at(D.dz(i - 1), t);
      d.cols = D.nw;
      din<kBf16>(X, ldw, mwt + M.wt[i], lo_wt, nw8, d, r0);
    }
    // Layer 0: input the point encode.
    add_db(X, ldw, dB + L.b_dense[0]);
    if (want_dx) {
      Din d;
      d.out = E;
      d.s_out = kSe;
      din<kBf16>(X, ldw, mwt + M.wt[0], lo_wt, kEncX >> 3, d, r0);
      for (int idx = tid; idx < 3 * kRows; idx += kThreads) {
        const int c = idx / kRows, r = idx % kRows;
        const long long s = base + r;
        const float v = encode_vjp(E, kSe, r, c, xin[c * kRows + r], tc::kXBands);
        if (s < n) dpts[s * 3 + c] = v;
      }
    }
    __syncthreads();
  }
}

template <bool kBf16, bool kSigmaOnly>
cudaError_t launch(int grid, cudaStream_t stream, const float* pts, const float* dirs, long long n,
                   long long dir_div, const float* g_rgb, const float* g_sigma,
                   const void* weights, const float* mwt, long long lo_wt, const float* bias,
                   const WideLayout& L, const Mma::LayoutMma& M, const float* rec,
                   long long rec_stride, const uint8_t* view, const DwWs& D, long long tile0,
                   long long tiles, float* small, long long n_b, long long small_stride,
                   float* dpts, float* ddirs) {
  auto kernel = fused_mlp_wide1k_bwd_kernel<kBf16, kSigmaOnly>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(pts, dirs, n, dir_div, g_rgb, g_sigma, weights,
                                                 mwt, lo_wt, bias, L, M, rec, rec_stride, view,
                                                 D, tile0, tiles, small, n_b, small_stride, dpts,
                                                 ddirs);
  return cudaGetLastError();
}

}  // namespace

// One round of K2 past width 512: the tiles tile0 .. tile0 + tiles - 1 of
// the call (64 samples each; below ceil(n / 64)), their halves on `grid`
// CTAs, after the record pass of the round: f32 (bf16 == 0),
// nerf_fused_mlp_wide1k_f32tc_record filled rec (ws_stride(depth, ldw,
// ldv, 64) floats a tile), whose layer outputs this call first splits into
// the workspace; bf16, nerf_fused_mlp_wide1k_tc_record wrote the encodes
// and layer inputs into the workspace and the view outputs into view.
// Writes the output gradients (and, f32, the encodes) into the workspace ws
// (fused_mlp_wide_dw.cuh: planes 3 in f32, 1 in bf16, laid out for ws_tiles
// tiles) and the sums into `small` (grid x small_stride floats: n_b bias
// gradients, then ldw + 3 ldv head weight gradients; zeroed by the caller
// before the first round); d(points) and d(dirs) when dpts is not null.
// weights: PackedMLP.weights (f32 or bf16: the heads); mma_wt: the
// transposed pack (hi and lo rows lo_wt floats apart); layout its
// kWideLayoutLen offsets, layout_mma its 2 kWideMaxDepth + 3. Then
// nerf_wide_dw for the round, and nerf_wide_small_sum after the last.
// Returns a cudaError_t value (0 = launched).
extern "C" int nerf_wide1k_bwd_tiles(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights, const void* mma_wt, long long lo_wt,
    const void* biases, const long long* layout, int layout_len, const long long* layout_mma,
    int layout_mma_len, int ldw, int ldv, int depth, int sigma_only, int bf16, const void* rec,
    const void* view, void* ws, long long ws_tiles, long long tile0, long long tiles, void* small,
    long long n_b, long long small_stride, int grid, void* dpts, void* ddirs, int device,
    void* stream) {
  WideLayout L;
  Mma::LayoutMma M;
  const int nw = (ldw + 63) / 64 * 64, nv = (ldv + 63) / 64 * 64;
  if (!parse_wide1k_layout(layout, layout_len, ldw, ldv, depth, &L) ||
      !bwd_tc::parse_mma<Mma>(layout_mma, layout_mma_len, depth, &M) || dir_div < 1 ||
      n < 1 || grid < 1 || tiles < 1 || tiles > ws_tiles || tile0 < 0 || tile0 * kTile >= n ||
      n_b < 1 || small_stride < n_b + ldw + 3 * ldv || (dpts == nullptr) != (ddirs == nullptr) ||
      lo_wt < 1 || (bf16 ? (!sigma_only && view == nullptr) : rec == nullptr) ||
      reinterpret_cast<uintptr_t>(mma_wt) % 16 != 0 || reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwWs D{static_cast<uint8_t*>(ws), ws_tiles, bf16 ? 1 : 3, nw, nv, depth};
  const long long rec_stride = f32tc::ws_stride(depth, ldw, ldv, kTile);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(rec);
  if (!bf16) {
    bwd_tc::record_planes_kernel<<<dim3(static_cast<unsigned>(tiles),
                                        sigma_only ? depth : depth + 1),
                                   kThreads, 0, s>>>(r, rec_stride, D, ldw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* p = static_cast<const float*>(pts);
  const auto* d = static_cast<const float*>(dirs);
  const auto* gr = static_cast<const float*>(g_rgb);
  const auto* gs = static_cast<const float*>(g_sigma);
  const auto* mw = static_cast<const float*>(mma_wt);
  const auto* b = static_cast<const float*>(biases);
  const auto* v = static_cast<const uint8_t*>(view);
  auto* sm = static_cast<float*>(small);
  auto* dp = static_cast<float*>(dpts);
  auto* dd = static_cast<float*>(ddirs);
  if (bf16) {
    err = sigma_only ? launch<true, true>(grid, s, p, d, n, dir_div, gr, gs, weights, mw, lo_wt, b,
                                          L, M, r, rec_stride, v, D, tile0, tiles, sm, n_b,
                                          small_stride, dp, dd)
                     : launch<true, false>(grid, s, p, d, n, dir_div, gr, gs, weights, mw, lo_wt,
                                           b, L, M, r, rec_stride, v, D, tile0, tiles, sm, n_b,
                                           small_stride, dp, dd);
  } else {
    err = sigma_only ? launch<false, true>(grid, s, p, d, n, dir_div, gr, gs, weights, mw, lo_wt,
                                           b, L, M, r, rec_stride, v, D, tile0, tiles, sm, n_b,
                                           small_stride, dp, dd)
                     : launch<false, false>(grid, s, p, d, n, dir_div, gr, gs, weights, mw, lo_wt,
                                            b, L, M, r, rec_stride, v, D, tile0, tiles, sm, n_b,
                                            small_stride, dp, dd);
  }
  return static_cast<int>(err);
}
