// Fused NeRF MLP backward in float32 for Hopper (sm_90a) for wide or deep
// networks, K2's f32 mode beyond the narrow envelope: trunk and view widths
// up to 512, up to 32 dense layers (fused_mlp_wide.cuh's tables). Per tile
// of 64 samples of a round it backpropagates through the rgb head, the
// view layer, the bottleneck, the sigma head and the trunk with its skip
// layer, and writes the encodes and every layer's output gradient, split
// into bf16 hi, mid and lo planes, to the round's workspace
// (fused_mlp_wide_dw.cuh), where the dW kernel (fused_mlp_wide_dw.cu) sums
// the weight gradients over the whole round in split-f32 wgmma (the
// layers' outputs, its other inputs, it splits from the record); with
// input gradients requested, also d(points) and d(dirs) through the
// encode.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t (:663, the
// Pallas call at :675) for dtype="float32" where the narrow kernel
// (fused_mlp_bwd_tc.cu: widths up to 256, depth up to 16) stops; the JAX
// kernel trains any width that is a multiple of 128 and any depth.
//
// - The recompute: the wide f32 forward (fused_mlp_wide_f32.cu, true f32
//   on the CUDA cores) in record mode, nerf_fused_mlp_wide_f32_record, a
//   launch before each round of tiles, so the activations and ReLU masks
//   are bit for bit those of the forward that made the loss. A tile's
//   record at 512/256/8 is (96 + 9 x 512 + 256) x 64 x 4 B = 1.27 MB.
// - W dz: the narrow f32 backward's 3xTF32 mma.sync products
//   (fused_mlp_bwd_tc.cuh's din_layer, BwdTc at 64 rows and 512 columns:
//   kMi 4 m16 x kNt 8 n8 tiles a warp, 128 accumulators a thread). Why not
//   split-f32 wgmma as K1 f32: its A, dZ, would be three bf16 planes of 64
//   x 512 in shared memory, 192 KB before a weight ring (48 KB a stage of
//   16 k-rows at 512) and the point and dir encode gradients; split in
//   registers each k-step instead, ptxas serialized K1 f32's wgmmas
//   (C7512). dW, twice the work of W dz's two products a forward, went to
//   the dW kernel, and with it cols_mma's double-buffered workspace blocks,
//   which took this kernel to 255 registers and spills.
// - Shared memory: the activation or gradient buffer (64 x 516 f32, 132
//   KB), the point and dir encode gradients (17 and 9 KB), the inputs and
//   head cotangents (2.5 KB): 161 KB.
//
// What bounds it on the H100: operations. At 512/256/8 a fine sample costs
// the recompute's forward on the CUDA cores (4.60 MFLOP at 67 TFLOP/s),
// W dz as 3xTF32 (three tf32 products of 4.60 MFLOP at 495 TFLOP/s) and
// dW as split-f32 in the dW kernel (six bf16 passes at 989 TFLOP/s).

#include "fused_mlp_bwd_tc.cuh"
#include "fused_mlp_wide.cuh"
#include "fused_mlp_wide_dw.cuh"

namespace {

using namespace nerf;
using namespace nerf::wide;
using Wide = bwd_tc::BwdTc<64, kWideMaxWidth, kWideMaxDepth>;

// Writes the hi, mid and lo planes of a 64-row block of `cols` columns
// (an image of fused_mlp_wide_dw.cuh, plane q at dst + q cols 128) from
// get(row, col) -> the f32 pair (col, col + 1), zeros from column `valid`
// on (a multiple of 8). Consecutive threads write consecutive words.
template <class Get>
__device__ __forceinline__ void put_planes(uint8_t* dst, int cols, int valid, Get get) {
  const int plane = cols * 128;
  for (int i = threadIdx.x; i < 32 * cols; i += Wide::kThreadsBwd) {
    const int cp = i & 3, row = (i >> 2) & 63, cg = i >> 8;
    const int col = 8 * cg + 2 * cp;
    const float2 v = col < valid ? get(row, col) : make_float2(0.f, 0.f);
    uint32_t h, m, l;
    f32tc::split3(v, h, m, l);
    auto* p = reinterpret_cast<unsigned int*>(dst + cg * 1024 + row * 16 + cp * 4);
    __stcg(p, h);
    __stcg(reinterpret_cast<unsigned int*>(reinterpret_cast<uint8_t*>(p) + plane), m);
    __stcg(reinterpret_cast<unsigned int*>(reinterpret_cast<uint8_t*>(p) + 2 * plane), l);
  }
}

// The two bf16 of a word (the lower at the lower address), as floats.
__device__ __forceinline__ float2 pair(unsigned int u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}

// 3xTF32 with two accumulators a pass: [kMi m16 tiles][4 n8 tiles][4].
using Acc4 = float[Wide::kMi][4][4];

// big and small (the tile's samples x this warp's NT n8 tiles from its
// tile j0: nb = warp + 8 (j0 + j)) = A (shared, row stride kSx, k_valid
// columns, a multiple of 8) . B (a transposed segment of n8 blocks): per
// k8 step the two cross terms into small, x.hi w.hi into big, so the big
// sum takes one rounding a step, not three. The next step's B is in
// flight.
template <int NT>
__device__ __forceinline__ void rows_mma2(Acc4& big, Acc4& small, const float* X, int k_valid,
                                          const float* w, long long lo, int n8, int warp,
                                          int j0) {
  const int steps = k_valid >> 3;
  bwd_tc::BFrag b[4], nxt[4];
#pragma unroll
  for (int j = 0; j < NT; ++j) bwd_tc::b_pack(b[j], w, lo, 0, 0, n8, warp + 8 * (j0 + j));
  for (int k = 0; k < steps; ++k) {
    if (k + 1 < steps) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bwd_tc::b_pack(nxt[j], w, lo, (k + 1) >> 1, (k + 1) & 1, n8, warp + 8 * (j0 + j));
      }
    }
#pragma unroll
    for (int mi = 0; mi < Wide::kMi; ++mi) {
      uint32_t ah[4], al[4];
      bwd_tc::a_rows(X, Wide::kSx, 16 * mi, 8 * k, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) bwd_tc::mma_tf32(small[mi][j], al, b[j].hi[0], b[j].hi[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) bwd_tc::mma_tf32(small[mi][j], ah, b[j].lo[0], b[j].lo[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) bwd_tc::mma_tf32(big[mi][j], ah, b[j].hi[0], b[j].hi[1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = nxt[j];
  }
}

// One input-gradient product, X . w (X: the output gradient, k_red
// columns; w: a transposed segment, n8 blocks of the input), in two passes
// of this warp's n8 tiles (nb = warp + 8 j, j < 4 and j >= 4), so that its
// two accumulators fit. With `out`: added into out (row stride s_out).
// Else: plus gs[row] w_alpha[col] unless w_alpha is null, masked by the
// record slot `mask` (n8 blocks) unless it is null, split into the planes
// of dst (an image of `cols` columns, the layer's output gradient in the
// workspace), and, once every warp has read X, read back into X (hi + mid
// + lo: exact). Ends behind a barrier.
__device__ __forceinline__ void din_wide(float* X, int k_red, const float* w, long long lo,
                                         int n8, const float* mask, const float* w_alpha,
                                         const float* gs, float* out, int s_out, uint8_t* dst,
                                         int cols) {
  const int warp = bwd_tc::warp_id(), g = bwd_tc::lane_id() >> 2, t = bwd_tc::lane_id() & 3;
  const int nt = Wide::tiles_of(warp, n8);
  const int plane = cols * 128;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    Acc4 big, small;
#pragma unroll
    for (int mi = 0; mi < Wide::kMi; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) big[mi][j][e] = small[mi][j][e] = 0.f;
      }
    }
    switch (min(max(nt - 4 * pass, 0), 4)) {
      case 4: rows_mma2<4>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
      case 3: rows_mma2<3>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
      case 2: rows_mma2<2>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
      case 1: rows_mma2<1>(big, small, X, k_red, w, lo, n8, warp, 4 * pass); break;
      default: break;
    }
#pragma unroll
    for (int mi = 0; mi < Wide::kMi; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = warp + 8 * (4 * pass + j);
        if (nb >= n8) continue;
        const int col = 8 * nb + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mi + g + 8 * r;
          float v0 = big[mi][j][2 * r] + small[mi][j][2 * r];
          float v1 = big[mi][j][2 * r + 1] + small[mi][j][2 * r + 1];
          if (out != nullptr) {
            float2* p = reinterpret_cast<float2*>(out + row * s_out + col);
            const float2 o = *p;
            *p = make_float2(o.x + v0, o.y + v1);
            continue;
          }
          if (w_alpha != nullptr) {
            v0 = v0 + gs[row] * load1(w_alpha + col);
            v1 = v1 + gs[row] * load1(w_alpha + col + 1);
          }
          if (mask != nullptr) {
            if (!(__ldcg(mask + f32tc::ws_index(row, col, n8)) > 0.f)) v0 = 0.f;
            if (!(__ldcg(mask + f32tc::ws_index(row, col + 1, n8)) > 0.f)) v1 = 0.f;
          }
          uint32_t h, m, l;
          f32tc::split3(make_float2(v0, v1), h, m, l);
          uint8_t* p = dst + (col >> 3) * 1024 + (row >> 3) * 128 + (row & 7) * 16 + (col & 7) * 2;
          __stcg(reinterpret_cast<unsigned int*>(p), h);
          __stcg(reinterpret_cast<unsigned int*>(p + plane), m);
          __stcg(reinterpret_cast<unsigned int*>(p + 2 * plane), l);
        }
      }
    }
  }
  if (out != nullptr) return;
  __syncthreads();   // every warp has read X and written its planes
  for (int i = threadIdx.x; i < 256 * n8; i += Wide::kThreadsBwd) {   // 4 pairs x 64 rows a group
    const int cp = i & 3, row = (i >> 2) & 63, cg = i >> 8;
    const unsigned int* p = reinterpret_cast<const unsigned int*>(dst + cg * 1024 + row * 16 + cp * 4);
    const float2 h = pair(__ldcg(p));
    const float2 m = pair(__ldcg(p + plane / 4));
    const float2 l = pair(__ldcg(p + plane / 2));
    *reinterpret_cast<float2*>(X + row * Wide::kSx + 8 * cg + 2 * cp) =
        make_float2((h.x + m.x) + l.x, (h.y + m.y) + l.y);
  }
  __syncthreads();
}

// One CTA walks the round's tiles t = blockIdx.x, blockIdx.x + gridDim.x,
// ... below `tiles` (tile tile0 + t of the call), whose record (rec_stride
// floats a tile, tile t of the round's) the record pass has filled; writes
// their planes to the workspace D and adds into its small partial: every
// bias gradient in the packed bias layout, then the alpha head's ldw
// weight gradients and the rgb head's 3 ldv, small_stride floats a CTA.
template <bool kSigmaOnly>
__global__ void __launch_bounds__(Wide::kThreadsBwd, 1)
fused_mlp_wide_bwd_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                             long long n, long long dir_div, const float* __restrict__ g_rgb,
                             const float* __restrict__ g_sigma, const float* __restrict__ w,
                             const float* __restrict__ mwt, long long lo_wt,
                             const float* __restrict__ bias, const WideLayout L,
                             const Wide::LayoutMma M, const float* rec_all, long long rec_stride,
                             const DwWs D, long long tile0, long long tiles, float* small_all,
                             long long n_b, long long small_stride, float* __restrict__ dpts,
                             float* __restrict__ ddirs) {
  using B = Wide;
  constexpr int kRows = B::kRows, kSx = B::kSx, kSe = B::kSe, kSd = B::kSd;
  constexpr int kThreadsBwd = B::kThreadsBwd;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // [kRows][kSx] activations, then gradients
  float* E = X + kRows * kSx;                   // [kRows][kSe] point encode gradient
  float* De = E + kRows * kSe;                  // [kRows][kSd] dir encode gradient
  float* xin = De + kRows * kSd;                // [6][kRows] points, dirs
  float* gs = xin + 6 * kRows;                  // [kRows] sigma cotangent, then d(pre-ReLU)
  float* gr = gs + kRows;                       // [kRows][3] rgb cotangent, then d(pre-sigmoid)
  const int tid = threadIdx.x;
  const int ldw = L.ldw, ldv = L.ldv, depth = L.depth;
  const int nw8 = ldw >> 3;
  const bool want_dx = dpts != nullptr;
  float* dB = small_all + static_cast<long long>(blockIdx.x) * small_stride;
  float* dW_alpha = dB + n_b;
  float* dW_rgb = dW_alpha + ldw;
  auto from_x = [&](int r, int c) { return *reinterpret_cast<const float2*>(X + r * kSx + c); };

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = (tile0 + t) * kRows;
    float* ws = const_cast<float*>(rec_all) + t * rec_stride;
    // Slot i of the record: trunk layer i's output; i = depth the
    // bottleneck's, depth + 1 the view layer's (ldv columns).
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
    // The encodes, split, to the workspace (the record pass built them for
    // its products with the same enc_at; record_planes_kernel splits the
    // trunk outputs and the bottleneck's).
    put_planes(D.at(0, t), kEncX, kEncX, [&](int r, int j) {
      return make_float2(
          f32tc::enc_at(xin[r], xin[kRows + r], xin[2 * kRows + r], j, 3 + 6 * tc::kXBands),
          f32tc::enc_at(xin[r], xin[kRows + r], xin[2 * kRows + r], j + 1, 3 + 6 * tc::kXBands));
    });
    put_planes(D.at(1, t), kEncD, kEncD, [&](int r, int j) {
      return make_float2(f32tc::enc_at(xin[3 * kRows + r], xin[4 * kRows + r],
                                       xin[5 * kRows + r], j, 3 + 6 * tc::kDBands),
                         f32tc::enc_at(xin[3 * kRows + r], xin[4 * kRows + r],
                                       xin[5 * kRows + r], j + 1, 3 + 6 * tc::kDBands));
    });
    B::x_from_slot(X, ws_h(depth - 1), ldw);   // h_last, recorded
    // Sigma head, K1's sum (rows hr and hr + 64): gs becomes d(pre-ReLU
    // sigma); then its dW and db.
    const int hr = f32tc::head_row();
    {
      auto x_row = [&](int i) { return X[hr * kSx + i]; };
      const float pre = f32tc::head_sum(x_row, ldw, w + L.w_alpha, 1, 0) + __ldg(bias + L.b_alpha);
      if (!(tid & 3) && !(pre > 0.f)) gs[hr] = 0.f;
    }
    __syncthreads();
    for (int k = tid; k < ldw; k += kThreadsBwd) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a = fmaf(X[r * kSx + k], gs[r], a);
      dW_alpha[k] += a;
    }
    if (tid == 0) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a += gs[r];
      dB[L.b_alpha] += a;
    }

    if (!kSigmaOnly) {
      __syncthreads();   // every read of h_last before X takes the view output
      B::x_from_slot(X, ws_h(depth + 1), ldv);
      // Rgb head, K1's sums: gr becomes d(pre-sigmoid rgb); sigmoid' =
      // sg (1 - sg), with 1 - sg as sigmoid(-pre): no cancellation where it
      // saturates.
      {
        auto x_row = [&](int i) { return X[hr * kSx + i]; };
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float pre =
              f32tc::head_sum(x_row, ldv, w + L.w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
          const float sg = 1.f / (1.f + expf(-pre));
          const float sg_neg = 1.f / (1.f + expf(pre));
          if (!(tid & 3)) gr[hr * 3 + c] = gr[hr * 3 + c] * sg * sg_neg;
        }
      }
      __syncthreads();
      for (int idx = tid; idx < 3 * ldv; idx += kThreadsBwd) {
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
      put_planes(D.at(D.dz_view(), t), D.nv, ldv, from_x);
      B::add_db(X, ldv, dB + L.b_view);
      if (want_dx) {   // d(dir encode) into De
        for (int idx = tid; idx < kRows * kSd; idx += kThreadsBwd) De[idx] = 0.f;
        __syncthreads();
        din_wide(X, ldv, mwt + M.wt[B::kViewDir], lo_wt, kEncD >> 3, nullptr, nullptr, nullptr,
                 De, kSd, nullptr, 0);
      }
      // d(bottleneck), no activation, to the workspace and X.
      din_wide(X, ldv, mwt + M.wt[B::kView], lo_wt, nw8, nullptr, nullptr, nullptr, nullptr, 0,
               D.at(D.dz(depth), t), D.nw);
      if (want_dx) {
        for (int idx = tid; idx < 3 * kRows; idx += kThreadsBwd) {
          const int c = idx / kRows, r = idx % kRows;
          const long long s = base + r;
          const float v = encode_vjp(De, kSd, r, c, xin[(3 + c) * kRows + r], tc::kDBands);
          if (s < n) ddirs[s * 3 + c] = v;
        }
      }
      // Bottleneck: d(h_last) from it and the sigma head.
      B::add_db(X, ldw, dB + L.b_bneck);
      din_wide(X, ldw, mwt + M.wt[B::kBneck], lo_wt, nw8, ws_h(depth - 1), w + L.w_alpha, gs,
               nullptr, 0, D.at(D.dz(depth - 1), t), D.nw);
    } else {
      // Sigma head only: d(h_last) = gs w_alpha^T masked by h_last.
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
      put_planes(D.at(D.dz(depth - 1), t), D.nw, ldw, from_x);
    }

    // Trunk, from the last layer down to layer 1; d(point encode) sums in E.
    if (want_dx) {
      for (int idx = tid; idx < kRows * kSe; idx += kThreadsBwd) E[idx] = 0.f;
      __syncthreads();
    }
    for (int i = depth - 1; i >= 1; --i) {
      B::add_db(X, ldw, dB + L.b_dense[i]);
      if (want_dx && L.w_skip[i] >= 0) {
        din_wide(X, ldw, mwt + M.wt[B::kMaxDepth + i], lo_wt, kEncX >> 3, nullptr, nullptr,
                 nullptr, E, kSe, nullptr, 0);
      }
      din_wide(X, ldw, mwt + M.wt[i], lo_wt, nw8, ws_h(i - 1), nullptr, nullptr, nullptr, 0,
               D.at(D.dz(i - 1), t), D.nw);
    }
    // Layer 0: input the point encode.
    B::add_db(X, ldw, dB + L.b_dense[0]);
    if (want_dx) {
      din_wide(X, ldw, mwt + M.wt[0], lo_wt, kEncX >> 3, nullptr, nullptr, nullptr, E, kSe,
               nullptr, 0);
      __syncthreads();
      for (int idx = tid; idx < 3 * kRows; idx += kThreadsBwd) {
        const int c = idx / kRows, r = idx % kRows;
        const long long s = base + r;
        const float v = encode_vjp(E, kSe, r, c, xin[c * kRows + r], tc::kXBands);
        if (s < n) dpts[s * 3 + c] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// One round of the wide f32 backward: the tiles tile0 .. tile0 + tiles - 1
// of the call (64 samples each; below ceil(n / 64)) on `grid` CTAs, after
// nerf_fused_mlp_wide_f32_record filled rec (ws_stride(depth, ldw, ldv, 64)
// floats a tile, tile0's first); their planes into the workspace ws
// (fused_mlp_wide_dw.cuh: planes 3, laid out for ws_tiles tiles) and
// their sums into `small` (grid x small_stride floats: n_b bias
// gradients, then ldw + 3 ldv head weight gradients; zeroed by the caller
// before the first round); d(points) and d(dirs) when dpts is not null.
// layout: the wide pack's kWideLayoutLen offsets, layout_mma its 2
// kWideMaxDepth + 3. Then nerf_wide_dw for the round, and
// nerf_wide_small_sum after the last. Returns a cudaError_t value.
extern "C" int nerf_wide_bwd_f32_tiles(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights, const void* mma_wt, long long lo_wt,
    const void* biases, const long long* layout, int layout_len, const long long* layout_mma,
    int layout_mma_len, int ldw, int ldv, int depth, int sigma_only, const void* rec, void* ws,
    long long ws_tiles, long long tile0, long long tiles, void* small, long long n_b,
    long long small_stride, int grid, void* dpts, void* ddirs, int device, void* stream) {
  WideLayout L;
  Wide::LayoutMma M;
  const int nw = (ldw + 63) / 64 * 64, nv = (ldv + 63) / 64 * 64;
  if (!parse_wide_layout(layout, layout_len, ldw, ldv, depth, &L) ||
      !bwd_tc::parse_mma<Wide>(layout_mma, layout_mma_len, depth, &M) || dir_div < 1 ||
      n < 1 || grid < 1 || tiles < 1 || tiles > ws_tiles || tile0 < 0 ||
      tile0 * Wide::kRows >= n || n_b < 1 || small_stride < n_b + ldw + 3 * ldv ||
      (dpts == nullptr) != (ddirs == nullptr) || lo_wt < 1 ||
      reinterpret_cast<uintptr_t>(mma_wt) % 16 != 0 || reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwWs D{static_cast<uint8_t*>(ws), ws_tiles, 3, nw, nv, depth};
  const long long rec_stride = f32tc::ws_stride(depth, ldw, ldv, Wide::kRows);
  bwd_tc::record_planes_kernel<<<dim3(static_cast<unsigned>(tiles),
                                      sigma_only ? depth : depth + 1),
                                 Wide::kThreadsBwd, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), rec_stride, D, ldw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = sigma_only ? fused_mlp_wide_bwd_tc_kernel<true> : fused_mlp_wide_bwd_tc_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Wide::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, Wide::kThreadsBwd, Wide::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(dirs), n, dir_div,
      static_cast<const float*>(g_rgb), static_cast<const float*>(g_sigma),
      static_cast<const float*>(weights), static_cast<const float*>(mma_wt), lo_wt,
      static_cast<const float*>(biases), L, M, static_cast<const float*>(rec), rec_stride, D, tile0,
      tiles, static_cast<float*>(small),
      n_b, small_stride, static_cast<float*>(dpts), static_cast<float*>(ddirs));
  return static_cast<int>(cudaGetLastError());
}
