// Fused NeRF MLP backward in bf16 on Hopper's tensor cores (sm_90a), K2's
// bf16 mode: per tile of 128 samples, recompute the forward, backpropagate
// through the rgb head, the view layer, the bottleneck, the sigma head and
// the trunk with its skip layer, and sum every layer's weight and bias
// gradient over the samples; with input gradients requested, also
// d(points) and d(dirs) through the encode. The f32 mode is
// fused_mlp_bwd_tc.cu.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t (:663, the
// Pallas call at :675) and its kernel body _kernel_bwd (:505) for
// dtype="bfloat16". Numerics, the JAX kernel's: bf16 weights, activations
// and encodes; each layer's output gradient rounded to bf16 after its ReLU
// mask (the heads' gradients after the sigmoid and ReLU derivatives); dW,
// db and the encode gradient accumulated in f32.
//
// The recompute is the tensor-core forward itself: fused_mlp_tc.cuh's
// encode_row, layer and row_dot, on the same pack (PackedMLP.weights_tc)
// through the same ring, so its activations and ReLU masks are bit for bit
// those of K1's bf16 forward, the ones that made the loss.
// The dW products, their reductions, the bias sums and the launch are
// fused_mlp_bwd_bf16.cuh's, shared with the wide kernel at 64-sample tiles.
//
// Roles and data flow (fused_mlp_tc.cuh): a persistent grid, one CTA of
// 384 threads an SM; the producer warpgroup bulk-copies every weight chunk
// the tile needs, in the consumers' order, onto the mbarrier ring; two
// consumer warpgroups own 64 rows each. Three kinds of product, all
// m64n64k16 wgmma from shared memory:
// - the recompute, x W: A the warpgroup's rows (K-major), B a ring chunk;
// - the input gradients, dZ W^T: A the warpgroup's rows of dZ, B the same
//   ring chunks read transposed (MN-major): a chunk of 64 input rows of a
//   segment gives one 64-column piece of dZ W^T, so no transposed pack;
// - dW = H^T dZ over the tile's 128 samples: A = H and B = dZ both read
//   transposed from the activation and gradient buffers, where samples run
//   along K; each warpgroup takes every other 64-row block of dW.
// Per tile the recompute writes each trunk output and the bottleneck
// output to the CTA's workspace (the buffer's own core-matrix image, 16
// bytes a lane); the backward reads each back once, as the dW products'
// H and the ReLU mask.
//
// What bounds it on the H100: operations, three forwards of bf16 products,
// 3 x 1.187 MFLOP a fine sample at 989 TFLOP/s (2.83 ms a 4096 x 192
// call). The four causes that held the CUDA-core K2 back, and what this
// design does:
// 1. CUDA-core FMAs: every layer product is a wgmma; the CUDA cores keep
//    the encode, the heads (N = 1, 3), masks, roundings and bias sums.
// 2. The read-modify-write of the dW partial every 64 samples (59 GB a
//    fine call): 128-sample tiles, and each CTA adds its tile sums into its
//    own partial with fire-and-forget 16-byte reductions (four f32 entries
//    each, sm_90's vector red) from the accumulators, retired by L2 while
//    the warps go on: 2 x 2.4 MB x 6144 tiles = 29.5 GB. Each partial
//    entry belongs to one thread, which adds tile after tile in program
//    order, so the sums' order and bits are fixed; a second launch sums the
//    partials in a fixed order.
// 3. The activation round trip: (depth + 1) x 128 x 256 bf16 a tile, 0.59
//    MB written and read back (7.2 GB a fine call; 12.9 GB before).
// 4. No overlap: the weight copies run ahead on the producer across layers
//    and tiles, the reductions and workspace stores retire in the memory
//    system, and the two warpgroups' wgmmas overlap each other's epilogues.
// Shared memory (227,360 bytes): a 2-stage ring of 32 KB, the activation
// buffer and the gradient buffer (128 x 256 bf16, 64 KB each), the dir and
// point encodes (8 and 16 KB), the head weights (4 KB), the head gradients
// (2 KB), the barriers. The encode gradients go to the workspace in f32.

#include "fused_mlp_bwd_bf16.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::bwd16;
using B = BwdBf16<kRows>;

constexpr int kStages = 2;
constexpr int kBufBytes = kRows * kMaxWidth * 2;
constexpr int kActOff = kStages * kStageBytes;            // ring first
constexpr int kDzOff = kActOff + kBufBytes;
// The dir encode before the point encode: a 64-row dW block of the dir
// encode (32 columns) reads its other 32 rows from the point encode, into
// accumulator rows that are never stored.
constexpr int kEncDOff = kDzOff + kBufBytes;
constexpr int kEncXOff = kEncDOff + kRows * kEncD * 2;
constexpr int kHeadOff = kEncXOff + kRows * kEncX * 2;    // alpha [256], rgb [256][3] f32
constexpr int kGradOff = kHeadOff + 4 * kMaxWidth * 4;    // gs [128], gr [128][3] f32
constexpr int kBarOff = kGradOff + 4 * kRows * 4;         // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

// All 256 consumer threads (named barrier 3).
__device__ __forceinline__ void consumers_barrier() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// Warpgroup g's 64 rows of a 128-row buffer of n columns, to and from its
// image in the workspace (n / 8 runs of 1 KB).
__device__ __forceinline__ void rows_out(const uint8_t* buf, uint8_t* ws, int n, int g, int t) {
  for (int i = t; i < n * 8; i += 128) {
    const int off = (i >> 6) * (kRows * 16) + g * 1024 + (i & 63) * 16;
    __stcg(reinterpret_cast<uint4*>(ws + off), *reinterpret_cast<const uint4*>(buf + off));
  }
}

__device__ __forceinline__ void rows_in(uint8_t* buf, const uint8_t* ws, int n, int g, int t) {
  for (int i = t; i < n * 8; i += 128) {
    const int off = (i >> 6) * (kRows * 16) + g * 1024 + (i & 63) * 16;
    *reinterpret_cast<uint4*>(buf + off) = __ldcg(reinterpret_cast<const uint4*>(ws + off));
  }
}

// acc piece p = this warpgroup's rows of dZ (a, k_out columns) times the
// transpose of the next NP ring chunks: chunk p holds 64 input rows of a
// segment with k_out output columns, read MN-major.
template <int NP, int S>
__device__ __forceinline__ void mma_t(float (&acc)[4][32], Pipe<S>& q, uint32_t a, int k_out) {
  fence_acc<NP>(acc);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint32_t b = q.acquire();
#pragma unroll 1
    for (int s = 0; s < k_out; s += 16) {
      wgmma_64<0, 1>(acc[p], desc(a + (s >> 3) * (kRows * 16), kRows * 16, 128),
                     desc(b + (s >> 3) * 128, 128, k_out * 16), s > 0 ? 1 : 0);
    }
    wgmma_commit();
    q.advance();
  }
  wgmma_wait<0>();
  fence_acc<NP>(acc);
  q.release();
}

// One input-gradient layer for warpgroup g: its rows of out (bf16) =
// round((dZ W^T [+ gs w_alpha^T]) masked by mask > 0), NP 64-column
// pieces; mask and w_alpha (ldw entries) may be null.
template <int NP, int S>
__device__ __forceinline__ void din_layer(Pipe<S>& q, uint32_t a, int k_out, uint8_t* out,
                                          const uint8_t* mask, const float* gs,
                                          const float* w_alpha, int ldw, int g) {
  float acc[4][32];
  mma_t<NP>(acc, q, a, k_out);
  wg_barrier(g);   // every warp's wgmmas have read the rows it overwrites
  const int r0 = g * 64 + frag_row(), c0 = frag_col();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p * kPiece + 8 * j + c0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        float v0 = acc[p][4 * j + 2 * r], v1 = acc[p][4 * j + 2 * r + 1];
        if (w_alpha != nullptr && col < ldw) {
          v0 = v0 + gs[row] * w_alpha[col];
          v1 = v1 + gs[row] * w_alpha[col + 1];
        }
        if (mask != nullptr) {
          if (!(ld_bf16(mask, row, col) > 0.f)) v0 = 0.f;
          if (!(ld_bf16(mask, row, col + 1) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + a_off(row, col)) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int S>
__device__ __forceinline__ void din_any(int np, Pipe<S>& q, uint32_t a, int k_out, uint8_t* out,
                                        const uint8_t* mask, const float* gs, const float* w_alpha,
                                        int ldw, int g) {
  switch (np) {
    case 1: din_layer<1>(q, a, k_out, out, mask, gs, w_alpha, ldw, g); break;
    case 2: din_layer<2>(q, a, k_out, out, mask, gs, w_alpha, ldw, g); break;
    case 3: din_layer<3>(q, a, k_out, out, mask, gs, w_alpha, ldw, g); break;
    default: din_layer<4>(q, a, k_out, out, mask, gs, w_alpha, ldw, g); break;
  }
}

// An encode gradient for warpgroup g: its rows of de (f32, kDeCols a
// row, the first n columns) = or += dZ times the next ring chunk's
// transpose, unrounded.
template <int S>
__device__ __forceinline__ void din_encode(Pipe<S>& q, uint32_t a, int k_out, float* de, int n,
                                           bool add, int g) {
  float acc[4][32];
  mma_t<1>(acc, q, a, k_out);
  const int r0 = g * 64 + frag_row(), c0 = frag_col();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= n) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2* p = reinterpret_cast<float2*>(de + (r0 + 8 * r) * kDeCols + col);
      float2 v = make_float2(acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]);
      if (add) {
        const float2 o = *p;
        v = make_float2(o.x + v.x, o.y + v.y);
      }
      *p = v;
    }
  }
}

// One CTA walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and adds
// into its partial: n_w weight-gradient floats in the gradient layout G
// (PackedMLP.layout), then the bias gradients (part_stride apart). L is
// the pack's own table (layout_tc); both hold the same bias offsets.
template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreadsTc, 1)
fused_mlp_bwd_bf16_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                          long long n, long long dir_div, const float* __restrict__ g_rgb,
                          const float* __restrict__ g_sigma, const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias, const Layout L, const Layout G,
                          const int nw, const int nv, uint8_t* ws_all, long long ws_bytes,
                          float* partials, long long n_w, long long part_stride,
                          float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* act = smem + kActOff;
  uint8_t* dz = smem + kDzOff;
  uint8_t* enc_x = smem + kEncXOff;
  uint8_t* enc_d = smem + kEncDOff;
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kMaxWidth;
  float* gs = reinterpret_cast<float*>(smem + kGradOff);   // sigma cotangent, then d(pre-ReLU)
  float* gr = gs + kRows;                                  // rgb cotangent, then d(pre-sigmoid)
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kRows - 1) / kRows;
  const int tid = threadIdx.x;
  const int depth = L.depth;
  const bool want_dx = dpts != nullptr;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = tid; k < L.ldw; k += kThreadsTc) w_alpha[k] = load1(w + L.w_alpha + k);
  for (int k = tid; k < 3 * L.ldv; k += kThreadsTc) w_rgb[k] = load1(w + L.w_rgb + k);
  __syncthreads();

  // The role split on a warp-uniform value, never rejoined.
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
  if (warp >= kConsumers / 32) {
    // Producer: every chunk of a tile in the consumers' order, the
    // recompute's (K1's order) then the backward's.
    reg_dealloc<kProducerRegs>();
    if (tid != kConsumers) return;
    Producer<kStages> pr{smem_u32(smem), bars, 0, 0u};
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      pr.emit(w, L.w_dense[0], kEncX, nw);
      for (int i = 1; i < depth; ++i) {
        if (L.w_skip[i] >= 0) pr.emit(w, L.w_skip[i], kEncX, nw);
        pr.emit(w, L.w_dense[i], nw, nw);
      }
      if (!kSigmaOnly) {
        pr.emit(w, L.w_bneck, nw, nw);
        pr.emit(w, L.w_view, nw, nv);
        pr.emit(w, L.w_view_dir, kEncD, nv);
        if (want_dx) pr.emit(w, L.w_view_dir, kEncD, nv);
        pr.emit(w, L.w_view, nw, nv);
        pr.emit(w, L.w_bneck, nw, nw);
      }
      for (int i = depth - 1; i >= 1; --i) {
        if (want_dx && L.w_skip[i] >= 0) pr.emit(w, L.w_skip[i], kEncX, nw);
        pr.emit(w, L.w_dense[i], nw, nw);
      }
      if (want_dx) pr.emit(w, L.w_dense[0], kEncX, nw);
    }
    return;
  }

  // Consumers: warpgroup g owns rows [64 g, 64 g + 64) of every tile.
  // Every branch below is uniform across a warp, or guards stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  const int t = tid & 127;
  const int ldw = L.ldw, ldv = L.ldv;
  const int npw = nw / kPiece, npv = nv / kPiece;
  Pipe<kStages> q{smem_u32(smem), bars, 0, 0u, -1};
  const uint32_t s_act = smem_u32(act), s_dz = smem_u32(dz);
  const uint32_t s_ex = smem_u32(enc_x), s_ed = smem_u32(enc_d);
  const uint32_t a_act = s_act + g * 1024;   // this warpgroup's rows: 8 row groups of 128 B
  const uint32_t a_dz = s_dz + g * 1024;
  const uint32_t a_ex = s_ex + g * 1024;
  const uint32_t a_ed = s_ed + g * 1024;
  const int row = g * 64 + (t & 63);
  const bool half = t >= 64;
  float* dW = partials + static_cast<long long>(blockIdx.x) * part_stride;
  float* dB = dW + n_w;
  uint8_t* ws = ws_all + static_cast<long long>(blockIdx.x) * ws_bytes;
  auto slot = [&](int i) { return ws + static_cast<long long>(i) * kRows * nw * 2; };
  float* de = reinterpret_cast<float*>(slot(depth + 1));

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long s = tile * kRows + row;
    const bool in = s < n;            // rows past n: zero inputs and cotangents, never stored
    float p[3], d[3];
    {
      const long long r = (in ? s : 0) / dir_div;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] = in ? pts[s * 3 + c] : 0.f;
        d[c] = in ? dirs[r * 3 + c] : 0.f;
      }
      encode_row(enc_x, enc_d, row, half, p, d);
      if (!half) {
        gs[row] = in ? g_sigma[s] : 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) gr[row * 3 + c] = in ? g_rgb[s * 3 + c] : 0.f;
      }
    }
    fence_async_smem();
    wg_barrier(g);

    // Recompute: K1's trunk; each output also to its workspace slot.
    layer_any(npw, q, a_ex, kEncX, 0, 0, nw, bias + L.b_dense[0], ldw, true, act, g);
    rows_out(act, slot(0), nw, g, t);
    for (int i = 1; i < depth; ++i) {
      if (L.w_skip[i] >= 0) {
        layer_any(npw, q, a_ex, kEncX, a_act, nw, nw, bias + L.b_dense[i], ldw, true, act, g);
      } else {
        layer_any(npw, q, a_act, nw, 0, 0, nw, bias + L.b_dense[i], ldw, true, act, g);
      }
      rows_out(act, slot(i), nw, g, t);
    }
    // Sigma head, K1's sum: gs becomes d(pre-ReLU sigma); its dW and db.
    if (!half) {
      const float pre = row_dot(act, row, ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha);
      gs[row] = round_act<true>(pre > 0.f ? gs[row] : 0.f);
    }
    consumers_barrier();
    for (int k = tid; k < ldw; k += kConsumers) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a = fmaf(ld_bf16(act, r, k), gs[r], a);
      atomicAdd(dW + G.w_alpha + k, a);
    }
    if (tid == 0) {
      float a = 0.f;
      for (int r = 0; r < kRows; ++r) a += gs[r];
      atomicAdd(dB + G.b_alpha, a);
    }
    consumers_barrier();   // every read of h_last before the bottleneck overwrites it

    if (!kSigmaOnly) {
      // K1's bottleneck (to the workspace) and view layer, then its rgb
      // head: gr becomes d(pre-sigmoid rgb), sigmoid' = sg (1 - sg) with
      // 1 - sg as sigmoid(-pre).
      layer_any(npw, q, a_act, nw, 0, 0, nw, bias + L.b_bneck, ldw, false, act, g);
      rows_out(act, slot(depth), nw, g, t);
      layer_any(npv, q, a_act, nw, a_ed, kEncD, nv, bias + L.b_view, ldv, true, act, g);
      if (!half) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float pre = row_dot(act, row, ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
          const float sg = 1.f / (1.f + expf(-pre));
          const float sg_neg = 1.f / (1.f + expf(pre));
          gr[row * 3 + c] = round_act<true>(gr[row * 3 + c] * sg * sg_neg);
        }
      }
      consumers_barrier();
      for (int idx = tid; idx < 3 * ldv; idx += kConsumers) {
        const int k = idx / 3, c = idx % 3;
        float a = 0.f;
        for (int r = 0; r < kRows; ++r) a = fmaf(ld_bf16(act, r, k), gr[r * 3 + c], a);
        atomicAdd(dW + G.w_rgb + idx, a);
      }
      if (tid < 3) {
        float a = 0.f;
        for (int r = 0; r < kRows; ++r) a += gr[r * 3 + tid];
        atomicAdd(dB + G.b_rgb + tid, a);
      }
      // d(view output), masked by the view output, into dz (own rows).
      for (int idx = t; idx < 64 * nv; idx += 128) {
        const int r = g * 64 + (idx & 63), k = idx >> 6;
        float v = 0.f;
        if (ld_bf16(act, r, k) > 0.f) {
          v = gr[r * 3] * w_rgb[k * 3];
          v = fmaf(gr[r * 3 + 1], w_rgb[k * 3 + 1], v);
          v = fmaf(gr[r * 3 + 2], w_rgb[k * 3 + 2], v);
        }
        st_bf16(dz, r, k, v);
      }
      fence_async_smem();
      consumers_barrier();   // dz whole; every read of the view output done
      rows_in(act, slot(depth), nw, g, t);   // the bottleneck output
      fence_async_smem();
      consumers_barrier();
      int turn = 0;
      B::dw_segment(s_act, ldw, s_dz, npv, ldv, dW + G.w_view, turn, g);
      B::dw_segment(s_ed, kEncD, s_dz, npv, ldv, dW + G.w_view_dir, turn, g);
      B::add_db(dz, ldv, dB + G.b_view);
      consumers_barrier();   // every read of dz before its rows are overwritten
      if (want_dx) {
        din_encode(q, a_dz, nv, de, kEncD, false, g);
        wg_barrier(g);
        if (t < 64 && in) {
#pragma unroll
          for (int c = 0; c < 3; ++c) ddirs[s * 3 + c] = encode_vjp(de, kDeCols, row, c, d[c], kDBands);
        }
      }
      // d(bottleneck), no activation; then, from the bottleneck's input
      // h_last, its dW and d(h_last) with the sigma head's part.
      din_any(npw, q, a_dz, nv, dz, nullptr, nullptr, nullptr, ldw, g);
      fence_async_smem();
      consumers_barrier();
      rows_in(act, slot(depth - 1), nw, g, t);
      fence_async_smem();
      consumers_barrier();
      turn = 0;
      B::dw_segment(s_act, ldw, s_dz, npw, ldw, dW + G.w_bneck, turn, g);
      B::add_db(dz, ldw, dB + G.b_bneck);
      consumers_barrier();
      din_any(npw, q, a_dz, nw, dz, act, gs, w_alpha, ldw, g);
    } else {
      // Sigma head only: d(h_last) = round(gs w_alpha^T masked by h_last).
      for (int idx = t; idx < 64 * nw; idx += 128) {
        const int r = g * 64 + (idx & 63), k = idx >> 6;
        const float v = k < ldw ? gs[r] * w_alpha[k] : 0.f;
        st_bf16(dz, r, k, ld_bf16(act, r, k) > 0.f ? v : 0.f);
      }
      if (want_dx && t < 64 && in) {
#pragma unroll
        for (int c = 0; c < 3; ++c) ddirs[s * 3 + c] = 0.f;
      }
    }
    fence_async_smem();
    consumers_barrier();

    // Trunk, from the last layer down to layer 1; d(point encode) sums in
    // the workspace.
    bool de_started = false;
    for (int i = depth - 1; i >= 1; --i) {
      rows_in(act, slot(i - 1), nw, g, t);
      fence_async_smem();
      consumers_barrier();
      const bool skip = L.w_skip[i] >= 0;
      int turn = 0;
      B::dw_segment(s_act, ldw, s_dz, npw, ldw, dW + G.w_dense[i], turn, g);
      if (skip) B::dw_segment(s_ex, kEncX, s_dz, npw, ldw, dW + G.w_skip[i], turn, g);
      B::add_db(dz, ldw, dB + G.b_dense[i]);
      consumers_barrier();
      if (want_dx && skip) {
        din_encode(q, a_dz, nw, de, kEncX, de_started, g);
        de_started = true;
      }
      din_any(npw, q, a_dz, nw, dz, act, nullptr, nullptr, ldw, g);
      fence_async_smem();
      consumers_barrier();
    }
    // Layer 0: input the point encode.
    {
      int turn = 0;
      B::dw_segment(s_ex, kEncX, s_dz, npw, ldw, dW + G.w_dense[0], turn, g);
      B::add_db(dz, ldw, dB + G.b_dense[0]);
    }
    if (want_dx) {
      din_encode(q, a_dz, nw, de, kEncX, de_started, g);
      wg_barrier(g);
      if (t < 64 && in) {
#pragma unroll
        for (int c = 0; c < 3; ++c) dpts[s * 3 + c] = encode_vjp(de, kDeCols, row, c, p[c], kXBands);
      }
    }
    consumers_barrier();   // before the next tile's encodes and cotangents
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* g_rgb, const float* g_sigma, const __nv_bfloat16* w,
                   const float* bias, const Layout& L, const Layout& G, uint8_t* ws,
                   float* partials, long long n_w, long long n_b, int grid, float* dweights,
                   float* dbiases, float* dpts, float* ddirs, cudaStream_t stream) {
  return B::launch(fused_mlp_bwd_bf16_kernel<kSigmaOnly>, kSmemBytes, pts, dirs, n, dir_div,
                   g_rgb, g_sigma, w, bias, L, G, ws, partials, n_w, n_b, grid, dweights,
                   dbiases, dpts, ddirs, stream);
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; g_rgb (n, 3) and g_sigma (n,) f32 cotangents; weights_tc
// (bf16, 16-byte aligned) and biases (f32) as pack_params writes them for
// the tensor-core forward, with layout_tc, and layout: the pack's f32-order
// table (PackedMLP.layout), whose weight offsets place the gradients; ws:
// grid * 128 * ((depth + 1) * nw + 128) bf16 elements, nw = ldw rounded up
// to 64, 16-byte aligned; partials: grid * (n_w + n_b) f32, zeroed;
// dweights (n_w) and dbiases (n_b) f32 outputs; dpts and ddirs (n, 3) f32
// outputs (per sample), or both null for no input gradients. 1 <= grid.
// Returns a cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_backward_bf16(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights_tc, const void* biases, const long long* layout_tc,
    const long long* layout, int layout_len, int ldw, int ldv, int depth, int sigma_only,
    void* ws, void* partials, long long n_w, long long n_b, int grid, void* dweights,
    void* dbiases, void* dpts, void* ddirs, int device, void* stream) {
  Layout L, G;
  if (!parse_layout(layout_tc, layout_len, ldw, ldv, depth, &L) ||
      !parse_layout(layout, layout_len, ldw, ldv, depth, &G) || dir_div < 1 || n < 1 ||
      grid < 1 || n_w < 1 || n_b < 1 || (dpts == nullptr) != (ddirs == nullptr) ||
      reinterpret_cast<uintptr_t>(weights_tc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 2 * kMaxDepth + 5; ++i) {   // the weight segments
    const bool needed = i < depth || i >= 2 * kMaxDepth;
    // Segments start on 16-byte boundaries, as the bulk copies need.
    if ((needed && layout_tc[i] < 0) || (layout_tc[i] >= 0 && layout_tc[i] % 8 != 0) ||
        (needed && layout[i] < 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* gr = static_cast<const float*>(g_rgb);
  const float* gsg = static_cast<const float*>(g_sigma);
  const auto* w = static_cast<const __nv_bfloat16*>(weights_tc);
  const float* b = static_cast<const float*>(biases);
  auto* wsb = static_cast<uint8_t*>(ws);
  float* part = static_cast<float*>(partials);
  float* dw = static_cast<float*>(dweights);
  float* db = static_cast<float*>(dbiases);
  float* dp = static_cast<float*>(dpts);
  float* dd = static_cast<float*>(ddirs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true>(p, d, n, dir_div, gr, gsg, w, b, L, G, wsb, part, n_w, n_b, grid,
                                  dw, db, dp, dd, s)
                   : launch<false>(p, d, n, dir_div, gr, gsg, w, b, L, G, wsb, part, n_w, n_b,
                                   grid, dw, db, dp, dd, s);
  return static_cast<int>(err);
}
