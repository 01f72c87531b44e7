// Fused NeRF MLP backward in bf16 on Hopper's tensor cores (sm_90a) for
// wide or deep networks, K2's bf16 mode beyond the narrow envelope: trunk
// and view widths up to 512, up to 32 dense layers (fused_mlp_wide.cuh's
// tables). Per tile of 64 samples: recompute the forward, backpropagate
// through the rgb head, the view layer, the bottleneck, the sigma head and
// the trunk with its skip layer, and sum every layer's weight and bias
// gradient over the samples; with input gradients requested, also
// d(points) and d(dirs) through the encode.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t (:663, the
// Pallas call at :675) for dtype="bfloat16" where the narrow kernel
// (fused_mlp_bwd_bf16.cu: widths up to 256, depth up to 16) stops.
// Numerics, the JAX kernel's and the narrow kernel's: bf16 weights,
// activations and encodes; each layer's output gradient rounded to bf16
// after its ReLU mask (the heads' gradients after the sigmoid and ReLU
// derivatives); dW, db and the encode gradient accumulated in f32.
//
// The recompute is the wide bf16 forward itself: fused_mlp_wide_tc.cuh's
// encode_tile and wide_layer, and f32tc::head_sum for the heads, on the
// same pack (PackedMLP.weights_tc of a wide pack) in the same chunks, so
// its activations and ReLU masks are bit for bit those of K1's wide bf16
// forward, the ones that made the loss.
// The dW products, their reductions, the bias sums and the launch are
// fused_mlp_bwd_bf16.cuh's, shared with the narrow kernel at 128-sample
// tiles.
//
// Why not the narrow kernel at 512: it gives each consumer warpgroup 64 of
// a tile's 128 rows and all of a layer's N, so its activation and gradient
// buffers are 128 x kMaxWidth bf16 each, 256 KB at width 512 before a
// ring, and a warpgroup would need eight 64-column accumulators (256
// registers a thread). This kernel takes the wide forward's layout
// instead: 64-sample tiles, and the two consumer warpgroups on the two
// halves of each product's N. Roles: a producer warpgroup bulk-copies
// every weight chunk the tile needs, in the consumers' order, onto a ring
// of 2 stages of 32 KB (32 K-rows a chunk above width 256, 64 at or below);
// three kinds of product, all wgmma from shared memory:
// - the recompute, x W: A the tile's 64 rows (K-major), B a ring chunk, N
//   split between the warpgroups (wide_layer);
// - the input gradients, dZ W^T: A the tile's 64 rows of dZ, B the same
//   ring chunks read transposed (MN-major): a chunk of 64 input rows of a
//   segment gives one 64-column piece of dZ W^T (m64n64k16), a chunk of 32
//   rows half a piece (m64n32k16); warpgroup g takes its Share of the
//   pieces and walks past the other's chunks;
// - dW = H^T dZ over the tile's 64 samples: A = H and B = dZ both read
//   transposed from the activation and gradient buffers, in blocks of 64
//   input features x up to four 64-column pieces of output, taken in turn
//   by the two warpgroups (a block has one owner in every tile).
// Per tile the recompute writes each trunk output and the bottleneck
// output to the CTA's workspace (the buffer's own image); the backward
// reads each back once, as the dW products' H and the ReLU mask.
//
// What bounds it on the H100: operations, three forwards of bf16 products
// at 989 TFLOP/s (at 512/256/8, 3 x 4.60 MFLOP a fine sample); the pack
// streams from L2 twice a 64-sample tile (recompute and W dz).
// Determinism: each partial entry belongs to one thread, which adds tile
// after tile in program order, and a second launch sums the partials in a
// fixed order (reduce_partials).
// Shared memory (218,144 bytes): the ring (64 KB), the activation and the
// gradient buffers (64 x 512 bf16, 64 KB each), the dir and point encodes
// (4 and 8 KB), the head weights (8 KB), the head gradients (1 KB), the
// barriers. The encode gradients go to the workspace in f32.

#include "fused_mlp_bwd_bf16.cuh"
#include "fused_mlp_wide_tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::bwd16;
using namespace nerf::wide;
using f32tc::head_row;
using f32tc::head_sum;

constexpr int kStages = 2;
constexpr int kBufBytes = kBlock * kWideMaxWidth * 2;
constexpr int kActOff = kStages * kStageBytesW;           // ring first
constexpr int kDzOff = kActOff + kBufBytes;
// The dir encode before the point encode: a 64-row dW block of the dir
// encode (32 columns) reads its other 32 rows from the point encode, into
// accumulator rows that are never stored.
constexpr int kEncDOff = kDzOff + kBufBytes;
constexpr int kEncXOff = kEncDOff + kBlock * kEncD * 2;
constexpr int kHeadOff = kEncXOff + kBlock * kEncX * 2;    // alpha [512], rgb [512][3] f32
constexpr int kGradOff = kHeadOff + 4 * kWideMaxWidth * 4; // gs [64], gr [64][3] f32
constexpr int kBarOff = kGradOff + 4 * kBlock * 4;         // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

using Ring = WidePipe<kStages>;
using B = BwdBf16<kBlock>;

// d (64 x 32, f32: the half kH of a 64-column accumulator) = a (64 x 16,
// bf16) * b (16 x 32, bf16) + (scale_d ? d : 0); kTa, kTb: a, b read
// MN-major. Accumulator element i of the half sits where element 16 kH + i
// of an m64n64 accumulator does (column 32 kH + 8 j + 2 (lane % 4) + e).
template <int kTa, int kTb, int kH>
__device__ __forceinline__ void wgmma_32(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  constexpr int o = 16 * kH;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),
        "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),
        "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]),
        "+f"(d[o + 15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTa), "n"(kTb));
}

// The 64-row buffer of n columns, to and from its image in the workspace
// (n / 8 runs of 1 KB), by the 256 consumer threads.
__device__ __forceinline__ void buf_out(const uint8_t* buf, uint8_t* ws, int n) {
  for (int i = threadIdx.x; i < n * 8; i += kConsumers) {
    __stcg(reinterpret_cast<uint4*>(ws) + i, reinterpret_cast<const uint4*>(buf)[i]);
  }
}

__device__ __forceinline__ void buf_in(uint8_t* buf, const uint8_t* ws, int n) {
  for (int i = threadIdx.x; i < n * 8; i += kConsumers) {
    reinterpret_cast<uint4*>(buf)[i] = __ldcg(reinterpret_cast<const uint4*>(ws) + i);
  }
}

// A chunk this warpgroup does not multiply: acquired and released in turn.
__device__ __forceinline__ void pass_chunk(Ring& q) {
  q.acquire();
  wgmma_commit();
  q.advance();
}

// acc = dZ (a: the tile's 64 rows, n columns) times the transpose of the
// next chunks of a segment of k_in input rows and n output columns, for
// this warpgroup's NP 64-column pieces of the result from piece p0 (input
// rows 64 p0 ..); the chunks of the other pieces pass by.
template <int NP>
__device__ __forceinline__ void din_mma(float (&acc)[4][32], Ring& q, uint32_t a, int k_in, int n,
                                        int p0) {
  const int ck = chunk_k(n);
  const int chunks = (k_in + ck - 1) / ck;
  const int c0 = min(chunks, p0 * kPiece / ck), c1 = min(chunks, (p0 + NP) * kPiece / ck);
  fence_acc<NP>(acc);
  for (int c = 0; c < c0; ++c) pass_chunk(q);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = (p0 + p) * kPiece + 32 * h;   // the chunk's first input row
      if ((h == 1 && ck == 64) || r0 >= k_in) continue;
      const uint32_t b = q.acquire();
      const bool full = min(ck, k_in - r0) == 64;
#pragma unroll 1
      for (int s = 0; s < n; s += 16) {
        const uint64_t da = desc(a + (s >> 3) * 1024, 1024, 128);
        const uint64_t db = desc(b + (s >> 3) * 128, 128, n * 16);
        if (full) {
          wgmma_64<0, 1>(acc[p], da, db, s > 0 ? 1 : 0);
        } else if (h == 0) {
          wgmma_32<0, 1, 0>(acc[p], da, db, s > 0 ? 1 : 0);
        } else {
          wgmma_32<0, 1, 1>(acc[p], da, db, s > 0 ? 1 : 0);
        }
      }
      wgmma_commit();
      q.advance();
    }
  }
  for (int c = c1; c < chunks; ++c) pass_chunk(q);
  wgmma_wait<0>();
  fence_acc<NP>(acc);
  q.release();
}

// One input-gradient layer: out (bf16; this warpgroup's NP pieces from
// p0) = round((dZ W^T [+ gs w_alpha^T]) masked by mask > 0); mask and
// w_alpha (ldw entries) may be null. dZ may be `out` itself: both
// warpgroups have read all of it before either writes.
template <int NP>
__device__ __forceinline__ void din_layer(Ring& q, uint32_t a, int k_in, int n, int p0,
                                          uint8_t* out, const uint8_t* mask, const float* gs,
                                          const float* w_alpha, int ldw) {
  float acc[4][32];
  din_mma<NP>(acc, q, a, k_in, n, p0);
  consumers_barrier();
  const int r0 = frag_row(), c0 = frag_col();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (p0 + p) * kPiece + 8 * j + c0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        float v0 = acc[p][4 * j + 2 * r], v1 = acc[p][4 * j + 2 * r + 1];
        if (w_alpha != nullptr && col < ldw) {
          v0 = v0 + gs[row] * w_alpha[col];
          v1 = v1 + gs[row] * w_alpha[col + 1];
        }
        if (mask != nullptr) {
          if (!(ld_act(mask, row, col) > 0.f)) v0 = 0.f;
          if (!(ld_act(mask, row, col + 1) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + p_off(row, col)) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

__device__ __forceinline__ void din_any(const Share& sh, Ring& q, uint32_t a, int k_in, int n,
                                        uint8_t* out, const uint8_t* mask, const float* gs,
                                        const float* w_alpha, int ldw) {
  switch (sh.count) {
    case 0: din_layer<0>(q, a, k_in, n, sh.p0, out, mask, gs, w_alpha, ldw); break;
    case 1: din_layer<1>(q, a, k_in, n, sh.p0, out, mask, gs, w_alpha, ldw); break;
    case 2: din_layer<2>(q, a, k_in, n, sh.p0, out, mask, gs, w_alpha, ldw); break;
    case 3: din_layer<3>(q, a, k_in, n, sh.p0, out, mask, gs, w_alpha, ldw); break;
    default: din_layer<4>(q, a, k_in, n, sh.p0, out, mask, gs, w_alpha, ldw); break;
  }
}

// An encode gradient (k_in = 64 or 32 input rows, one piece, warpgroup 0's):
// de (f32, kDeCols a row, the first k_in columns) = or += dZ times the
// transpose of the segment's next chunks, unrounded. Warpgroup 1 passes
// the chunks by.
__device__ __forceinline__ void din_encode(Ring& q, uint32_t a, int k_in, int n, float* de,
                                           bool add, int g) {
  float acc[4][32];
  if (g != 0) {
    din_mma<0>(acc, q, a, k_in, n, 1);
    return;
  }
  din_mma<1>(acc, q, a, k_in, n, 0);
  const int r0 = frag_row(), c0 = frag_col();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= k_in) continue;
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
fused_mlp_wide_bwd_bf16_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                               long long n, long long dir_div, const float* __restrict__ g_rgb,
                               const float* __restrict__ g_sigma,
                               const __nv_bfloat16* __restrict__ w,
                               const float* __restrict__ bias, const WideLayout L,
                               const WideLayout G, const int nw, const int nv, uint8_t* ws_all,
                               long long ws_bytes, float* partials, long long n_w,
                               long long part_stride, float* __restrict__ dpts,
                               float* __restrict__ ddirs) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* act = smem + kActOff;
  uint8_t* dz = smem + kDzOff;
  uint8_t* enc_x = smem + kEncXOff;
  uint8_t* enc_d = smem + kEncDOff;
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kWideMaxWidth;
  float* gs = reinterpret_cast<float*>(smem + kGradOff);   // sigma cotangent, then d(pre-ReLU)
  float* gr = gs + kBlock;                                 // rgb cotangent, then d(pre-sigmoid)
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kBlock - 1) / kBlock;
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
    WideProducer<kStages> pr{smem_u32(smem), bars, 0, 0u};
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

  // Consumers: warpgroup g on its Share of every product's pieces. Every
  // branch below is uniform across a warp, or guards stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  const int ldw = L.ldw, ldv = L.ldv;
  const int npw = nw / kPiece, npv = nv / kPiece;
  const Share sw(npw, g), sv(npv, g);
  Ring q{smem_u32(smem), bars, 0, 0u, -1};
  const uint32_t s_act = smem_u32(act), s_dz = smem_u32(dz);
  const uint32_t s_ex = smem_u32(enc_x), s_ed = smem_u32(enc_d);
  const int hrow = head_row();
  auto row = [&](int i) { return ld_act(act, hrow, i); };
  float* dW = partials + static_cast<long long>(blockIdx.x) * part_stride;
  float* dB = dW + n_w;
  uint8_t* ws = ws_all + static_cast<long long>(blockIdx.x) * ws_bytes;
  auto slot = [&](int i) { return ws + static_cast<long long>(i) * kBlock * nw * 2; };
  float* de = reinterpret_cast<float*>(slot(depth + 1));

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Inputs: the encode (K1's), the cotangents; rows past n zeros.
    encode_tile(pts, dirs, n, dir_div, tile, enc_x, enc_d);
    if (tid < kBlock) {
      const long long s = tile * kBlock + tid;
      const bool in = s < n;
      gs[tid] = in ? g_sigma[s] : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) gr[tid * 3 + c] = in ? g_rgb[s * 3 + c] : 0.f;
    }
    fence_async_smem();
    consumers_barrier();

    // Recompute: K1's trunk; each output also to its workspace slot.
    wide_layer_any(sw.count, q, s_ex, kEncX, 0, 0, nw, sw.p0, bias + L.b_dense[0], ldw, true,
                   act);
    buf_out(act, slot(0), nw);
    for (int i = 1; i < depth; ++i) {
      if (L.w_skip[i] >= 0) {
        wide_layer_any(sw.count, q, s_ex, kEncX, s_act, nw, nw, sw.p0, bias + L.b_dense[i], ldw,
                       true, act);
      } else {
        wide_layer_any(sw.count, q, s_act, nw, 0, 0, nw, sw.p0, bias + L.b_dense[i], ldw, true,
                       act);
      }
      buf_out(act, slot(i), nw);
    }
    // Sigma head, K1's sum: gs becomes d(pre-ReLU sigma); its dW and db.
    {
      const float pre = head_sum(row, ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha);
      if (!(tid & 3)) gs[hrow] = round_act<true>(pre > 0.f ? gs[hrow] : 0.f);
    }
    consumers_barrier();
    for (int k = tid; k < ldw; k += kConsumers) {
      float a = 0.f;
      for (int r = 0; r < kBlock; ++r) a = fmaf(ld_act(act, r, k), gs[r], a);
      atomicAdd(dW + G.w_alpha + k, a);
    }
    if (tid == 0) {
      float a = 0.f;
      for (int r = 0; r < kBlock; ++r) a += gs[r];
      atomicAdd(dB + G.b_alpha, a);
    }
    consumers_barrier();   // every read of h_last before the bottleneck overwrites it

    if (!kSigmaOnly) {
      // K1's bottleneck (to the workspace) and view layer, then its rgb
      // head: gr becomes d(pre-sigmoid rgb), sigmoid' = sg (1 - sg) with
      // 1 - sg as sigmoid(-pre).
      wide_layer_any(sw.count, q, s_act, nw, 0, 0, nw, sw.p0, bias + L.b_bneck, ldw, false, act);
      buf_out(act, slot(depth), nw);
      wide_layer_any(sv.count, q, s_act, nw, s_ed, kEncD, nv, sv.p0, bias + L.b_view, ldv, true,
                     act);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pre = head_sum(row, ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
        const float sg = 1.f / (1.f + expf(-pre));
        const float sg_neg = 1.f / (1.f + expf(pre));
        if (!(tid & 3)) gr[hrow * 3 + c] = round_act<true>(gr[hrow * 3 + c] * sg * sg_neg);
      }
      consumers_barrier();
      for (int idx = tid; idx < 3 * ldv; idx += kConsumers) {
        const int k = idx / 3, c = idx % 3;
        float a = 0.f;
        for (int r = 0; r < kBlock; ++r) a = fmaf(ld_act(act, r, k), gr[r * 3 + c], a);
        atomicAdd(dW + G.w_rgb + idx, a);
      }
      if (tid < 3) {
        float a = 0.f;
        for (int r = 0; r < kBlock; ++r) a += gr[r * 3 + tid];
        atomicAdd(dB + G.b_rgb + tid, a);
      }
      // d(view output), masked by the view output, into dz.
      for (int idx = tid; idx < kBlock * nv; idx += kConsumers) {
        const int r = idx & (kBlock - 1), k = idx >> 6;
        float v = 0.f;
        if (ld_act(act, r, k) > 0.f) {
          v = gr[r * 3] * w_rgb[k * 3];
          v = fmaf(gr[r * 3 + 1], w_rgb[k * 3 + 1], v);
          v = fmaf(gr[r * 3 + 2], w_rgb[k * 3 + 2], v);
        }
        *reinterpret_cast<__nv_bfloat16*>(dz + p_off(r, k)) = __float2bfloat16_rn(v);
      }
      fence_async_smem();
      consumers_barrier();   // dz whole; every read of the view output done
      buf_in(act, slot(depth), nw);   // the bottleneck output
      fence_async_smem();
      consumers_barrier();
      int turn = 0;
      B::dw_segment(s_act, ldw, s_dz, npv, ldv, dW + G.w_view, turn, g);
      B::dw_segment(s_ed, kEncD, s_dz, npv, ldv, dW + G.w_view_dir, turn, g);
      B::add_db(dz, ldv, dB + G.b_view);
      consumers_barrier();   // every read of dz before it is overwritten
      if (want_dx) {
        din_encode(q, s_dz, kEncD, nv, de, false, g);
        consumers_barrier();
        const long long s = tile * kBlock + tid;
        if (tid < kBlock && s < n) {
          const long long r = s / dir_div;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            ddirs[s * 3 + c] = encode_vjp(de, kDeCols, tid, c, dirs[r * 3 + c], kDBands);
          }
        }
      }
      // d(bottleneck), no activation; then, from the bottleneck's input
      // h_last, its dW and d(h_last) with the sigma head's part.
      din_any(sw, q, s_dz, nw, nv, dz, nullptr, nullptr, nullptr, ldw);
      fence_async_smem();
      consumers_barrier();
      buf_in(act, slot(depth - 1), nw);
      fence_async_smem();
      consumers_barrier();
      turn = 0;
      B::dw_segment(s_act, ldw, s_dz, npw, ldw, dW + G.w_bneck, turn, g);
      B::add_db(dz, ldw, dB + G.b_bneck);
      consumers_barrier();
      din_any(sw, q, s_dz, nw, nw, dz, act, gs, w_alpha, ldw);
    } else {
      // Sigma head only: d(h_last) = round(gs w_alpha^T masked by h_last).
      for (int idx = tid; idx < kBlock * nw; idx += kConsumers) {
        const int r = idx & (kBlock - 1), k = idx >> 6;
        const float v = k < ldw ? gs[r] * w_alpha[k] : 0.f;
        *reinterpret_cast<__nv_bfloat16*>(dz + p_off(r, k)) =
            __float2bfloat16_rn(ld_act(act, r, k) > 0.f ? v : 0.f);
      }
      const long long s = tile * kBlock + tid;
      if (want_dx && tid < kBlock && s < n) {
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
      buf_in(act, slot(i - 1), nw);
      fence_async_smem();
      consumers_barrier();
      const bool skip = L.w_skip[i] >= 0;
      int turn = 0;
      B::dw_segment(s_act, ldw, s_dz, npw, ldw, dW + G.w_dense[i], turn, g);
      if (skip) B::dw_segment(s_ex, kEncX, s_dz, npw, ldw, dW + G.w_skip[i], turn, g);
      B::add_db(dz, ldw, dB + G.b_dense[i]);
      consumers_barrier();
      if (want_dx && skip) {
        din_encode(q, s_dz, kEncX, nw, de, de_started, g);
        de_started = true;
      }
      din_any(sw, q, s_dz, nw, nw, dz, act, nullptr, nullptr, ldw);
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
      din_encode(q, s_dz, kEncX, nw, de, de_started, g);
      consumers_barrier();
      const long long s = tile * kBlock + tid;
      if (tid < kBlock && s < n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dpts[s * 3 + c] = encode_vjp(de, kDeCols, tid, c, pts[s * 3 + c], kXBands);
        }
      }
    }
    consumers_barrier();   // before the next tile's encodes and cotangents
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* g_rgb, const float* g_sigma, const __nv_bfloat16* w,
                   const float* bias, const WideLayout& L, const WideLayout& G, uint8_t* ws,
                   float* partials, long long n_w, long long n_b, int grid, float* dweights,
                   float* dbiases, float* dpts, float* ddirs, cudaStream_t stream) {
  return B::launch(fused_mlp_wide_bwd_bf16_kernel<kSigmaOnly>, kSmemBytes, pts, dirs, n,
                   dir_div, g_rgb, g_sigma, w, bias, L, G, ws, partials, n_w, n_b, grid,
                   dweights, dbiases, dpts, ddirs, stream);
}

}  // namespace

// nerf_fused_mlp_backward_bf16's contract for a wide pack: weights_tc and
// layout_tc of a wide pack (kWideLayoutLen entries), layout its f32-order
// table (PackedMLP.layout, the same length), whose weight offsets place
// the gradients; ws: grid * (64 * (depth + 1) * nw * 2 + 64 * 64 * 4)
// bytes, nw = ldw rounded up to 64, 16-byte aligned. Returns a
// cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_wide_backward_bf16(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights_tc, const void* biases, const long long* layout_tc,
    const long long* layout, int layout_len, int ldw, int ldv, int depth, int sigma_only,
    void* ws, void* partials, long long n_w, long long n_b, int grid, void* dweights,
    void* dbiases, void* dpts, void* ddirs, int device, void* stream) {
  WideLayout L, G;
  if (!parse_wide_layout(layout_tc, layout_len, ldw, ldv, depth, &L) ||
      !parse_wide_layout(layout, layout_len, ldw, ldv, depth, &G) || dir_div < 1 || n < 1 ||
      grid < 1 || n_w < 1 || n_b < 1 || (dpts == nullptr) != (ddirs == nullptr) ||
      reinterpret_cast<uintptr_t>(weights_tc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
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
