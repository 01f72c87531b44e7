// W8A8 NeRF MLP forward on Hopper's tensor cores (sm_90a) for wide or deep
// networks: trunk and view widths up to 512, up to 32 dense layers. The
// positional encode, then every dense layer as int8 codes x int8 codes ->
// int32 on s8 wgmma, dequantized and requantized per sample, in one
// persistent kernel; activations never leave the SM.
//
// Replaces tools/pallas_int8_probe.py::main -> make -> go (the Pallas call
// at :66: a chain of int8 x int8 -> int32 products with a per-sample
// absmax requantize) where the narrow kernel (int8_mlp_tc.cu: widths up to
// 256, depth up to 16) stops, as K1's wide pair does for K1. It computes
// what int8_mlp_tc.cu's header specifies, with the same per-layer
// arithmetic and the same device code (int8_mlp_tc.cuh): for each dense
// layer and sample, with x the layer's f32 input row (the skip layer's
// [h0, h] and the view layer's [bottleneck, dirs_enc] included),
//   sx   = max(max_j |x_j| / 127, 1e-12)               (__fdiv_rn)
//   q_j  = clamp(rint(x_j / sx), -127, 127)            (code_bits: half to even)
//   acc  = sum_j q_j * wq[j, n]                        (int32, exact)
//   y_n  = ((float)acc * sx) * sw[n] + b[n]            (three rounded ops)
// then ReLU, nothing (bottleneck) or sigmoid (rgb); the heads are integer
// dot products. The sums are exact in int32 and equal the plain version's
// f32 sums: |acc| <= 127^2 K < 2^24 while K <= 1040, and the widest K here
// is the skip layer's 64 + 512 = 576 (the view layer's 512 + 32). So the
// codes, the accumulators and sigma equal the plain version's bit for bit;
// rgb differs only where expf differs from torch's sigmoid.
//
// What bounds it on the H100: operations. A fine sample of a 512/256/8
// network costs 4.602 M int8 operations (multiply-adds counted as two)
// against 24 bytes of input and 16 of output, so a fine call (8192 x 192)
// is bounded at 3.657 ms by the 1,979 TOP/s int8 tensor-core peak.
//
// Why the narrow kernel's layout does not stretch: each of its consumer
// warpgroups owns all N columns of a 64-row tile of its own, 128 int32
// accumulators a thread at width 256 and 256 at 512, over the 240
// registers setmaxnreg can give; its ring's 128-row stage would be 64 KB
// and its two code planes a warpgroup 32 KB each. The design here:
// - a persistent grid, one CTA of 384 threads an SM, one 64-sample tile
//   (one wgmma M) at a time: a producer warpgroup, whose registers
//   setmaxnreg hands to the consumers (240 each, the producer 24), and two
//   consumer warpgroups that split each layer's N: warpgroup g on pieces
//   [p0, p0 + count) of the 64-column pieces (the first half rounded up,
//   then the rest), so each keeps at most four pieces, 128 int32
//   accumulators a thread, at width 512; a warpgroup without pieces (width
//   64) still walks and releases every chunk;
// - one producer thread copies each layer's codes (the pack of
//   int8_mlp.py::int8_tile, where every 16 K-rows are one contiguous run of
//   16 N bytes), 64 K-rows a chunk above N = 256 and 128 at or below (32 KB
//   at most), with one cp.async.bulk onto an mbarrier into a ring of 4
//   stages that both warpgroups read, running ahead across layers and
//   tiles (tc::Pipe: a chunk goes back to the ring when the next one's
//   wgmmas are issued and its own have retired);
// - the requantize needs the whole row's absmax: each warpgroup takes its
//   half-row max by quad shuffles in registers (combined with the encode's
//   absmax before a skip layer, with the dir encode's before the view
//   layer), writes it to shared memory, meets the other at a barrier of
//   the 256 consumer threads and reads the other half's. A max is exact
//   and does not depend on order, so the row scale, and every code, is the
//   plain version's;
// - that barrier also comes after every wgmma of the layer has retired in
//   both warpgroups (each waits for its own before it), so the layer's
//   codes overwrite its input codes in one 64 x 512 plane: no second plane,
//   and no write-after-read hazard at any depth. The encode's code plane is
//   rewritten for a skip layer, and the dir encode's for the view layer,
//   behind the same barrier; a second barrier after the codes (and a proxy
//   fence) makes the whole plane visible to the next layer's wgmmas;
// - the heads (alpha width -> 1, rgb v_width -> 3): each thread's integer
//   dot products over its own columns of the plane, summed over its quad by
//   shuffles, then over the two warpgroups through shared memory (integer
//   sums: exact in any order);
// - the encode (64 x 96 f32, kept in shared memory because the skip and
//   view layers requantize it at their own row scales) runs on the first
//   warpgroup, two threads a row, as the narrow kernel runs it.
// Shared memory: the ring 128 KB, the code plane 32 KB, the encode's 4 KB
// and the dir encode's 2 KB code planes, the 25 KB f32 encode, the per-row
// scales and maxima, the heads' partial sums and codes: 196 KB. Widths pad
// to multiples of 64; padding codes, scales and biases are zero, so padding
// outputs dequantize to 0 and never raise an absmax.
//
// Layout contract with pack_int8_params: int8_mlp_tc.cu's segments and
// slots; the int64 layout array holds, in this order:
//   [0, 32)  dense layer i's byte offset        [32, 64) its scale/bias slot
//   [64, 96) 1 if dense layer i takes the encode rows first (skip), else 0
//   96 alpha, 97 bottleneck, 98 viewdirs, 99 rgb byte offsets
//   100 alpha, 101 bottleneck, 102 viewdirs, 103 rgb scale/bias slots

#include "int8_mlp_tc.cuh"

namespace {

using namespace nerf::int8;

using nerf::tc::bulk_copy;
using nerf::tc::desc;
using nerf::tc::fence_async_smem;
using nerf::tc::mbar_expect_tx;
using nerf::tc::mbar_init;
using nerf::tc::mbar_wait;
using nerf::tc::reg_alloc;
using nerf::tc::reg_dealloc;
using nerf::tc::smem_u32;
using nerf::tc::wgmma_commit;
using nerf::tc::wgmma_wait;

constexpr int kMaxDepth = 32;
constexpr int kLayoutLen = 3 * kMaxDepth + 8;
constexpr int kMaxWidth = 512;
constexpr int kStages = 4;
constexpr int kStageBytes = 32768;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared memory, in bytes from the dynamic base.
constexpr int kPlaneOff = kStages * kStageBytes;            // the tile's codes, 64 x 512
constexpr int kEOff = kPlaneOff + kRows * kMaxWidth;        // the encode's codes
constexpr int kDOff = kEOff + kRows * kEncX;                // the dir encode's codes
constexpr int kEncOff = kDOff + kRows * kEncD;              // the f32 encode
constexpr int kRowOff = kEncOff + kRows * kEncStride * 4;   // sx, ex, ed [kRows] f32
constexpr int kMaxOff = kRowOff + 3 * kRows * 4;            // half-row maxima [2][kRows] f32
constexpr int kSumOff = kMaxOff + 2 * kRows * 4;            // head sums [2][4][kRows] int32
constexpr int kHeadOff = kSumOff + 2 * 4 * kRows * 4;       // codes: alpha [512], rgb [3][512]
constexpr int kBarOff = kHeadOff + 4 * kMaxWidth;           // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

using Pipe = nerf::tc::Pipe<kStages, kStageBytes>;

// K rows a ring chunk of a segment nn columns wide holds (32 KB at most).
__device__ __forceinline__ int chunk_rows(int nn) { return nn > 256 ? 64 : 128; }

// The 256 consumer threads (named barrier 1).
__device__ __forceinline__ void consumers_barrier() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

struct QLayout {
  long long w_dense[kMaxDepth];
  long long sb_dense[kMaxDepth];
  int skip[kMaxDepth];
  long long w_alpha, w_bneck, w_view, w_rgb;
  long long sb_alpha, sb_bneck, sb_view, sb_rgb;
  int nw, nv, depth;
};

bool parse_layout(const long long* layout, int layout_len, int nw, int nv, int depth,
                  QLayout* L) {
  constexpr int D = kMaxDepth;
  if (layout_len != kLayoutLen || depth < 1 || depth > D || nw < kPiece || nw > kMaxWidth ||
      nw % kPiece != 0 || nv < kPiece || nv > kMaxWidth || nv % kPiece != 0) {
    return false;
  }
  for (int i = 0; i < D; ++i) {
    L->w_dense[i] = layout[i];
    L->sb_dense[i] = layout[D + i];
    L->skip[i] = static_cast<int>(layout[2 * D + i]);
    // The segments a launch reads start on 16-byte boundaries.
    if (i < depth && (layout[i] < 0 || layout[i] % 16 != 0)) return false;
  }
  for (int i = 3 * D; i < 3 * D + 4; ++i) {
    if (layout[i] < 0 || layout[i] % 16 != 0) return false;
  }
  L->w_alpha = layout[3 * D];
  L->w_bneck = layout[3 * D + 1];
  L->w_view = layout[3 * D + 2];
  L->w_rgb = layout[3 * D + 3];
  L->sb_alpha = layout[3 * D + 4];
  L->sb_bneck = layout[3 * D + 5];
  L->sb_view = layout[3 * D + 6];
  L->sb_rgb = layout[3 * D + 7];
  L->nw = nw;
  L->nv = nv;
  L->depth = depth;
  return L->skip[0] == 0;
}

// The producer's walk through the ring: copies segment chunks in the
// consumers' order, each stage once both consumer warpgroups released it.
struct Producer {
  uint32_t ring, bars;   // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)
  int stage;
  uint32_t phase;

  // The k rows of a segment of nn columns at byte off, in chunks of
  // chunk_rows(nn).
  __device__ __forceinline__ void emit(const int8_t* w, long long off, int k, int nn) {
    const int ck = chunk_rows(nn);
    for (int c = 0; c < k; c += ck) {
      const uint32_t bytes = static_cast<uint32_t>(min(ck, k - c) * nn);
      mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
      mbar_expect_tx(bars + 8 * stage, bytes);
      bulk_copy(ring + stage * kStageBytes, w + off + static_cast<long long>(c) * nn, bytes,
                bars + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
};

// This thread's two rows of the tile (r0 and r0 + 8, the rows of its
// accumulator fragment) and their scales.
struct Rows {
  int r0;
  Scale sx[2];   // the scale of the current layer's input row
};

// A warpgroup's share of a layer's 64-column pieces: [p0, p0 + count).
struct Share {
  int p0, count;
  __device__ Share(int pieces, int g) {
    const int first = (pieces + 1) / 2;
    p0 = g ? first : 0;
    count = g ? pieces - first : first;
  }
};

// The products of the tile's 64 rows of [a1 (k1 code columns); a2 (k2)]
// with this warpgroup's NP pieces from p0 of the next ring chunks (n
// columns in all) into acc. The first k-step (from a1: k1 >= 32)
// overwrites acc. With NP = 0 the chunks are walked and released only.
template <int NP>
__device__ __forceinline__ void products(int (&acc)[4][32], Pipe& q, uint32_t a1, int k1,
                                         uint32_t a2, int k2, int n, int p0) {
  fence_acc<NP>(acc);
  const int k = k1 + k2, ck = chunk_rows(n);
  const uint32_t bp = static_cast<uint32_t>(p0) * 1024;   // piece p0's first core matrix
  uint32_t b = q.acquire();
  if constexpr (NP > 0) {
    const uint64_t da = desc(a1, kRows * 16, 128);
#pragma unroll
    for (int p = 0; p < NP; ++p) wgmma_s8<0>(acc[p], da, desc(b + bp + p * 1024, n * 16, 128));
  }
  int c = 0, s = 32;
  while (true) {
    const int kc = min(ck, k - c);
    if constexpr (NP > 0) {
      for (; s < kc; s += 32) {
        const int kk = c + s;
        const uint32_t a =
            kk < k1 ? a1 + (kk >> 4) * (kRows * 16) : a2 + ((kk - k1) >> 4) * (kRows * 16);
        const uint64_t da = desc(a, kRows * 16, 128);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          wgmma_s8<1>(acc[p], da, desc(b + bp + p * 1024 + (s >> 4) * (n * 16), n * 16, 128));
        }
      }
    }
    wgmma_commit();
    q.advance();
    c += ck;
    if (c >= k) break;
    b = q.acquire();
    s = 0;
  }
  wgmma_wait<0>();
  fence_acc<NP>(acc);
  q.release();
}

// The codes of this thread's outputs (its NP pieces from p0), held in acc
// as f32 bits, at the row scales R.sx, into the plane out.
template <int NP>
__device__ __forceinline__ void codes(const int (&acc)[4][32], uint8_t* out, int p0,
                                      const Rows& R) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<uint16_t*>(out + plane_off(R.r0 + 8 * r,
                                                     (p0 + p) * kPiece + 8 * j + c0)) =
            static_cast<uint16_t>(code_pair(__int_as_float(acc[p][4 * j + 2 * r]),
                                            __int_as_float(acc[p][4 * j + 2 * r + 1]),
                                            R.sx[r]));
      }
    }
  }
}

// One layer for this warpgroup's pieces: the products, then the epilogue
// in registers: dequant, the floor lo (0 for a ReLU, -inf for none), the
// half-row absmax (starting from extra), exchanged with the other
// warpgroup's through xm at a barrier of both, the new row scale into
// R.sx, and the codes of the outputs at that scale into the plane out
// (which the layer's products may have read: every wgmma of both
// warpgroups has retired at the barrier). The epilogue's loops are
// branch-free, so that a thread's 128 independent chains interleave.
template <int NP>
__device__ __forceinline__ void layer(Pipe& q, uint32_t a1, int k1, uint32_t a2, int k2, int n,
                                      int p0, const float* __restrict__ ep, float lo,
                                      const float (&extra)[2], uint8_t* out, float* xm, int g,
                                      Rows& R) {
  int acc[4][32];
  products<NP>(acc, q, a1, k1, a2, k2, n, p0);

  // Accumulator element 4 j + 2 r + e of piece p sits at row R.r0 + 8 r
  // and column (p0 + p) * 64 + 8 j + 2 (lane % 4) + e.
  const int c0 = 2 * (threadIdx.x & 3);
  const float sx[2] = {R.sx[0].s, R.sx[1].s};
  float m[2] = {extra[0], extra[1]};
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (p0 + p) * kPiece + 8 * j + c0;
      const float4 v = __ldg(reinterpret_cast<const float4*>(ep + 2 * col));   // sw, sw, b, b
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float y0 = fmaxf(dequant(acc[p][4 * j + 2 * r], sx[r], v.x, v.z), lo);
        const float y1 = fmaxf(dequant(acc[p][4 * j + 2 * r + 1], sx[r], v.y, v.w), lo);
        m[r] = fmaxf(m[r], fmaxf(fabsf(y0), fabsf(y1)));
        acc[p][4 * j + 2 * r] = __float_as_int(y0);   // the outputs replace the sums
        acc[p][4 * j + 2 * r + 1] = __float_as_int(y1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xFFFFFFFFu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xFFFFFFFFu, m[r], 2));
  }
  if ((threadIdx.x & 3) == 0) {
    xm[g * kRows + R.r0] = m[0];
    xm[g * kRows + R.r0 + 8] = m[1];
  }
  consumers_barrier();   // both halves' maxima; every wgmma of the layer has retired
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    R.sx[r] = row_scale(fmaxf(m[r], xm[(g ^ 1) * kRows + R.r0 + 8 * r]));
  }
  codes<NP>(acc, out, p0, R);
}

// layer<NP> for a runtime NP in 0..4, inlined at each call site so that
// the accumulators stay in registers.
__device__ __forceinline__ void layer_any(int np, Pipe& q, uint32_t a1, int k1, uint32_t a2,
                                          int k2, int n, int p0, const float* __restrict__ ep,
                                          float lo, const float (&extra)[2], uint8_t* out,
                                          float* xm, int g, Rows& R) {
  switch (np) {
    case 0: layer<0>(q, a1, k1, a2, k2, n, p0, ep, lo, extra, out, xm, g, R); break;
    case 1: layer<1>(q, a1, k1, a2, k2, n, p0, ep, lo, extra, out, xm, g, R); break;
    case 2: layer<2>(q, a1, k1, a2, k2, n, p0, ep, lo, extra, out, xm, g, R); break;
    case 3: layer<3>(q, a1, k1, a2, k2, n, p0, ep, lo, extra, out, xm, g, R); break;
    default: layer<4>(q, a1, k1, a2, k2, n, p0, ep, lo, extra, out, xm, g, R); break;
  }
}

// The int32 dot products of this thread's two rows of the code plane
// (its own columns of [c_begin, c_end): c_begin + 2 (lane % 4) + 8 i and
// the next) with the first H rows of the heads' codes wh, summed over the
// quad: exact.
template <int H>
__device__ __forceinline__ void head_sums(const uint8_t* plane, int c_begin, int c_end,
                                          const int8_t* wh, const Rows& R, int (&hs)[2][3]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int h = 0; h < H; ++h) hs[r][h] = 0;
  }
  for (int col = c_begin + 2 * (threadIdx.x & 3); col < c_end; col += 8) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const char2 c2 = *reinterpret_cast<const char2*>(plane + plane_off(R.r0 + 8 * r, col));
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const char2 w2 = *reinterpret_cast<const char2*>(wh + h * kMaxWidth + col);
        hs[r][h] += c2.x * w2.x + c2.y * w2.y;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      hs[r][h] += __shfl_xor_sync(0xFFFFFFFFu, hs[r][h], 1);
      hs[r][h] += __shfl_xor_sync(0xFFFFFFFFu, hs[r][h], 2);
    }
  }
}

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
int8_mlp_wide_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                        long long n, long long dir_div, const int8_t* __restrict__ w,
                        const float* __restrict__ epi, const QLayout L, float* __restrict__ rgb,
                        float* __restrict__ sigma) {
  extern __shared__ __align__(1024) uint8_t smem[];
  int8_t* wh = reinterpret_cast<int8_t*>(smem + kHeadOff);
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kRows - 1) / kRows;
  const int tid = threadIdx.x;
  const int nw = L.nw, nv = L.nv;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The heads' codes out of their N = 8 tiles: alpha's n-row 0, rgb's 0-2.
  for (int i = tid; i < 4 * kMaxWidth; i += kThreads) {
    const int h = i / kMaxWidth, k = i % kMaxWidth;
    int8_t v = 0;
    if (h == 0 && k < nw) {
      v = w[L.w_alpha + (k >> 4) * 128 + (k & 15)];
    } else if (h > 0 && k < nv && !kSigmaOnly) {
      v = w[L.w_rgb + (k >> 4) * 128 + (h - 1) * 16 + (k & 15)];
    }
    wh[i] = v;
  }
  __syncthreads();

  // The role split on a warp-uniform value, never rejoined.
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
  if (warp >= kConsumers / 32) {
    // Producer warpgroup: one thread copies the chunks in the consumers'
    // order; the warpgroup hands its registers to the consumers.
    reg_dealloc<kProducerRegs>();
    if (tid != kConsumers) return;
    Producer pr{smem_u32(smem), bars, 0, 0u};
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int i = 0; i < L.depth; ++i) {
        pr.emit(w, L.w_dense[i], i == 0 ? kEncX : (L.skip[i] ? kEncX + nw : nw), nw);
      }
      if (!kSigmaOnly) {
        pr.emit(w, L.w_bneck, nw, nw);
        pr.emit(w, L.w_view, nw + kEncD, nv);
      }
    }
    return;
  }

  // Consumers: both warpgroups on the same tile, warpgroup g on its share
  // of each layer's pieces. Every branch below is uniform across a warp,
  // or guards stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  const int t = tid & 127;
  const int lane = tid & 31;
  uint8_t* plane = smem + kPlaneOff;
  uint8_t* eplane = smem + kEOff;
  uint8_t* dplane = smem + kDOff;
  float* encf = reinterpret_cast<float*>(smem + kEncOff);
  float* rowv = reinterpret_cast<float*>(smem + kRowOff);   // sx, ex, ed of each row
  float* xm = reinterpret_cast<float*>(smem + kMaxOff);
  int* hsum = reinterpret_cast<int*>(smem + kSumOff);      // [g][alpha, r, g, b][row]
  const Share sw(nw / kPiece, g), sv(nv / kPiece, g);
  Pipe pipe{smem_u32(smem), bars, 0, 0u, -1};
  Rows R;
  R.r0 = (warp & 3) * 16 + (lane >> 2);
  const int quad = lane & 3;
  const uint32_t a_p = smem_u32(plane), a_e = smem_u32(eplane), a_d = smem_u32(dplane);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = tile * kRows;
    if (g == 0) {
      // Encode: threads t and t + 1 on row t / 2 (encode_row), then
      // dense0's codes, its row scale and the two absmaxes. (The last
      // tile's reads of these buffers ended behind its layers' barriers.)
      const int row = t >> 1, half = t & 1;
      const long long s = base + row;
      const bool in = s < n;
      const long long dr = (in ? s : 0) / dir_div;
      float p[3], d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] = in ? pts[s * 3 + c] : 0.f;
        d[c] = in ? dirs[dr * 3 + c] : 0.f;
      }
      float* er = encf + row * kEncStride;
      float mx = 0.f, md = 0.f;
      encode_row(er, half, p, d, mx, md);
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
      md = fmaxf(md, __shfl_xor_sync(0xFFFFFFFFu, md, 1));
      const Scale s0 = row_scale(mx);
      __syncwarp();
      store16(eplane + plane_off(row, 32 * half), er + 32 * half, s0);
      store16(eplane + plane_off(row, 32 * half + 16), er + 32 * half + 16, s0);
      if (!half) {
        rowv[row] = s0.s;
        rowv[kRows + row] = mx;
        rowv[2 * kRows + row] = md;
      }
    }
    fence_async_smem();
    consumers_barrier();
    R.sx[0] = {rowv[R.r0], __frcp_rn(rowv[R.r0])};
    R.sx[1] = {rowv[R.r0 + 8], __frcp_rn(rowv[R.r0 + 8])};
    int hs[2][3];

    // Layer l: the trunk's dense l for l < depth, then the bottleneck (no
    // activation) and the view layer over [bottleneck, dirs_enc], all
    // through one call site. Before a skip layer the row absmax spans the
    // point encode's, and the bottleneck's spans the dir encode's.
    const int layers = L.depth + (kSigmaOnly ? 0 : 2);
    for (int l = 0; l < layers; ++l) {
      const bool trunk = l < L.depth, view = l == L.depth + 1;
      const bool reads_enc = l == 0 || (trunk && L.skip[l]);
      const bool next_skip = l + 1 < L.depth && L.skip[l + 1];
      const long long sb = trunk ? L.sb_dense[l] : view ? L.sb_view : L.sb_bneck;
      const int e = next_skip ? kRows : l == L.depth ? 2 * kRows : -1;   // the encode's absmax
      const float extra[2] = {e < 0 ? 0.f : rowv[e + R.r0], e < 0 ? 0.f : rowv[e + R.r0 + 8]};
      const Share& sh = view ? sv : sw;
      layer_any(sh.count, pipe, reads_enc ? a_e : a_p, reads_enc ? kEncX : nw, view ? a_d : a_p,
                view ? kEncD : (reads_enc && l > 0 ? nw : 0), view ? nv : nw, sh.p0,
                epi + 2 * sb, l == L.depth ? -INFINITY : 0.f, extra, plane, xm, g, R);
      if (next_skip) {
        // The next layer's encode codes at its row scale: this
        // warpgroup's 32 columns, 8 a thread of the quad, for both rows.
        // (Every wgmma that read the encode plane has retired.)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = R.r0 + 8 * r, col = 32 * g + 8 * quad;
          const float* x = encf + row * kEncStride + col;
          *reinterpret_cast<uint2*>(eplane + plane_off(row, col)) =
              make_uint2(pack4(x, R.sx[r]), pack4(x + 4, R.sx[r]));
        }
      }
      if (l + 1 == L.depth) {
        // The sigma head's sums over this warpgroup's columns.
        head_sums<1>(plane, sw.p0 * kPiece, (sw.p0 + sw.count) * kPiece, wh, R, hs);
        if (quad == 0) {
          hsum[(4 * g) * kRows + R.r0] = hs[0][0];
          hsum[(4 * g) * kRows + R.r0 + 8] = hs[1][0];
        }
      } else if (l == L.depth) {
        // The view layer's dir-encode codes at the bottleneck's row scale:
        // this warpgroup's 16 columns, 4 a thread of the quad.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = R.r0 + 8 * r, col = 16 * g + 4 * quad;
          *reinterpret_cast<uint32_t*>(dplane + plane_off(row, col)) =
              pack4(encf + row * kEncStride + kEncX + col, R.sx[r]);
        }
      } else if (view) {
        // The rgb head's sums over this warpgroup's columns.
        head_sums<3>(plane, sv.p0 * kPiece, (sv.p0 + sv.count) * kPiece, wh + kMaxWidth, R, hs);
        if (quad == 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            hsum[(4 * g + 1 + c) * kRows + R.r0] = hs[0][c];
            hsum[(4 * g + 1 + c) * kRows + R.r0 + 8] = hs[1][c];
          }
        }
      }
      fence_async_smem();
      consumers_barrier();   // the layer's codes and sums, whole
      if (l + 1 == L.depth && g == 0) {
        // Sigma from both warpgroups' sums.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = R.r0 + 8 * r;
          const long long s = base + row;
          if (quad == 0 && s < n) {
            const float* ep = epi + 2 * L.sb_alpha;
            const int acc = hsum[row] + hsum[4 * kRows + row];
            sigma[s] = fmaxf(dequant(acc, R.sx[r].s, __ldg(ep), __ldg(ep + 2)), 0.f);
            if (kSigmaOnly) {
              rgb[s * 3] = 0.f;
              rgb[s * 3 + 1] = 0.f;
              rgb[s * 3 + 2] = 0.f;
            }
          }
        }
      } else if (view && g == 1) {
        // Rgb from both warpgroups' sums, with sigmoid.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = R.r0 + 8 * r;
          float o[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float* ep = epi + 2 * L.sb_rgb + 4 * (c >> 1) + (c & 1);
            const int acc = hsum[(1 + c) * kRows + row] + hsum[(5 + c) * kRows + row];
            const float y = dequant(acc, R.sx[r].s, __ldg(ep), __ldg(ep + 2));
            o[c] = 1.f / (1.f + expf(-y));
          }
          const long long s = base + row;
          if (quad == r && s < n) {
            rgb[s * 3] = o[0];
            rgb[s * 3 + 1] = o[1];
            rgb[s * 3 + 2] = o[2];
          }
        }
      }
    }
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const int8_t* w, const float* epi, const QLayout& L, float* rgb,
                   float* sigma, int device, cudaStream_t stream) {
  auto kernel = int8_mlp_wide_tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(pts, dirs, n, dir_div, w, epi, L, rgb, sigma);
  return cudaGetLastError();
}

}  // namespace

// nerf_int8_mlp_forward's contract for the wide envelope: layout holds
// kLayoutLen (104) host int64 offsets; ldw, ldv: the pack's trunk and
// view widths (multiples of 64, at most 512); depth at most 32. Returns a
// cudaError_t value (0 = launched).
extern "C" int nerf_int8_mlp_wide_forward(const void* pts, const void* dirs, long long n,
                                          long long dir_div, const void* codes,
                                          const void* epilogue, const long long* layout,
                                          int layout_len, int ldw, int ldv, int depth,
                                          int sigma_only, void* rgb, void* sigma, int device,
                                          void* stream) {
  QLayout L;
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(epilogue) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const int8_t* w = static_cast<const int8_t*>(codes);
  const float* ep = static_cast<const float*>(epilogue);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, ep, L, o_rgb, o_sigma, device, s)
                   : launch<false>(p, d, n, dir_div, w, ep, L, o_rgb, o_sigma, device, s);
  return static_cast<int>(err);
}
