// W8A8 NeRF MLP forward on Hopper's tensor cores (sm_90a): positional
// encode, then every dense layer as int8 codes x int8 codes -> int32 on
// s8 wgmma, dequantized and requantized per sample in registers, in one
// persistent kernel. Activations never leave the SM.
//
// Replaces tools/pallas_int8_probe.py::main -> make -> go, the Pallas call
// at :66: a chain of int8 x int8 -> int32 products with the weights
// resident, each followed by a ReLU in f32 and a per-sample absmax
// requantize back to int8. Here the chain is the real W8A8 NeRF MLP of
// nerf_rs_tpu/models/quant.py::int8_nerf_mlp(fake=False), whose plain
// version is nerf_rs_tpu_torch/models/quant.py::int8_nerf_mlp. Per dense
// layer, with x the layer's f32 input row of one sample (width K, the skip
// layer's [h0, h] and the view layer's [bottleneck, dirs_enc] included):
//   sx   = max(max_j |x_j| / 127, 1e-12)
//   q_j  = clamp(rint(x_j / sx), -127, 127)
//   acc  = sum_j q_j * wq[j, n]                       (int32, exact)
//   y_n  = ((float)acc * sx) * sw[n] + b[n]           (three rounded ops)
// then ReLU (trunk, alpha, view layer), nothing (bottleneck) or sigmoid
// (rgb). The weight codes and their per-column scales come from the pack
// (ops/kernels/int8_mlp.py::pack_int8_params).
//
// What bounds it on the H100: operations. A fine sample costs 1.187 M int8
// operations (multiply-adds counted as two), against 24 bytes of input and
// 16 of output, so a fine call (8192 x 192) is bounded at 0.9433 ms by the
// 1,979 TOP/s int8 tensor-core peak. The design works toward that bound:
// - the products run on s8 wgmma (m64n64k32, int32 accumulators; the sums
//   are exact, |acc| <= 127 * 127 * 320 < 2^31, and equal the plain
//   version's f32 sums: every partial sum is an integer below 127^2 K <
//   2^24, which holds while K <= 1040);
// - a persistent grid, one CTA of 384 threads an SM: two consumer
//   warpgroups, each on a 64-sample tile of its own, and a producer
//   warpgroup whose registers setmaxnreg hands to the consumers (240 each,
//   the producer 24: no spills; 128 int32 accumulators cover a whole
//   256-wide layer). Each consumer owns all N columns of its 64 rows, so a
//   row's absmax is a quad shuffle, with no exchange between warpgroups,
//   and one warpgroup's epilogue runs under the other's wgmmas. (A
//   producer warp alone, 288 threads, still caps a thread at 168
//   registers: a sub-partition of the SM holds three of the nine warps;
//   the consumers spilled);
// - one thread of the producer copies each layer's codes, 128 K-rows at a
//   time (32 KB at N = 256), with one cp.async.bulk onto an mbarrier into
//   a ring of 3 stages that both consumers read, running ahead across
//   layers and tiles. The pack is pre-tiled on the host
//   (int8_mlp.py::int8_tile) into wgmma's no-swizzle K-major core-matrix
//   order (8 n-rows x 16 k-codes), so a chunk is one contiguous run;
// - the epilogue works in registers: each int32 sum is dequantized, the
//   ReLU applied and the row absmax taken (combined with the point
//   encode's absmax before a skip layer, with the dir encode's before the
//   view layer); the outputs overwrite the sums in the accumulator
//   registers (a layer's first k-step does not read them, so ptxas keeps
//   the wgmmas asynchronous), and the next layer's codes go straight into
//   its A plane, K-major in the same core-matrix order. No f32 activation
//   plane; one warpgroup barrier a layer (the planes are double-buffered,
//   so a layer's codes never overwrite what its own wgmmas read). The
//   epilogue is branch-free, and the requantize needs neither a division
//   nor a conversion instruction (code_bits below): an IEEE division an
//   element, the first design, made the kernel 3.5x slower;
// - the layers run through one call site (trunk, bottleneck, view), so
//   the epilogue is compiled once for each piece count;
// - the f32 encode stays in shared memory, because the skip and view
//   layers requantize it with their own row scale;
// - the heads (alpha width -> 1, rgb v_width -> 3) are integer dot
//   products of the last trunk layer's and the view layer's codes, read
//   back by the thread that wrote them, with the heads' codes, summed over
//   a quad by shuffles: exact. A wgmma of N = 8 would spend 7/8 (alpha) or
//   5/8 (rgb) of its work on padding.
// Shared memory: the ring 96 KB, per consumer warpgroup two 16 KB code
// planes, the encode's 4 KB and the dir encode's 2 KB code planes, the
// 25 KB f32 encode and the per-row scales (64 KB), the heads' codes 1 KB.
// Widths pad to multiples of 64 (the wgmma N of one piece); padding codes,
// scales and biases are zero, so padding outputs dequantize to 0 and never
// raise an absmax.
//
// Numerics: the row scales are __fdiv_rn, every dequant op __fmul_rn or
// __fadd_rn (no FMA contraction), each code the rounded quotient rounded
// half to even (as torch.round), computed exactly without a division
// (code_bits); the encode is sinf/cosf as torch computes it. Built without
// fast math. So the codes, the accumulators and sigma equal the plain
// version's bit for bit; rgb differs only where expf differs from torch's
// sigmoid.
//
// The device code that the wide kernel (int8_mlp_wide_tc.cu: widths up to
// 512, depth up to 32) runs too is in int8_mlp_tc.cuh.
//
// Layout contract with pack_int8_params: each layer is an int8 segment of
// K x ld codes in the order int8_tile gives (the core matrix of k group kg
// and n group ng at byte (kg * ld / 8 + ng) * 128, n-row n % 8 at 16 bytes
// a row, code k % 16 at its byte); ld is the output width padded to 64 (8
// for the heads); K is the padded input width: 64 for dense0 (63 encode
// rows), ldw + 64 for a skip layer (the encode rows first), ldw for the
// other trunk layers, alpha and the bottleneck, ldw + 32 for the view layer
// (27 dir-encode rows after the bottleneck's), ldv for rgb. Segments start
// on 16-byte boundaries. The int64 layout array holds, in this order:
//   [0, 16)  dense layer i's byte offset        [16, 32) its scale/bias slot
//   [32, 48) 1 if dense layer i takes the encode rows first (skip), else 0
//   48 alpha, 49 bottleneck, 50 viewdirs, 51 rgb byte offsets
//   52 alpha, 53 bottleneck, 54 viewdirs, 55 rgb scale/bias slots
// A slot of o columns: columns 2 i and 2 i + 1 as [sw, sw, b, b] at float
// 2 o + 4 i of the epilogue array, one 16-byte load.

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
using nerf::tc::wg_barrier;
using nerf::tc::wgmma_commit;
using nerf::tc::wgmma_wait;

constexpr int kMaxDepth = 16;
constexpr int kLayoutLen = 56;
constexpr int kMaxWidth = 256;
constexpr int kChunkK = 128;               // K rows a bulk copy
constexpr int kStages = 3;
constexpr int kStageBytes = kChunkK * kMaxWidth;   // 32 KB
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared memory, in bytes from the dynamic base. Warpgroup g's block at
// kWgOff + g * kWgBytes: two code planes, the encode's and the dir
// encode's code planes, the f32 encode, the per-row scale and absmaxes.
constexpr int kPlaneBytes = kRows * kMaxWidth;             // 16 KB
constexpr int kEOff = 2 * kPlaneBytes;
constexpr int kDOff = kEOff + kRows * kEncX;
constexpr int kEncOff = kDOff + kRows * kEncD;
constexpr int kRowOff = kEncOff + kRows * kEncStride * 4;  // sx, ex, ed [kRows] f32
constexpr int kWgBytes = 65536;
static_assert(kRowOff + 3 * kRows * 4 <= kWgBytes, "warpgroup block overflows");
constexpr int kWgOff = kStages * kStageBytes;
constexpr int kHeadOff = kWgOff + 2 * kWgBytes;            // codes: alpha [256], rgb [3][256]
constexpr int kBarOff = kHeadOff + 4 * kMaxWidth;          // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

using Pipe = nerf::tc::Pipe<kStages, kStageBytes>;

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
  if (layout_len != kLayoutLen || depth < 1 || depth > kMaxDepth || nw < kPiece ||
      nw > kMaxWidth || nw % kPiece != 0 || nv < kPiece || nv > kMaxWidth || nv % kPiece != 0) {
    return false;
  }
  for (int i = 0; i < kMaxDepth; ++i) {
    L->w_dense[i] = layout[i];
    L->sb_dense[i] = layout[kMaxDepth + i];
    L->skip[i] = static_cast<int>(layout[2 * kMaxDepth + i]);
    // The segments a launch reads start on 16-byte boundaries.
    if (i < depth && (layout[i] < 0 || layout[i] % 16 != 0)) return false;
  }
  for (int i = 48; i < 52; ++i) {
    if (layout[i] < 0 || layout[i] % 16 != 0) return false;
  }
  L->w_alpha = layout[48];
  L->w_bneck = layout[49];
  L->w_view = layout[50];
  L->w_rgb = layout[51];
  L->sb_alpha = layout[52];
  L->sb_bneck = layout[53];
  L->sb_view = layout[54];
  L->sb_rgb = layout[55];
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

  // The k rows of a segment of nn columns at byte off, in chunks of kChunkK.
  __device__ __forceinline__ void emit(const int8_t* w, long long off, int k, int nn) {
    for (int c = 0; c < k; c += kChunkK) {
      const uint32_t bytes = static_cast<uint32_t>(min(kChunkK, k - c) * nn);
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

// This thread's two rows of its warpgroup's tile (r0 and r0 + 8, the rows
// of its accumulator fragment) and their scales.
struct Rows {
  int r0;
  Scale sx[2];   // the scale of the current layer's input row
};

// The products of this warpgroup's 64 rows of [a1 (k1 code columns); a2
// (k2)] with the next (k1 + k2) / kChunkK ring chunks (n columns, NP
// pieces) into acc. The first k-step (from a1: k1 >= 32) overwrites acc.
template <int NP>
__device__ __forceinline__ void products(int (&acc)[4][32], Pipe& q, uint32_t a1, int k1,
                                         uint32_t a2, int k2, int n) {
  fence_acc<NP>(acc);
  const int k = k1 + k2;
  uint32_t b = q.acquire();
  {
    const uint64_t da = desc(a1, kRows * 16, 128);
#pragma unroll
    for (int p = 0; p < NP; ++p) wgmma_s8<0>(acc[p], da, desc(b + p * 1024, n * 16, 128));
  }
  int c = 0, s = 32;
  while (true) {
    const int kc = min(kChunkK, k - c);
    for (; s < kc; s += 32) {
      const int kk = c + s;
      const uint32_t a =
          kk < k1 ? a1 + (kk >> 4) * (kRows * 16) : a2 + ((kk - k1) >> 4) * (kRows * 16);
      const uint64_t da = desc(a, kRows * 16, 128);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_s8<1>(acc[p], da, desc(b + p * 1024 + (s >> 4) * (n * 16), n * 16, 128));
      }
    }
    wgmma_commit();
    q.advance();
    c += kChunkK;
    if (c >= k) break;
    b = q.acquire();
    s = 0;
  }
  wgmma_wait<0>();
  fence_acc<NP>(acc);
  q.release();
}

// The codes of this thread's outputs, held in acc as f32 bits, at the row
// scales R.sx, into the plane out.
template <int NP>
__device__ __forceinline__ void codes(const int (&acc)[4][32], uint8_t* out, const Rows& R) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<uint16_t*>(out + plane_off(R.r0 + 8 * r, p * kPiece + 8 * j + c0)) =
            static_cast<uint16_t>(code_pair(__int_as_float(acc[p][4 * j + 2 * r]),
                                            __int_as_float(acc[p][4 * j + 2 * r + 1]),
                                            R.sx[r]));
      }
    }
  }
}

// One layer for this warpgroup: the products, then the epilogue in
// registers: dequant, the floor lo (0 for a ReLU, -inf for none), the row
// absmax (starting from extra), the new row scale into R.sx, and the codes
// of the output at that scale into the plane out. The epilogue's loops
// are branch-free, so that a thread's 128 independent chains interleave.
template <int NP>
__device__ __forceinline__ void layer(Pipe& q, uint32_t a1, int k1, uint32_t a2, int k2, int n,
                                      const float* __restrict__ ep, float lo,
                                      const float (&extra)[2], uint8_t* out, Rows& R) {
  int acc[4][32];
  products<NP>(acc, q, a1, k1, a2, k2, n);

  // Accumulator element 4 j + 2 r + e of piece p sits at row R.r0 + 8 r
  // and column p * 64 + 8 j + 2 (lane % 4) + e.
  const int c0 = 2 * (threadIdx.x & 3);
  const float sx[2] = {R.sx[0].s, R.sx[1].s};
  float m[2] = {extra[0], extra[1]};
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p * kPiece + 8 * j + c0;
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
    R.sx[r] = row_scale(m[r]);
  }
  codes<NP>(acc, out, R);
}

// layer<NP> for a runtime NP in 1..4, inlined at each call site so that
// the accumulators stay in registers.
__device__ __forceinline__ void layer_any(int np, Pipe& q, uint32_t a1, int k1, uint32_t a2,
                                          int k2, int n, const float* __restrict__ ep, float lo,
                                          const float (&extra)[2], uint8_t* out, Rows& R) {
  switch (np) {
    case 1: layer<1>(q, a1, k1, a2, k2, n, ep, lo, extra, out, R); break;
    case 2: layer<2>(q, a1, k1, a2, k2, n, ep, lo, extra, out, R); break;
    case 3: layer<3>(q, a1, k1, a2, k2, n, ep, lo, extra, out, R); break;
    default: layer<4>(q, a1, k1, a2, k2, n, ep, lo, extra, out, R); break;
  }
}

// The int32 dot products of this thread's two rows of a code plane
// (columns [0, n), its own: 2 (lane % 4) + 8 i and the next) with the
// first H rows of the heads' codes wh, summed over the quad: exact.
template <int H>
__device__ __forceinline__ void head_sums(const uint8_t* plane, int n, const int8_t* wh,
                                          const Rows& R, int (&hs)[2][3]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int h = 0; h < H; ++h) hs[r][h] = 0;
  }
  for (int col = 2 * (threadIdx.x & 3); col < n; col += 8) {
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
int8_mlp_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
                   long long dir_div, const int8_t* __restrict__ w,
                   const float* __restrict__ epi, const QLayout L, float* __restrict__ rgb,
                   float* __restrict__ sigma) {
  extern __shared__ __align__(1024) uint8_t smem[];
  int8_t* wh = reinterpret_cast<int8_t*>(smem + kHeadOff);
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kRows - 1) / kRows;
  const long long rounds = (tiles + 1) / 2;      // a tile for each consumer warpgroup
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
    for (long long rd = blockIdx.x; rd < rounds; rd += gridDim.x) {
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

  // Consumers: warpgroup g takes tile 2 rd + g of round rd (past the last
  // tile, a tile of zeros that is never stored, so that both warpgroups
  // read every ring chunk). Every branch below is uniform across a warp,
  // or guards stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  const int t = tid & 127;
  const int lane = tid & 31;
  uint8_t* blk = smem + kWgOff + g * kWgBytes;
  uint8_t* eplane = blk + kEOff;
  uint8_t* dplane = blk + kDOff;
  float* encf = reinterpret_cast<float*>(blk + kEncOff);
  float* rowv = reinterpret_cast<float*>(blk + kRowOff);   // sx, ex, ed of each row
  const int npw = nw / kPiece, npv = nv / kPiece;
  Pipe pipe{smem_u32(smem), bars, 0, 0u, -1};
  Rows R;
  R.r0 = (warp & 3) * 16 + (lane >> 2);
  const int quad = lane & 3;

  for (long long rd = blockIdx.x; rd < rounds; rd += gridDim.x) {
    const long long base = (2 * rd + g) * kRows;
    {
      // Encode: threads t and t + 1 on row t / 2 (encode_row), then
      // dense0's codes, its row scale and the two absmaxes.
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
    wg_barrier(g);
    R.sx[0] = {rowv[R.r0], __frcp_rn(rowv[R.r0])};
    R.sx[1] = {rowv[R.r0 + 8], __frcp_rn(rowv[R.r0 + 8])};
    const uint32_t a_e = smem_u32(eplane), a_d = smem_u32(dplane);
    int cur = 0;   // the plane that holds the current layer's input codes
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
      const uint32_t a_cur = smem_u32(blk + cur * kPlaneBytes);
      uint8_t* out = blk + (cur ^ 1) * kPlaneBytes;
      const long long sb = trunk ? L.sb_dense[l] : view ? L.sb_view : L.sb_bneck;
      const int e = next_skip ? kRows : l == L.depth ? 2 * kRows : -1;   // the encode's absmax
      const float extra[2] = {e < 0 ? 0.f : rowv[e + R.r0], e < 0 ? 0.f : rowv[e + R.r0 + 8]};
      layer_any(view ? npv : npw, pipe, reads_enc ? a_e : a_cur,
                reads_enc ? kEncX : nw, view ? a_d : a_cur,
                view ? kEncD : (reads_enc && l > 0 ? nw : 0), view ? nv : nw, epi + 2 * sb,
                l == L.depth ? -INFINITY : 0.f, extra, out, R);
      if (next_skip) {
        // The next layer's encode codes at its row scale: 16 columns a
        // thread of the quad, for both rows.
        if (reads_enc) wg_barrier(g);   // every wgmma of this layer has read the encode plane
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = R.r0 + 8 * r;
          store16(eplane + plane_off(row, 16 * quad), encf + row * kEncStride + 16 * quad,
                  R.sx[r]);
        }
      }
      if (l + 1 == L.depth) {
        // The sigma head from the last trunk layer's codes.
        head_sums<1>(out, nw, wh, R, hs);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long s = base + R.r0 + 8 * r;
          if (quad == 0 && s < n) {
            const float* ep = epi + 2 * L.sb_alpha;
            sigma[s] = fmaxf(dequant(hs[r][0], R.sx[r].s, __ldg(ep), __ldg(ep + 2)), 0.f);
            if (kSigmaOnly) {
              rgb[s * 3] = 0.f;
              rgb[s * 3 + 1] = 0.f;
              rgb[s * 3 + 2] = 0.f;
            }
          }
        }
      } else if (l == L.depth) {
        // The view layer's dir-encode codes at the bottleneck's row scale.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = R.r0 + 8 * r;
          const float* x = encf + row * kEncStride + kEncX + 8 * quad;
          *reinterpret_cast<uint2*>(dplane + plane_off(row, 8 * quad)) =
              make_uint2(pack4(x, R.sx[r]), pack4(x + 4, R.sx[r]));
        }
      } else if (view) {
        // The rgb head from the view layer's codes, with sigmoid.
        head_sums<3>(out, nv, wh + kMaxWidth, R, hs);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float o[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float* ep = epi + 2 * L.sb_rgb + 4 * (c >> 1) + (c & 1);
            const float y = dequant(hs[r][c], R.sx[r].s, __ldg(ep), __ldg(ep + 2));
            o[c] = 1.f / (1.f + expf(-y));
          }
          const long long s = base + R.r0 + 8 * r;
          if (quad == r && s < n) {
            rgb[s * 3] = o[0];
            rgb[s * 3 + 1] = o[1];
            rgb[s * 3 + 2] = o[2];
          }
        }
      }
      fence_async_smem();
      wg_barrier(g);   // the layer's codes, whole, before the next layer's wgmmas read them
      cur ^= 1;
    }
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const int8_t* w, const float* epi, const QLayout& L, float* rgb,
                   float* sigma, int device, cudaStream_t stream) {
  auto kernel = int8_mlp_tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long rounds = ((n + kRows - 1) / kRows + 1) / 2;
  const unsigned grid = static_cast<unsigned>(rounds < sms ? rounds : sms);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(pts, dirs, n, dir_div, w, epi, L, rgb, sigma);
  return cudaGetLastError();
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; codes (int8, 16-byte aligned) and epilogue (f32, scales and
// biases interleaved, 16-byte aligned) as packed by pack_int8_params;
// layout: kLayoutLen host int64 offsets; ldw,
// ldv: the pack's trunk and view widths (multiples of 64); rgb (n, 3) and
// sigma (n,) f32 outputs. Returns a cudaError_t value (0 = launched).
extern "C" int nerf_int8_mlp_forward(const void* pts, const void* dirs, long long n,
                                     long long dir_div, const void* codes, const void* epilogue,
                                     const long long* layout, int layout_len,
                                     int ldw, int ldv, int depth, int sigma_only, void* rgb,
                                     void* sigma, int device, void* stream) {
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
