// Fused NeRF MLP backward in bf16 on Hopper's tensor cores (sm_90a) for
// wide or deep networks, K2's bf16 mode beyond the narrow envelope: trunk
// and view widths up to 512, up to 32 dense layers (fused_mlp_wide.cuh's
// tables). Per tile of 64 samples of a round: recompute the forward,
// backpropagate through the rgb head, the view layer, the bottleneck, the
// sigma head and the trunk with its skip layer, and write every layer's
// input and output gradient to the round's workspace
// (fused_mlp_wide_dw.cuh), where the dW kernel (fused_mlp_wide_dw.cu) sums
// the weight gradients over the whole round; with input gradients
// requested, also d(points) and d(dirs) through the encode.
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
// encode_tile and wide_layer (passes of two pieces a warpgroup, each ring
// chunk summed from zero and added to a running f32 sum), and
// f32tc::head_sum for the heads, on the same pack (PackedMLP.weights_tc
// of a wide pack) in the same chunks, so its activations and ReLU masks
// are bit for bit those of K1's wide bf16 forward, the ones that made the
// loss. Its layers write the two 64 x 512 buffers in turn, the last one
// (h_last, or the view output) into the activation buffer.
//
// Layout, the wide forward's: 64-sample tiles, the two warpgroups on the
// two halves of each product's N. Consumer thread 0 bulk-copies every
// weight chunk the tile needs, in the consumers' order (a chunk table
// built once, walked once a tile), onto a ring of 2 stages of 32 KB; two
// kinds of product, both wgmma from shared memory:
// - the recompute, x W: A the tile's 64 rows (K-major), B a ring chunk of
//   a pass's columns (wide::layer_chunks: one bulk copy a k-group of 8
//   rows), each pass split between the warpgroups (wide_layer);
// - the input gradients, dZ W^T: A the tile's 64 rows of dZ, B the same
//   ring chunks (all of a segment's columns: 32 K-rows above width 256,
//   64 at or below; one contiguous run) read transposed (MN-major): a
//   chunk of 64 input rows of a
//   segment gives one 64-column piece of dZ W^T (m64n64k16), a chunk of 32
//   rows half a piece (m64n32k16); warpgroup g takes its Share of the
//   pieces one at a time and walks past the other's chunks. The chunk
//   shape is a template argument of each product, so no runtime branch
//   picks a wgmma shape. Each layer reads the gradient from one 64 x 512
//   buffer and writes the next into the other (the activation buffer, free
//   once the recompute's outputs are in the workspace), so a piece's
//   outputs are written as soon as it is done.
// Per tile the encodes, each trunk output and the bottleneck output
// (layer inputs) and each layer's output gradient go to the workspace as
// their shared-memory images; the backward reads each trunk output's image
// there as its ReLU mask.
//
// What bounds it on the H100: operations, two forwards of bf16 products
// at 989 TFLOP/s (at 512/256/8, 2 x 4.60 MFLOP a fine sample); the pack
// streams from L2 twice a 64-sample tile (recompute and W dz), and a
// sample's images, 19.1 KB at 512/256/8, are written once.
// Determinism: the bias gradients and the heads' weight gradients sum into
// a small per-CTA partial, each entry owned by one thread, tile after tile
// in program order; the host sums the partials in a fixed order.
// Registers: the kernel runs at ptxas's 255 a thread beside the
// recompute's 128 accumulators, and spills nothing only because (1) the
// recompute is one call site, a loop over the layers, (2) thread 0's ring
// feeder reads a ready chunk table and (3) the addresses an epilogue
// derives are kept from being hoisted out of the tile loop (opaque()).
// Shared memory (227,704 bytes): the ring (64 KB), the two 64 x 512 bf16
// buffers (activations, then gradients; 64 KB each), the dir and point
// encodes (4 and 8 KB), the head weights (8 KB), the head gradients (1
// KB), the chunk table (9.4 KB), the barriers. The encode gradients go to
// a per-CTA scratch in f32.

#include "fused_mlp_bwd_bf16.cuh"
#include "fused_mlp_wide_dw.cuh"
#include "fused_mlp_wide_tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::bwd16;
using namespace nerf::wide;
using f32tc::head_row;
using f32tc::head_sum;

constexpr int kStages = 2;
constexpr int kThreads = kConsumers;                      // two warpgroups, no producer
// Ring chunks a tile's walk reads, at most: the recompute's
// (kMaxFwdChunks), then the backward's, a 512-row segment of 16 chunks
// and a skip of 2 each layer past the first, dense0's 2, the bottleneck's
// and the view layer's 16, the dir encode's 1.
constexpr int kMaxChunks = kMaxFwdChunks + (2 + (kWideMaxDepth - 1) * 18 + 33);
constexpr int kBufBytes = kBlock * kWideMaxWidth * 2;
constexpr int kActOff = kStages * kStageBytesW;           // ring first
constexpr int kDzOff = kActOff + kBufBytes;
constexpr int kEncDOff = kDzOff + kBufBytes;
constexpr int kEncXOff = kEncDOff + kBlock * kEncD * 2;
constexpr int kHeadOff = kEncXOff + kBlock * kEncX * 2;    // alpha [512], rgb [512][3] f32
constexpr int kGradOff = kHeadOff + 4 * kWideMaxWidth * 4; // gs [64], gr [64][3] f32
constexpr int kChunkOff = kGradOff + 4 * kBlock * 4;       // the walk's chunks
constexpr int kFeedOff = kChunkOff + kMaxChunks * 8;       // thread 0's Feed
constexpr int kBarOff = kFeedOff + 64;                     // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

using B = BwdBf16<kBlock>;


// Thread 0's side of the ring, in shared memory (so that no consumer
// thread holds it in registers): the walk over the tile's chunk table,
// `laps` times over, and the stages it fills.
struct Feed {
  const __nv_bfloat16* w;
  int count, laps, i;                  // the walk: chunks, laps left, next chunk
  int fill_stage, ahead;               // the next stage to fill; chunks copied, not acquired
  uint32_t fill_phase;
};

__device__ __forceinline__ Feed& feed() {
  extern __shared__ __align__(1024) uint8_t smem[];
  return *reinterpret_cast<Feed*>(smem + kFeedOff);
}

__device__ __forceinline__ Chunk feed_chunk(int i) {
  extern __shared__ __align__(1024) uint8_t smem[];
  return reinterpret_cast<const Chunk*>(smem + kChunkOff)[i];
}

// The weight ring, fed by consumer thread 0 (f32tc::FedPipe's scheme, in
// stages of 32 KB): without a producer warpgroup the launch bounds give
// every thread the registers that the accumulators and the wgmma pipeline
// need (with one, ptxas holds the consumers to 168 registers: spills and
// serialized wgmmas). Thread 0 copies in acquire(), where its warp waits
// for the chunk anyway: the chunk about to be acquired, if it is not
// copied yet, then the next one if its stage is already free.
struct Ring {
  Pipe<kStages, kStageBytesW> q;       // the consumers' side

  // Thread 0: copies the next chunk into the fill stage, once it is free
  // (at once, or not at all unless `wait`).
  __device__ __forceinline__ void put(bool wait) {
    Feed& f = feed();
    const uint32_t full = q.bars + 8 * f.fill_stage;
    const uint32_t empty = q.bars + 8 * (kStages + f.fill_stage);
    if (!wait && !f32tc::mbar_test(empty, f.fill_phase ^ 1)) return;
    mbar_wait(empty, f.fill_phase ^ 1);
    const Chunk ch = feed_chunk(f.i);
    const uint32_t run = ch.run16 * 16u;
    mbar_expect_tx(full, run * ch.runs);
    for (int r = 0; r < ch.runs; ++r) {
      bulk_copy(q.ring + f.fill_stage * kStageBytesW + r * run, f.w + ch.off + r * 64 * ch.n8,
                run, full);
    }
    if (++f.i == f.count) {
      f.i = 0;
      --f.laps;
    }
    ++f.ahead;
    if (++f.fill_stage == kStages) {
      f.fill_stage = 0;
      f.fill_phase ^= 1;
    }
  }
  __device__ __forceinline__ uint32_t acquire() {
    if (threadIdx.x == 0) {
      Feed& f = feed();
      if (f.ahead == 0) put(true);
      --f.ahead;
      if (f.ahead == 0 && f.laps > 0) put(false);
    }
    return q.acquire();   // (its __syncwarp rejoins thread 0)
  }
  // After the wgmmas on the acquired chunk are committed: they retire
  // (every product waits for its chunk's sums anyway), and the chunk is
  // released at once, so that thread 0 may refill its stage while the
  // next chunk is multiplied.
  __device__ __forceinline__ void advance() {
    wgmma_wait<0>();
    mbar_arrive(q.bars + 8 * (kStages + q.stage));
    if (++q.stage == kStages) {
      q.stage = 0;
      q.phase ^= 1;
    }
  }
  // tc::Pipe's release of the last chunk: none is held.
  __device__ __forceinline__ void release() {}
};

// d (64 x 32, f32) = a (64 x 16, bf16) * b (16 x 32, bf16) + (scale_d ? d :
// 0); kTa, kTb: a, b read MN-major. Element 4 j + 2 r + e sits at row
// 16 (warp % 4) + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + e, as in an
// m64n64 accumulator's first 16.
template <int kTa, int kTb>
__device__ __forceinline__ void wgmma_32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTa), "n"(kTb));
}

// The 64-row buffer of n columns to its image in the workspace (n / 8 runs
// of 1 KB), by the 256 consumer threads.
__device__ __forceinline__ void buf_out(const uint8_t* buf, uint8_t* ws, int n) {
  for (int i = threadIdx.x; i < n * 8; i += kConsumers) {
    __stcg(reinterpret_cast<uint4*>(ws) + i, reinterpret_cast<const uint4*>(buf)[i]);
  }
}

// A chunk this warpgroup does not multiply: acquired and released in turn.
__device__ __forceinline__ void pass_chunk(Ring& q) {
  q.acquire();
  wgmma_commit();
  q.advance();
}

// Keeps the compiler from moving accumulator accesses across the wgmmas.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// v, opaque to the compiler, so that what a product's epilogue computes
// from it (its columns, guards and addresses) is computed there. Without
// it the compiler hoists every call site's addresses out of the tile loop,
// holds them across the whole tile beside the accumulators, and ptxas
// spills them.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  auto v = reinterpret_cast<unsigned long long>(p);
  asm volatile("" : "+l"(v));
  return reinterpret_cast<T*>(v);
}

// Tile t's image of slot s in the workspace, s opaque (so that the slot's
// offset is not held across the tile loop).
__device__ __forceinline__ uint8_t* image(const DwWs& D, int s, long long t) {
  return D.at(opaque(s), t);
}

// d = dZ (a: the tile's 64 rows, n columns) times the transpose of the next
// ring chunk: N = 32, a chunk of 64 input rows (m64n64k16); N = 16, a chunk
// of 32 (m64n32k16). Each chunk has an accumulator of its own: with the
// halves of one, and with all of a warpgroup's pieces in registers at
// once, ptxas spilled and serialized the wgmmas.
template <int N>
__device__ __forceinline__ void chunk_mma(float (&d)[N], Ring& q, uint32_t a, int n) {
  fence_regs(d);
  const uint32_t b = q.acquire();
#pragma unroll 1
  for (int s = 0; s < n; s += 16) {
    const uint64_t da = desc(a + (s >> 3) * 1024, 1024, 128);
    const uint64_t db = desc(b + (s >> 3) * 128, 128, n * 16);
    if constexpr (N == 32) {
      wgmma_64<0, 1>(d, da, db, s > 0 ? 1 : 0);
    } else {
      wgmma_32<0, 1>(d, da, db, s > 0 ? 1 : 0);
    }
  }
  wgmma_commit();
  q.advance();
  wgmma_wait<0>();
  fence_regs(d);
}

// One input-gradient layer: out (bf16, a buffer other than dZ's; this
// warpgroup's Share of the pieces) = round((dZ W^T [+ gs w_alpha^T])
// masked by mask > 0), a chunk at a time (kCK input rows: chunk_k(n)):
// its product into an accumulator of its own, then its outputs. mask: the
// layer input's image in the workspace (written this tile), or null;
// w_alpha (zero past the width) may be null. The other warpgroup's chunks
// pass by.
template <int kCK>
__device__ __forceinline__ void din_layer(Ring& q, uint32_t a, int k_in, int n, const Share& sh,
                                          uint8_t* out, const uint8_t* mask, const float* gs,
                                          const float* w_alpha) {
  constexpr int kPer = kPiece / kCK;   // chunks a piece
  const int chunks = k_in / kCK;
  const int c0 = min(chunks, sh.p0 * kPer), c1 = min(chunks, (sh.p0 + sh.count) * kPer);
  for (int c = 0; c < c0; ++c) pass_chunk(q);
#pragma unroll 1
  for (int c = c0; c < c1; ++c) {
    float acc[kCK / 2];
    chunk_mma(acc, q, a, n);
    const int r0 = opaque(frag_row()), cf = opaque(frag_col());
#pragma unroll
    for (int j = 0; j < kCK / 8; ++j) {
      const int col = c * kCK + 8 * j + cf;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (w_alpha != nullptr) {
          v0 = v0 + gs[row] * w_alpha[col];
          v1 = v1 + gs[row] * w_alpha[col + 1];
        }
        if (mask != nullptr) {
          const uint32_t m = __ldcg(reinterpret_cast<const unsigned int*>(mask + p_off(row, col)));
          if (!(__uint_as_float(m << 16) > 0.f)) v0 = 0.f;
          if (!(__uint_as_float(m & 0xFFFF0000u) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + p_off(row, col)) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  for (int c = c1; c < chunks; ++c) pass_chunk(q);
  q.release();
}

// din_layer with the chunk shape from n; then the consumers meet, and the
// outputs are visible to wgmma.
__device__ __forceinline__ void din_any(const Share& sh, Ring& q, uint32_t a, int k_in, int n,
                                        uint8_t* out, const uint8_t* mask, const float* gs,
                                        const float* w_alpha) {
  if (n > kMaxWidth) {
    din_layer<32>(q, a, k_in, n, sh, out, mask, gs, w_alpha);
  } else {
    din_layer<64>(q, a, k_in, n, sh, out, mask, gs, w_alpha);
  }
  fence_async_smem();
  consumers_barrier();
}

// de (f32, kDeCols a row) at columns c0 .. c0 + N / 2 - 1 = or += acc, a
// chunk's product (N accumulators).
template <int N>
__device__ __forceinline__ void encode_out(const float (&acc)[N], float* de, int c0, bool add) {
  const int r0 = opaque(frag_row()), cf = opaque(frag_col());
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2* p = reinterpret_cast<float2*>(de + (r0 + 8 * r) * kDeCols + c0 + 8 * j + cf);
      float2 v = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if (add) {
        const float2 o = *p;
        v = make_float2(o.x + v.x, o.y + v.y);
      }
      *p = v;
    }
  }
}

// An encode gradient (k_in = 64 or 32 input rows, warpgroup 0's): de (f32,
// kDeCols a row, the first k_in columns) = or += dZ times the transpose of
// the segment's next chunks (kCK rows each, the last maybe 32), unrounded.
// Warpgroup 1 passes the chunks by.
template <int kCK>
__device__ __forceinline__ void din_encode_k(Ring& q, uint32_t a, int k_in, int n, float* de,
                                             bool add, int g) {
#pragma unroll 1
  for (int c0 = 0; c0 < k_in; c0 += kCK) {
    if (g != 0) {
      pass_chunk(q);
    } else if (kCK == 64 && k_in - c0 >= 64) {
      float acc[32];
      chunk_mma(acc, q, a, n);
      encode_out(acc, de, c0, add);
    } else {
      float acc[16];
      chunk_mma(acc, q, a, n);
      encode_out(acc, de, c0, add);
    }
  }
  q.release();
}

__device__ __forceinline__ void din_encode(Ring& q, uint32_t a, int k_in, int n, float* de,
                                           bool add, int g) {
  if (n > kMaxWidth) {
    din_encode_k<32>(q, a, k_in, n, de, add, g);
  } else {
    din_encode_k<64>(q, a, k_in, n, de, add, g);
  }
}

// One CTA walks the round's tiles t = blockIdx.x, blockIdx.x + gridDim.x,
// ... below `tiles` (tile tile0 + t of the call), writes their images to
// the workspace D (tile t of its layout) and adds into its small partial:
// every bias gradient at the pack's bias offsets (L's, the same as the
// f32 table's), then the alpha head's ldw weight gradients and the rgb
// head's 3 ldv, small_stride floats a CTA.
template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_wide_bwd_bf16_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                               long long n, long long dir_div, const float* __restrict__ g_rgb,
                               const float* __restrict__ g_sigma,
                               const __nv_bfloat16* __restrict__ w,
                               const float* __restrict__ bias, const WideLayout L, const int nw,
                               const int nv, const DwWs D, const long long tile0,
                               const long long tiles, float* small_all, const long long n_b,
                               const long long small_stride, float* de_all,
                               float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* act = smem + kActOff;
  uint8_t* dz = smem + kDzOff;
  uint8_t* enc_x = smem + kEncXOff;
  uint8_t* enc_d = smem + kEncDOff;
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kWideMaxWidth;
  float* gs = reinterpret_cast<float*>(smem + kGradOff);   // sigma cotangent, then d(pre-ReLU)
  float* gr = gs + kBlock;                                 // rgb cotangent, then d(pre-sigmoid)
  Chunk* chunks = reinterpret_cast<Chunk*>(smem + kChunkOff);
  const uint32_t bars = smem_u32(smem + kBarOff);
  const int tid = threadIdx.x;
  const int depth = L.depth;
  const bool want_dx = dpts != nullptr;

  // Every chunk of a tile in the order the consumers take them: the
  // recompute's (K1's: wide::layer_chunks), then the backward's (thread
  // 0's table).
  int count = 0;
  auto put = [&](long long off, uint32_t run_bytes, int runs, int stride) {
    if (tid == 0) chunks[count] = ring_chunk(off, run_bytes, runs, stride);
    ++count;
  };
  layer_chunks(L.w_dense[0], kEncX, -1, 0, nw, put);
  for (int i = 1; i < depth; ++i) {
    if (L.w_skip[i] >= 0) {
      layer_chunks(L.w_skip[i], kEncX, L.w_dense[i], nw, nw, put);
    } else {
      layer_chunks(L.w_dense[i], nw, -1, 0, nw, put);
    }
  }
  if (!kSigmaOnly) {
    layer_chunks(L.w_bneck, nw, -1, 0, nw, put);
    layer_chunks(L.w_view, nw, L.w_view_dir, kEncD, nv, put);
  }
  auto add = [&](long long off, int k, int nn) {
    for (int c = 0; c < k; c += chunk_k(nn)) {
      if (tid == 0) {
        const int bytes = min(chunk_k(nn), k - c) * nn * 2;
        chunks[count] = {static_cast<uint32_t>(off + static_cast<long long>(c) * nn),
                         static_cast<uint16_t>(bytes / 16), 1, 0};
      }
      ++count;
    }
  };
  if (!kSigmaOnly) {
    if (want_dx) add(L.w_view_dir, kEncD, nv);
    add(L.w_view, nw, nv);
    add(L.w_bneck, nw, nw);
  }
  for (int i = depth - 1; i >= 1; --i) {
    if (want_dx && L.w_skip[i] >= 0) add(L.w_skip[i], kEncX, nw);
    add(L.w_dense[i], nw, nw);
  }
  if (want_dx) add(L.w_dense[0], kEncX, nw);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The alpha head's weights, zero past the width: din_layer adds
  // gs w_alpha^T on every column without a guard.
  for (int k = tid; k < kWideMaxWidth; k += kThreads) {
    w_alpha[k] = k < L.ldw ? load1(w + L.w_alpha + k) : 0.f;
  }
  for (int k = tid; k < 3 * L.ldv; k += kThreads) w_rgb[k] = load1(w + L.w_rgb + k);
  __syncthreads();

  // Warpgroup g on its Share of every product's pieces. Every branch below
  // is uniform across a warp, or guards stores only.
  const int g = __shfl_sync(0xFFFFFFFFu, tid >> 7, 0);
  const int ldw = L.ldw, ldv = L.ldv;
  const Share sw(nw / kPiece, g);   // the input-gradient products' pieces
  const int laps = static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  if (tid == 0) feed() = Feed{w, count, laps, 0, 0, 0, 0u};
  consumers_barrier();
  Ring q{{smem_u32(smem), bars, 0, 0u, -1}};
  const uint32_t s_act = smem_u32(act), s_dz = smem_u32(dz);
  const uint32_t s_ex = smem_u32(enc_x);
  const int hrow = head_row();
  auto row = [&](int i) { return ld_act(act, hrow, i); };
  // This CTA's small partial (dB: the bias gradients, then the alpha and
  // rgb heads' weights) and encode-gradient scratch, found where used.
  auto part = [&]() { return opaque(small_all) + blockIdx.x * small_stride; };
  auto scratch = [&]() { return opaque(de_all) + blockIdx.x * kBlock * kDeCols; };

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long tile = tile0 + t;
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
    buf_out(enc_x, image(D, 0, t), kEncX);
    buf_out(enc_d, image(D, 1, t), kEncD);

    // Recompute: K1's layers through one call site, the trunk (i < depth),
    // the bottleneck (i = depth) and the view layer, into act and dz in
    // turn so that the last layer writes act (h_last, the view output);
    // each trunk output and the bottleneck's also to its workspace slot;
    // the sigma head on h_last (act) before the view layer overwrites it.
    // (The arguments that a layer's epilogue derives its addresses from
    // are opaque: see opaque().)
    const int layers = kSigmaOnly ? depth : depth + 2;
    for (int i = 0; i < layers; ++i) {
      const bool view = i == depth + 1;
      const bool skip = i > 0 && i < depth && L.w_skip[i] >= 0;
      const bool odd = (layers - 1 - i) & 1;
      uint8_t* out = opaque(odd ? dz : act);
      const uint32_t s_in = odd ? s_act : s_dz;
      const uint32_t a1 = i == 0 || skip ? s_ex : s_in;
      const int k1 = i == 0 || skip ? kEncX : nw;
      const uint32_t a2 = skip ? s_in : (view ? smem_u32(enc_d) : 0u);
      const int k2 = skip ? nw : (view ? kEncD : 0);
      const long long b_off = i < depth ? L.b_dense[i] : (view ? L.b_view : L.b_bneck);
      wide_layer(q, a1, k1, a2, k2, view ? nv : nw, opaque(bias + b_off), view ? ldv : ldw,
                 i != depth, out, g);
      if (i <= depth) buf_out(out, image(D, DwWs::h(i), t), nw);
      if (i != depth - 1) continue;
      // Sigma head, K1's sum: gs becomes d(pre-ReLU sigma); its dW and db.
      {
        const float pre = head_sum(row, ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha);
        if (!(tid & 3)) gs[hrow] = round_act<true>(pre > 0.f ? gs[hrow] : 0.f);
      }
      consumers_barrier();
      float* dB = part();
      for (int k = tid; k < ldw; k += kConsumers) {
        float a = 0.f;
        for (int r = 0; r < kBlock; ++r) a = fmaf(ld_act(act, r, k), gs[r], a);
        dB[n_b + k] += a;
      }
      if (tid == 0) {
        float a = 0.f;
        for (int r = 0; r < kBlock; ++r) a += gs[r];
        dB[L.b_alpha] += a;
      }
      consumers_barrier();   // every read of h_last before the bottleneck overwrites it
    }

    if (!kSigmaOnly) {
      // K1's rgb head on the view output: gr becomes d(pre-sigmoid rgb),
      // sigmoid' = sg (1 - sg) with 1 - sg as sigmoid(-pre).
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pre = head_sum(row, ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
        const float sg = 1.f / (1.f + expf(-pre));
        const float sg_neg = 1.f / (1.f + expf(pre));
        if (!(tid & 3)) gr[hrow * 3 + c] = round_act<true>(gr[hrow * 3 + c] * sg * sg_neg);
      }
      consumers_barrier();
      float* dB = part();
      for (int idx = tid; idx < 3 * ldv; idx += kConsumers) {
        const int k = idx / 3, c = idx % 3;
        float a = 0.f;
        for (int r = 0; r < kBlock; ++r) a = fmaf(ld_act(act, r, k), gr[r * 3 + c], a);
        dB[n_b + ldw + idx] += a;
      }
      if (tid < 3) {
        float a = 0.f;
        for (int r = 0; r < kBlock; ++r) a += gr[r * 3 + tid];
        dB[L.b_rgb + tid] += a;
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
      buf_out(dz, image(D, D.dz_view(), t), nv);
      B::add_db(dz, ldv, part() + L.b_view);
      if (want_dx) {
        din_encode(q, s_dz, kEncD, nv, scratch(), false, g);
        consumers_barrier();
        const long long s = tile * kBlock + tid;
        if (tid < kBlock && s < n) {
          const long long r = s / dir_div;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            ddirs[s * 3 + c] = encode_vjp(scratch(), kDeCols, tid, c, dirs[r * 3 + c], kDBands);
          }
        }
      }
      // d(bottleneck), no activation, into act (the view output is read);
      // then d(h_last) with the sigma head's part, masked by h_last, into dz.
      din_any(sw, q, s_dz, nw, nv, act, nullptr, nullptr, nullptr);
      buf_out(act, image(D, D.dz(depth), t), nw);
      B::add_db(act, ldw, part() + L.b_bneck);
      din_any(sw, q, s_act, nw, nw, dz, image(D, DwWs::h(depth - 1), t), gs, w_alpha);
    } else {
      // Sigma head only: d(h_last) = round(gs w_alpha^T masked by h_last).
      for (int idx = tid; idx < kBlock * nw; idx += kConsumers) {
        const int r = idx & (kBlock - 1), k = idx >> 6;
        const float v = gs[r] * w_alpha[k];
        *reinterpret_cast<__nv_bfloat16*>(dz + p_off(r, k)) =
            __float2bfloat16_rn(ld_act(act, r, k) > 0.f ? v : 0.f);
      }
      const long long s = tile * kBlock + tid;
      if (want_dx && tid < kBlock && s < n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) ddirs[s * 3 + c] = 0.f;
      }
      fence_async_smem();
      consumers_barrier();
    }

    // Trunk, from the last layer down to layer 1, the gradient in the two
    // buffers in turn (each layer reads one, writes the other); d(point
    // encode) sums in the scratch.
    uint8_t* cur = dz;
    uint8_t* other = act;
    bool de_started = false;
    for (int i = depth - 1; i >= 1; --i) {
      buf_out(cur, image(D, D.dz(i), t), nw);
      B::add_db(cur, ldw, part() + L.b_dense[i]);
      if (want_dx && L.w_skip[i] >= 0) {
        din_encode(q, smem_u32(cur), kEncX, nw, scratch(), de_started, g);
        de_started = true;
      }
      din_any(sw, q, smem_u32(cur), nw, nw, other, image(D, DwWs::h(i - 1), t), nullptr, nullptr);
      uint8_t* done = cur;
      cur = other;
      other = done;
    }
    // Layer 0: input the point encode.
    buf_out(cur, image(D, D.dz(0), t), nw);
    B::add_db(cur, ldw, part() + L.b_dense[0]);
    if (want_dx) {
      din_encode(q, smem_u32(cur), kEncX, nw, scratch(), de_started, g);
      consumers_barrier();
      const long long s = tile * kBlock + tid;
      if (tid < kBlock && s < n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dpts[s * 3 + c] = encode_vjp(scratch(), kDeCols, tid, c, pts[s * 3 + c], kXBands);
        }
      }
    }
    consumers_barrier();   // before the next tile's encodes and cotangents
  }
}

}  // namespace

// One round of the wide bf16 backward: the tiles tile0 .. tile0 + tiles - 1
// of the call (64 samples each; below ceil(n / 64)) on `grid` CTAs, their
// images into the workspace ws (fused_mlp_wide_dw.cuh: planes 1, laid out
// for ws_tiles tiles) and their sums into `small` (grid x small_stride
// floats: n_b bias gradients, then ldw + 3 ldv head weight gradients;
// zeroed by the caller before the first round), d(points) and d(dirs)
// when dpts is not null, with de (grid x 64 x 64 floats) as scratch.
// weights_tc and layout_tc: a wide bf16 pack (kWideLayoutLen entries).
// Then nerf_wide_dw for the round, and nerf_wide_small_sum after the last.
// Returns a cudaError_t value (0 = launched).
extern "C" int nerf_wide_bwd_bf16_tiles(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights_tc, const void* biases, const long long* layout_tc,
    int layout_len, int ldw, int ldv, int depth, int sigma_only, void* ws, long long ws_tiles,
    long long tile0, long long tiles, void* small, long long n_b, long long small_stride,
    void* de, int grid, void* dpts, void* ddirs, int device, void* stream) {
  WideLayout L;
  const int nw = (ldw + kPiece - 1) / kPiece * kPiece, nv = (ldv + kPiece - 1) / kPiece * kPiece;
  if (!parse_wide_layout(layout_tc, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 1 ||
      grid < 1 || tiles < 1 || tiles > ws_tiles || tile0 < 0 || tile0 * kBlock >= n ||
      n_b < 1 || small_stride < n_b + ldw + 3 * ldv || (dpts == nullptr) != (ddirs == nullptr) ||
      reinterpret_cast<uintptr_t>(weights_tc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwWs D{static_cast<uint8_t*>(ws), ws_tiles, 1, nw, nv, depth};
  auto kernel = sigma_only ? fused_mlp_wide_bwd_bf16_kernel<true>
                           : fused_mlp_wide_bwd_bf16_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(dirs), n, dir_div,
      static_cast<const float*>(g_rgb), static_cast<const float*>(g_sigma),
      static_cast<const __nv_bfloat16*>(weights_tc), static_cast<const float*>(biases), L, nw, nv,
      D, tile0, tiles, static_cast<float*>(small), n_b, small_stride, static_cast<float*>(de),
      static_cast<float*>(dpts), static_cast<float*>(ddirs));
  return static_cast<int>(cudaGetLastError());
}
