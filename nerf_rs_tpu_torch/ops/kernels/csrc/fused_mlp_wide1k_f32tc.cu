// Fused NeRF MLP forward in float32 on Hopper's tensor cores (sm_90a) for
// networks past width 512: trunk or view widths from 513 up to 1024, up to
// 32 dense layers (fused_mlp_wide1k.cuh). The positional encode, the trunk
// with its skip layer, the sigma head and, unless sigma_only, the
// bottleneck, the view layer and the rgb head, in one persistent kernel;
// activations never leave the cluster's shared memory.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call at fused_mlp.py:779 -> :795) for dtype="float32" past the wide f32
// kernel's width of 512 (fused_mlp_wide_f32.cu); the JAX kernel serves any
// width that is a multiple of 128 (fused_mlp.py::supports_arch).
//
// Record mode (nerf_fused_mlp_wide1k_f32tc_record) is K2's f32 recompute
// past width 512 (fused_mlp_wide1k_bwd.cu): the same kernel over a round of
// 64-sample tiles writes each CTA's quarter of every trunk layer's, the
// bottleneck's and the view layer's f32 output to those tiles' record
// (fused_mlp_f32tc.cuh's ws_index layout at 64 rows, the wide f32
// forward's record) instead of computing the heads, so the backward
// differentiates this kernel's own activations and ReLU masks, bit for bit.
//
// Numerics: fused_mlp_f32tc.cuh's split-f32 (the JAX kernel's
// Precision.HIGHEST, as bf16 passes): each f32 operand splits into three
// bf16 pieces (f32tc::split3), and a product takes six wgmma m64n64k16 a
// k-step of 16 in fused_mlp.py's SPLIT_F32_ORDER, five small ones into one
// f32 accumulator over the layer's K, hi.hi into a second. That second
// one is summed from zero every k-step (one ring chunk) and added to a
// running f32 sum, rounded to nearest: a wgmma accumulator rounds toward
// zero as it adds, so one accumulator over K = 1024 drifts with the
// k-steps (fused_mlp_wide1k_tc.cu). The layer's output is (run + small) +
// bias. The sources of a layer run in order (a skip layer's encode part
// first, the view layer's trunk part first), each padded with zeros to
// whole k-steps. fused_mlp.py::split_f32_dense(group=WIDE1K_GROUP_STEPS,
// pad=...) computes the same on the CPU. The encode (exact sincosf), ReLU,
// the heads and the sigmoid are f32.
//
// What bounds it on the H100: at 1024/512/8 a fine sample costs 18.1
// MFLOP, six bf16 passes 108.7: 172.9 ms a 8192 x 192 call at 989
// TFLOP/s. A 64-sample tile's split input at width 1024 is 384 KB (256 KB
// as f32), more than the 227 KB a block may use, so one CTA cannot hold
// what a layer's products read. The split pack (PackedMLP.weights_f32tc1k,
// 54.3 MB at 1024/512/8) is larger than the 50 MB L2, and it streams once
// a 64-sample tile: 1.33 TB a fine call. The design:
// - a persistent grid of thread-block clusters of four CTAs, one CTA of
//   256 threads an SM, all four on the same 64-sample tile (one wgmma M).
//   CTA q owns a quarter of every layer's 64-column pieces (Quarter: the
//   first n % 4 quarters one more), at most four, so one pass: its two
//   warpgroups take at most two pieces each (wide::Share), with a small
//   accumulator, a hi.hi chunk accumulator and a running sum a piece (192
//   registers a thread). A K-split was the other way to fit; it would
//   exchange partial sums of every column of a layer, where this exchanges
//   the layer's inputs once;
// - each CTA keeps its quarter of a layer's output in f32 ([column][row],
//   64 KB at most), two such buffers in turn. A layer's products read the
//   whole input: every k-step, the 256 threads load its 64 x 16 f32
//   values from the CTA that owns those columns (ld.shared::cluster
//   through mapa, or the encode computed from the tile's points and dirs),
//   split them and store the three bf16 planes into one of two 6 KB A
//   stages, which the next k-step's wgmmas read from shared memory (with
//   A from registers, split each k-step, ptxas serialized the narrow
//   kernel's wgmmas: C7512). The next k-step's loads are issued before
//   this one's wgmmas and its planes stored while they run; the 256
//   threads meet at a barrier a k-step;
// - thread 0 copies the CTA's columns of each k-step of the split pack
//   (PackedMLP.weights_f32tc1k lays each k-step of a segment out quarter
//   by quarter: one contiguous run of three planes, 24 KB at most) with
//   one cp.async.bulk onto an mbarrier, into a ring of 3 stages, up to two
//   ahead across layers and tiles, the refills issued behind the k-step's
//   wgmmas; each warp releases a stage with one arrival (no producer
//   warpgroup: the launch bounds leave every thread the registers the
//   three sums need);
// - the CTAs of a cluster meet at a cluster barrier after each layer's
//   epilogue (the outputs whole, the inputs read by every peer); each
//   computes its columns' part of the heads and CTA 0 adds the four parts
//   in rank order.
// Shared memory: ring 72 KB, two output buffers 128 KB, two A stages 12
// KB, the tile's points and dirs 1.5 KB, the head parts 1 KB, the chunk
// table 1.6 KB: 216 KB of the 227 KB a block may use. Widths pad to
// multiples of 64; padding weights and biases are zero, so padding columns
// stay 0.

#include "fused_mlp_cluster.cuh"
#include "fused_mlp_wide1k.cuh"
#include "fused_mlp_wide_tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::wide1k;
using f32tc::consumers_barrier;
using f32tc::enc_at;
using f32tc::p_off;
using f32tc::split3;
using wide::Share;

constexpr int kBlock = 64;                          // samples a tile
constexpr int kQuarters = 4;                        // CTAs of a cluster, all on one tile
constexpr int kThreads = kConsumers;                // two warpgroups, no producer
constexpr int kMaxCols = 4 * kPiece;                // a CTA's columns of a layer, at most
constexpr int kStepK = 16;                          // k rows a ring chunk: one k-step
constexpr int kStepBytes = 3 * kStepK * kMaxCols * 2;   // 24 KB: its three planes
constexpr int kStages = 3;
constexpr int kPlaneA = kBlock * kStepK * 2;        // 2 KB: a k-step of one A plane
constexpr int kMaxSegs = 2 * kWideMaxDepth + 3;     // segments a forward reads

// A CTA's chunks of one segment: `steps` k-steps, the first at element
// `off` of the pack, each `stride` elements after the one before, `bytes`
// each.
struct Seg {
  long long off;
  int steps, stride;
  uint32_t bytes;
};

// Thread 0's walk over the chunk table, `laps` times over, and the stages
// it fills (in shared memory, so that no other thread holds it).
struct Feed {
  const __nv_bfloat16* w;
  long long laps;
  int count, i, s;                     // segments; the next chunk: segment i, step s
  int fill_stage, ahead;               // the next stage to fill; chunks copied, not acquired
  uint32_t fill_phase;
};

// Shared memory, in bytes from the dynamic base.
constexpr int kActBytes = kMaxCols * kBlock * 4;                 // 64 KB: f32 [column][row]
constexpr int kActOff = kStages * kStepBytes;                    // ring first
constexpr int kAOff = kActOff + 2 * kActBytes;                   // two A stages of 3 planes
constexpr int kInOff = kAOff + 2 * 3 * kPlaneA;                  // points, dirs [6][64]
constexpr int kPartOff = kInOff + 6 * kBlock * 4;                // head parts [4][64]
constexpr int kSegOff = kPartOff + 4 * kBlock * 4;               // the chunk table
constexpr int kFeedOff = kSegOff + kMaxSegs * static_cast<int>(sizeof(Seg));
constexpr int kBarOff = kFeedOff + 64;                           // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(sizeof(Feed) <= 64, "Feed's slot");
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

// CTA q's quarter of np 64-column pieces: the first np % 4 quarters take
// one piece more than the rest.
struct Quarter {
  int p0, count;
  __device__ __forceinline__ Quarter(int np, int q)
      : p0(q * (np / kQuarters) + min(q, np % kQuarters)),
        count(np / kQuarters + (q < np % kQuarters ? 1 : 0)) {}
};


__device__ __forceinline__ Feed& feed() {
  extern __shared__ __align__(1024) uint8_t smem[];
  return *reinterpret_cast<Feed*>(smem + kFeedOff);
}

__device__ __forceinline__ const Seg& seg_at(int i) {
  extern __shared__ __align__(1024) uint8_t smem[];
  return reinterpret_cast<const Seg*>(smem + kSegOff)[i];
}

// The quarter that owns piece p of np (< np), by comparisons with the
// quarters' first pieces (a quarter without pieces starts at np).
__device__ __forceinline__ int owner(int np, int p) {
  return (p >= Quarter(np, 1).p0) + (p >= Quarter(np, 2).p0) + (p >= Quarter(np, 3).p0);
}

// The weight ring, fed by thread 0 (f32tc::FedPipe's scheme): when it
// acquires, the chunk about to be acquired if it is not copied yet; once
// the k-step's products are issued (refill), as many chunks after it as
// there are free stages, while they run.
struct Ring {
  uint32_t ring, bars;   // full[s] at bars + 8 s, empty[s] at bars + 8 (S + s)
  int stage;
  uint32_t phase;

  // Thread 0: copies the next chunk into the fill stage once it is free
  // (at once, or not at all unless `wait`); false if it did not.
  static __device__ __forceinline__ bool put(uint32_t ring, uint32_t bars, bool wait) {
    Feed& f = feed();
    if (f.laps <= 0) return false;
    const uint32_t full = bars + 8 * f.fill_stage, empty = bars + 8 * (kStages + f.fill_stage);
    if (!wait && !f32tc::mbar_test(empty, f.fill_phase ^ 1)) return false;
    mbar_wait(empty, f.fill_phase ^ 1);
    const Seg& sg = seg_at(f.i);
    mbar_expect_tx(full, sg.bytes);
    bulk_copy(ring + f.fill_stage * kStepBytes, f.w + sg.off + static_cast<long long>(f.s) * sg.stride,
              sg.bytes, full);
    if (++f.s == sg.steps) {
      f.s = 0;
      if (++f.i == f.count) {
        f.i = 0;
        --f.laps;
      }
    }
    ++f.ahead;
    if (++f.fill_stage == kStages) {
      f.fill_stage = 0;
      f.fill_phase ^= 1;
    }
    return true;
  }
  __device__ __forceinline__ uint32_t acquire() {
    if (threadIdx.x == 0) {
      Feed& f = feed();
      if (f.ahead == 0) put(ring, bars, true);
      --f.ahead;
    }
    mbar_wait(bars + 8 * stage, phase);
    __syncwarp();   // the spin may exit lane by lane; wgmma wants the warp converged
    wgmma_fence();
    return ring + stage * kStepBytes;
  }
  __device__ __forceinline__ void refill() {
    if (threadIdx.x == 0) {
      while (feed().ahead < kStages - 1 && put(ring, bars, false)) {
      }
    }
  }
  // After the chunk's wgmmas have retired: lane 0 of each warp arrives
  // (predicated, as cluster::warp_arrive_remote does), eight arrivals a
  // k-step on the stage's barrier rather than 256.
  __device__ __forceinline__ void release() {
    __syncwarp();
    asm volatile(
        "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
        " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bars + 8 * (kStages + stage)),
        "r"(threadIdx.x & 31)
        : "memory");
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A layer's input: kind 0 the trunk (layer outputs, np pieces in the
// quarters' buffers at shared address `buf` of each CTA), 1 the point
// encode, 2 the dir encode; k columns (a multiple of 16).
struct Src {
  int kind, k, np;
  uint32_t buf;
};

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// This thread's values of k-step k0 of src, by the 256 threads: thread t
// the columns 4 (t / 64) .. + 3 of row t % 64. in: the tile's points
// ([0, 3) x 64) and dirs ([3, 6) x 64).
__device__ __forceinline__ void stage_load(const Src& src, int k0, const float* in, float (&v)[4]) {
  const int row = threadIdx.x & (kBlock - 1), c = 4 * (threadIdx.x >> 6);
  if (src.kind == 0) {
    const int p = (k0 + c) / kPiece;
    const int q = owner(src.np, p);
    const int col = k0 + c - Quarter(src.np, q).p0 * kPiece;
    const uint32_t at = cluster::mapa(src.buf + (col * kBlock + row) * 4, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = ld_cluster(at + e * kBlock * 4);
  } else {
    const float* x = in + (src.kind == 1 ? 0 : 3) * kBlock;
    const int count = src.kind == 1 ? 3 + 6 * kXBands : 3 + 6 * kDBands;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = enc_at(x[row], x[kBlock + row], x[2 * kBlock + row], k0 + c + e, count);
    }
  }
}

// stage_load's values split into the three A planes at a (hi, mid, lo,
// kPlaneA apart, p_off order).
__device__ __forceinline__ void stage_store(const float (&v)[4], uint8_t* a) {
  const int row = threadIdx.x & (kBlock - 1), c = 4 * (threadIdx.x >> 6);
  uint32_t h[2], m[2], l[2];
  split3(make_float2(v[0], v[1]), h[0], m[0], l[0]);
  split3(make_float2(v[2], v[3]), h[1], m[1], l[1]);
  const uint32_t off = p_off(row, c);
  *reinterpret_cast<uint2*>(a + off) = make_uint2(h[0], h[1]);
  *reinterpret_cast<uint2*>(a + kPlaneA + off) = make_uint2(m[0], m[1]);
  *reinterpret_cast<uint2*>(a + 2 * kPlaneA + off) = make_uint2(l[0], l[1]);
}

template <int NP>
__device__ __forceinline__ void fence_acc3(float (&x)[2][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(x[p][i])::"memory");
  }
}

// One layer for this CTA's nq columns, this warpgroup's NP pieces from its
// local piece pw: out (f32, [column][row], local columns) = act((run +
// small) + bias), run the hi.hi products promoted a k-step at a time.
// Every thread stages every k-step; a warpgroup without pieces (NP = 0)
// multiplies nothing. col0: the CTA's first column of the layer; n_valid:
// columns with a bias.
template <int NP>
__device__ __forceinline__ void layer_q(Ring& q, const Src& s1, const Src& s2, int nq, int pw,
                                      int col0, const float* __restrict__ bias, int n_valid,
                                      bool relu, float* out, uint8_t* a_stages, const float* in) {
  constexpr int kA[6] = {2, 0, 1, 1, 0, 0};   // x piece of product j (SPLIT_F32_ORDER)
  constexpr int kB[6] = {0, 2, 1, 0, 1, 0};   // w plane of product j
  float big[2][32], small[2][32], run[2][32];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) run[p][i] = 0.f;
  }
  const int steps1 = s1.k / kStepK, steps = steps1 + s2.k / kStepK;
  float v[4];
  stage_load(s1, 0, in, v);
  stage_store(v, a_stages);
  fence_async_smem();
  consumers_barrier();
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const uint32_t a = smem_u32(a_stages + (t & 1) * 3 * kPlaneA);
    fence_acc3<NP>(big);
    fence_acc3<NP>(small);
    const uint32_t b = q.acquire();
    // The next k-step's loads, issued before this one's products so that
    // their latency (the peers' shared memory) runs beside them.
    const bool next = t + 1 < steps, first = t + 1 < steps1;
    if (next) stage_load(first ? s1 : s2, (first ? t + 1 : t + 1 - steps1) * kStepK, in, v);
    if constexpr (NP > 0) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const uint64_t da = desc(a + kA[j] * kPlaneA, 1024, 128);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint64_t db = desc(b + kB[j] * (nq * kStepK * 2) + (pw + p) * 1024, nq * 16, 128);
          if (j < 5) {
            wgmma_64<0, 0>(small[p], da, db, (t == 0 && j == 0) ? 0 : 1);
          } else {
            wgmma_64<0, 0>(big[p], da, db, 0);
          }
        }
      }
    }
    wgmma_commit();
    if (next) {
      // Into the other A stage (its last reader, k-step t - 1, retired
      // before the barrier that ended it).
      stage_store(v, a_stages + ((t + 1) & 1) * 3 * kPlaneA);
      fence_async_smem();
    }
    q.refill();
    wgmma_wait<0>();
    fence_acc3<NP>(big);
    fence_acc3<NP>(small);
    q.release();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) run[p][i] += big[p][i];
    }
    consumers_barrier();   // the next stage written; this one's wgmmas retired
  }
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // Accumulator element 4 j + 2 r + e sits at row row0 + 8 r and
      // column 8 j + 2 (lane % 4) + e of the piece.
      const int col = (pw + p) * kPiece + j * 8 + 2 * (lane & 3);
      float2 bv = make_float2(0.f, 0.f);
      if (col0 + col < n_valid) bv = __ldg(reinterpret_cast<const float2*>(bias + col0 + col));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v0 = (run[p][4 * j + 2 * r] + small[p][4 * j + 2 * r]) + bv.x;
        float v1 = (run[p][4 * j + 2 * r + 1] + small[p][4 * j + 2 * r + 1]) + bv.y;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        out[col * kBlock + row0 + 8 * r] = v0;
        out[(col + 1) * kBlock + row0 + 8 * r] = v1;
      }
    }
  }
}

// Layer i's segments in the order the kernel reads them: i < depth the
// trunk layers (a skip layer's encode part first), then the bottleneck and
// the view layer (its dir-encode part second).
struct LayerIo {
  long long off1, off2;   // segments in the pack (-1: none)
  int k1, k2, n;
};

__device__ __forceinline__ LayerIo layer_io(const WideLayout& P, int i, int nw, int nv) {
  if (i == 0) return {P.w_dense[0], -1, kEncX, 0, nw};
  if (i < P.depth) {
    if (P.w_skip[i] >= 0) return {P.w_skip[i], P.w_dense[i], kEncX, nw, nw};
    return {P.w_dense[i], -1, nw, 0, nw};
  }
  if (i == P.depth) return {P.w_bneck, -1, nw, 0, nw};
  return {P.w_view, P.w_view_dir, nw, kEncD, nv};
}

// This CTA's part of a head over its nq columns of `act` (f32 [column]
// [row]) for head_row(): sum of act * w[(col0 + col) * stride + c] over
// the columns below n_valid, the row's four threads a quarter each, in
// order, added as (q0 + q1) + (q2 + q3).
__device__ __forceinline__ float head_part(const float* act, int nq, int col0, int n_valid,
                                           const float* __restrict__ w, int stride, int c) {
  const int row = f32tc::head_row(), h = nq >> 2, i0 = (threadIdx.x & 3) * h;
  float acc = 0.f;
  for (int i = i0; i < i0 + h; ++i) {
    if (col0 + i < n_valid) acc = fmaf(act[i * kBlock + row], __ldg(w + (col0 + i) * stride + c), acc);
  }
  acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
  return acc + __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
}

// CTA 0's sum of the four CTAs' parts in slot `slot` for row `row`, in
// rank order.
__device__ __forceinline__ float head_total(uint32_t parts, int slot, int row) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kQuarters; ++r) {
    acc += ld_cluster(cluster::mapa(parts + (slot * kBlock + row) * 4, r));
  }
  return acc;
}

// Tiles tile_lo .. tile_hi - 1 of 64 samples, one a cluster (rows past n
// read zeros and are never stored). P: the split pack's table (its layer
// segments), L: the f32 pack's (the heads) and the biases'. With rec (the
// record mode): every layer's output into the record of tile t - tile_lo
// (rec_stride floats a tile), and no heads.
template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_wide1k_f32tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                              long long n, long long dir_div, const float* __restrict__ w32,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias, const WideLayout L,
                              const WideLayout P, const int nw, const int nv,
                              float* __restrict__ rgb, float* __restrict__ sigma,
                              const long long tile_lo, const long long tile_hi,
                              float* __restrict__ rec, const long long rec_stride) {
  extern __shared__ __align__(1024) uint8_t smem[];
  float* bufs = reinterpret_cast<float*>(smem + kActOff);   // two of kActBytes
  uint8_t* a_stages = smem + kAOff;
  float* in = reinterpret_cast<float*>(smem + kInOff);
  float* parts = reinterpret_cast<float*>(smem + kPartOff);
  Seg* segs = reinterpret_cast<Seg*>(smem + kSegOff);
  const uint32_t bars = smem_u32(smem + kBarOff);
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster::ctarank());
  const long long first_tile = tile_lo + blockIdx.x / kQuarters;
  const long long tile_step = gridDim.x / kQuarters;
  const int layers = kSigmaOnly ? L.depth : L.depth + 2;

  if (tid == 0) {
    // This CTA's chunks of every segment, in the order the layers read
    // them (a quarter without pieces of a layer reads none of it).
    int count = 0;
    for (int i = 0; i < layers; ++i) {
      const LayerIo io = layer_io(P, i, nw, nv);
      const Quarter qt(io.n / kPiece, rank);
      for (int src = 0; src < 2 && qt.count > 0; ++src) {
        const long long off = src ? io.off2 : io.off1;
        const int k = src ? io.k2 : io.k1;
        if (k == 0) continue;
        segs[count++] = {off + 3LL * kStepK * kPiece * qt.p0, k / kStepK, 3 * kStepK * io.n,
                         static_cast<uint32_t>(3 * kStepK * qt.count * kPiece * 2)};
      }
    }
    feed() = Feed{w, (tile_hi - first_tile + tile_step - 1) / tile_step, count, 0, 0, 0, 0, 0u};
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster::cluster_sync();   // the barriers, the table; every CTA of the cluster started

  // Every branch below is uniform across a warp, or guards stores only.
  const int g = __shfl_sync(0xFFFFFFFFu, tid >> 7, 0);
  Ring q{smem_u32(smem), bars, 0, 0u};
  const uint32_t s_parts = smem_u32(parts);

  for (long long tile = first_tile; tile < tile_hi; tile += tile_step) {
    // The tile's points and dirs (rows past n zeros); the last tile's
    // reads of them ended behind its layers' barriers.
    if (tid < 2 * kBlock) {
      const int r = tid & (kBlock - 1);
      const bool dir = tid >= kBlock;
      const long long s = tile * kBlock + r;
      float x[3] = {0.f, 0.f, 0.f};
      if (s < n) {
        const float* src = dir ? dirs + (s / dir_div) * 3 : pts + s * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = src[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) in[((dir ? 3 : 0) + c) * kBlock + r] = x[c];
    }
    consumers_barrier();

    // The trunk, then (unless sigma-only) the bottleneck (no activation)
    // and the view layer (bottleneck part plus dir-encode part, ReLU), from
    // one call site; layer i writes buffer i % 2 and reads the other.
    const int hrow = f32tc::head_row();
    const long long srow = tile * kBlock + tid;
    for (int i = 0; i < layers; ++i) {
      const LayerIo io = layer_io(P, i, nw, nv);
      const bool view = i == L.depth + 1;
      const bool skip = i > 0 && i < L.depth && L.w_skip[i] >= 0;
      float* out = bufs + (i & 1) * (kActBytes / 4);
      const Src trunk{0, nw, nw / kPiece, smem_u32(bufs + ((i + 1) & 1) * (kActBytes / 4))};
      const Src none{0, 0, 1, 0u};
      const Src s1 = (i == 0 || skip) ? Src{1, kEncX, 0, 0u} : trunk;
      const Src s2 = skip ? trunk : (view ? Src{2, kEncD, 0, 0u} : none);
      const Quarter qt(io.n / kPiece, rank);
      const long long b = i < L.depth ? L.b_dense[i] : (view ? L.b_view : L.b_bneck);
      if (qt.count > 0) {
        const Share sh(qt.count, g);
        const int nq = qt.count * kPiece, col0 = qt.p0 * kPiece;
        const int n_valid = view ? L.ldv : L.ldw;
        switch (sh.count) {
          case 0:
            layer_q<0>(q, s1, s2, nq, sh.p0, col0, bias + b, n_valid, i != L.depth, out, a_stages,
                     in);
            break;
          case 1:
            layer_q<1>(q, s1, s2, nq, sh.p0, col0, bias + b, n_valid, i != L.depth, out, a_stages,
                     in);
            break;
          default:
            layer_q<2>(q, s1, s2, nq, sh.p0, col0, bias + b, n_valid, i != L.depth, out, a_stages,
                     in);
            break;
        }
      }
      cluster::cluster_sync();   // the outputs whole in every CTA; the inputs read by all
      if (rec != nullptr) {
        // This CTA's columns of the output into record slot i (ld columns,
        // ws_index order); the buffer is next written two layers on, after
        // a cluster barrier that every thread reaches after these stores.
        const int ld = view ? L.ldv : L.ldw, col0 = qt.p0 * kPiece;
        float* slot = f32tc::ws_slot(rec + (tile - tile_lo) * rec_stride, i, L.ldw, kBlock);
        for (int e = tid; e < qt.count * kPiece * kBlock; e += kThreads) {
          const int col = e / kBlock, row = e % kBlock;
          if (col0 + col < ld) {
            __stcg(slot + f32tc::ws_index(row, col0 + col, ld >> 3), out[col * kBlock + row]);
          }
        }
        continue;
      }
      if (i != L.depth - 1 && i != L.depth + 1) continue;
      // A head: this CTA's part, then CTA 0's sum of the four.
      const int nq = qt.count * kPiece, col0 = qt.p0 * kPiece;
      if (i == L.depth - 1) {
        const float part = head_part(out, nq, col0, L.ldw, w32 + L.w_alpha, 1, 0);
        if (!(tid & 3)) parts[hrow] = part;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float part = head_part(out, nq, col0, L.ldv, w32 + L.w_rgb, 3, c);
          if (!(tid & 3)) parts[(1 + c) * kBlock + hrow] = part;
        }
      }
      cluster::cluster_sync();
      if (rank == 0 && tid < kBlock && srow < n) {
        if (i == L.depth - 1) {
          sigma[srow] = fmaxf(head_total(s_parts, 0, tid) + __ldg(bias + L.b_alpha), 0.f);
          if (kSigmaOnly) {
            rgb[srow * 3] = 0.f;
            rgb[srow * 3 + 1] = 0.f;
            rgb[srow * 3 + 2] = 0.f;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float x = head_total(s_parts, 1 + c, tid) + __ldg(bias + L.b_rgb + c);
            rgb[srow * 3 + c] = 1.f / (1.f + expf(-x));
          }
        }
      }
    }
  }
  cluster::cluster_sync();   // no CTA leaves while a peer may read its shared memory
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* w32, const __nv_bfloat16* w, const float* bias,
                   const WideLayout& L, const WideLayout& P, float* rgb, float* sigma,
                   long long tile_lo, long long tile_hi, float* rec, cudaStream_t stream) {
  auto kernel = fused_mlp_wide1k_f32tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // Clusters of four CTAs, as many as fit the card at once (one CTA an
  // SM) and the tiles need.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kQuarters;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kQuarters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = tile_hi - tile_lo;
  cfg.gridDim = dim3(static_cast<unsigned>((tiles < fit ? tiles : fit) * kQuarters));
  const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the split pack
  const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
  const long long rec_stride = f32tc::ws_stride(L.depth, L.ldw, L.ldv, kBlock);
  err = cudaLaunchKernelEx(&cfg, kernel, pts, dirs, n, dir_div, w32, w, bias, L, P, nw, nv, rgb,
                           sigma, tile_lo, tile_hi, rec, rec_stride);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// nerf_fused_mlp_f32tc_forward's contract for widths up to 1024: pts (n,
// 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row s / dir_div;
// weights (PackedMLP.weights, f32: the heads), weights_1k
// (PackedMLP.weights_f32tc1k, bf16, 16-byte aligned), biases (f32);
// layout and layout_1k, their kWideLayoutLen host int64 offset tables
// (layout_1k's head entries are -1; its bias entries are layout's); rgb
// (n, 3) and sigma (n,) f32 outputs. Returns a cudaError_t value (0 =
// launched).
extern "C" int nerf_fused_mlp_wide1k_f32tc_forward(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* weights,
    const void* weights_1k, const void* biases, const long long* layout,
    const long long* layout_1k, int layout_len, int ldw, int ldv, int depth, int sigma_only,
    void* rgb, void* sigma, int device, void* stream) {
  WideLayout L, P;
  if (layout_len != kWideLayoutLen) return static_cast<int>(cudaErrorInvalidValue);
  // The split pack's table with the f32 pack's head entries, so that one
  // parser checks both.
  long long table[kWideLayoutLen];
  for (int i = 0; i < kWideLayoutLen; ++i) table[i] = layout_1k[i];
  table[2 * kWideMaxDepth] = layout[2 * kWideMaxDepth];            // alpha
  table[2 * kWideMaxDepth + 4] = layout[2 * kWideMaxDepth + 4];    // rgb
  if (!parse_wide1k_layout(layout, layout_len, ldw, ldv, depth, &L) ||
      !parse_wide1k_layout(table, layout_len, ldw, ldv, depth, &P) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(weights_1k) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* w32 = static_cast<const float*>(weights);
  const auto* w = static_cast<const __nv_bfloat16*>(weights_1k);
  const float* b = static_cast<const float*>(biases);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kBlock - 1) / kBlock;
  err = sigma_only
            ? launch<true>(p, d, n, dir_div, w32, w, b, L, P, o_rgb, o_sigma, 0, tiles, nullptr, s)
            : launch<false>(p, d, n, dir_div, w32, w, b, L, P, o_rgb, o_sigma, 0, tiles, nullptr,
                            s);
  return static_cast<int>(err);
}

// The record mode: the forward's contract without rgb and sigma, over the
// tiles of samples row0 .. row0 + rows - 1 (row0 and rows multiples of 64;
// samples from n on read zeros), each tile's trunk outputs, bottleneck
// output and view output (the last two unless sigma_only) into the record
// ws (fused_mlp_f32tc.cuh's ws_stride(depth, ldw, ldv, 64) floats a tile,
// row0's first; its encode slots unwritten). K2 past width 512 runs it
// before each round. Returns a cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_wide1k_f32tc_record(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* weights,
    const void* weights_1k, const void* biases, const long long* layout,
    const long long* layout_1k, int layout_len, int ldw, int ldv, int depth, int sigma_only,
    long long row0, long long rows, void* ws, int device, void* stream) {
  WideLayout L, P;
  if (layout_len != kWideLayoutLen) return static_cast<int>(cudaErrorInvalidValue);
  long long table[kWideLayoutLen];
  for (int i = 0; i < kWideLayoutLen; ++i) table[i] = layout_1k[i];
  table[2 * kWideMaxDepth] = layout[2 * kWideMaxDepth];
  table[2 * kWideMaxDepth + 4] = layout[2 * kWideMaxDepth + 4];
  if (!parse_wide1k_layout(layout, layout_len, ldw, ldv, depth, &L) ||
      !parse_wide1k_layout(table, layout_len, ldw, ldv, depth, &P) || dir_div < 1 || n < 1 ||
      row0 < 0 || row0 % kBlock != 0 || rows < 1 || rows % kBlock != 0 || row0 >= n ||
      ws == nullptr || reinterpret_cast<uintptr_t>(weights_1k) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* w32 = static_cast<const float*>(weights);
  const auto* w = static_cast<const __nv_bfloat16*>(weights_1k);
  const float* b = static_cast<const float*>(biases);
  float* r = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long t0 = row0 / kBlock, t1 = t0 + rows / kBlock;
  err = sigma_only ? launch<true>(p, d, n, dir_div, w32, w, b, L, P, nullptr, nullptr, t0, t1, r, s)
                   : launch<false>(p, d, n, dir_div, w32, w, b, L, P, nullptr, nullptr, t0, t1,
                                   r, s);
  return static_cast<int>(err);
}
