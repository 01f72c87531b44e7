// Fused NeRF MLP forward in bf16 on Hopper's tensor cores (sm_90a) for
// networks past width 512: trunk or view widths from 513 up to 1024, up to
// 32 dense layers (fused_mlp_wide1k.cuh). The positional encode, the trunk
// with its skip layer, the sigma head and, unless sigma_only, the
// bottleneck, the view layer and the rgb head, in one persistent kernel;
// activations never leave the cluster's shared memory.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call at fused_mlp.py:779 -> :795) for dtype="bfloat16" where the wide
// bf16 kernel (fused_mlp_wide_tc.cu: widths up to 512) stops; the JAX
// kernel serves any width that is a multiple of 128
// (fused_mlp.py::supports_arch). fused_mlp_wide_tc.cu is unchanged and
// still serves every network up to width 512.
//
// Record mode (nerf_fused_mlp_wide1k_tc_record) is K2's bf16 recompute past
// width 512 (fused_mlp_wide1k_bwd.cu): the same kernel over a round of
// tiles writes the tile's encodes and each CTA's half of every trunk
// layer's and the bottleneck's output, as their shared-memory images, to
// the round's workspace (fused_mlp_wide_dw.cuh: the layer inputs H the dW
// kernel reads) and the view layer's to an image of its own, and stores no
// heads, so the backward differentiates this kernel's own activations and
// ReLU masks, bit for bit.
//
// Numerics: the wide bf16 contract of fused_mlp_wide_tc.cu. The encode
// (exact sincosf), the weights and each layer's input activations are
// bf16; products are summed in f32 over K in order (a skip layer's encode
// part first, the view layer's trunk part first); bias, ReLU and the round
// to bf16 follow each layer; the heads read the rounded activations and
// write f32. Padding weights and biases are zero, so padding columns stay
// 0. A wgmma accumulator rounds toward zero as it adds, so one accumulator
// over all of K drifts with the number of k-steps: at K = 1024 on the lego
// widened 4x (chip_smoke.widen_nerf), three times as many sigmas left the
// bf16 bars of the float64 evaluation as the plain version's (70 against
// 22 of 524,288 on an H100 80GB HBM3, chip_smoke.py phase 29 (e)), from
// bf16 roundings flipped early in the trunk. So each group of 64 K rows
// (4 k-steps: one or two ring chunks, pass_sum) is summed by wgmmas from
// zero and added to a running f32 sum in registers, rounded to nearest.
//
// What bounds it on the H100: at 1024/512/8 a fine sample costs 18.1
// MFLOP (28.8 ms a 8192 x 192 call at 989 TFLOP/s), but the bf16 pack (18.1
// MB) has to reach every 64-sample tile from L2. At width 1024 one tile's
// bf16 activations are 128 KB and a whole layer's f32 accumulators would be
// the entire register file, so one CTA cannot hold a tile's layer:
// - a persistent grid of thread-block clusters of two CTAs, one CTA of 384
//   threads an SM, both CTAs of a cluster on the same 64-sample tile (one
//   wgmma M); CTA r owns half r of every layer's 64-column pieces (the
//   first half rounded up, then the rest), at most 512 columns, which it
//   computes in passes of at most four pieces; in each pass its two
//   consumer warpgroups take at most two pieces each (wide::Share), with
//   a 64-column f32 accumulator and a running sum a piece (128 registers
//   a thread), and keep the pass's rounded outputs as bf16 pairs until the
//   layer's exchange; a producer warpgroup, whose registers setmaxnreg
//   hands to the consumers;
// - each CTA holds the whole layer input (64 x 1024 bf16, 128 KB) and
//   streams only its pass's columns of every weight chunk from L2 (one
//   cp.async.bulk a run of 8 K-rows of those columns: fused_mlp.py::tc_tile
//   lays each 8 K-rows of a segment out column group by column group) into
//   a ring of 4 stages of 16 KB (32 K-rows of 256 columns, or 64 of 128),
//   so the cluster reads the pack once a tile;
// - each consumer warpgroup issues m64n64k16 wgmmas (A: the activation or
//   encode buffer, all of K; B: its pieces of the chunk), waits for them,
//   releases the chunk and adds it to its running sums;
// - the layer's output is exchanged through distributed shared memory:
//   once every consumer thread of both CTAs has arrived on the read
//   barrier of both (its wgmmas retired: nobody reads the layer input any
//   more), each thread writes its rounded bf16 values into its own CTA's
//   activation buffer and into the peer's (st.shared::cluster), fences
//   them for the async proxy and arrives on the written barrier of both;
//   a CTA's next layer starts once all 512 threads have arrived on its own
//   (release and acquire at cluster scope);
// - the encode (64 x 96 bf16, filled once a tile in each CTA) and the heads
//   (four threads a row, a quarter of K each) run on the consumers' CUDA
//   cores; both CTAs compute the heads and rank 0 stores them.
// The whole pack streams from L2 once a tile: about 445 GB for a fine
// 8192 x 192 call at 1024/512/8, which bounds this design well above the
// tensor bound. Sharing the stream across tiles is later work.
// Shared memory: ring 64 KB, activations 128 KB, encodes 12 KB, heads 16
// KB: 220 KB of the 227 KB a block may use.

#include "fused_mlp_cluster.cuh"
#include "fused_mlp_wide1k.cuh"
#include "fused_mlp_wide_dw.cuh"
#include "fused_mlp_wide_tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::wide1k;
using f32tc::head_row;
using f32tc::head_sum;
using wide::encode_tile;
using wide::kBlock;
using wide::ld_act;
using wide::DwWs;
using wide::Share;

constexpr int kClusterW = 2;                 // CTAs on one tile, each on half of N
constexpr int kStages1k = 4;
constexpr int kStageBytes1k = 16 * (kWide1kMaxWidth / 2) * 2;   // 16 KB

// Shared memory, in bytes from the dynamic base.
constexpr int kActOff = kStages1k * kStageBytes1k;                 // ring first
constexpr int kEncXOff = kActOff + kBlock * kWide1kMaxWidth * 2;
constexpr int kEncDOff = kEncXOff + kBlock * kEncX * 2;
constexpr int kHeadOff = kEncDOff + kBlock * kEncD * 2;            // alpha [1024], rgb [1024][3]
constexpr int kBarOff = kHeadOff + 4 * kWide1kMaxWidth * 4;        // full, empty, read, written
constexpr int kSmemBytes = kBarOff + (2 * kStages1k + 2) * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

constexpr int kPassPieces = 4;         // 64-column pieces of a CTA's pass: two a warpgroup

// K rows a ring chunk of a pass holds, nh <= 256 columns wide (16 KB at
// most; a multiple of 16, one wgmma k-step); one chunk is one promotion.
__device__ __forceinline__ int chunk_rows(int nh) { return nh > 128 ? 32 : 64; }

// This CTA's half of np 64-column pieces: the first (np + 1) / 2, or the
// rest.
struct Half {
  int p0, count;
  __device__ __forceinline__ Half(int np, int rank)
      : p0(rank ? (np + 1) / 2 : 0), count(rank ? np / 2 : (np + 1) / 2) {}
};

// Layer i's segments in the order the kernel reads them: i < depth the
// trunk layers (a skip layer's encode part first), then the bottleneck and
// the view layer (its dir-encode part second).
struct LayerIo {
  long long off1, off2;   // segments in the pack (-1: none)
  int k1, k2, n;
};

__device__ __forceinline__ LayerIo layer_io(const WideLayout& L, int i, int nw, int nv) {
  if (i == 0) return {L.w_dense[0], -1, kEncX, 0, nw};
  if (i < L.depth) {
    if (L.w_skip[i] >= 0) return {L.w_skip[i], L.w_dense[i], kEncX, nw, nw};
    return {L.w_dense[i], -1, nw, 0, nw};
  }
  if (i == L.depth) return {L.w_bneck, -1, nw, 0, nw};
  return {L.w_view, L.w_view_dir, nw, kEncD, nv};
}

// The producer thread's walk through the ring: columns [col0, col0 + nh)
// of each chunk (one pass of this CTA's half), one bulk copy a run of 8
// K-rows.
struct PassProducer {
  uint32_t ring, bars;   // full[s] at bars + 8 s, empty[s] at bars + 8 (S + s)
  int stage;
  uint32_t phase;

  // The k rows of a segment of n columns at w + off.
  __device__ __forceinline__ void emit(const __nv_bfloat16* w, long long off, int k, int n,
                                       int col0, int nh) {
    const int ck = chunk_rows(nh);
    const uint32_t run = static_cast<uint32_t>(nh * 16);    // 8 K-rows of nh columns, bytes
    for (int c = 0; c < k; c += ck) {
      const int kc = min(ck, k - c);
      mbar_wait(bars + 8 * (kStages1k + stage), phase ^ 1);
      mbar_expect_tx(bars + 8 * stage, (kc / 8) * run);
      for (int g = 0; g < kc / 8; ++g) {
        bulk_copy(ring + stage * kStageBytes1k + g * run,
                  w + off + static_cast<long long>(c + 8 * g) * n + col0 * 8, run,
                  bars + 8 * stage);
      }
      if (++stage == kStages1k) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
};

// The consumers' walk through the ring: each chunk released as soon as
// its wgmmas have retired.
struct PassRing {
  uint32_t ring, bars;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(bars + 8 * stage, phase);
    __syncwarp();   // the spin may exit lane by lane; wgmma wants the warp converged
    wgmma_fence();
    return ring + stage * kStageBytes1k;
  }
  __device__ __forceinline__ void release() {
    mbar_arrive(bars + 8 * (kStages1k + stage));
    if (++stage == kStages1k) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int NP>
__device__ __forceinline__ void fence_acc2(float (&acc)[2][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[p][i])::"memory");
  }
}

// K rows of a source that one accumulator sums before pass_sum adds them
// to the running sum: two ring chunks of 32 rows, or one of 64.
constexpr int kGroupRows = 64;

// One pass of a layer for this warpgroup: run (NP pieces, from local piece
// pw of the pass's nh columns) = sum over the sources (a1: k1 columns, a2:
// k2) of the A buffer times the next ring chunks. The wgmmas of each group
// of kGroupRows K rows start from zero and their sum is added to run in
// f32 (round to nearest) once they retire: a wgmma's accumulation rounds
// toward zero, so over all of K in one accumulator its error grows with
// the k-steps and does not average out (at K = 1024 it flips bf16
// roundings that cascade). A group of 64 rows, as the <= 512 wide kernels
// sum theirs: on the random 1024/1024/32 network of K2's card test, groups
// of 32 rows put K2 bf16 (which recomputes with this code) further from
// the float64 evaluation than the plain version, groups of 64 nearer
// (tools/torch_wide1k_bf16_groups.py emulates these sums on the CPU).
template <int NP>
__device__ __forceinline__ void pass_sum(float (&run)[2][32], PassRing& q, uint32_t a1, int k1,
                                         uint32_t a2, int k2, int nh, int pw) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) run[p][i] = 0.f;
  }
  float acc[2][32];
  const int ck = chunk_rows(nh);
  for (int src = 0; src < 2; ++src) {
    const uint32_t a = src ? a2 : a1;
    const int k = src ? k2 : k1;
    for (int c = 0; c < k; c += ck) {
      const int kc = min(ck, k - c);
      const bool fresh = c % kGroupRows == 0;                      // the group's first chunk
      const bool ends = (c + kc) % kGroupRows == 0 || c + kc >= k;  // and its last
      fence_acc2<NP>(acc);   // before the wgmma stage opens: nothing else defines acc in it
      const uint32_t b = q.acquire();
      if constexpr (NP > 0) {
        for (int s = 0; s < kc; s += 16) {
          const uint64_t da = desc(a + ((c + s) >> 3) * 1024, 1024, 128);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            wgmma_64<0, 0>(acc[p], da,
                           desc(b + (pw + p) * 1024 + (s >> 3) * (nh * 16), nh * 16, 128),
                           (s || !fresh) ? 1 : 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc2<NP>(acc);
      q.release();
      if (!ends) continue;
      if constexpr (NP > 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
          for (int i = 0; i < 32; ++i) run[p][i] += acc[p][i];
        }
      }
    }
  }
}

// A pass's outputs: bias, ReLU and the round to bf16 of run's NP pieces,
// whose first column is col0, packed as bf16 pairs (element 4 j + 2 r + e
// of a piece at row row0 + 8 r, column 8 j + 2 (lane % 4) + e).
template <int NP>
__device__ __forceinline__ void pass_out(uint32_t (&out)[2][8][2], const float (&run)[2][32],
                                         int col0, const float* __restrict__ bias, int n_valid,
                                         bool relu) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + p * kPiece + j * 8 + 2 * (lane & 3);
      float2 b = make_float2(0.f, 0.f);
      if (col < n_valid) b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v0 = run[p][4 * j + 2 * r] + b.x;
        float v1 = run[p][4 * j + 2 * r + 1] + b.y;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        out[p][j][r] = f32tc::bits(__floats2bfloat162_rn(v0, v1));
      }
    }
  }
}

// The exchange of a layer's output between the two CTAs of a cluster: the
// read and written barriers of this CTA and of the peer (shared::cluster
// addresses), each taking one arrival of every consumer thread of both
// CTAs a layer, and the parity of the layer's phase.
struct Exchange {
  uint32_t read[2], written[2];   // [0] this CTA's, [1] the peer's
  uint32_t act_peer;              // the peer's activation buffer
  uint32_t phase;

  static __device__ __forceinline__ void arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
                 : "memory");
  }
  static __device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } while (!done);
  }
  // Every consumer thread of both CTAs is done reading the layer input.
  __device__ __forceinline__ void both_read(uint32_t local_read) {
    arrive(read[0]);
    arrive(read[1]);
    wait(local_read, phase);
  }
  // Every consumer thread of both CTAs has written its outputs into both.
  __device__ __forceinline__ void both_written(uint32_t local_written) {
    asm volatile("fence.proxy.async;" ::: "memory");   // the writes, for the wgmmas of both
    arrive(written[0]);
    arrive(written[1]);
    wait(local_written, phase);
    fence_async_smem();
    phase ^= 1;
  }
};

__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// One layer: out = act(a1 w1 [+ a2 w2] + bias), bf16, this CTA's half of
// the pieces (count from piece cp0) in passes of kPassPieces, warpgroup g's
// share of each pass into the activation buffers of both CTAs. n_valid:
// columns with a bias. g comes from a __shfl_sync-ed warp index, so that
// ptxas sees the branches on it as warp-uniform (else C7520 serializes
// the wgmmas).
__device__ __forceinline__ void layer_half(PassRing& q, uint32_t a1, int k1, uint32_t a2, int k2,
                                           int cp0, int count, const float* __restrict__ bias,
                                           int n_valid, bool relu, uint8_t* act, Exchange& x,
                                           uint32_t bars, int g) {
  uint32_t out[2][2][8][2];
  int mine[2] = {0, 0}, col0[2] = {0, 0};
  float run[2][32];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int pc = min(count - pass * kPassPieces, kPassPieces);
    if (pc <= 0) continue;
    const Share sh(pc, g);
    const int nh = pc * kPiece;
    mine[pass] = sh.count;
    col0[pass] = (cp0 + pass * kPassPieces + sh.p0) * kPiece;
    switch (sh.count) {
      case 0: pass_sum<0>(run, q, a1, k1, a2, k2, nh, sh.p0); break;
      case 1:
        pass_sum<1>(run, q, a1, k1, a2, k2, nh, sh.p0);
        pass_out<1>(out[pass], run, col0[pass], bias, n_valid, relu);
        break;
      default:
        pass_sum<2>(run, q, a1, k1, a2, k2, nh, sh.p0);
        pass_out<2>(out[pass], run, col0[pass], bias, n_valid, relu);
        break;
    }
  }
  x.both_read(bars + 8 * 2 * kStages1k);   // both CTAs' wgmmas have read what is overwritten
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= mine[pass]) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0[pass] + p * kPiece + j * 8 + 2 * (lane & 3);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = f32tc::p_off(row0 + 8 * r, col);
          *reinterpret_cast<uint32_t*>(act + off) = out[pass][p][j][r];
          st_cluster_u32(x.act_peer + off, out[pass][p][j][r]);
        }
      }
    }
  }
  x.both_written(bars + 8 * (2 * kStages1k + 1));   // the whole output, in both CTAs
}

// Bytes [b0, b1) (multiples of 16) of a shared-memory image to dst, by
// the 256 consumer threads.
__device__ __forceinline__ void image_out(const uint8_t* buf, uint8_t* dst, int b0, int b1) {
  for (int i = b0 / 16 + static_cast<int>(threadIdx.x); i < b1 / 16; i += kConsumers) {
    __stcg(reinterpret_cast<uint4*>(dst) + i, reinterpret_cast<const uint4*>(buf)[i]);
  }
}

// Tiles tile_lo .. tile_hi - 1 of 64 samples, one a cluster. Record mode
// (D.base not null): the encodes and the layer inputs of tile t - tile_lo
// into its images in the workspace D, the view output into view_rec (an
// image of nv columns a tile), and no heads stored.
template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreadsTc, 1)
fused_mlp_wide1k_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                           long long n, long long dir_div, const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias, const WideLayout L, const int nw,
                           const int nv, float* __restrict__ rgb, float* __restrict__ sigma,
                           const long long tile_lo, const long long tile_hi, const DwWs D,
                           uint8_t* __restrict__ view_rec) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* act = smem + kActOff;
  uint8_t* enc_x = smem + kEncXOff;
  uint8_t* enc_d = smem + kEncDOff;
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kWide1kMaxWidth;
  const uint32_t bars = smem_u32(smem + kBarOff);
  const int tid = threadIdx.x;
  const int layers = kSigmaOnly ? L.depth : L.depth + 2;
  const int rank = static_cast<int>(cluster::ctarank());
  const long long first_tile = tile_lo + static_cast<long long>(blockIdx.x) / kClusterW;
  const long long tile_step = static_cast<long long>(gridDim.x) / kClusterW;
  const bool record = D.base != nullptr;

  if (tid == 0) {
    for (int s = 0; s < kStages1k; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages1k + s), kConsumers);
    }
    mbar_init(bars + 8 * 2 * kStages1k, 2 * kConsumers);         // read
    mbar_init(bars + 8 * (2 * kStages1k + 1), 2 * kConsumers);   // written
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = tid; k < L.ldw; k += kThreadsTc) w_alpha[k] = load1(w + L.w_alpha + k);
  for (int k = tid; k < 3 * L.ldv; k += kThreadsTc) w_rgb[k] = load1(w + L.w_rgb + k);
  cluster::cluster_sync();   // both CTAs' barriers, before any remote arrive

  // The role split on a warp-uniform value, rejoined only at the cluster
  // barrier before the exit.
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
  if (warp >= kConsumers / 32) {
    // Producer warpgroup: one thread copies this CTA's half of the chunks
    // in the consumers' order; the warpgroup hands its registers to the
    // consumers.
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      PassProducer pr{smem_u32(smem), bars, 0, 0u};
      for (long long tile = first_tile; tile < tile_hi; tile += tile_step) {
        for (int i = 0; i < layers; ++i) {
          const LayerIo io = layer_io(L, i, nw, nv);
          const Half half(io.n / kPiece, rank);
          for (int p0 = 0; p0 < half.count; p0 += kPassPieces) {
            const int col0 = (half.p0 + p0) * kPiece;
            const int nh = min(kPassPieces, half.count - p0) * kPiece;
            pr.emit(w, io.off1, io.k1, io.n, col0, nh);
            if (io.k2 > 0) pr.emit(w, io.off2, io.k2, io.n, col0, nh);
          }
        }
      }
    }
    cluster::cluster_sync();
    return;
  }

  // Consumers. Every branch below is uniform across a warp, or guards
  // stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  PassRing q{smem_u32(smem), bars, 0, 0u};
  const uint32_t peer = static_cast<uint32_t>(rank ^ 1);
  const uint32_t own = static_cast<uint32_t>(rank);
  const uint32_t rd = bars + 8 * 2 * kStages1k, wr = rd + 8;
  Exchange x{{cluster::mapa(rd, own), cluster::mapa(rd, peer)},
             {cluster::mapa(wr, own), cluster::mapa(wr, peer)},
             cluster::mapa(smem_u32(act), peer), 0u};
  const uint32_t a_act = smem_u32(act), a_ex = smem_u32(enc_x), a_ed = smem_u32(enc_d);
  const int hrow = head_row();
  auto row = [&](int i) { return ld_act(act, hrow, i); };

  for (long long tile = first_tile; tile < tile_hi; tile += tile_step) {
    // The tile's encode, in each CTA. (The last tile's reads of the
    // encodes ended behind its layers' barriers.)
    encode_tile(pts, dirs, n, dir_div, tile, enc_x, enc_d);
    fence_async_smem();
    f32tc::consumers_barrier();
    if (record) {
      if (rank == 0) {
        image_out(enc_x, D.at(0, tile - tile_lo), 0, kBlock * kEncX * 2);
      } else {
        image_out(enc_d, D.at(1, tile - tile_lo), 0, kBlock * kEncD * 2);
      }
    }

    // The trunk, then (unless sigma-only) the bottleneck (no activation)
    // and the view layer (bottleneck part plus dir-encode part, ReLU),
    // from one call site.
    const long long s = static_cast<long long>(tile) * kBlock + hrow;
    // rank 0's first thread of the row stores its heads (none in record mode).
    const bool mine = rank == 0 && !(tid & 3) && s < n && !record;
    for (int i = 0; i < layers; ++i) {
      const LayerIo io = layer_io(L, i, nw, nv);
      const bool view = i == L.depth + 1;
      const bool enc = i == 0 || (i < L.depth && L.w_skip[i] >= 0);
      const long long b = i < L.depth ? L.b_dense[i] : (view ? L.b_view : L.b_bneck);
      const Half half(io.n / kPiece, rank);
      layer_half(q, enc ? a_ex : a_act, io.k1, view ? a_ed : a_act, io.k2, half.p0, half.count,
                 bias + b, view ? L.ldv : L.ldw, i != L.depth, act, x, bars, g);
      if (record) {
        // This CTA's half of the output's image (64-column pieces of 8 KB),
        // read before this thread arrives on the next layer's read barrier,
        // which both CTAs pass before they overwrite act.
        uint8_t* dst = view ? view_rec + (tile - tile_lo) * nv * 128
                            : D.at(DwWs::h(i), tile - tile_lo);
        image_out(act, dst, half.p0 * 8192, (half.p0 + half.count) * 8192);
      }
      if (i != L.depth - 1) continue;
      // Sigma head. Its reads come before this thread's arrivals on the
      // next layer's read barriers, which both CTAs wait on before they
      // write.
      const float sig =
          fmaxf(head_sum(row, L.ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha), 0.f);
      if (mine) sigma[s] = sig;
      if (kSigmaOnly && mine) {
        rgb[s * 3] = 0.f;
        rgb[s * 3 + 1] = 0.f;
        rgb[s * 3 + 2] = 0.f;
      }
    }
    if constexpr (!kSigmaOnly) {
      // Rgb head with sigmoid; its reads come before the next tile's first
      // read barrier.
      float out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xv = head_sum(row, L.ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
        out[c] = 1.f / (1.f + expf(-xv));
      }
      if (mine) {
        rgb[s * 3] = out[0];
        rgb[s * 3 + 1] = out[1];
        rgb[s * 3 + 2] = out[2];
      }
    }
  }
  cluster::cluster_sync();   // no CTA leaves while its peer may write or arrive in it
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const __nv_bfloat16* w, const float* bias, const WideLayout& L, float* rgb,
                   float* sigma, long long tile_lo, long long tile_hi, const DwWs& D,
                   uint8_t* view_rec, cudaStream_t stream) {
  auto kernel = fused_mlp_wide1k_tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // Clusters of two CTAs, as many as fit the card at once (one CTA an SM)
  // and the tiles need.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterW;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterW);
  cfg.blockDim = dim3(kThreadsTc);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = tile_hi - tile_lo;
  cfg.gridDim = dim3(static_cast<unsigned>((tiles < fit ? tiles : fit) * kClusterW));
  const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the pack
  const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
  err = cudaLaunchKernelEx(&cfg, kernel, pts, dirs, n, dir_div, w, bias, L, nw, nv, rgb, sigma,
                           tile_lo, tile_hi, D, view_rec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// nerf_fused_mlp_wide_tc_forward's contract for widths up to 1024: the
// tensor-core pack (PackedMLP.weights_tc, bf16, 16-byte aligned), the
// biases (f32) and layout_tc, its kWideLayoutLen host int64 offsets.
// Returns a cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_wide1k_tc_forward(const void* pts, const void* dirs, long long n,
                                                long long dir_div, const void* weights,
                                                const void* biases, const long long* layout,
                                                int layout_len, int ldw, int ldv, int depth,
                                                int sigma_only, void* rgb, void* sigma, int device,
                                                void* stream) {
  WideLayout L;
  if (!parse_wide1k_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const auto* w = static_cast<const __nv_bfloat16*>(weights);
  const float* b = static_cast<const float*>(biases);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kBlock - 1) / kBlock;
  const DwWs none{nullptr, 0, 1, 0, 0, 0};
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, 0, tiles, none,
                                  nullptr, s)
                   : launch<false>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, 0, tiles, none,
                                   nullptr, s);
  return static_cast<int>(err);
}

// The record mode: the forward's contract without rgb and sigma, over the
// tiles tile0 .. tile0 + tiles - 1 (below ceil(n / 64); samples from n on
// read zeros): each tile's encodes, trunk outputs and bottleneck output
// (unless sigma_only) as bf16 images into the workspace ws
// (fused_mlp_wide_dw.cuh, planes 1, laid out for ws_tiles tiles; tile0's
// are its tile 0), its view output (unless sigma_only) into view (128 nv
// bytes a tile). K2 past width 512 runs it before each round. Returns a
// cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_wide1k_tc_record(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* weights,
    const void* biases, const long long* layout, int layout_len, int ldw, int ldv, int depth,
    int sigma_only, long long tile0, long long tiles, void* ws, long long ws_tiles, void* view,
    int device, void* stream) {
  WideLayout L;
  if (!parse_wide1k_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 1 ||
      tile0 < 0 || tiles < 1 || tiles > ws_tiles || tile0 * kBlock >= n || ws == nullptr ||
      (!sigma_only && view == nullptr) || reinterpret_cast<uintptr_t>(weights) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0 || reinterpret_cast<uintptr_t>(view) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = (ldw + kPiece - 1) / kPiece * kPiece, nv = (ldv + kPiece - 1) / kPiece * kPiece;
  const DwWs D{static_cast<uint8_t*>(ws), ws_tiles, 1, nw, nv, depth};
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const auto* w = static_cast<const __nv_bfloat16*>(weights);
  const float* b = static_cast<const float*>(biases);
  auto* v = static_cast<uint8_t*>(view);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, b, L, nullptr, nullptr, tile0,
                                  tile0 + tiles, D, v, s)
                   : launch<false>(p, d, n, dir_div, w, b, L, nullptr, nullptr, tile0,
                                   tile0 + tiles, D, v, s);
  return static_cast<int>(err);
}
