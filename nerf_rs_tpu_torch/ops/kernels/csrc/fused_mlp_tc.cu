// Fused NeRF MLP forward in bf16 on Hopper's tensor cores (sm_90a): the
// positional encode, the trunk with its skip layer, the sigma head and,
// unless sigma_only, the bottleneck, the view layer and the rgb head, in
// one persistent kernel. Activations never leave the SM.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call at fused_mlp.py:779 -> :795, _kernel_body -> _mlp_chain) for
// dtype="bfloat16"; the float32 mode stays on the CUDA cores
// (fused_mlp.cu).
//
// Numerics, the bf16 contract of ops/kernels/fused_mlp.py: the encode
// (exact sinf/cosf), the weights and each layer's input activations are
// bf16; wgmma multiplies bf16 and accumulates in f32; bias, ReLU and the
// round to bf16 follow each layer; the heads read the rounded activations
// and write f32. Only the f32 summation order differs from the plain
// version.
//
// What bounds it on the H100: at 128 samples a tile, the tensor cores
// (1.19 MFLOP a fine sample at 989 TFLOP/s) and, nearly as tight, L2: the
// whole bf16 pack (1.19 MB for the lego fine network) streams through
// shared memory once per tile, 14.6 GB a 8192 x 192 call. The design:
// - a persistent grid, one CTA of 384 threads an SM, walking 128-sample
//   tiles: two consumer warpgroups of 64 rows each and a producer
//   warpgroup, whose registers setmaxnreg hands to the consumers;
// - the producer copies each layer's weights, 64 K-rows at a time, with
//   one cp.async.bulk onto an mbarrier into a ring of 4 stages of 32 KB,
//   running ahead of the consumers across layers and tiles; the pack is
//   pre-tiled on the host (fused_mlp.py::tc_tile) into wgmma's
//   no-swizzle K-major core-matrix order, so a chunk is one contiguous run
//   and needs no tensor map;
// - each consumer warpgroup issues m64n64k16 wgmmas (A: its 64 rows of
//   the activation or encode buffer, B: the chunk) into up to four 64-col
//   f32 accumulators (128 registers a thread), releases each chunk as soon
//   as its wgmmas retire, then adds the bias, applies the ReLU, rounds to
//   bf16 and writes its own 64 rows of the one activation buffer in the
//   same core-matrix order, for the next layer's A;
// - the skip and view layers are two wgmma sequences into one accumulator
//   (encode rows plus trunk rows; trunk rows plus dir-encode rows);
// - the encode and the heads (alpha width -> 1, rgb v_width -> 3) run on
//   the CUDA cores of the consumer threads, from shared memory.
// Widths pad to multiples of 64 (the wgmma N of one piece); padding
// weights and biases are zero, so padding columns stay 0.
//
// The pack (PackedMLP.weights_tc) and its offset table (layout_tc) are
// this kernel's own; the table has the order of fused_mlp_common.cuh's
// Layout, so the same parse and the same entry signature as fused_mlp.cu
// serve it. Its layer segments are tiled as above, its head segments are
// fused_mlp_common.cuh's K-major (ldw, 1) and (ldv, 3) rows.

#include "fused_mlp_common.cuh"

namespace {

using namespace nerf;

constexpr int kRows = 128;                 // samples a tile, 64 per consumer warpgroup
constexpr int kPiece = 64;                 // wgmma N of one instruction
constexpr int kChunkK = 64;                // weight K rows per bulk copy
constexpr int kStages = 4;
constexpr int kStageBytes = kChunkK * kMaxWidth * 2;
constexpr int kConsumers = 256;
constexpr int kThreadsTc = kConsumers + 128;   // + the producer warpgroup
// Registers a thread (65,536 an SM): 168 at launch; the producer drops to
// 40, the consumers (128 accumulators each) rise to 232.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kXBands = 10, kDBands = 4;   // encoding bands (points, dirs)

// Shared memory, in bytes from the dynamic base.
constexpr int kActOff = kStages * kStageBytes;            // ring first
constexpr int kEncXOff = kActOff + kRows * kMaxWidth * 2;
constexpr int kEncDOff = kEncXOff + kRows * kEncX * 2;
constexpr int kHeadOff = kEncDOff + kRows * kEncD * 2;    // alpha [256], rgb [256][3] f32
constexpr int kBarOff = kHeadOff + 4 * kMaxWidth * 4;     // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wg_barrier(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(g + 1) : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas.
template <int NP>
__device__ __forceinline__ void fence_acc(float (&acc)[4][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[p][i])::"memory");
  }
}

// wgmma matrix descriptor, no swizzle: start address, LBO (stride between
// the two core matrices of a k-step, along K) and SBO (stride between
// 8-row groups, along M or N), all in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 64, f32) = a (64 x 16, bf16) * b (16 x 64, bf16) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Byte offset of (row, col) in a kRows-row buffer in K-major core-matrix
// order: 8 x 8 blocks of 16-byte rows, all row groups of one 8-column
// group contiguous. A k-step's two column groups lie kRows * 16 apart.
__device__ __forceinline__ uint32_t a_off(int row, int col) {
  return (col >> 3) * (kRows * 16) + (row >> 3) * 128 + (row & 7) * 16 + (col & 7) * 2;
}

__device__ __forceinline__ void st_bf16(uint8_t* buf, int row, int col, float v) {
  *reinterpret_cast<__nv_bfloat16*>(buf + a_off(row, col)) = __float2bfloat16_rn(v);
}

// The consumers' walk through the weight ring.
struct Pipe {
  uint32_t ring, bars;   // ring base; full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)
  int stage;
  uint32_t phase;
  int pending;           // stage whose wgmmas may still run, or -1
};

// Accumulates a (this warpgroup's 64 rows of an A buffer, k columns)
// times the next k / 64 ring chunks (k x n) into acc's NP pieces.
template <int NP>
__device__ __forceinline__ void mma_source(float (&acc)[4][32], Pipe& q, uint32_t a, int k, int n,
                                           bool& first) {
  for (int c = 0; c < k; c += kChunkK) {
    const int kc = min(kChunkK, k - c);
    mbar_wait(q.bars + 8 * q.stage, q.phase);
    __syncwarp();   // the spin may exit lane by lane; wgmma wants the warp converged
    wgmma_fence();
    const uint32_t b = q.ring + q.stage * kStageBytes;
    for (int s = 0; s < kc; s += 16) {
      const uint64_t da = desc(a + ((c + s) >> 3) * (kRows * 16), kRows * 16, 128);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_64(acc[p], da, desc(b + p * 1024 + (s >> 3) * (n * 16), n * 16, 128), first ? 0 : 1);
      }
      first = false;
    }
    wgmma_commit();
    if (q.pending >= 0) {
      wgmma_wait<1>();
      mbar_arrive(q.bars + 8 * (kStages + q.pending));
    }
    q.pending = q.stage;
    if (++q.stage == kStages) {
      q.stage = 0;
      q.phase ^= 1;
    }
  }
}

// One layer for this warpgroup: out = act(a1 w1 [+ a2 w2] + bias), bf16,
// into its 64 rows of the activation buffer. n_valid: columns with a bias.
template <int NP>
__device__ __forceinline__ void layer(Pipe& q, uint32_t a1, int k1, uint32_t a2, int k2, int n,
                                      const float* __restrict__ bias, int n_valid, bool relu,
                                      uint8_t* act, int g) {
  float acc[4][32];
  fence_acc<NP>(acc);
  bool first = true;
  mma_source<NP>(acc, q, a1, k1, n, first);
  if (k2 > 0) mma_source<NP>(acc, q, a2, k2, n, first);
  wgmma_wait<0>();
  fence_acc<NP>(acc);
  mbar_arrive(q.bars + 8 * (kStages + q.pending));
  q.pending = -1;
  wg_barrier(g);   // every warp's wgmmas have read the activations it overwrites
  const int lane = threadIdx.x & 31;
  const int row0 = g * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // Accumulator element 4 j + 2 r + e sits at row row0 + 8 r and
      // column 8 j + 2 (lane % 4) + e of the piece.
      const int col = p * kPiece + j * 8 + 2 * (lane & 3);
      float2 b = make_float2(0.f, 0.f);
      if (col < n_valid) b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v0 = acc[p][4 * j + 2 * r] + b.x;
        float v1 = acc[p][4 * j + 2 * r + 1] + b.y;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(act + a_off(row0 + 8 * r, col)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  fence_async_smem();
  wg_barrier(g);
}

// layer<NP> for a runtime NP in 1..4, inlined at each call site so that
// the accumulators stay in registers.
__device__ __forceinline__ void layer_any(int np, Pipe& q, uint32_t a1, int k1, uint32_t a2, int k2,
                                          int n, const float* __restrict__ bias, int n_valid,
                                          bool relu, uint8_t* act, int g) {
  switch (np) {
    case 1: layer<1>(q, a1, k1, a2, k2, n, bias, n_valid, relu, act, g); break;
    case 2: layer<2>(q, a1, k1, a2, k2, n, bias, n_valid, relu, act, g); break;
    case 3: layer<3>(q, a1, k1, a2, k2, n, bias, n_valid, relu, act, g); break;
    default: layer<4>(q, a1, k1, a2, k2, n, bias, n_valid, relu, act, g); break;
  }
}

// Dot product of row `row` of the activation buffer (columns [0, k), a
// multiple of 8) with w[c + stride * col].
__device__ __forceinline__ float row_dot(const uint8_t* act, int row, int k, const float* w,
                                         int stride, int c) {
  float acc = 0.f;
  for (int kg = 0; kg < k; kg += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(act + a_off(row, kg));
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc = fmaf(__uint_as_float(u[e] << 16), w[(kg + 2 * e) * stride + c], acc);
      acc = fmaf(__uint_as_float(u[e] & 0xFFFF0000u), w[(kg + 2 * e + 1) * stride + c], acc);
    }
  }
  return acc;
}

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreadsTc, 1)
fused_mlp_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
                    long long dir_div, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, const Layout L, const int nw, const int nv,
                    float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* act = smem + kActOff;
  uint8_t* enc_x = smem + kEncXOff;
  uint8_t* enc_d = smem + kEncDOff;
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kMaxWidth;
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kRows - 1) / kRows;
  const int tid = threadIdx.x;

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
    // Producer warpgroup: one thread copies the chunks in the consumers'
    // order; the warpgroup hands its registers to the consumers.
    reg_dealloc<kProducerRegs>();
    if (tid != kConsumers) return;
    const uint32_t ring = smem_u32(smem);
    int stage = 0;
    uint32_t phase = 0;
    auto emit = [&](long long off, int k, int nn) {
      for (int c = 0; c < k; c += kChunkK) {
        const uint32_t bytes = static_cast<uint32_t>(min(kChunkK, k - c) * nn * 2);
        mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
        mbar_expect_tx(bars + 8 * stage, bytes);
        bulk_copy(ring + stage * kStageBytes, w + off + static_cast<long long>(c) * nn, bytes,
                  bars + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    };
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      emit(L.w_dense[0], kEncX, nw);
      for (int i = 1; i < L.depth; ++i) {
        if (L.w_skip[i] >= 0) emit(L.w_skip[i], kEncX, nw);
        emit(L.w_dense[i], nw, nw);
      }
      if (!kSigmaOnly) {
        emit(L.w_bneck, nw, nw);
        emit(L.w_view, nw, nv);
        emit(L.w_view_dir, kEncD, nv);
      }
    }
    return;
  }

  // Consumers: warpgroup g owns rows [64 g, 64 g + 64) of every tile.
  // Every branch below is uniform across a warp, or guards stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  const int t = tid & 127;
  const int npw = nw / kPiece, npv = nv / kPiece;
  Pipe q{smem_u32(smem), bars, 0, 0u, -1};
  const uint32_t a_act = smem_u32(act) + g * 1024;     // row 64 g: 8 row groups of 128 B
  const uint32_t a_ex = smem_u32(enc_x) + g * 1024;
  const uint32_t a_ed = smem_u32(enc_d) + g * 1024;
  // Thread t works on row g * 64 + t % 64, in half t / 64 of its encode;
  // both halves compute the heads of that row, the first half stores them.
  const int row = g * 64 + (t & 63);
  const bool half = t >= 64;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long s = tile * kRows + row;
    const bool in = s < n;            // rows past n encode zeros and are never stored
    {
      float p[3], d[3];
      const long long r = (in ? s : 0) / dir_div;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] = in ? pts[s * 3 + c] : 0.f;
        d[c] = in ? dirs[r * 3 + c] : 0.f;
      }
      // The first half: the points' identity and bands 0-6; the second:
      // the dirs' identity and bands 0-3, the points' bands 7-9, and the
      // padding columns (63 of the points, 27-31 of the dirs).
      uint8_t* ibuf = half ? enc_d : enc_x;
#pragma unroll
      for (int c = 0; c < 3; ++c) st_bf16(ibuf, row, c, half ? d[c] : p[c]);
#pragma unroll
      for (int z = 0; z < 5; ++z) st_bf16(ibuf, row, half ? 3 + 6 * kDBands + z : kEncX - 1, 0.f);
#pragma unroll
      for (int u = 0; u < 7; ++u) {
        const bool dir_unit = half && u >= 3;
        const int band = half ? (u < 3 ? 7 + u : u - 3) : u;
        const float scale = __int_as_float((127 + band) << 23);   // 2^band, exact
        uint8_t* buf = dir_unit ? enc_d : enc_x;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float sv, cv;
          sincosf((dir_unit ? d[c] : p[c]) * scale, &sv, &cv);
          st_bf16(buf, row, 3 + 6 * band + c, sv);
          st_bf16(buf, row, 6 + 6 * band + c, cv);
        }
      }
    }
    fence_async_smem();
    wg_barrier(g);

    // Trunk.
    layer_any(npw, q, a_ex, kEncX, 0, 0, nw, bias + L.b_dense[0], L.ldw, true, act, g);
    for (int i = 1; i < L.depth; ++i) {
      if (L.w_skip[i] >= 0) {
        layer_any(npw, q, a_ex, kEncX, a_act, nw, nw, bias + L.b_dense[i], L.ldw, true, act, g);
      } else {
        layer_any(npw, q, a_act, nw, 0, 0, nw, bias + L.b_dense[i], L.ldw, true, act, g);
      }
    }

    // Sigma head. The barriers inside `layer` keep these reads before the
    // bottleneck's writes.
    const float sig =
        fmaxf(row_dot(act, row, L.ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha), 0.f);
    if (!half && in) sigma[s] = sig;
    if (kSigmaOnly) {
      if (!half && in) {
        rgb[s * 3] = 0.f;
        rgb[s * 3 + 1] = 0.f;
        rgb[s * 3 + 2] = 0.f;
      }
      continue;
    }

    // Bottleneck (no activation), then the view layer: bottleneck part
    // plus dir-encode part, ReLU.
    layer_any(npw, q, a_act, nw, 0, 0, nw, bias + L.b_bneck, L.ldw, false, act, g);
    layer_any(npv, q, a_act, nw, a_ed, kEncD, nv, bias + L.b_view, L.ldv, true, act, g);

    // Rgb head with sigmoid.
    float out[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = row_dot(act, row, L.ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
      out[c] = 1.f / (1.f + expf(-x));
    }
    if (!half && in) {
      rgb[s * 3] = out[0];
      rgb[s * 3 + 1] = out[1];
      rgb[s * 3 + 2] = out[2];
    }
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const __nv_bfloat16* w, const float* bias, const Layout& L, float* rgb,
                   float* sigma, int device, cudaStream_t stream) {
  auto kernel = fused_mlp_tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the pack
  const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
  kernel<<<grid, kThreadsTc, kSmemBytes, stream>>>(pts, dirs, n, dir_div, w, bias, L, nw, nv, rgb,
                                                   sigma);
  return cudaGetLastError();
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; weights: the tensor-core pack (bf16, 16-byte aligned) and
// biases (f32) as pack_params writes them, layout: its kLayoutLen host
// int64 offsets (layout_tc); rgb (n, 3) and sigma (n,) f32 outputs. The
// signature is nerf_fused_mlp_forward's. Returns a cudaError_t value
// (0 = launched).
extern "C" int nerf_fused_mlp_tc_forward(const void* pts, const void* dirs, long long n,
                                         long long dir_div, const void* weights,
                                         const void* biases, const long long* layout,
                                         int layout_len, int ldw, int ldv, int depth,
                                         int sigma_only, void* rgb, void* sigma, int device,
                                         void* stream) {
  Layout L;
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 2 * kMaxDepth + 5; ++i) {   // the weight segments
    const bool needed = i < depth || i >= 2 * kMaxDepth;
    // Segments start on 16-byte boundaries, as the bulk copies need.
    if ((needed && layout[i] < 0) || (layout[i] >= 0 && layout[i] % 8 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
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
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, device, s)
                   : launch<false>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, device, s);
  return static_cast<int>(err);
}
