// The bf16 tensor-core device code of the fused NeRF MLP, shared by the
// forward (fused_mlp_tc.cu, K1) and the backward (fused_mlp_bwd_bf16.cu,
// K2's bf16 mode), so that K2 recomputes the forward with K1's own code:
// the same wgmma k-order, the same roundings, the same activations. The
// int8 kernel (int8_mlp_tc.cu) uses its mbarrier, bulk-copy, descriptor,
// wgmma-fence and Pipe helpers.
//
// Roles: a producer warpgroup copies weight chunks (64 K-rows of a layer
// segment pre-tiled by fused_mlp.py::tc_tile, one contiguous run) with one
// cp.async.bulk each onto an mbarrier, into a ring of S stages of 32 KB;
// two consumer warpgroups of 64 tile rows each issue m64n64k16 wgmmas from
// shared memory and do the elementwise work. Activation and encode buffers
// hold 128 rows in the no-swizzle K-major core-matrix order of a_off.

#pragma once

#include "fused_mlp_common.cuh"

namespace nerf {
namespace tc {

constexpr int kRows = 128;                 // samples a tile, 64 per consumer warpgroup
constexpr int kPiece = 64;                 // wgmma N of one instruction
constexpr int kChunkK = 64;                // weight K rows per bulk copy
constexpr int kStageBytes = kChunkK * kMaxWidth * 2;
constexpr int kConsumers = 256;
constexpr int kThreadsTc = kConsumers + 128;   // + the producer warpgroup
// Registers a thread (65,536 an SM): 168 at launch; the producer drops to
// 40, the consumers (128 accumulators each) rise to 232.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kXBands = 10, kDBands = 4;   // encoding bands (points, dirs)

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

// The 128 threads of consumer warpgroup g (named barriers 1 and 2).
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
// 8-row groups, along M or N), all in bytes. An operand read transposed
// (MN-major, the trans bit set) keeps the same meanings: its core matrix
// is 8 k-rows of 8 consecutive M or N elements.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 64, f32) = a (64 x 16, bf16) * b (16 x 64, bf16) + (scale_d ? d : 0);
// kTa, kTb: a, b read MN-major (transposed).
template <int kTa, int kTb>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTa), "n"(kTb));
}

// Byte offset of (row, col) in a kRows-row buffer in K-major core-matrix
// order: 8 x 8 blocks of 16-byte rows, all row groups of one 8-column
// group contiguous. A k-step's two column groups lie kRows * 16 apart;
// warpgroup g's 64 rows of a column group are the 1 KB at g * 1024.
__device__ __forceinline__ uint32_t a_off(int row, int col) {
  return (col >> 3) * (kRows * 16) + (row >> 3) * 128 + (row & 7) * 16 + (col & 7) * 2;
}

__device__ __forceinline__ void st_bf16(uint8_t* buf, int row, int col, float v) {
  *reinterpret_cast<__nv_bfloat16*>(buf + a_off(row, col)) = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ld_bf16(const uint8_t* buf, int row, int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(buf + a_off(row, col)));
}

// The producer's walk through the ring: copies segment chunks in the
// consumers' order, each stage once its consumers have released it.
template <int S>
struct Producer {
  uint32_t ring, bars;   // full[s] at bars + 8 s, empty[s] at bars + 8 (S + s)
  int stage;
  uint32_t phase;

  // The k rows of a segment of nn columns at w + off, in chunks of kChunkK.
  __device__ __forceinline__ void emit(const __nv_bfloat16* w, long long off, int k, int nn) {
    for (int c = 0; c < k; c += kChunkK) {
      const uint32_t bytes = static_cast<uint32_t>(min(kChunkK, k - c) * nn * 2);
      mbar_wait(bars + 8 * (S + stage), phase ^ 1);
      mbar_expect_tx(bars + 8 * stage, bytes);
      bulk_copy(ring + stage * kStageBytes, w + off + static_cast<long long>(c) * nn, bytes,
                bars + 8 * stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
};

// The consumers' walk through the ring (stages of kBytes).
template <int S, int kBytes = kStageBytes>
struct Pipe {
  uint32_t ring, bars;   // as Producer's
  int stage;
  uint32_t phase;
  int pending;           // stage whose wgmmas may still run, or -1

  // Waits for the next chunk; returns its shared address.
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(bars + 8 * stage, phase);
    __syncwarp();   // the spin may exit lane by lane; wgmma wants the warp converged
    wgmma_fence();
    return ring + stage * kBytes;
  }

  // After the wgmmas on the acquired chunk are committed: releases the
  // chunk before it once its wgmmas retire, and moves on.
  __device__ __forceinline__ void advance() {
    if (pending >= 0) {
      wgmma_wait<1>();
      mbar_arrive(bars + 8 * (S + pending));
    }
    pending = stage;
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

  // After wgmma_wait<0>: releases the last chunk.
  __device__ __forceinline__ void release() {
    mbar_arrive(bars + 8 * (S + pending));
    pending = -1;
  }
};

// Accumulates a (this warpgroup's 64 rows of an A buffer, k columns)
// times the next k / 64 ring chunks (k x n) into acc's NP pieces.
template <int NP, int S>
__device__ __forceinline__ void mma_source(float (&acc)[4][32], Pipe<S>& q, uint32_t a, int k,
                                           int n, bool& first) {
  for (int c = 0; c < k; c += kChunkK) {
    const int kc = min(kChunkK, k - c);
    const uint32_t b = q.acquire();
    for (int s = 0; s < kc; s += 16) {
      const uint64_t da = desc(a + ((c + s) >> 3) * (kRows * 16), kRows * 16, 128);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_64<0, 0>(acc[p], da, desc(b + p * 1024 + (s >> 3) * (n * 16), n * 16, 128),
                       first ? 0 : 1);
      }
      first = false;
    }
    wgmma_commit();
    q.advance();
  }
}

// One layer for this warpgroup: out = act(a1 w1 [+ a2 w2] + bias), bf16,
// into its 64 rows of the activation buffer. n_valid: columns with a bias.
template <int NP, int S>
__device__ __forceinline__ void layer(Pipe<S>& q, uint32_t a1, int k1, uint32_t a2, int k2, int n,
                                      const float* __restrict__ bias, int n_valid, bool relu,
                                      uint8_t* act, int g) {
  float acc[4][32];
  fence_acc<NP>(acc);
  bool first = true;
  mma_source<NP>(acc, q, a1, k1, n, first);
  if (k2 > 0) mma_source<NP>(acc, q, a2, k2, n, first);
  wgmma_wait<0>();
  fence_acc<NP>(acc);
  q.release();
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
template <int S>
__device__ __forceinline__ void layer_any(int np, Pipe<S>& q, uint32_t a1, int k1, uint32_t a2,
                                          int k2, int n, const float* __restrict__ bias,
                                          int n_valid, bool relu, uint8_t* act, int g) {
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

// The encode of tile row `row` (points p, dirs d; zeros past n), bf16,
// split between the two threads of the row: the first half writes the
// points' identity and bands 0-6; the second the dirs' identity and bands
// 0-3, the points' bands 7-9, and the padding columns (63 of the points,
// 27-31 of the dirs).
__device__ __forceinline__ void encode_row(uint8_t* enc_x, uint8_t* enc_d, int row, bool half,
                                           const float (&p)[3], const float (&d)[3]) {
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

}  // namespace tc
}  // namespace nerf
