// The bf16 tensor-core device code of the wide fused NeRF MLP, shared by
// the wide forward (fused_mlp_wide_tc.cu, K1) and the wide bf16 backward
// (fused_mlp_wide_bwd_bf16.cu, K2), so that K2 recomputes the forward with
// K1's own code: the same encode, the same wgmma k-order and chunks, the
// same roundings, the same head sums.
//
// A tile is 64 samples (one wgmma M); the two consumer warpgroups split
// each layer's N, warpgroup g on pieces [p0, p0 + count) of the 64-column
// pieces (Share: the first half rounded up, then the rest), so each keeps
// at most four 64-column f32 accumulators (128 registers a thread) at width
// 512. Weight chunks (fused_mlp.py::tc_tile's pack, one contiguous run a
// chunk) come through a ring of S stages of 32 KB: 32 K-rows a chunk above
// width 256, 64 at or below (chunk_k). The activation and encode buffers
// hold 64 rows in fused_mlp_f32tc.cuh's p_off order (K-major core
// matrices, column groups 1 KB apart).

#pragma once

#include "fused_mlp_f32tc.cuh"
#include "fused_mlp_wide.cuh"

namespace nerf {
namespace wide {

using namespace tc;
using f32tc::consumers_barrier;
using f32tc::enc_at;
using f32tc::p_off;

constexpr int kBlock = 64;                                    // samples a tile
constexpr int kStageBytesW = 32 * kWideMaxWidth * 2;          // 32 KB
static_assert(kStageBytesW == kStageBytes, "tc::Pipe's default stage size");

// K rows a ring chunk of a segment nn columns wide holds (32 KB at most).
__device__ __forceinline__ int chunk_k(int nn) { return nn > kMaxWidth ? 32 : 64; }

// The producer's walk through a ring of S stages, tc::Producer with
// chunk_k rows.
template <int S>
struct WideProducer {
  uint32_t ring, bars;   // full[s] at bars + 8 s, empty[s] at bars + 8 (S + s)
  int stage;
  uint32_t phase;

  __device__ __forceinline__ void emit(const __nv_bfloat16* w, long long off, int k, int nn) {
    const int ck = chunk_k(nn);
    for (int c = 0; c < k; c += ck) {
      const uint32_t bytes = static_cast<uint32_t>(min(ck, k - c) * nn * 2);
      mbar_wait(bars + 8 * (S + stage), phase ^ 1);
      mbar_expect_tx(bars + 8 * stage, bytes);
      bulk_copy(ring + stage * kStageBytesW, w + off + static_cast<long long>(c) * nn, bytes,
                bars + 8 * stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
};

template <int S>
using WidePipe = Pipe<S, kStageBytesW>;

// Accumulates the 64-row A buffer at shared address a (k columns) times the
// next ring chunks (k x n) into this warpgroup's NP pieces from piece p0.
// A warpgroup without pieces (NP = 0) still walks and releases the chunks.
// Q: the consumers' side of the ring (WidePipe, or a ring that a consumer
// thread feeds), with acquire, advance and release.
template <int NP, class Q>
__device__ __forceinline__ void wide_mma_source(float (&acc)[4][32], Q& q, uint32_t a, int k,
                                                int n, int p0, bool& first) {
  const int ck = chunk_k(n);
  for (int c = 0; c < k; c += ck) {
    const int kc = min(ck, k - c);
    const uint32_t b = q.acquire();
    if constexpr (NP > 0) {
      for (int s = 0; s < kc; s += 16) {
        const uint64_t da = desc(a + ((c + s) >> 3) * 1024, 1024, 128);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          wgmma_64<0, 0>(acc[p], da, desc(b + (p0 + p) * 1024 + (s >> 3) * (n * 16), n * 16, 128),
                         first ? 0 : 1);
        }
        first = false;
      }
    }
    wgmma_commit();
    q.advance();
  }
}

// One layer: out = act(a1 w1 [+ a2 w2] + bias), bf16, this warpgroup's NP
// pieces from p0 into the activation buffer. n_valid: columns with a bias.
template <int NP, class Q>
__device__ __forceinline__ void wide_layer(Q& q, uint32_t a1, int k1, uint32_t a2, int k2, int n,
                                           int p0, const float* __restrict__ bias, int n_valid,
                                           bool relu, uint8_t* act) {
  float acc[4][32];
  fence_acc<NP>(acc);
  bool first = true;
  wide_mma_source<NP>(acc, q, a1, k1, n, p0, first);
  if (k2 > 0) wide_mma_source<NP>(acc, q, a2, k2, n, p0, first);
  wgmma_wait<0>();
  fence_acc<NP>(acc);
  q.release();
  consumers_barrier();   // both warpgroups' wgmmas have read the buffer they overwrite
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // Accumulator element 4 j + 2 r + e sits at row row0 + 8 r and
      // column 8 j + 2 (lane % 4) + e of the piece.
      const int col = (p0 + p) * kPiece + j * 8 + 2 * (lane & 3);
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
        *reinterpret_cast<__nv_bfloat162*>(act + p_off(row0 + 8 * r, col)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  fence_async_smem();
  consumers_barrier();   // the whole output, for the next layer's wgmmas and the heads
}

// wide_layer<count> for this warpgroup's runtime piece count (0..4),
// inlined at each call site so that the accumulators stay in registers.
template <class Q>
__device__ __forceinline__ void wide_layer_any(int count, Q& q, uint32_t a1, int k1,
                                               uint32_t a2, int k2, int n, int p0,
                                               const float* __restrict__ bias, int n_valid,
                                               bool relu, uint8_t* act) {
  switch (count) {
    case 0: wide_layer<0>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, act); break;
    case 1: wide_layer<1>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, act); break;
    case 2: wide_layer<2>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, act); break;
    case 3: wide_layer<3>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, act); break;
    default: wide_layer<4>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, act); break;
  }
}

// Warpgroup g's share of np pieces: the first (np + 1) / 2, or the rest.
struct Share {
  int p0, count;
  __device__ __forceinline__ Share(int np, int g)
      : p0(g ? (np + 1) / 2 : 0), count(g ? np / 2 : (np + 1) / 2) {}
};

__device__ __forceinline__ float ld_act(const uint8_t* buf, int row, int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(buf + p_off(row, col)));
}

// The encode of tile `tile` (64 samples; rows past n zeros) into the point
// and dir encode buffers, bf16, by the 256 consumer threads: 48 column
// pairs a row (32 of the points', 16 of the dirs'). The caller fences and
// meets the other consumers before a wgmma reads them.
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts,
                                            const float* __restrict__ dirs, long long n,
                                            long long dir_div, long long tile, uint8_t* enc_x,
                                            uint8_t* enc_d) {
  for (int i = threadIdx.x; i < kBlock * (kEncX + kEncD) / 2; i += kConsumers) {
    const int r = i & (kBlock - 1), col = 2 * (i >> 6);
    const bool dir = col >= kEncX;
    const long long s = tile * kBlock + r;
    float x[3] = {0.f, 0.f, 0.f};
    if (s < n) {
      const float* src = dir ? dirs + (s / dir_div) * 3 : pts + s * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = src[c];
    }
    const int j = dir ? col - kEncX : col;
    const int count = dir ? 3 + 6 * kDBands : 3 + 6 * kXBands;
    *reinterpret_cast<__nv_bfloat162*>((dir ? enc_d : enc_x) + p_off(r, j)) =
        __floats2bfloat162_rn(enc_at(x[0], x[1], x[2], j, count),
                              enc_at(x[0], x[1], x[2], j + 1, count));
  }
}

}  // namespace wide
}  // namespace nerf
