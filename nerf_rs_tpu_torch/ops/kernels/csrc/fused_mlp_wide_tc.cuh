// The bf16 tensor-core device code of the wide fused NeRF MLP, shared by
// the wide forward (fused_mlp_wide_tc.cu, K1) and the wide bf16 backward
// (fused_mlp_wide_bwd_bf16.cu, K2), so that K2 recomputes the forward with
// K1's own code: the same encode, the same wgmma k-order and chunks, the
// same roundings, the same head sums.
//
// A tile is 64 samples (one wgmma M). A layer's 64-column pieces run in
// passes of up to kPassPieces, and the two consumer warpgroups split each
// pass (Share: the first half rounded up, then the rest), so a warpgroup
// keeps at most two pieces. Weight chunks come through a ring: a pass's
// columns of kPassK K-rows of a segment (fused_mlp.py::tc_tile's pack lays
// each 8 K-rows out column group by column group, so a chunk is one run of
// nh * 16 bytes a k-group of 8 rows; at most 32 KB). Every chunk is summed
// by wgmmas from zero (four k-steps) and added to a running f32 sum in
// registers, rounded to nearest: a wgmma accumulator rounds toward zero as
// it adds, so one accumulator over a layer's K drifts with the number of
// k-steps (the random 512/512/32 network's bf16 chain left float64's
// bars on twice as many sigmas with one accumulator as with chunk sums;
// PERF.md). A piece takes 32 registers a thread for its chunk sum and 32
// for its running sum, so two pieces a warpgroup cost what four
// one-accumulator pieces did. K1 (wide_layer_in_place) overwrites the
// layer input in place once every wgmma of the layer has read it, keeping
// each pass's rounded outputs in registers until then, as
// fused_mlp_wide1k_tc.cu does; K2 (wide_layer) writes into the other of
// two buffers at once. The activation and encode buffers hold 64 rows in
// fused_mlp_f32tc.cuh's p_off order (K-major core matrices, column groups
// 1 KB apart).

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
constexpr int kPassPieces = 4;                                // 64-column pieces a pass
// K rows of a pass's ring chunk (32 KB at most): one chunk is one
// promotion to the running sum.
constexpr int kPassK = 64;
static_assert(kPassK * kPassPieces * kPiece * 2 == kStageBytesW, "a pass's chunk fills a stage");

// K rows of the backward's ring chunks (fused_mlp_wide_bwd_bf16.cu: all
// of a segment's nn columns, 32 KB at most).
__device__ __forceinline__ int chunk_k(int nn) { return nn > kMaxWidth ? 32 : 64; }

// A ring chunk of the pack: `runs` runs of run16 x 16 bytes, the first
// from element `off`, each 64 n8 elements after the one before (8 K-rows
// of a segment n8 x 8 columns wide), laid end to end in the stage. The
// rings' feeders walk tables of them, built once a launch.
struct Chunk {
  uint32_t off;
  uint16_t run16;
  uint8_t runs, n8;
};

// Ring chunks the forward's layers read, at most: two passes of 256
// columns, each 8 chunks of a 512-row segment and 1 of a skip's encode
// part a layer past the first, dense0's 1, the bottleneck's 8 and the
// view layer's 9.
constexpr int kMaxFwdChunks = 2 * (1 + (kWideMaxDepth - 1) * 9 + 17);

// The chunk layer_chunks hands put().
__device__ __forceinline__ Chunk ring_chunk(long long off, uint32_t run_bytes, int runs,
                                            int stride) {
  return {static_cast<uint32_t>(off), static_cast<uint16_t>(run_bytes / 16),
          static_cast<uint8_t>(runs), static_cast<uint8_t>(stride / 64)};
}

// Calls put(offset, run_bytes, runs, stride) for every ring chunk of one
// layer in the order the consumers take them (pass by pass; in a pass the
// segment at off1, k1 rows, then the one at off2, k2 rows, n columns
// wide): the chunk's first element in the pack, its runs (one a k-group
// of 8 rows, run_bytes each) and the elements from one run to the next.
template <class Put>
__device__ __forceinline__ void layer_chunks(long long off1, int k1, long long off2, int k2, int n,
                                             Put&& put) {
  const int np = n / kPiece, rows = kPassK;
  for (int pp = 0; pp < np; pp += kPassPieces) {
    const int nh = min(np - pp, kPassPieces) * kPiece;
    for (int src = 0; src < 2; ++src) {
      const long long off = src ? off2 : off1;
      const int k = src ? k2 : k1;
      for (int c = 0; c < k; c += rows) {
        put(off + static_cast<long long>(c) * n + pp * kPiece * 8, static_cast<uint32_t>(nh * 16),
            min(rows, k - c) / 8, 8 * n);
      }
    }
  }
}

// Keeps the compiler from moving accumulator accesses across the wgmmas.
template <int NP>
__device__ __forceinline__ void fence_pair(float (&acc)[2][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[p][i])::"memory");
  }
}

// One pass of a layer for this warpgroup: run (NP pieces, from local piece
// pw of the pass's nh columns) = the sum over the sources (a1: k1 columns,
// a2: k2) of the 64-row A buffer times the next ring chunks, each chunk
// summed by wgmmas from zero and added to run once they retire. A
// warpgroup without pieces (NP = 0) still walks and releases the chunks.
// Q: the consumers' side of the ring (acquire, advance, release).
template <int NP, class Q>
__device__ __forceinline__ void pass_sum(float (&run)[2][32], Q& q, uint32_t a1, int k1,
                                         uint32_t a2, int k2, int nh, int pw) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) run[p][i] = 0.f;
  }
  float acc[2][32];
  const int rows = kPassK;
  for (int src = 0; src < 2; ++src) {
    const uint32_t a = src ? a2 : a1;
    const int k = src ? k2 : k1;
    for (int c = 0; c < k; c += rows) {
      const int kc = min(rows, k - c);
      fence_pair<NP>(acc);   // before the wgmma stage opens: nothing else defines acc in it
      const uint32_t b = q.acquire();
      if constexpr (NP > 0) {
        for (int s = 0; s < kc; s += 16) {
          const uint64_t da = desc(a + ((c + s) >> 3) * 1024, 1024, 128);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            wgmma_64<0, 0>(acc[p], da,
                           desc(b + (pw + p) * 1024 + (s >> 3) * (nh * 16), nh * 16, 128),
                           s ? 1 : 0);
          }
        }
      }
      wgmma_commit();
      q.advance();
      wgmma_wait<0>();
      fence_pair<NP>(acc);
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
// whose first column is col0, as bf16 pairs: accumulator element 4 j + 2 r
// + e of a piece sits at row row0 + 8 r, column 8 j + 2 (lane % 4) + e
// (out_at). n_valid: columns with a bias.
template <int NP>
__device__ __forceinline__ void pass_pack(uint32_t (&h)[2][8][2], const float (&run)[2][32],
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
        h[p][j][r] = f32tc::bits(__floats2bfloat162_rn(v0, v1));
      }
    }
  }
}

// pass_pack's outputs stored at once into the activation buffer out.
template <int NP>
__device__ __forceinline__ void pass_out(const float (&run)[2][32], int col0,
                                         const float* __restrict__ bias, int n_valid, bool relu,
                                         uint8_t* out) {
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
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
        *reinterpret_cast<__nv_bfloat162*>(out + p_off(row0 + 8 * r, col)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The byte offset of packed pair (j, r) of a piece whose first column is
// col (pass_pack's order) in an activation buffer.
__device__ __forceinline__ uint32_t out_at(int col, int j, int r) {
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  return p_off(row0 + 8 * r, col + j * 8 + 2 * (lane & 3));
}

// pass_pack's outputs of the first `count` of two pieces from column col0,
// stored into the activation buffer out.
__device__ __forceinline__ void store_packed(const uint32_t (&h)[2][8][2], int count, int col0,
                                             uint8_t* out) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= count) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<uint32_t*>(out + out_at(col0 + p * kPiece, j, r)) = h[p][j][r];
      }
    }
  }
}

// Warpgroup g's share of np pieces: the first (np + 1) / 2, or the rest.
struct Share {
  int p0, count;
  __device__ __forceinline__ Share(int np, int g)
      : p0(g ? (np + 1) / 2 : 0), count(g ? np / 2 : (np + 1) / 2) {}
};

// One layer: out = act(a1 w1 [+ a2 w2] + bias), bf16, n columns in passes
// of kPassPieces pieces, warpgroup g (from a __shfl_sync-ed warp index,
// so that ptxas sees the branches on it as warp-uniform; else C7520
// serializes the wgmmas) on its Share of each pass, into the activation
// buffer out, which neither source is: each pass's outputs are stored at
// once. n_valid: columns with a bias. Inlined at each call site, so that
// the sums stay in registers.
template <class Q>
__device__ __forceinline__ void wide_layer(Q& q, uint32_t a1, int k1, uint32_t a2, int k2, int n,
                                           const float* __restrict__ bias, int n_valid, bool relu,
                                           uint8_t* out, int g) {
  const int np = n / kPiece;
  float run[2][32];
#pragma unroll 1
  for (int pp = 0; pp < np; pp += kPassPieces) {
    const int pc = min(np - pp, kPassPieces);
    const Share sh(pc, g);
    const int col0 = (pp + sh.p0) * kPiece;
    switch (sh.count) {
      case 0: pass_sum<0>(run, q, a1, k1, a2, k2, pc * kPiece, sh.p0); break;
      case 1:
        pass_sum<1>(run, q, a1, k1, a2, k2, pc * kPiece, sh.p0);
        pass_out<1>(run, col0, bias, n_valid, relu, out);
        break;
      default:
        pass_sum<2>(run, q, a1, k1, a2, k2, pc * kPiece, sh.p0);
        pass_out<2>(run, col0, bias, n_valid, relu, out);
        break;
    }
  }
  q.release();
  fence_async_smem();
  consumers_barrier();   // the whole output, for the next layer's wgmmas and the heads
}

// wide_layer with out the buffer of a1 or a2 (n <= 2 kPassPieces pieces:
// at most two passes): each pass's outputs stay in registers as bf16 pairs
// until both warpgroups' wgmmas have read the whole layer input.
template <class Q>
__device__ __forceinline__ void wide_layer_in_place(Q& q, uint32_t a1, int k1, uint32_t a2,
                                                    int k2, int n,
                                                    const float* __restrict__ bias, int n_valid,
                                                    bool relu, uint8_t* out, int g) {
  const int np = n / kPiece;
  float run[2][32];
  uint32_t h[2][2][8][2];
  int count[2] = {0, 0}, col[2] = {0, 0};
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int pc = min(np - pass * kPassPieces, kPassPieces);
    if (pc <= 0) continue;
    const Share sh(pc, g);
    count[pass] = sh.count;
    col[pass] = (pass * kPassPieces + sh.p0) * kPiece;
    switch (sh.count) {
      case 0: pass_sum<0>(run, q, a1, k1, a2, k2, pc * kPiece, sh.p0); break;
      case 1:
        pass_sum<1>(run, q, a1, k1, a2, k2, pc * kPiece, sh.p0);
        pass_pack<1>(h[pass], run, col[pass], bias, n_valid, relu);
        break;
      default:
        pass_sum<2>(run, q, a1, k1, a2, k2, pc * kPiece, sh.p0);
        pass_pack<2>(h[pass], run, col[pass], bias, n_valid, relu);
        break;
    }
  }
  q.release();
  consumers_barrier();   // both warpgroups' wgmmas have read the buffer they overwrite
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) store_packed(h[pass], count[pass], col[pass], out);
  fence_async_smem();
  consumers_barrier();   // the whole output, for the next layer's wgmmas and the heads
}

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
