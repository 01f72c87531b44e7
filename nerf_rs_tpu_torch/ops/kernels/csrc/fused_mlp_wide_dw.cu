// The weight gradients of the wide backward (K2 past width 256 or depth
// 16, both modes): dW = H^T dZ of every layer segment, summed over a round
// of tiles as one long product whose K runs over the round's samples.
//
// The per-tile kernels (fused_mlp_wide_bwd_bf16.cu, fused_mlp_wide_bwd_tc.cu)
// run what must go layer after layer, the recompute and dZ W^T down the
// trunk, and write each layer's input H and output gradient dZ for a round
// of tiles to the workspace (fused_mlp_wide_dw.cuh). This kernel then
// takes the products they used to sum per 64-sample tile into a per-CTA
// partial of every weight (1.2 GB of partials at 512/256/8, each tile's
// adds a round trip to device memory). It replaces no TPU kernel of its
// own: the JAX kernel (nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t,
// :663) sums dW in one VMEM-resident output block over its sequential
// grid (:671, :685-686, :699), which 132 SMs in no order cannot share.
//
// Work. A job is an output tile of one segment: 128 input features (two
// consumer warpgroups of 64; one where the segment has 64 or fewer left)
// by kTileN output columns (64-column pieces). An item is a job over one
// of `splits` contiguous slices of the round's tiles; items are taken by
// the CTAs in turn. Per tile of the slice a producer thread bulk-copies the
// job's columns of the H and dZ images (contiguous runs, every plane) into
// a ring stage, and the consumers run wgmma with both operands read
// MN-major from shared memory (A = H^T: M the features, K the samples;
// B = dZ), accumulating in registers across the slice. The item's sum is
// stored whole into its own partial tile; dw_sum_kernel then adds, per
// weight, the slices' partial tiles in slice order into the gradient, a
// round after a round: every sum has a fixed order, so two calls agree bit
// for bit.
//
// Modes, both with kTileN 128 (two 64-column pieces a warpgroup; four
// pieces of one accumulator spilled and serialized the wgmmas).
// bf16 (1 plane): one m64n64k16 per piece a k-step of 16 samples, a ring
// of 6 stages of 32 KB. f32 (3 planes, split-f32 as K1 f32's route,
// fused_mlp_f32tc.cuh): per k-step the six piece products of
// fused_mlp.SPLIT_F32_ORDER, x.hi w.hi into an accumulator of its own and
// the other five into a second (128 accumulators), a ring of 2 stages of
// 96 KB. Three bf16 pieces hold all 24 bits of an f32 significand.
//
// What bounds it on the H100: operations at 989 TFLOP/s (2 n_w FLOP a
// sample, six passes in f32) when the items fill the SMs. A round's
// workspace is larger than the 50 MB L2 (at 512/256/8 even one tile a CTA
// is 161 MB in bf16), so it streams from device memory; the items that run
// together read the same slice of tiles, and what of that meets in L2 is
// not measured.

#include "fused_mlp_tc.cuh"
#include "fused_mlp_wide_dw.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using nerf::wide::DwWs;

// A job's fields (int64), as fused_mlp.py::wide_dw_jobs writes them. Where
// its operands lie in the workspace follows from DwWs alone.
enum {
  kASlot,    // the workspace slot of A (H)
  kAC0,      // its first column: the job's first input feature
  kBSlot,    // the slot of B (dZ)
  kBC0,      // its first column: the job's first output column
  kOut,      // offset in dweights of entry (first feature, first column)
  kLd,       // row stride of the segment in dweights
  kMValid,   // features to store
  kNValid,   // columns to store
  kJobLen
};

constexpr int kTileM = 128;
constexpr int kABuf = kTileM * 128;   // 16 KB: 128 features x 64 samples

// A job's operand: its columns [c0, c0 + cols) of slot s, at most `most`
// (a multiple of 64, as every slot's width): the bytes of a plane of one
// tile's image, 128 x cols, and where tile t's plane q of them starts.
struct Operand {
  long long slot, c0;
  __device__ __forceinline__ uint32_t bytes(const DwWs& D, int most) const {
    const long long cols = D.cols(static_cast<int>(slot)) - c0;
    return static_cast<uint32_t>(128 * (cols < most ? cols : most));
  }
  __device__ __forceinline__ const uint8_t* at(const DwWs& D, long long t, int q) const {
    return D.at(static_cast<int>(slot), t, q) + 128 * c0;
  }
};

template <int P>
struct Cfg {
  static constexpr int kTileN = 128;   // two 64-column pieces a warpgroup
  static constexpr int kTileFloats = kTileM * kTileN;
  static constexpr int kPlaneBytes = kABuf + kTileN * 128;
  static constexpr int kStageBytes = P * kPlaneBytes;   // 32 KB or 96 KB
  static constexpr int kStages = P == 1 ? 6 : 2;
  static constexpr int kBarOff = kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};

template <int N>
__device__ __forceinline__ void fence_regs(float (&acc)[N][32]) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[p][i])::"memory");
  }
}

// One item for this warpgroup: NP pieces (0: the warpgroup has no
// features in the job and only walks the stages) over n_tiles stages;
// then its 64 rows of the item's partial tile. acc[p] holds x.hi w.hi
// (f32) or the whole product (bf16); acc[NP + p] the other five.
template <int P, int NP, class Q>
__device__ __forceinline__ void run_item(Q& q, long long n_tiles, int g, float* out) {
  using C = Cfg<P>;
  constexpr int kAcc = NP == 0 ? 1 : (P == 1 ? NP : 2 * NP);
  float acc[kAcc][32];
  fence_regs(acc);
  bool first = true;
  for (long long t = 0; t < n_tiles; ++t) {
    const uint32_t st = q.acquire();
    if constexpr (NP > 0) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {   // k-steps of 16 samples
        const int scale = (first && ks == 0) ? 0 : 1;
        if constexpr (P == 1) {
          const uint64_t da = desc(st + g * 8192 + ks * 256, 128, 1024);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            wgmma_64<1, 1>(acc[p], da, desc(st + kABuf + p * 8192 + ks * 256, 128, 1024), scale);
          }
        } else {
          constexpr int kA[6] = {2, 0, 1, 1, 0, 0};   // H piece of product j
          constexpr int kB[6] = {0, 2, 1, 0, 1, 0};   // dZ piece of product j
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            const uint64_t da = desc(st + kA[j] * C::kPlaneBytes + g * 8192 + ks * 256, 128, 1024);
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const uint64_t db =
                  desc(st + kB[j] * C::kPlaneBytes + kABuf + p * 8192 + ks * 256, 128, 1024);
              if (j < 5) {
                wgmma_64<1, 1>(acc[NP + p], da, db, (scale == 0 && j == 0) ? 0 : 1);
              } else {
                wgmma_64<1, 1>(acc[p], da, db, scale);
              }
            }
          }
        }
      }
      first = false;
    }
    wgmma_commit();
    q.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  q.release();
  if constexpr (NP > 0) {
    const int lane = threadIdx.x & 31;
    const int r0 = 64 * g + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // Accumulator element 4 j + 2 r + e: row r0 + 8 r, column 8 j +
        // 2 (lane % 4) + e of piece p.
        const int col = p * kPiece + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2 v = make_float2(acc[p][4 * j + 2 * r], acc[p][4 * j + 2 * r + 1]);
          if constexpr (P != 1) {
            v.x += acc[NP + p][4 * j + 2 * r];
            v.y += acc[NP + p][4 * j + 2 * r + 1];
          }
          __stcg(reinterpret_cast<float2*>(out + (r0 + 8 * r) * C::kTileN + col), v);
        }
      }
    }
  }
}

// Items it = s * n_jobs + j (job j over slice s of `splits`), taken by the
// CTAs in turn; the partial tile of item it at part + it * kTileFloats.
template <int P>
__global__ void __launch_bounds__(kThreadsTc, 1)
fused_mlp_wide_dw_kernel(const DwWs D, const long long* __restrict__ jobs, int n_jobs, int splits,
                         long long tiles, float* __restrict__ part) {
  using C = Cfg<P>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = smem_u32(smem), bars = smem_u32(smem + C::kBarOff);
  const int tid = threadIdx.x;
  const int items = n_jobs * splits;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The role split on a warp-uniform value, never rejoined. The producer
  // gives up registers for the consumers' 128 accumulators (held to the
  // launch's 168, ptxas spilled f32 jobs and serialized their wgmmas).
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
  if (warp >= kConsumers / 32) {
    reg_dealloc<kProducerRegs>();
    if (tid != kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const long long* job = jobs + static_cast<long long>(it % n_jobs) * kJobLen;
      const int s = it / n_jobs;
      const Operand a{job[kASlot], job[kAC0]}, b{job[kBSlot], job[kBC0]};
      const uint32_t ab = a.bytes(D, kTileM), bb = b.bytes(D, C::kTileN);
      for (long long t = tiles * s / splits; t < tiles * (s + 1) / splits; ++t) {
        const uint32_t full = bars + 8 * stage;
        mbar_wait(bars + 8 * (C::kStages + stage), phase ^ 1);
        mbar_expect_tx(full, P * (ab + bb));
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const uint32_t dst = ring + stage * C::kStageBytes + q * C::kPlaneBytes;
          bulk_copy(dst, a.at(D, t, q), ab, full);
          bulk_copy(dst + kABuf, b.at(D, t, q), bb, full);
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  Pipe<C::kStages, C::kStageBytes> q{ring, bars, 0, 0u, -1};
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const long long* job = jobs + static_cast<long long>(it % n_jobs) * kJobLen;
    const int s = it / n_jobs;
    const long long n_tiles = tiles * (s + 1) / splits - tiles * s / splits;
    const Operand a{job[kASlot], job[kAC0]}, b{job[kBSlot], job[kBC0]};
    const int rows = static_cast<int>(a.bytes(D, kTileM) >> 7);
    const int np = 64 * g < rows ? static_cast<int>(b.bytes(D, C::kTileN) >> 13) : 0;
    float* out = part + static_cast<long long>(it) * C::kTileFloats;
    switch (np) {
      case 0: run_item<P, 0>(q, n_tiles, g, out); break;
      case 1: run_item<P, 1>(q, n_tiles, g, out); break;
      default: run_item<P, 2>(q, n_tiles, g, out); break;
    }
  }
}

// dweights[out + row * ld + col] += the sum over slices s = 0, 1, ... of
// item (s, j)'s partial tile at (row, col), for every job j and its valid
// rows and columns; one thread an entry.
template <int P>
__global__ void dw_sum_kernel(const float* __restrict__ part, const long long* __restrict__ jobs,
                              int n_jobs, int splits, float* __restrict__ dweights) {
  using C = Cfg<P>;
  const int j = blockIdx.x;
  const long long* job = jobs + static_cast<long long>(j) * kJobLen;
  const int m_valid = static_cast<int>(job[kMValid]), n_valid = static_cast<int>(job[kNValid]);
  const long long ld = job[kLd];
  float* dst = dweights + job[kOut];
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < C::kTileFloats;
       e += gridDim.y * blockDim.x) {
    const int row = e / C::kTileN, col = e % C::kTileN;
    if (row >= m_valid || col >= n_valid) continue;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) {
      s += __ldcg(part + (static_cast<long long>(k) * n_jobs + j) * C::kTileFloats + e);
    }
    dst[row * ld + col] += s;
  }
}

template <int P>
cudaError_t launch_dw(const DwWs& D, const long long* jobs, int n_jobs, int splits,
                      long long tiles, float* part, float* dweights, int grid,
                      cudaStream_t stream) {
  using C = Cfg<P>;
  auto kernel = fused_mlp_wide_dw_kernel<P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsTc, C::kSmemBytes, stream>>>(D, jobs, n_jobs, splits, tiles, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_sum_kernel<P><<<dim3(n_jobs, 16), 256, 0, stream>>>(part, jobs, n_jobs, splits, dweights);
  return cudaGetLastError();
}

// The small sums the per-tile kernels keep per CTA (every bias gradient in
// the packed bias layout, n_b floats, then the alpha head's ldw weights
// and the rgb head's 3 ldv), summed over the CTAs in order into dbiases
// and the heads' segments of dweights.
__global__ void small_sum_kernel(const float* __restrict__ small, int parts, long long stride,
                                 long long n_b, int ldw, long long w_alpha, long long w_rgb,
                                 float* __restrict__ dweights, float* __restrict__ dbiases) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < stride;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += small[p * stride + e];
    if (e < n_b) {
      dbiases[e] = s;
    } else if (e < n_b + ldw) {
      dweights[w_alpha + (e - n_b)] = s;
    } else {
      dweights[w_rgb + (e - n_b - ldw)] = s;
    }
  }
}

}  // namespace

// One round's weight gradients: the items of n_jobs jobs (a device array
// of n_jobs x kJobLen int64, fused_mlp.py::wide_dw_jobs) over `splits`
// slices of the first `tiles` tiles of the workspace ws (laid out for
// ws_tiles tiles of a network of widths ldw, ldv and `depth` layers;
// planes 1: bf16, 3: f32) on `grid` CTAs, their partial tiles into part
// (splits x n_jobs x 128 x 128 floats), then added into dweights.
// splits <= tiles <= ws_tiles. Returns a cudaError_t value (0 = launched).
extern "C" int nerf_wide_dw(void* ws, long long ws_tiles, const void* jobs, int n_jobs,
                            int splits, long long tiles, int planes, int ldw, int ldv, int depth,
                            void* part, void* dweights, int grid, int device, void* stream) {
  if (n_jobs < 1 || splits < 1 || tiles < splits || tiles > ws_tiles || grid < 1 ||
      (planes != 1 && planes != 3) || ldw < 1 || ldv < 1 || depth < 1 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = (ldw + kPiece - 1) / kPiece * kPiece, nv = (ldv + kPiece - 1) / kPiece * kPiece;
  const DwWs D{static_cast<uint8_t*>(ws), ws_tiles, planes, nw, nv, depth};
  const auto* j = static_cast<const long long*>(jobs);
  auto* p = static_cast<float*>(part);
  auto* d = static_cast<float*>(dweights);
  auto s = static_cast<cudaStream_t>(stream);
  err = planes == 1 ? launch_dw<1>(D, j, n_jobs, splits, tiles, p, d, grid, s)
                    : launch_dw<3>(D, j, n_jobs, splits, tiles, p, d, grid, s);
  return static_cast<int>(err);
}

// The per-tile kernels' small sums (parts CTAs of `stride` floats: n_b
// bias gradients, ldw alpha-head and 3 ldv rgb-head weight gradients) into
// dbiases and dweights at w_alpha and w_rgb. Returns a cudaError_t value.
extern "C" int nerf_wide_small_sum(const void* small, int parts, long long stride, long long n_b,
                                   int ldw, long long w_alpha, long long w_rgb, void* dweights,
                                   void* dbiases, int device, void* stream) {
  if (parts < 1 || n_b < 1 || ldw < 1 || stride < n_b + ldw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (stride + 255) / 256;
  small_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(small), parts, stride, n_b, ldw, w_alpha, w_rgb,
      static_cast<float*>(dweights), static_cast<float*>(dbiases));
  return static_cast<int>(cudaGetLastError());
}
