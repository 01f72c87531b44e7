// Multiresolution hash encode (the hash-grid family's field input) for
// Hopper (sm_90a): per (sample, level), the cell of the sample's normalized
// position, the 8 corner rows (direct index or spatial hash), their
// trilinear weights, the gathered rows and their weighted sum, in one launch.
//
// Replaces tools/pallas_gather_probe.py:81 (P1, `go` -> pl.pallas_call): the
// TPU's attempt to gather table rows inside a kernel for this encode. On the
// TPU, Mosaic's only gather crashed past a vreg-sized table, so
// nerf_rs_tpu/models/hashgrid.py::hash_encode stayed on XLA gathers. Here
// any thread loads any row, so the gather, the hash and the blend are one
// kernel. It computes the function of the port's plain version
// (ops/kernels/hash_encode.py::hash_encode_reference), operation for
// operation.
//
// What bounds it on the H100. The bytes the function must move are the
// points (12 B a sample), the table rows the corners touch (at most 16 MiB
// in f32 at the paper config: L = 16 levels of T = 2^17 rows, F = 2) and
// the output (L*F values a sample, 128 B in f32): 0.135 ms at 3.35 TB/s
// for 16384 x 192 samples, 88% of it the output. The table stays in the
// 50 MB L2, so HBM is not what holds the kernel: the corner loads are. A
// (sample, level) loads 8 rows of 8 bytes (4 in bf16); on the fine levels
// each comes from a sector of its own. Timed with parts taken out
// (tools/torch_hash_ablation.py, 16384 x 192 f32, an H100 SXM): the loads
// of the 11 hashed levels take two thirds of the time, the index and blend
// arithmetic (0.39 ms without any table load) the rest; the 5 direct
// levels' loads and the output's stores cost a few percent each.
//
// The design, against the sector model (counts reckoned on the CPU by
// tools/torch_hash_sectors.py from the port's _Corners on the render's
// ray-ordered points, paper config):
// - A CTA takes kTile consecutive samples, which on the main path (64 and
//   192 samples a ray) lie on one ray. It normalizes each sample's point
//   once into shared memory (one IEEE division an axis, not one a level).
// - Each warp takes one level for 32 consecutive samples (lane = sample),
//   so its lanes fall in neighbouring cells and share sectors: 4.96
//   distinct sectors a (sample, level) over the 8 corner loads, against
//   6.43 when a warp took 2 samples x 16 levels (the first kernel), the
//   gain on the coarse levels. The level's constants are kernel
//   parameters, read at one address by the whole warp; the index
//   arithmetic is 32-bit.
// - Paired corner loads: the hash gives x the prime 1, so on a hashed level
//   with even cx the corners (0, by, bz) and (1, by, bz) are rows 2k and
//   2k + 1 (in either order); on a direct level the corners bz = 0 and 1 are
//   rows idx and idx + 1. Where a pair's two rows are one aligned pair, one
//   load (16 bytes in f32, 8 in bf16) fetches both: about half the pairs.
// - f32 reads the table with an L2 evict-last policy. The output tile is
//   staged in shared memory and written point-major with 16-byte streaming
//   (evict-first) stores; a level-major warp's own stores would land 128
//   bytes apart (1.6x slower).
// Against the first kernel, on the same card and inputs: bf16 13% faster
// at 16384 x 192, f32 10% slower (PERF.md §6). What L2 must serve is the
// distinct sectors a CTA's tile touches, once its L1 merges the reuse: 38
// a sample in f32 for a 64-sample tile, 40 for the first kernel's
// 16-sample CTA (34 and 36 in bf16), for both at 3.4-4.1 TB/s. Along a
// ray the finest levels share nothing; tiles of 8 neighbouring rays x 8
// samples would need 18 (13 in bf16), but the kernel is not told the
// samples a ray.
//
// Numerics: every product and sum is an explicit IEEE intrinsic, so nvcc
// contracts nothing into an FMA: frac is pos - floor(pos) of the rounded
// product N_l * x, as in the plain version. The AABB normalization is a
// true division. NaN maps to 0 and +-inf to +-FLT_MAX before the clip to
// [0, 1], as nan_to_num does. The corners sum in the JAX order
// (meshgrid "ij" over (bx, by, bz), bz fastest), c = 0..7, whatever order
// their rows were loaded in, so the result is the first kernel's bit for
// bit. F != 2 (or tables the paired loads cannot take) runs a generic path:
// one load a feature, stores straight to the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 64;            // hash_encode.py MAX_LEVELS
constexpr int kTile = 64;                 // samples a CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = kTile / 32;       // 32-sample groups a tile
constexpr unsigned kPrimeY = 2654435761u, kPrimeZ = 805459861u;   // x's prime is 1

struct Levels {
  float res[kMaxLevels];                  // N_l
  int np1[kMaxLevels];                    // N_l + 1
  int direct[kMaxLevels];                 // (N_l + 1)^3 <= T: direct index, else the hash
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// Rows of a (rows, 2) table as two floats each (a bf16's f32 bits are its
// own bits << 16): the aligned pair of rows (row & ~1, row | 1) in one
// load, 16 bytes in f32, 8 in bf16, or one row. Each loads only where its
// `pred` holds (else 0): a predicated load, not a branch, so that it issues
// beside the other corners' loads. f32 reads through L2 with the evict-last
// `policy`; bf16 without it (its 8 MiB table stays in L2 either way, and
// the hint cost bf16 4%: PERF.md §6).
struct Rows2 {
  float2 even, odd;
};

__device__ __forceinline__ float2 unpack_bf16x2(unsigned u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}

__device__ __forceinline__ float2 load_row_if(bool pred, const float* t, unsigned row,
                                              uint64_t policy) {
  float2 v = make_float2(0.f, 0.f);
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%3], %4;\n\t}"
      : "+f"(v.x), "+f"(v.y)
      : "r"(static_cast<int>(pred)), "l"(t + 2 * static_cast<size_t>(row)), "l"(policy));
  return v;
}
__device__ __forceinline__ float2 load_row_if(bool pred, const __nv_bfloat16* t, unsigned row,
                                              uint64_t policy) {
  unsigned u = 0;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
      "@p ld.global.nc.b32 %0, [%2];\n\t}"
      : "+r"(u)
      : "r"(static_cast<int>(pred)), "l"(t + 2 * static_cast<size_t>(row)));
  return unpack_bf16x2(u);
}
__device__ __forceinline__ Rows2 load_pair_if(bool pred, const float* t, unsigned row,
                                              uint64_t policy) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %4, 0;\n\t"
      "@p ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%5], %6;\n\t}"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "r"(static_cast<int>(pred)), "l"(t + 2 * static_cast<size_t>(row & ~1u)), "l"(policy));
  return {make_float2(v.x, v.y), make_float2(v.z, v.w)};
}
__device__ __forceinline__ Rows2 load_pair_if(bool pred, const __nv_bfloat16* t, unsigned row,
                                              uint64_t policy) {
  unsigned u0 = 0, u1 = 0;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p ld.global.nc.v2.b32 {%0, %1}, [%3];\n\t}"
      : "+r"(u0), "+r"(u1)
      : "r"(static_cast<int>(pred)), "l"(t + 2 * static_cast<size_t>(row & ~1u)));
  return {unpack_bf16x2(u0), unpack_bf16x2(u1)};
}

__device__ __forceinline__ void store_pair(float* p, float a0, float a1) {
  *reinterpret_cast<float2*>(p) = make_float2(a0, a1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a0, float a1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a0, a1);
}

// The 8 corners' rows of one level in four pairs, in corner order in `v`.
// Pair p is the corners (2p, 2p + 1) (the z pair) on a direct level and
// (p, p + 4) (the x pair) on a hashed one. Where the pair's rows are the
// two rows of one aligned pair (2k, 2k + 1), one load fetches both (16
// bytes in f32, 8 in bf16); elsewhere each corner loads its own row. The
// loads are predicated, not branched, and all issue before any is used,
// so a warp waits for L2 once a level.
template <bool kDirect, typename Scalar>
__device__ __forceinline__ void gather_pairs(const Scalar* level, const unsigned (&idx)[8],
                                             uint64_t policy, float2 (&v)[8]) {
  Rows2 q[4];
  float2 own_a[4], own_b[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const unsigned ia = idx[kDirect ? 2 * p : p], ib = idx[kDirect ? 2 * p + 1 : p + 4];
    const bool pair = (ia ^ ib) == 1;
    q[p] = load_pair_if(pair, level, ia, policy);
    own_a[p] = load_row_if(!pair, level, ia, policy);
    own_b[p] = load_row_if(!pair, level, ib, policy);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ca = kDirect ? 2 * p : p, cb = kDirect ? 2 * p + 1 : p + 4;
    const unsigned ia = idx[ca], ib = idx[cb];
    const bool pair = (ia ^ ib) == 1;
    v[ca] = pair ? (ia & 1 ? q[p].odd : q[p].even) : own_a[p];
    v[cb] = pair ? (ib & 1 ? q[p].odd : q[p].even) : own_b[p];
  }
}

// Bytes between two staged output rows: the row rounded up to 16 bytes, and
// 16 more, so that the lanes' stores (one sample a lane) spread over the
// banks and every row starts 16-byte aligned for the copy out.
__host__ __device__ __forceinline__ int tile_pitch(int row_bytes) {
  return ((row_bytes + 15) & ~15) + 16;
}

template <typename Scalar, bool kPair>
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const float* __restrict__ points, long long n,
                   const Scalar* __restrict__ tables, int levels, long long table_size,
                   unsigned hash_mask, int features, float lo, float span, Levels lv,
                   Scalar* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);             // [kTile][3] normalized points
  unsigned char* tile = smem + kTile * 3 * sizeof(float);  // [kTile][pitch] staged output
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), n - s0));
  const int row_bytes = levels * features * static_cast<int>(sizeof(Scalar));
  const int pitch = tile_pitch(row_bytes);

  // Each point normalized once: into the AABB's unit cube, NaN to 0, the
  // clip to [0, 1] (which takes +-inf where nan_to_num's +-max would go).
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    float x = 0.f;                        // the tail tile's missing samples: cell 0
    if (i < rows * 3) {
      x = __fdiv_rn(__fsub_rn(points[s0 * 3 + i], lo), span);
      x = isnan(x) ? 0.f : fminf(fmaxf(x, 0.f), 1.f);
    }
    xs[i] = x;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint64_t policy = evict_last_policy();
  for (int task = warp; task < levels * kGroups; task += kWarps) {
    const int l = task / kGroups;
    const int s = (task - l * kGroups) * 32 + lane;       // this lane's sample in the tile
    const float res = lv.res[l];
    unsigned cell[3];
    float frac[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = __fmul_rn(res, xs[s * 3 + a]);
      const float i0 = fminf(fmaxf(floorf(pos), 0.f), __fsub_rn(res, 1.f));
      cell[a] = static_cast<unsigned>(i0);
      frac[a] = __fsub_rn(pos, i0);
    }
    // The corners' rows within the level, c = bx * 4 + by * 2 + bz.
    const bool direct = lv.direct[l] != 0;
    unsigned idx[8];
    if (direct) {
      const unsigned np1 = static_cast<unsigned>(lv.np1[l]);
      const unsigned r0 = (cell[0] * np1 + cell[1]) * np1 + cell[2];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        idx[c] = r0 + (c >> 2) * np1 * np1 + ((c >> 1) & 1) * np1 + (c & 1);
      }
    } else {
      const unsigned hy0 = cell[1] * kPrimeY, hz0 = cell[2] * kPrimeZ;
      const unsigned hy1 = hy0 + kPrimeY, hz1 = hz0 + kPrimeZ;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        idx[c] = ((cell[0] + (c >> 2)) ^ ((c >> 1) & 1 ? hy1 : hy0) ^ (c & 1 ? hz1 : hz0)) &
                 hash_mask;
      }
    }
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wx = c >> 2 ? frac[0] : __fsub_rn(1.f, frac[0]);
      const float wy = (c >> 1) & 1 ? frac[1] : __fsub_rn(1.f, frac[1]);
      const float wz = c & 1 ? frac[2] : __fsub_rn(1.f, frac[2]);
      w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
    }
    const Scalar* level = tables + static_cast<size_t>(l) * static_cast<size_t>(table_size) *
                                       static_cast<size_t>(features);

    if (kPair) {
      float2 v[8];
      if (direct) {
        gather_pairs<true>(level, idx, policy, v);
      } else {
        gather_pairs<false>(level, idx, policy, v);
      }
      float a0 = __fmul_rn(v[0].x, w[0]), a1 = __fmul_rn(v[0].y, w[0]);
#pragma unroll
      for (int c = 1; c < 8; ++c) {
        a0 = __fadd_rn(a0, __fmul_rn(v[c].x, w[c]));
        a1 = __fadd_rn(a1, __fmul_rn(v[c].y, w[c]));
      }
      store_pair(reinterpret_cast<Scalar*>(tile + s * pitch) + 2 * l, a0, a1);
    } else if (s < rows) {
      Scalar* o = out + (s0 + s) * static_cast<long long>(levels * features) + l * features;
      for (int f = 0; f < features; ++f) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float t = __fmul_rn(to_float(level[static_cast<size_t>(idx[c]) * features + f]),
                                    w[c]);
          acc = c == 0 ? t : __fadd_rn(acc, t);
        }
        store(o + f, acc);
      }
    }
  }
  if (!kPair) return;

  // The staged tile, point-major, to the output: contiguous rows * row_bytes
  // bytes, in 16-byte streaming stores where rows are whole 16-byte chunks.
  __syncthreads();
  unsigned char* dst = reinterpret_cast<unsigned char*>(out) + s0 * row_bytes;
  if ((row_bytes & 15) == 0) {
    const int chunks = row_bytes >> 4;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks;
      __stcs(reinterpret_cast<float4*>(dst) + i,
             *reinterpret_cast<const float4*>(tile + r * pitch + (i - r * chunks) * 16));
    }
  } else {
    const int words = row_bytes >> 2;
    for (int i = threadIdx.x; i < rows * words; i += kThreads) {
      const int r = i / words;
      __stcs(reinterpret_cast<unsigned*>(dst) + i,
             *reinterpret_cast<const unsigned*>(tile + r * pitch + (i - r * words) * 4));
    }
  }
}

template <typename Scalar>
cudaError_t launch(const float* points, long long n, const void* tables, int levels,
                   long long table_size, int features, bool pair, float lo, float span,
                   const Levels& lv, void* out, cudaStream_t stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const unsigned mask = static_cast<unsigned>(table_size - 1);
  const Scalar* t = static_cast<const Scalar*>(tables);
  Scalar* o = static_cast<Scalar*>(out);
  const size_t row_bytes = static_cast<size_t>(levels) * features * sizeof(Scalar);
  const size_t smem = kTile * 3 * sizeof(float) + (pair ? kTile * tile_pitch(row_bytes) : 0);
  const auto kernel = pair ? hash_encode_kernel<Scalar, true> : hash_encode_kernel<Scalar, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      points, n, t, levels, table_size, mask, features, lo, span, lv, o);
  return cudaGetLastError();
}

}  // namespace

// points (n, 3) f32; tables (levels * table_size, features) f32 (bf16 = 0)
// or bf16 (bf16 = 1), contiguous; res / np1 / direct: `levels` host values
// per level (N_l, N_l + 1, and 1 where the level indexes directly); out
// (n, levels * features) in the tables' dtype, 16-byte aligned. pair = 1
// takes the paired loads and the staged output: it needs features = 2, an
// even table_size and the tables 16-byte (f32) or 8-byte (bf16) aligned.
// Needs 1 <= levels <= kMaxLevels, features >= 1, 1 <= table_size <= 2^32.
// Launches on `stream` without synchronizing. Returns a cudaError_t value
// (0 = launched).
extern "C" int nerf_hash_encode(const void* points, long long n, const void* tables, int levels,
                                long long table_size, int features, int bf16, int pair,
                                const float* res, const int* np1, const int* direct, float lo,
                                float span, void* out, int device, void* stream) {
  const uintptr_t align = bf16 ? 8 : 16;
  if (levels < 1 || levels > kMaxLevels || features < 1 || table_size < 1 ||
      table_size > (1LL << 32) || n < 0 ||
      (pair && (features != 2 || table_size % 2 != 0 ||
                reinterpret_cast<uintptr_t>(tables) % align != 0 ||
                reinterpret_cast<uintptr_t>(out) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Levels lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.res[l] = res[l];
    lv.np1[l] = np1[l];
    lv.direct[l] = direct[l];
  }
  const float* p = static_cast<const float*>(points);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<__nv_bfloat16>(p, n, tables, levels, table_size, features, pair != 0, lo,
                                     span, lv, out, s)
             : launch<float>(p, n, tables, levels, table_size, features, pair != 0, lo, span,
                             lv, out, s);
  return static_cast<int>(err);
}
