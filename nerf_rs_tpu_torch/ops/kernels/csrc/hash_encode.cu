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
// What bounds it on the H100: memory, in two places. The bytes the function
// must move are the points (12 B a sample), the table (16 MiB in f32 at the
// paper config) and the output (L*F values a sample, 128 B in f32): at
// 3.35 TB/s, 0.136 ms for 16384 x 192 samples. The table fits in the 50 MB
// L2, but every sample makes L*8 = 128 random row loads, each a 32-byte
// sector for an 8-byte row, so L2 sector traffic (not HBM) bounds the
// gather. This first kernel is simple: one thread per (sample, level),
// consecutive threads on consecutive levels so that the output writes
// coalesce; F = 2 rows load in one instruction (8 bytes f32, 4 bytes bf16,
// as the JAX package's _packed_pair_gather); f32 accumulation, one rounding
// to the tables' dtype. Making it fast (level-major blocks that keep a
// coarse level's rows in shared memory, L2 persistence for the table, the
// tiny MLP fused behind it) is later work.
//
// Numerics: every product and sum is an explicit IEEE intrinsic, so nvcc
// contracts nothing into an FMA: frac is pos - floor(pos) of the rounded
// product N_l * x, as in the plain version. The AABB normalization is a
// true division. NaN maps to 0 and +-inf to +-FLT_MAX before the clip to
// [0, 1], as nan_to_num does. The corners sum in the JAX order
// (meshgrid "ij" over (bx, by, bz), bz fastest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 64;            // hash_encode.py MAX_LEVELS
constexpr int kThreads = 256;

struct Levels {
  float res[kMaxLevels];                  // N_l
  int np1[kMaxLevels];                    // N_l + 1
  int direct[kMaxLevels];                 // (N_l + 1)^3 <= T: direct index, else the hash
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Row `row` of a (rows, 2) table as two floats, in one load: 8 bytes for
// f32, 4 bytes for bf16 (a bf16's f32 bits are its own bits << 16).
__device__ __forceinline__ float2 load_pair(const float* t, long long row) {
  return reinterpret_cast<const float2*>(t)[row];
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* t, long long row) {
  const unsigned u = reinterpret_cast<const unsigned*>(t)[row];
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}

template <typename Scalar, bool kPair>
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const float* __restrict__ points, long long n,
                   const Scalar* __restrict__ tables, int levels, long long table_size,
                   unsigned hash_mask, int features, float lo, float span, Levels lv,
                   Scalar* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n * levels) return;
  const long long s = i / levels;
  const int l = static_cast<int>(i - s * levels);
  const float res = lv.res[l];

  int cell[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float x = __fdiv_rn(__fsub_rn(points[s * 3 + a], lo), span);
    x = isnan(x) ? 0.f : fminf(fmaxf(x, 0.f), 1.f);
    const float pos = __fmul_rn(res, x);
    const float i0 = fminf(fmaxf(floorf(pos), 0.f), __fsub_rn(res, 1.f));
    cell[a] = static_cast<int>(i0);
    frac[a] = __fsub_rn(pos, i0);
  }

  const long long base = static_cast<long long>(l) * table_size;
  const bool direct = lv.direct[l] != 0;
  const long long np1 = lv.np1[l];
  long long rows[8];
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int bx = c >> 2, by = (c >> 1) & 1, bz = c & 1;
    const int cx = cell[0] + bx, cy = cell[1] + by, cz = cell[2] + bz;
    long long idx;
    if (direct) {
      idx = (cx * np1 + cy) * np1 + cz;
    } else {
      idx = ((static_cast<unsigned>(cx) * 1u) ^ (static_cast<unsigned>(cy) * 2654435761u) ^
             (static_cast<unsigned>(cz) * 805459861u)) & hash_mask;
    }
    rows[c] = base + idx;
    const float wx = bx ? frac[0] : __fsub_rn(1.f, frac[0]);
    const float wy = by ? frac[1] : __fsub_rn(1.f, frac[1]);
    const float wz = bz ? frac[2] : __fsub_rn(1.f, frac[2]);
    w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }

  Scalar* o = out + i * features;
  if (kPair) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 v = load_pair(tables, rows[c]);
      const float t0 = __fmul_rn(v.x, w[c]), t1 = __fmul_rn(v.y, w[c]);
      a0 = c == 0 ? t0 : __fadd_rn(a0, t0);
      a1 = c == 0 ? t1 : __fadd_rn(a1, t1);
    }
    store(o, a0);
    store(o + 1, a1);
  } else {
    for (int f = 0; f < features; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float t = __fmul_rn(to_float(tables[rows[c] * features + f]), w[c]);
        acc = c == 0 ? t : __fadd_rn(acc, t);
      }
      store(o + f, acc);
    }
  }
}

template <typename Scalar>
cudaError_t launch(const float* points, long long n, const void* tables, int levels,
                   long long table_size, int features, bool pair, float lo, float span,
                   const Levels& lv, void* out, cudaStream_t stream) {
  const long long blocks = (n * levels + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const unsigned mask = static_cast<unsigned>(table_size - 1);
  const Scalar* t = static_cast<const Scalar*>(tables);
  Scalar* o = static_cast<Scalar*>(out);
  if (pair) {
    hash_encode_kernel<Scalar, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        points, n, t, levels, table_size, mask, features, lo, span, lv, o);
  } else {
    hash_encode_kernel<Scalar, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        points, n, t, levels, table_size, mask, features, lo, span, lv, o);
  }
  return cudaGetLastError();
}

}  // namespace

// points (n, 3) f32; tables (levels * table_size, features) f32 (bf16 = 0)
// or bf16 (bf16 = 1), contiguous; res / np1 / direct: `levels` host values
// per level (N_l, N_l + 1, and 1 where the level indexes directly); out
// (n, levels * features) in the tables' dtype. pair = 1 takes features = 2
// rows in one load and needs the tables 8-byte (f32) or 4-byte (bf16)
// aligned. Needs 1 <= levels <= kMaxLevels, features >= 1,
// 1 <= table_size <= 2^32. Launches on `stream` without synchronizing.
// Returns a cudaError_t value (0 = launched).
extern "C" int nerf_hash_encode(const void* points, long long n, const void* tables, int levels,
                                long long table_size, int features, int bf16, int pair,
                                const float* res, const int* np1, const int* direct, float lo,
                                float span, void* out, int device, void* stream) {
  if (levels < 1 || levels > kMaxLevels || features < 1 || table_size < 1 ||
      table_size > (1LL << 32) || n < 0 || (pair && features != 2)) {
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
