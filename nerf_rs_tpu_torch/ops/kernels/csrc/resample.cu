// Fused hierarchical resampler (K3) for Hopper (sm_90a): per ray, the
// coarse transmittance weights, the interior-weight PDF and its CDF, the
// inverse-CDF lookup of the fine samples, and the ascending merge of the
// coarse and fine t values, in one launch.
//
// Replaces nerf_rs_tpu/ops/kernels/resample.py::_resample_call, both of its
// Pallas calls: _kernel_extra (weights -> CDF -> lookup) and _kernel_merge
// (merge + bitonic sort). The TPU kernel split them in two launches around
// a Mosaic compiler crash and packed rows into power-of-two lane widths for
// its vector unit; neither constraint exists here. It computes the same
// function as the port's plain chain (ops/kernels/resample.py::
// fused_resample_reference): ops.volume.compute_weights, then
// ops.sampling.inverse_cdf on the given uniforms, then merge_samples.
//
// What bounds it on the H100: memory. A ray reads (2 Nc + Nf) floats and
// writes Nc + Nf, about 1.75 KB at (64, 128), against a few thousand
// operations. The design keeps every intermediate on chip, reads and
// writes each row once, coalesced, and keeps the instruction count of a
// ray small enough that the SMs' issue stays below the memory time:
// - one warp per ray, kWarps rays per CTA, no block-level barrier (each
//   warp owns its slice of shared memory and synchronizes with __syncwarp);
// - the transmittance product and the CDF sum are warp scans in a fixed
//   order (a serial scan per lane over a contiguous segment, then a
//   shuffle scan of the segment totals), so two calls are bitwise equal;
// - each fine sample finds its bin by a binary search over the CDF in
//   steps of decreasing powers of two (the largest j < Nc - 2 with
//   cdf[j] <= u: the reference's "first j with cdf[j] <= u < cdf[j+1]"),
//   up to kBatch searches of a lane in step so that their shared-memory
//   loads overlap;
// - the merge does not sort the row. Only the fine samples come unsorted
//   (they follow the uniforms), so they alone are sorted, in registers: K
//   values a lane (the smallest power of two with 32 K >= Nc and Nf; the
//   excess padded with +inf), a bitonic network whose distances below K
//   are compare-exchanges inside a lane and above it __shfl_xor_sync.
//   The coarse row is checked (a warp vote) and sorted the same way only
//   where it is not sorted already, so the kernel computes the sorted
//   merge for any input, as torch.sort does.
//   Each value's slot in the output is its index in its own sorted list
//   plus the count of the other list's values below it (< for a fine
//   value against the coarse list, <= for a coarse value against the fine
//   one), found by binary search in shared memory; the values are
//   scattered to the warp's row and the row written out coalesced. With no
//   NaN in the inputs the row is the sorted list of the Nc + Nf values,
//   which is unique, so it equals the first kernel's (a bitonic sort of the
//   whole row) bit for bit.
// Timed with parts taken out (tools/torch_hash_ablation.py, 16384 x (64,
// 128), an H100 SXM): of 0.045-0.048 ms as built, the merge's searches
// take 0.008-0.013 ms, the bin searches 0.007-0.008, the scans
// 0.003-0.004; a coarse row that needs its sort adds 0.005-0.006 (PERF.md
// §6).
//
// Numerics: expf and IEEE division (no fast math); the in-bin
// interpolation rounds its product and its sum separately, as the plain
// version's two tensor ops do. The CDF divides the running sum by the
// total, as the JAX kernel does, where the plain version normalizes first:
// the two differ by a few ulps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;                 // rays per CTA
constexpr int kMaxRow = 2048;             // Nc + Nf served (resample.py MAX_ROW)
constexpr int kBatch = 8;                 // searches a lane keeps in flight
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Mul {
  __device__ float operator()(float a, float b) const { return __fmul_rn(a, b); }
};
struct Add {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// Inclusive scan of x[0, n) in place, by the calling warp. Lane l scans
// the contiguous segment [l k, (l + 1) k), k = ceil(n / 32), serially; the
// warp scans the 32 segment totals with shuffles; each lane then folds the
// total of the segments before it into its own. The order is fixed.
template <typename Op>
__device__ void warp_scan(float* x, int n, float identity, Op op) {
  const int lane = threadIdx.x & 31;
  const int k = (n + 31) / 32;
  const int lo = min(lane * k, n), hi = min(lo + k, n);
  float run = identity;
  for (int i = lo; i < hi; ++i) {
    run = i == lo ? x[i] : op(run, x[i]);
    x[i] = run;
  }
  float total = run;
  for (int s = 1; s < 32; s <<= 1) {
    const float other = __shfl_up_sync(kFull, total, s);
    if (lane >= s) total = op(other, total);
  }
  const float before = __shfl_up_sync(kFull, total, 1);
  if (lane > 0) {
    for (int i = lo; i < hi; ++i) x[i] = op(before, x[i]);
  }
  __syncwarp();
}

// Ascending bitonic sort of the warp's 32 K values, K a power of two; lane
// l holds elements l K .. l K + K - 1 in v[0 .. K). Distances below K pair
// two of a lane's own registers, distances from K up pair register k of
// two lanes.
template <int K>
__device__ __forceinline__ void warp_sort(float (&v)[K], int lane) {
  constexpr int kLogN = 5 + (K >= 2) + (K >= 4) + (K >= 8) + (K >= 16) + (K >= 32) + (K >= 64);
#pragma unroll
  for (int ls = 1; ls <= kLogN; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < K) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = k ^ j;
          if (p > k) {
            const bool up = ((lane * K + k) & size) == 0;
            const float lo = fminf(v[k], v[p]), hi = fmaxf(v[k], v[p]);
            v[k] = up ? lo : hi;
            v[p] = up ? hi : lo;
          }
        }
      } else {
        const int m = j / K;                      // the partner lane is lane ^ m
        const bool keep_min = (((lane * K) & size) == 0) == ((lane & m) == 0);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float o = __shfl_xor_sync(kFull, v[k], m);
          v[k] = keep_min ? fminf(v[k], o) : fmaxf(v[k], o);
        }
      }
    }
  }
}

// The n values src[0, n) sorted ascending into dst[0, n) (src may be dst),
// by the calling warp through warp_sort: value k 32 + lane into register k
// of its lane, +inf past n.
template <int K>
__device__ __forceinline__ void warp_sort_into(const float* src, int n, float* dst) {
  const int lane = threadIdx.x & 31;
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    v[k] = i < n ? src[i] : INFINITY;
  }
  __syncwarp();
  warp_sort<K>(v, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane * K + k < n) dst[lane * K + k] = v[k];
  }
  __syncwarp();
}

// The largest power of two <= n (0 for n < 1).
__device__ __forceinline__ int top_step(int n) { return n < 1 ? 0 : 1 << (31 - __clz(n)); }

// Count of the sorted list s[0, n) below x (strictly, or <= with kOrEqual),
// by binary search in steps of decreasing powers of two, for B values at
// once.
template <bool kOrEqual, int B>
__device__ __forceinline__ void ranks(const float* s, int n, const float (&x)[B], int (&count)[B]) {
#pragma unroll
  for (int b = 0; b < B; ++b) count[b] = 0;
  for (int step = top_step(n); step > 0; step >>= 1) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int probe = count[b] + step;
      if (probe <= n) {
        const float y = s[probe - 1];
        if (kOrEqual ? y <= x[b] : y < x[b]) count[b] = probe;
      }
    }
  }
}

// Launch bounds with one CTA an SM: without the minimum, ptxas held some
// instances to 40 registers and spilled (PERF.md §6).
template <int K>
__global__ void __launch_bounds__(kWarps * 32, 1)
resample_kernel(const float* __restrict__ t_c, const float* __restrict__ sigma_c,
                const float* __restrict__ u, const float* __restrict__ far,
                long long far_stride, float far_value, long long n, int nc, int nf,
                float t_threshold, float pdf_eps, float cdf_eps, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (ray >= n) return;                   // the whole warp leaves together
  const int m = nc + nf;
  float* t = smem + warp * (4 * nc + 2 * nf);   // [nc] coarse t, in the given order
  float* a = t + nc;                            // [nc] sigma, then alpha, then the sorted t
  float* c = a + nc;                            // [nc] 1 - alpha -> T -> CDF
  float* row = c + nc;                          // [m] PDF scratch, then the merged row
  float* fs = row + m;                          // [nf] the sorted fine samples
  const int n_bins = nc - 2;

  for (int j = lane; j < nc; j += 32) {
    t[j] = t_c[ray * nc + j];
    a[j] = sigma_c[ray * nc + j];
  }
  __syncwarp();
  const float f = far != nullptr ? far[ray * far_stride] : far_value;

  // Deltas (the last one to far), clamped at 0; alpha = 1 - exp(-sigma delta).
  for (int j = lane; j < nc; j += 32) {
    const float delta = fmaxf(j < nc - 1 ? t[j + 1] - t[j] : f - t[j], 0.f);
    const float alpha = 1.f - expf(-a[j] * delta);
    a[j] = alpha;
    c[j] = 1.f - alpha;
  }
  __syncwarp();
  warp_scan(c, nc, 1.f, Mul());           // c[j] = T after sample j

  // Interior weights w[1 .. nc-2] -> PDF with its floor, into row[0, n_bins).
  for (int j = lane; j < n_bins; j += 32) {
    const float t_excl = c[j];            // T before sample j + 1
    float w = __fmul_rn(t_excl, a[j + 1]);
    if (t_threshold > 0.f && !(t_excl >= t_threshold)) w = 0.f;
    row[j] = fmaxf(w, 0.f) + pdf_eps;
  }
  __syncwarp();
  warp_scan(row, n_bins, 0.f, Add());
  const float total = row[n_bins - 1];

  // CDF: 0, the normalized running sums, and a last entry of exactly 1.
  for (int j = lane; j <= n_bins; j += 32) {
    c[j] = j == 0 ? 0.f : (j == n_bins ? 1.f : row[j - 1] / total);
  }
  __syncwarp();

  // The fine samples into fs (sample k 32 + lane from the lane's k-th
  // uniform), their bins searched B at a time; then sorted in place.
  constexpr int B = K < kBatch ? K : kBatch;
  const int top_bin = top_step(n_bins - 1);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += B) {
    float uk[B];
    int bin[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = (k0 + b) * 32 + lane;
      uk[b] = i < nf ? u[ray * nf + i] : 0.f;
      bin[b] = 0;
    }
    for (int step = top_bin; step > 0; step >>= 1) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int probe = bin[b] + step;
        if (probe < n_bins && c[probe] <= uk[b]) bin[b] = probe;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = (k0 + b) * 32 + lane, lo = bin[b];
      const float cdf_lo = c[lo], cdf_hi = c[lo + 1];
      const float bin_lo = 0.5f * (t[lo] + t[lo + 1]);
      const float bin_hi = 0.5f * (t[lo + 1] + t[lo + 2]);
      const float frac = (uk[b] - cdf_lo) / fmaxf(cdf_hi - cdf_lo, cdf_eps);
      if (i < nf) fs[i] = __fadd_rn(bin_lo, __fmul_rn(bin_hi - bin_lo, frac));
    }
  }
  warp_sort_into<K>(fs, nf, fs);

  // The coarse row, sorted into `a` where it is not sorted already.
  bool sorted = true;
  for (int j = lane; j < nc - 1; j += 32) sorted = sorted && t[j] <= t[j + 1];
  const float* cs = t;
  if (!__all_sync(kFull, sorted)) {
    warp_sort_into<K>(t, nc, a);
    cs = a;
  }

  // Rank merge: each value to its index in its own list plus the count of
  // the other list's values below it.
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += B) {
    float x[B];
    int below[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = (k0 + b) * 32 + lane;
      x[b] = i < nf ? fs[i] : INFINITY;
    }
    ranks<false>(cs, nc, x, below);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = (k0 + b) * 32 + lane;
      if (i < nf) row[i + below[b]] = x[b];
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = (k0 + b) * 32 + lane;
      x[b] = j < nc ? cs[j] : INFINITY;
    }
    ranks<true>(fs, nf, x, below);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = (k0 + b) * 32 + lane;
      if (j < nc) row[j + below[b]] = x[b];
    }
  }
  __syncwarp();

  for (int j = lane; j < m; j += 32) out[ray * m + j] = row[j];
}

template <int K>
cudaError_t launch(const float* t_c, const float* sigma_c, const float* u, const float* far,
                   long long far_stride, float far_value, long long n, int nc, int nf,
                   float t_threshold, float pdf_eps, float cdf_eps, float* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * (4 * nc + 2 * nf);
  cudaError_t err = cudaFuncSetAttribute(resample_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kWarps - 1) / kWarps;
  resample_kernel<K><<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      t_c, sigma_c, u, far, far_stride, far_value, n, nc, nf, t_threshold, pdf_eps, cdf_eps,
      out);
  return cudaGetLastError();
}

}  // namespace

// t_c (n, nc), sigma_c (n, nc), u (n, nf) f32, contiguous; far: one f32 per
// ray (far_stride 1) or one for all (far_stride 0) on the device, or null to
// use far_value; out (n, nc + nf) f32. Needs 3 <= nc, 1 <= nf,
// nc + nf <= kMaxRow. Launches on `stream` without synchronizing. Returns a
// cudaError_t value (0 = launched).
extern "C" int nerf_fused_resample(const void* t_c, const void* sigma_c, const void* u,
                                   const void* far, long long far_stride, float far_value,
                                   long long n, int nc, int nf, float t_threshold,
                                   float pdf_eps, float cdf_eps, void* out, int device,
                                   void* stream) {
  if (nc < 3 || nf < 1 || nc + nf > kMaxRow || n < 0 || (far_stride != 0 && far_stride != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K: values a lane, the smallest power of two with 32 K >= max(nc, nf).
  int k = 1;
  while (32 * k < nc || 32 * k < nf) k <<= 1;
  const auto* tc = static_cast<const float*>(t_c);
  const auto* sc = static_cast<const float*>(sigma_c);
  const auto* uu = static_cast<const float*>(u);
  const auto* fr = static_cast<const float*>(far);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_RESAMPLE_LAUNCH(K)                                                              \
  case K:                                                                                    \
    err = launch<K>(tc, sc, uu, fr, far_stride, far_value, n, nc, nf, t_threshold, pdf_eps, \
                    cdf_eps, o, s);                                                          \
    break;
  switch (k) {
    NERF_RESAMPLE_LAUNCH(1)
    NERF_RESAMPLE_LAUNCH(2)
    NERF_RESAMPLE_LAUNCH(4)
    NERF_RESAMPLE_LAUNCH(8)
    NERF_RESAMPLE_LAUNCH(16)
    NERF_RESAMPLE_LAUNCH(32)
    NERF_RESAMPLE_LAUNCH(64)
    default:
      err = cudaErrorInvalidValue;
  }
#undef NERF_RESAMPLE_LAUNCH
  return static_cast<int>(err);
}
