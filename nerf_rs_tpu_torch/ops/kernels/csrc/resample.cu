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
// floating-point operations. The design keeps every intermediate on chip
// and reads and writes each row once, coalesced:
// - one warp per ray, kWarps rays per CTA, no block-level barrier (each
//   warp owns its slice of shared memory and synchronizes with __syncwarp);
// - the transmittance product and the CDF sum are warp scans in a fixed
//   order (a serial scan per lane over a contiguous segment, then a
//   shuffle scan of the segment totals), so two calls are bitwise equal;
// - each fine sample finds its bin by binary search over the CDF, which
//   is strictly increasing because every PDF entry carries the pdf_eps
//   floor: the search returns the reference's "first j with
//   cdf[j] <= u < cdf[j+1]";
// - the merge is a bitonic sort of the row, padded with +inf to the next
//   power of two; the padding sorts to the tail and is not stored.
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

__global__ void __launch_bounds__(kWarps * 32)
resample_kernel(const float* __restrict__ t_c, const float* __restrict__ sigma_c,
                const float* __restrict__ u, const float* __restrict__ far,
                long long far_stride, float far_value, long long n, int nc, int nf, int width,
                float t_threshold, float pdf_eps, float cdf_eps, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (ray >= n) return;                   // the whole warp leaves together
  float* t = smem + warp * (3 * nc + width);   // [nc] coarse t
  float* a = t + nc;                           // [nc] sigma, then alpha
  float* c = a + nc;                           // [nc] 1 - alpha -> T -> CDF
  float* row = c + nc;                         // [width] PDF scratch, then the merged row
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

  // The merged row: coarse t, the fine samples, +inf padding.
  for (int j = lane; j < nc; j += 32) row[j] = t[j];
  for (int j = nc + nf + lane; j < width; j += 32) row[j] = INFINITY;
  for (int i = lane; i < nf; i += 32) {
    const float v = u[ray * nf + i];
    int lo = 0, hi = n_bins;              // c[lo] <= v; the bin lies in [lo, hi)
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (c[mid] <= v) lo = mid; else hi = mid;
    }
    const float cdf_lo = c[lo], cdf_hi = c[lo + 1];
    const float bin_lo = 0.5f * (t[lo] + t[lo + 1]);
    const float bin_hi = 0.5f * (t[lo + 1] + t[lo + 2]);
    const float frac = (v - cdf_lo) / fmaxf(cdf_hi - cdf_lo, cdf_eps);
    row[nc + i] = __fadd_rn(bin_lo, __fmul_rn(bin_hi - bin_lo, frac));
  }
  __syncwarp();

  // Ascending bitonic sort of the row; each lane takes width / 64 pairs.
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = lane; p < width / 2; p += 32) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const float x = row[i], y = row[i + j];
        if ((x > y) == ((i & k) == 0)) {
          row[i] = y;
          row[i + j] = x;
        }
      }
      __syncwarp();
    }
  }

  const int m = nc + nf;
  for (int j = lane; j < m; j += 32) out[ray * m + j] = row[j];
}

}  // namespace

// t_c (n, nc), sigma_c (n, nc), u (n, nf) f32, contiguous; far: one f32 per
// ray (far_stride 1) or one for all (far_stride 0) on the device, or null to
// use far_value; out (n, nc + nf) f32. Needs 3 <= nc, 1 <= nf,
// nc + nf <= kMaxRow. Launches on `stream` without synchronizing. Returns a cudaError_t value (0 = launched).
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
  int width = 1;
  while (width < nc + nf) width <<= 1;
  const size_t smem = sizeof(float) * kWarps * (3 * nc + width);
  err = cudaFuncSetAttribute(resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kWarps - 1) / kWarps;
  resample_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_c), static_cast<const float*>(sigma_c),
      static_cast<const float*>(u), static_cast<const float*>(far), far_stride, far_value, n, nc,
      nf, width, t_threshold, pdf_eps, cdf_eps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
