// Fused NeRF MLP backward in float32 for Hopper (sm_90a) for wide or deep
// networks, K2's f32 mode beyond the narrow envelope: trunk and view widths
// up to 512, up to 32 dense layers (fused_mlp_wide.cuh's tables). Per tile
// of 64 samples it backpropagates through the rgb head, the view layer,
// the bottleneck, the sigma head and the trunk with its skip layer, and
// sums every layer's weight and bias gradient over the samples; with input
// gradients requested, also d(points) and d(dirs) through the encode.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t (:663, the
// Pallas call at :675) for dtype="float32" where the narrow kernel
// (fused_mlp_bwd_tc.cu: widths up to 256, depth up to 16) stops; the JAX
// kernel trains any width that is a multiple of 128 and any depth.
//
// The design is the narrow kernel's, whose device code
// (fused_mlp_bwd_tc.cuh) this source instantiates for 64-sample tiles and
// 512 columns: 3xTF32 mma.sync for every dW and W dz product, the packs
// (PackedMLP.mma_wt of a wide pack, 67 entries in layout_mma) read from
// L2, the owner-thread partials and the fixed-order sum. What changes with
// the width:
// - the tile: the narrow kernel's 128 x 260 f32 activation buffer would be
//   128 x 516 at width 512, 264 KB, more than the 227 KB a block may use.
//   At the wide forward's own 64 samples a tile, shared memory holds the
//   activation or gradient buffer (64 x 516 f32, 132 KB), the point and dir
//   encode gradients (17 and 9 KB) and the inputs and head cotangents (2.5
//   KB): 161 KB. The register tile is kMi 4 m16 x kNt 8 n8 tiles a warp,
//   128 accumulators a thread, as the narrow kernel's 8 x 4;
// - the recompute: the wide f32 forward (fused_mlp_wide_f32.cu, true f32
//   on the CUDA cores) in record mode, nerf_fused_mlp_wide_f32_record, a
//   launch before each round of tiles, so the activations and ReLU masks
//   are bit for bit those of the forward that made the loss;
// - the workspace: one 64-sample tile's record at 512/256/8 is (96 + 9 x
//   512 + 256) x 64 x 4 B = 1.27 MB.
//
// What bounds it on the H100: operations. At 512/256/8 a fine sample costs
// three forwards of 4.60 MFLOP: the recompute on the CUDA cores (67
// TFLOP/s) and dW and W dz as 3xTF32 (three tf32 products each, 495
// TFLOP/s).

#include "fused_mlp_bwd_tc.cuh"
#include "fused_mlp_wide.cuh"

namespace {

using namespace nerf;
using namespace nerf::wide;
using Wide = bwd_tc::BwdTc<64, kWideMaxWidth, kWideMaxDepth>;

template <bool kSigmaOnly>
__global__ void __launch_bounds__(Wide::kThreadsBwd, 1)
fused_mlp_wide_bwd_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                             long long n, long long dir_div, const float* __restrict__ g_rgb,
                             const float* __restrict__ g_sigma, const float* __restrict__ w,
                             const float* __restrict__ mwt, long long lo_wt,
                             const float* __restrict__ bias, const WideLayout L,
                             const Wide::LayoutMma M, float* ws_all, long long ws_stride,
                             long long tile0, int per_cta, float* partials, long long n_w,
                             long long part_stride, long long ntiles, float* __restrict__ dpts,
                             float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  bwd_tc::bwd_tc_tiles<Wide, WideLayout, kSigmaOnly>(
      reinterpret_cast<float*>(smem4), pts, dirs, n, dir_div, g_rgb, g_sigma, w, mwt, lo_wt, bias,
      L, M, ws_all, ws_stride, tile0, per_cta, partials, n_w, part_stride, ntiles, dpts, ddirs);
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* g_rgb, const float* g_sigma, const float* w, const float* mwt,
                   long long lo_wt, const float* bias, const WideLayout& L,
                   const Wide::LayoutMma& M, float* ws, long long tile0, int per_cta,
                   float* partials, long long n_w, long long n_b, int grid, float* dpts,
                   float* ddirs, cudaStream_t stream) {
  auto kernel = fused_mlp_wide_bwd_tc_kernel<kSigmaOnly>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Wide::kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + Wide::kRows - 1) / Wide::kRows;
  const long long ws_stride = f32tc::ws_stride(L.depth, L.ldw, L.ldv, Wide::kRows);
  kernel<<<grid, Wide::kThreadsBwd, Wide::kSmemBytes, stream>>>(
      pts, dirs, n, dir_div, g_rgb, g_sigma, w, mwt, lo_wt, bias, L, M, ws, ws_stride, tile0,
      per_cta, partials, n_w, n_w + n_b, ntiles, dpts, ddirs);
  return cudaGetLastError();
}

}  // namespace

// nerf_fused_mlp_backward's contract for a wide pack: tiles of 64 samples
// (tiles tile0 + per_cta b + j, j < per_cta, below ceil(n / 64), for CTA b
// of grid), the workspace ws filled by nerf_fused_mlp_wide_f32_record
// (ws_stride(depth, ldw, ldv, 64) f32 a tile, from tile0's), layout the
// wide pack's kWideLayoutLen offsets, layout_mma its 2 kWideMaxDepth + 3.
// Returns a cudaError_t value (0 = launched). Then, once,
// nerf_fused_mlp_backward_sum.
extern "C" int nerf_fused_mlp_wide_backward(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights, const void* mma_wt, long long lo_wt,
    const void* biases, const long long* layout, int layout_len, const long long* layout_mma,
    int layout_mma_len, int ldw, int ldv, int depth, int sigma_only, void* ws, long long tile0,
    int per_cta, void* partials, long long n_w, long long n_b, int grid, void* dpts, void* ddirs,
    int device, void* stream) {
  WideLayout L;
  Wide::LayoutMma M;
  if (!parse_wide_layout(layout, layout_len, ldw, ldv, depth, &L) ||
      !bwd_tc::parse_mma<Wide>(layout_mma, layout_mma_len, depth, &M) || dir_div < 1 ||
      n < 1 || grid < 1 || per_cta < 1 || tile0 < 0 || n_w < 1 || n_b < 1 ||
      (dpts == nullptr) != (ddirs == nullptr) || lo_wt < 1 ||
      reinterpret_cast<uintptr_t>(mma_wt) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* gr = static_cast<const float*>(g_rgb);
  const float* gsg = static_cast<const float*>(g_sigma);
  const float* w = static_cast<const float*>(weights);
  const float* wt = static_cast<const float*>(mma_wt);
  const float* b = static_cast<const float*>(biases);
  float* wsf = static_cast<float*>(ws);
  float* part = static_cast<float*>(partials);
  float* dp = static_cast<float*>(dpts);
  float* dd = static_cast<float*>(ddirs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true>(p, d, n, dir_div, gr, gsg, w, wt, lo_wt, b, L, M, wsf, tile0,
                                  per_cta, part, n_w, n_b, grid, dp, dd, s)
                   : launch<false>(p, d, n, dir_div, gr, gsg, w, wt, lo_wt, b, L, M, wsf, tile0,
                                   per_cta, part, n_w, n_b, grid, dp, dd, s);
  return static_cast<int>(err);
}
