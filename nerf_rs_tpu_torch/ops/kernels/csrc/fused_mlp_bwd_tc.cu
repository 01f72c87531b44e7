// Fused NeRF MLP backward in float32 for Hopper (sm_90a), K2's f32 mode,
// its products on the tensor cores: per tile of 128 samples, recompute the
// forward, backpropagate through the rgb head, the view layer, the
// bottleneck, the sigma head and the trunk with its skip layer, and sum
// every layer's weight and bias gradient over the samples; with input
// gradients requested, also d(points) and d(dirs) through the encode. The
// bf16 mode is fused_mlp_bwd_bf16.cu.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t (:663, the
// Pallas call at :675) and its kernel body _kernel_bwd (:505) for
// dtype="float32". The JAX kernel runs every f32 product at
// Precision.HIGHEST, f32 emulated in bf16 passes on the MXU; its
// counterpart here is 3xTF32: each f32 operand x splits into hi =
// tf32_rna(x) and lo = tf32_rna(x - hi) (cvt.rna.tf32.f32; the weights
// come split from pack_params), and a product is lo*hi + hi*lo + hi*hi,
// summed in f32 by the tensor cores.
//
// The dW and W dz products are mma.sync m16n8k8 tf32: A from registers
// loaded from shared memory, B from registers loaded from L2 (the pack) or
// from the tile's workspace, a block or two ahead of its use. So each operand can be
// read in either orientation from one copy, which the two uses of every
// activation and gradient need (reduced over features in W dz, over
// samples in dW = H^T dZ): tf32 wgmma takes K-major operands only, and a
// 128 x 256 f32 tile split into hi and lo (256 KB) would not fit the
// 227 KB a block may use. mma.sync is the first tensor-core step the
// design allows for tf32; wgmma with a transposed staging copy is not
// built yet.
//
// The recompute is K1 f32 itself: its kernel (fused_mlp_f32tc.cu, the
// split-f32 wgmma layers on PackedMLP.weights_f32tc) runs first in record
// mode over a round of tiles and writes every layer's output to those
// tiles' workspace, which this kernel reads back. So the activations and
// ReLU masks are bit for bit those of the forward that made the loss (a
// recompute in other arithmetic, 3xTF32 with products kept to about
// 2^-21, flipped a mask at a pre-activation of -9.2e-8 among summands of
// 2.1, and every trunk gradient moved by 1-3%), and this kernel's
// registers serve its mma.sync products alone: with the wgmma recompute
// inlined beside them, ptxas spilled and a fine call took 157 ms, against
// 65 for the rest alone (PERF.md).
//
// What bounds it on the H100: operations. A fine sample costs three
// forwards, 3 x 1.187 MFLOP. Through the route it takes, the recompute as
// six bf16 passes at 989 TFLOP/s and dW and W dz as 3xTF32 at 495 (three
// tf32 products each), 16.98 ms a 4096 x 192 call; all on the CUDA cores
// 41.79 ms. What held the CUDA-core version back, and what this design
// does about it:
// 1. CUDA-core FMAs only: every product is on the tensor cores; the CUDA
//    cores keep the encode, the two heads (N = 1, 3), the masks and the
//    operand splits.
// 2. A read-modify-write of the whole dW partial every 64 samples, 59 GB a
//    fine call: the dW products take 128-sample tiles, and each CTA adds
//    its tile sums into its own partial with fire-and-forget reductions
//    (red.global.add.f32) from the accumulators: 2 x 2.4 MB x 6144 tiles =
//    29.5 GB, done by L2 while the SM goes on. Each partial entry belongs
//    to one thread, which adds tile after tile in program order, so the
//    sums' order and bits are fixed; a second launch sums the partials in
//    a fixed order.
// 3. The activation round trip: the tile's encodes (this kernel) and its
//    trunk, bottleneck and view outputs (the record pass) go to the tile's
//    workspace (1.3 MB a tile, written and read once), tiled in B-fragment
//    order, so the dW products load a block with one vector load a lane,
//    two blocks ahead, and stage nothing behind a barrier; X takes h_last
//    and the view output back from it.
// 4. No overlap: the reductions and workspace stores retire in the memory
//    system while the warps issue the next products, and each warp issues
//    the products of all its tiles of a k step together.
// Shared memory, one CTA of 256 threads an SM: the tile's activation or
// gradient buffer (128 x 260 f32, 130 KB), the point encode gradient (128
// x 68, 34 KB), the dir encode gradient (128 x 36, 18 KB), inputs and head
// cotangents (5 KB): 187 KB. The packs stay in L2: for the lego fine
// network the heads of the forward pack and the transposed pack as hi and
// lo (4.8 MB).
//
// The workspace holds a round of tiles (grid x tiles_per_cta), each its
// encodes, trunk outputs, bottleneck output and view output; the wrapper
// walks the tiles round by round (record pass, then this kernel), each CTA
// taking the same tiles of each round, so every partial sums its tiles in
// a fixed order.
//
// Samples past n in the ragged last tile get zero cotangents and add
// exactly zero.
//
// The device code is fused_mlp_bwd_tc.cuh's, which the wide backward
// (fused_mlp_wide_bwd_tc.cu: 64-sample tiles, widths up to 512, depth up to
// 32) shares; this source instantiates it for 128-sample tiles and the
// narrow envelope (kMaxWidth, kMaxDepth of fused_mlp_common.cuh).

#include "fused_mlp_bwd_tc.cuh"

namespace {

using namespace nerf;
using Narrow = bwd_tc::BwdTc<128, kMaxWidth, kMaxDepth>;

template <bool kSigmaOnly>
__global__ void __launch_bounds__(Narrow::kThreadsBwd, 1)
fused_mlp_bwd_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
                        long long dir_div, const float* __restrict__ g_rgb,
                        const float* __restrict__ g_sigma, const float* __restrict__ w,
                        const float* __restrict__ mwt, long long lo_wt,
                        const float* __restrict__ bias, const Layout L,
                        const Narrow::LayoutMma M, float* ws_all, long long ws_stride,
                        long long tile0, int per_cta, float* partials, long long n_w,
                        long long part_stride, long long ntiles, float* __restrict__ dpts,
                        float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  bwd_tc::bwd_tc_tiles<Narrow, Layout, kSigmaOnly>(
      reinterpret_cast<float*>(smem4), pts, dirs, n, dir_div, g_rgb, g_sigma, w, mwt, lo_wt, bias,
      L, M, ws_all, ws_stride, tile0, per_cta, partials, n_w, part_stride, ntiles, dpts, ddirs);
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* g_rgb, const float* g_sigma, const float* w, const float* mwt,
                   long long lo_wt, const float* bias, const Layout& L,
                   const Narrow::LayoutMma& M, float* ws, long long tile0, int per_cta,
                   float* partials, long long n_w, long long n_b, int grid, float* dpts,
                   float* ddirs, cudaStream_t stream) {
  auto kernel = fused_mlp_bwd_tc_kernel<kSigmaOnly>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Narrow::kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + Narrow::kRows - 1) / Narrow::kRows;
  const long long ws_stride = f32tc::ws_stride(L.depth, L.ldw, L.ldv);
  kernel<<<grid, Narrow::kThreadsBwd, Narrow::kSmemBytes, stream>>>(
      pts, dirs, n, dir_div, g_rgb, g_sigma, w, mwt, lo_wt, bias, L, M, ws, ws_stride, tile0,
      per_cta, partials, n_w, n_w + n_b, ntiles, dpts, ddirs);
  return cudaGetLastError();
}

}  // namespace

// One round of the f32 backward: tiles tile0 + per_cta b + j (j <
// per_cta, below ceil(n / 128)) for CTA b of grid, whose workspace ws
// (from tile0's; 128 * (96 + (depth + 1) * ldw + ldv) f32 a tile) the
// record pass (nerf_fused_mlp_f32tc_record) has filled. pts (n, 3) f32;
// dirs (ceil(n / dir_div), 3) f32, sample s reads row s / dir_div; g_rgb
// (n, 3) and g_sigma (n,) f32 cotangents; weights and biases (f32) as
// packed by pack_params, with its host int64 offset table layout
// (kLayoutLen); mma_wt, the transposed tensor-core pack, its lo row lo_wt
// elements after its hi row, with layout_mma (2 kMaxDepth + 3 entries);
// partials: grid * (n_w + n_b) f32, zeroed before the first round, each
// CTA adding into its own; dpts and ddirs (n, 3) f32 outputs (per
// sample), or both null for no input gradients. Returns a cudaError_t
// value (0 = launched). Then, once, nerf_fused_mlp_backward_sum. bf16 packs go to
// nerf_fused_mlp_backward_bf16 (fused_mlp_bwd_bf16.cu).
extern "C" int nerf_fused_mlp_backward(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights, const void* mma_wt, long long lo_wt,
    const void* biases, const long long* layout, int layout_len, const long long* layout_mma,
    int layout_mma_len, int ldw, int ldv, int depth, int sigma_only, void* ws, long long tile0,
    int per_cta, void* partials, long long n_w, long long n_b, int grid, void* dpts, void* ddirs,
    int device, void* stream) {
  Layout L;
  Narrow::LayoutMma M;
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, &L) ||
      !bwd_tc::parse_mma<Narrow>(layout_mma, layout_mma_len, depth, &M) || dir_div < 1 ||
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

// After the last round: dweights (n_w) and dbiases (n_b) f32 from the
// grid partials, summed in a fixed order. Returns a cudaError_t value.
extern "C" int nerf_fused_mlp_backward_sum(const void* partials, int grid, long long n_w,
                                           long long n_b, void* dweights, void* dbiases,
                                           int device, void* stream) {
  if (grid < 1 || n_w < 1 || n_b < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_partials(
      static_cast<const float*>(partials), grid, n_w + n_b, n_w, static_cast<float*>(dweights),
      static_cast<float*>(dbiases), static_cast<cudaStream_t>(stream)));
}
