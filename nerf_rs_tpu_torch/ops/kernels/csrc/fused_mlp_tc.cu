// Fused NeRF MLP forward in bf16 on Hopper's tensor cores (sm_90a): the
// positional encode, the trunk with its skip layer, the sigma head and,
// unless sigma_only, the bottleneck, the view layer and the rgb head, in
// one persistent kernel. Activations never leave the SM.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call at fused_mlp.py:779 -> :795, _kernel_body -> _mlp_chain) for
// dtype="bfloat16"; the float32 mode stays on the CUDA cores
// (fused_mlp.cu).
//
// Numerics, the bf16 contract of ops/kernels/fused_mlp.py: the encode
// (exact sinf/cosf), the weights and each layer's input activations are
// bf16; wgmma multiplies bf16 and accumulates in f32; bias, ReLU and the
// round to bf16 follow each layer; the heads read the rounded activations
// and write f32. Only the f32 summation order differs from the plain
// version.
//
// What bounds it on the H100: at 128 samples a tile, the tensor cores
// (1.19 MFLOP a fine sample at 989 TFLOP/s) and, nearly as tight, L2: the
// whole bf16 pack (1.19 MB for the lego fine network) streams through
// shared memory once per tile, 14.6 GB a 8192 x 192 call. The design:
// - a persistent grid, one CTA of 384 threads an SM, walking 128-sample
//   tiles: two consumer warpgroups of 64 rows each and a producer
//   warpgroup, whose registers setmaxnreg hands to the consumers;
// - the producer copies each layer's weights, 64 K-rows at a time, with
//   one cp.async.bulk onto an mbarrier into a ring of 4 stages of 32 KB,
//   running ahead of the consumers across layers and tiles; the pack is
//   pre-tiled on the host (fused_mlp.py::tc_tile) into wgmma's
//   no-swizzle K-major core-matrix order, so a chunk is one contiguous run
//   and needs no tensor map;
// - each consumer warpgroup issues m64n64k16 wgmmas (A: its 64 rows of
//   the activation or encode buffer, B: the chunk) into up to four 64-col
//   f32 accumulators (128 registers a thread), releases each chunk as soon
//   as its wgmmas retire, then adds the bias, applies the ReLU, rounds to
//   bf16 and writes its own 64 rows of the one activation buffer in the
//   same core-matrix order, for the next layer's A;
// - the skip and view layers are two wgmma sequences into one accumulator
//   (encode rows plus trunk rows; trunk rows plus dir-encode rows);
// - the encode and the heads (alpha width -> 1, rgb v_width -> 3) run on
//   the CUDA cores of the consumer threads, from shared memory.
// Widths pad to multiples of 64 (the wgmma N of one piece); padding
// weights and biases are zero, so padding columns stay 0.
//
// The pack (PackedMLP.weights_tc) and its offset table (layout_tc) are
// this kernel's own; the table has the order of fused_mlp_common.cuh's
// Layout, so the same parse and the same entry signature as fused_mlp.cu
// serve it. Its layer segments are tiled as above, its head segments are
// fused_mlp_common.cuh's K-major (ldw, 1) and (ldv, 3) rows.
//
// The device code of the layers, the ring and the encode is in
// fused_mlp_tc.cuh, which the bf16 backward (fused_mlp_bwd_bf16.cu) runs
// for its recompute.

#include "fused_mlp_tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;

constexpr int kStages = 4;

// Shared memory, in bytes from the dynamic base.
constexpr int kActOff = kStages * kStageBytes;            // ring first
constexpr int kEncXOff = kActOff + kRows * kMaxWidth * 2;
constexpr int kEncDOff = kEncXOff + kRows * kEncX * 2;
constexpr int kHeadOff = kEncDOff + kRows * kEncD * 2;    // alpha [256], rgb [256][3] f32
constexpr int kBarOff = kHeadOff + 4 * kMaxWidth * 4;     // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreadsTc, 1)
fused_mlp_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
                    long long dir_div, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, const Layout L, const int nw, const int nv,
                    float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* act = smem + kActOff;
  uint8_t* enc_x = smem + kEncXOff;
  uint8_t* enc_d = smem + kEncDOff;
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kMaxWidth;
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kRows - 1) / kRows;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = tid; k < L.ldw; k += kThreadsTc) w_alpha[k] = load1(w + L.w_alpha + k);
  for (int k = tid; k < 3 * L.ldv; k += kThreadsTc) w_rgb[k] = load1(w + L.w_rgb + k);
  __syncthreads();

  // The role split on a warp-uniform value, never rejoined.
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
  if (warp >= kConsumers / 32) {
    // Producer warpgroup: one thread copies the chunks in the consumers'
    // order; the warpgroup hands its registers to the consumers.
    reg_dealloc<kProducerRegs>();
    if (tid != kConsumers) return;
    Producer<kStages> pr{smem_u32(smem), bars, 0, 0u};
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      pr.emit(w, L.w_dense[0], kEncX, nw);
      for (int i = 1; i < L.depth; ++i) {
        if (L.w_skip[i] >= 0) pr.emit(w, L.w_skip[i], kEncX, nw);
        pr.emit(w, L.w_dense[i], nw, nw);
      }
      if (!kSigmaOnly) {
        pr.emit(w, L.w_bneck, nw, nw);
        pr.emit(w, L.w_view, nw, nv);
        pr.emit(w, L.w_view_dir, kEncD, nv);
      }
    }
    return;
  }

  // Consumers: warpgroup g owns rows [64 g, 64 g + 64) of every tile.
  // Every branch below is uniform across a warp, or guards stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  const int t = tid & 127;
  const int npw = nw / kPiece, npv = nv / kPiece;
  Pipe<kStages> q{smem_u32(smem), bars, 0, 0u, -1};
  const uint32_t a_act = smem_u32(act) + g * 1024;     // row 64 g: 8 row groups of 128 B
  const uint32_t a_ex = smem_u32(enc_x) + g * 1024;
  const uint32_t a_ed = smem_u32(enc_d) + g * 1024;
  // Thread t works on row g * 64 + t % 64, in half t / 64 of its encode;
  // both halves compute the heads of that row, the first half stores them.
  const int row = g * 64 + (t & 63);
  const bool half = t >= 64;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long s = tile * kRows + row;
    const bool in = s < n;            // rows past n encode zeros and are never stored
    {
      float p[3], d[3];
      const long long r = (in ? s : 0) / dir_div;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] = in ? pts[s * 3 + c] : 0.f;
        d[c] = in ? dirs[r * 3 + c] : 0.f;
      }
      encode_row(enc_x, enc_d, row, half, p, d);
    }
    fence_async_smem();
    wg_barrier(g);

    // Trunk.
    layer_any(npw, q, a_ex, kEncX, 0, 0, nw, bias + L.b_dense[0], L.ldw, true, act, g);
    for (int i = 1; i < L.depth; ++i) {
      if (L.w_skip[i] >= 0) {
        layer_any(npw, q, a_ex, kEncX, a_act, nw, nw, bias + L.b_dense[i], L.ldw, true, act, g);
      } else {
        layer_any(npw, q, a_act, nw, 0, 0, nw, bias + L.b_dense[i], L.ldw, true, act, g);
      }
    }

    // Sigma head. The barriers inside `layer` keep these reads before the
    // bottleneck's writes.
    const float sig =
        fmaxf(row_dot(act, row, L.ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha), 0.f);
    if (!half && in) sigma[s] = sig;
    if (kSigmaOnly) {
      if (!half && in) {
        rgb[s * 3] = 0.f;
        rgb[s * 3 + 1] = 0.f;
        rgb[s * 3 + 2] = 0.f;
      }
      continue;
    }

    // Bottleneck (no activation), then the view layer: bottleneck part
    // plus dir-encode part, ReLU.
    layer_any(npw, q, a_act, nw, 0, 0, nw, bias + L.b_bneck, L.ldw, false, act, g);
    layer_any(npv, q, a_act, nw, a_ed, kEncD, nv, bias + L.b_view, L.ldv, true, act, g);

    // Rgb head with sigmoid.
    float out[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = row_dot(act, row, L.ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
      out[c] = 1.f / (1.f + expf(-x));
    }
    if (!half && in) {
      rgb[s * 3] = out[0];
      rgb[s * 3 + 1] = out[1];
      rgb[s * 3 + 2] = out[2];
    }
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const __nv_bfloat16* w, const float* bias, const Layout& L, float* rgb,
                   float* sigma, int device, cudaStream_t stream) {
  auto kernel = fused_mlp_tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the pack
  const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
  kernel<<<grid, kThreadsTc, kSmemBytes, stream>>>(pts, dirs, n, dir_div, w, bias, L, nw, nv, rgb,
                                                   sigma);
  return cudaGetLastError();
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; weights: the tensor-core pack (bf16, 16-byte aligned) and
// biases (f32) as pack_params writes them, layout: its kLayoutLen host
// int64 offsets (layout_tc); rgb (n, 3) and sigma (n,) f32 outputs. The
// signature is nerf_fused_mlp_forward's. Returns a cudaError_t value
// (0 = launched).
extern "C" int nerf_fused_mlp_tc_forward(const void* pts, const void* dirs, long long n,
                                         long long dir_div, const void* weights,
                                         const void* biases, const long long* layout,
                                         int layout_len, int ldw, int ldv, int depth,
                                         int sigma_only, void* rgb, void* sigma, int device,
                                         void* stream) {
  Layout L;
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 2 * kMaxDepth + 5; ++i) {   // the weight segments
    const bool needed = i < depth || i >= 2 * kMaxDepth;
    // Segments start on 16-byte boundaries, as the bulk copies need.
    if ((needed && layout[i] < 0) || (layout[i] >= 0 && layout[i] % 8 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const auto* w = static_cast<const __nv_bfloat16*>(weights);
  const float* b = static_cast<const float*>(biases);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, device, s)
                   : launch<false>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, device, s);
  return static_cast<int>(err);
}
