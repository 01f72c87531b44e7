// Fused NeRF MLP forward in bf16 on Hopper's tensor cores (sm_90a) for
// wide or deep networks: trunk and view widths up to 512, up to 32 dense
// layers (fused_mlp_wide.cuh). The positional encode, the trunk with its
// skip layer, the sigma head and, unless sigma_only, the bottleneck, the
// view layer and the rgb head, in one persistent kernel; activations never
// leave the SM.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call at fused_mlp.py:779 -> :795) for dtype="bfloat16" where the narrow
// kernel (fused_mlp_tc.cu: widths up to 256, depth up to 16) stops; the
// JAX kernel serves any width that is a multiple of 128
// (fused_mlp.py::supports_arch). fused_mlp_tc.cu is unchanged and still
// serves every network within its envelope: K2's bf16 recompute runs its
// device code (fused_mlp_tc.cuh). This kernel's own device code (the layer
// loop, the encode) is fused_mlp_wide_tc.cuh, which the wide bf16 backward
// (fused_mlp_wide_bwd_bf16.cu) runs for its recompute.
//
// Numerics: fused_mlp_tc.cu's bf16 contract. The encode (exact sincosf),
// the weights and each layer's input activations are bf16; wgmma
// multiplies bf16 and accumulates in f32; bias, ReLU and the round to
// bf16 follow each layer; the heads read the rounded activations and write
// f32.
//
// What bounds it on the H100: at width 512 a fine sample costs 4.60 MFLOP
// (7.32 ms a 8192 x 192 call at 989 TFLOP/s), but the whole bf16 pack
// (4.6 MB for a 512/256 network of depth 8) streams from L2 through shared
// memory once per 64-sample tile, about 113 GB a 8192 x 192 call: L2, not
// the tensor cores, is the expected bound. The design is fused_mlp_tc.cu's
// with the two consumer warpgroups on the two halves of each layer's N
// instead of on 64 rows each, so that each keeps at most four 64-column
// f32 accumulators (128 registers a thread) at width 512:
// - a persistent grid, one CTA of 384 threads an SM, walking 64-sample
//   tiles (one wgmma M): a producer warpgroup, whose registers setmaxnreg
//   hands to the consumers, and two consumer warpgroups, warpgroup g on
//   pieces [p0(g), p0(g) + count(g)) of every layer (the first half of the
//   64-column pieces rounded up, then the rest);
// - the producer copies each layer's weights, 32 K-rows at a time above
//   width 256 (64 at or below), with one cp.async.bulk onto an mbarrier
//   into a ring of 4 stages of 32 KB, running ahead across layers and
//   tiles; the pack is fused_mlp.py::tc_tile's, one contiguous run a chunk;
// - each consumer warpgroup issues m64n64k16 wgmmas (A: the 64-row
//   activation or encode buffer, all of K; B: its pieces of the chunk);
//   the two warpgroups meet at a barrier of the 256 consumer threads
//   before the epilogue overwrites the one activation buffer in place
//   (both have read all of it), and again after it;
// - the encode (64 x 96 bf16, filled once a tile) and the heads (four
//   threads a row, a quarter of K each) run on the consumers' CUDA cores.
// Shared memory: ring 128 KB, activations 64 x 512 x 2 B = 64 KB, encodes
// 12 KB, heads 8 KB: 212 KB of the 227 KB a block may use. Widths pad to
// multiples of 64; padding weights and biases are zero, so padding columns
// stay 0.

#include "fused_mlp_wide_tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::wide;
using f32tc::head_row;
using f32tc::head_sum;

constexpr int kStagesW = 4;

// Shared memory, in bytes from the dynamic base.
constexpr int kActOff = kStagesW * kStageBytesW;              // ring first
constexpr int kEncXOff = kActOff + kBlock * kWideMaxWidth * 2;
constexpr int kEncDOff = kEncXOff + kBlock * kEncX * 2;
constexpr int kHeadOff = kEncDOff + kBlock * kEncD * 2;       // alpha [512], rgb [512][3] f32
constexpr int kBarOff = kHeadOff + 4 * kWideMaxWidth * 4;     // full[kStagesW], empty[kStagesW]
constexpr int kSmemBytes = kBarOff + 2 * kStagesW * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreadsTc, 1)
fused_mlp_wide_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                         long long n, long long dir_div, const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias, const WideLayout L, const int nw,
                         const int nv, float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* act = smem + kActOff;
  uint8_t* enc_x = smem + kEncXOff;
  uint8_t* enc_d = smem + kEncDOff;
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kWideMaxWidth;
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kBlock - 1) / kBlock;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStagesW + s), kConsumers);
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
    WideProducer<kStagesW> pr{smem_u32(smem), bars, 0, 0u};
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

  // Consumers. Every branch below is uniform across a warp, or guards
  // stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  const Share sw(nw / kPiece, g), sv(nv / kPiece, g);
  WidePipe<kStagesW> q{smem_u32(smem), bars, 0, 0u, -1};
  const uint32_t a_act = smem_u32(act), a_ex = smem_u32(enc_x), a_ed = smem_u32(enc_d);
  const int hrow = head_row();
  auto row = [&](int i) { return ld_act(act, hrow, i); };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // The tile's encode. (The last tile's reads of the encodes ended
    // behind its layers' barriers.)
    encode_tile(pts, dirs, n, dir_div, tile, enc_x, enc_d);
    fence_async_smem();
    consumers_barrier();

    // Trunk.
    wide_layer_any(sw.count, q, a_ex, kEncX, 0, 0, nw, sw.p0, bias + L.b_dense[0], L.ldw, true,
                   act);
    for (int i = 1; i < L.depth; ++i) {
      if (L.w_skip[i] >= 0) {
        wide_layer_any(sw.count, q, a_ex, kEncX, a_act, nw, nw, sw.p0, bias + L.b_dense[i],
                       L.ldw, true, act);
      } else {
        wide_layer_any(sw.count, q, a_act, nw, 0, 0, nw, sw.p0, bias + L.b_dense[i], L.ldw, true,
                       act);
      }
    }

    // Sigma head. The barriers inside `layer` keep these reads before the
    // bottleneck's writes.
    const long long s = tile * kBlock + hrow;
    const bool mine = !(tid & 3) && s < n;   // the first of the row's four threads stores
    const float sig = fmaxf(head_sum(row, L.ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha), 0.f);
    if (mine) sigma[s] = sig;
    if (kSigmaOnly) {
      if (mine) {
        rgb[s * 3] = 0.f;
        rgb[s * 3 + 1] = 0.f;
        rgb[s * 3 + 2] = 0.f;
      }
      continue;
    }

    // Bottleneck (no activation), then the view layer: bottleneck part
    // plus dir-encode part, ReLU.
    wide_layer_any(sw.count, q, a_act, nw, 0, 0, nw, sw.p0, bias + L.b_bneck, L.ldw, false, act);
    wide_layer_any(sv.count, q, a_act, nw, a_ed, kEncD, nv, sv.p0, bias + L.b_view, L.ldv, true,
                   act);

    // Rgb head with sigmoid; its reads end before the next tile's first
    // epilogue.
    float out[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = head_sum(row, L.ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
      out[c] = 1.f / (1.f + expf(-x));
    }
    if (mine) {
      rgb[s * 3] = out[0];
      rgb[s * 3 + 1] = out[1];
      rgb[s * 3 + 2] = out[2];
    }
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const __nv_bfloat16* w, const float* bias, const WideLayout& L, float* rgb,
                   float* sigma, int device, cudaStream_t stream) {
  auto kernel = fused_mlp_wide_tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kBlock - 1) / kBlock;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the pack
  const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
  kernel<<<grid, kThreadsTc, kSmemBytes, stream>>>(pts, dirs, n, dir_div, w, bias, L, nw, nv, rgb,
                                                   sigma);
  return cudaGetLastError();
}

}  // namespace

// nerf_fused_mlp_tc_forward's contract for the wide envelope: the
// tensor-core pack (PackedMLP.weights_tc of a wide pack, bf16, 16-byte
// aligned), the biases (f32) and layout_tc, its kWideLayoutLen host int64
// offsets. Returns a cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_wide_tc_forward(const void* pts, const void* dirs, long long n,
                                              long long dir_div, const void* weights,
                                              const void* biases, const long long* layout,
                                              int layout_len, int ldw, int ldv, int depth,
                                              int sigma_only, void* rgb, void* sigma, int device,
                                              void* stream) {
  WideLayout L;
  if (!parse_wide_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
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
