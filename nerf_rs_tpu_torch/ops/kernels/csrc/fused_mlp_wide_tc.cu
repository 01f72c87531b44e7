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
// multiplies bf16, each ring chunk's products are summed in f32 from zero
// and added to a running f32 sum, rounded to nearest; bias, ReLU and the
// round to bf16 follow each layer; the heads read the rounded activations
// and write f32.
//
// What bounds it on the H100: at width 512 a fine sample costs 4.60 MFLOP
// (7.32 ms a 8192 x 192 call at 989 TFLOP/s). The whole bf16 pack (4.6 MB
// for a 512/256 network of depth 8) streams from L2 through shared memory
// once per 64-sample tile, and each chunk's way there and back (copy,
// wgmmas, release) bounds how fast the ring turns over: without its
// products, the earlier one-accumulator kernel still took 11.7 ms, and
// with its copies cut to 16 bytes it was not faster
// (tools/torch_wide_k1_profile.py). So the design shares and shortens
// that walk rather than adding tensor work:
// - a persistent grid of thread-block clusters of kClusterW CTAs, one CTA
//   of 384 threads an SM, the cluster's CTAs on consecutive 64-sample
//   tiles (one wgmma M): a producer warpgroup, whose registers setmaxnreg
//   hands to the consumers, and two consumer warpgroups;
// - the cluster's CTAs share one weight stream (fused_mlp_cluster.cuh):
//   each chunk is read from L2 once, every CTA's producer thread copying
//   its share of the chunk's runs (one a k-group of 8 rows) into all of
//   them with multicast cp.async.bulk, into a ring of 4 stages of 16 KB,
//   running ahead across layers and tiles; a stage is refilled once every
//   CTA's consumer warps have released it (remote arrives);
// - each consumer warpgroup issues m64n64k16 wgmmas (A: the 64-row
//   activation or encode buffer, all of K; B: its pieces of the chunk),
//   and each chunk's wgmmas retire before the next chunk's are issued, so
//   that its stage goes back to the ring at once;
// - a layer runs in passes of at most four 64-column pieces, two a
//   consumer warpgroup (wide::Share), and each ring chunk (a pass's
//   columns of 64 K-rows, 32 KB at most) is summed by wgmmas from zero and
//   added to a running f32 sum (fused_mlp_wide_tc.cuh: a wgmma accumulator
//   rounds toward zero, and over a whole layer's K its drift flips bf16
//   roundings that a deep chain carries); a chunk is as many wgmmas as the
//   one-accumulator kernel's (two k-steps of four pieces then, four of two
//   now), so the ring turns over as often. (Chunks of 32 K-rows in a ring
//   of 16 KB stages, with the output in a second buffer, took 1.74x as
//   long: twice the chunks for the same products; PERF.md §6.);
// - each pass's rounded outputs stay in registers as bf16 pairs until the
//   two warpgroups have met at a barrier of the 256 consumer threads
//   (both have read the whole layer input), then overwrite it in place;
//   they meet again after the epilogue; every layer runs from one call
//   site;
// - every CTA of a cluster walks as many tiles as its first: past the last
//   tile a CTA computes a tile of zeros and stores nothing, so the ring's
//   chunks stay in step, and the CTAs meet at a cluster barrier before
//   they exit;
// - the encode (64 x 96 bf16, filled once a tile) and the heads (four
//   threads a row, a quarter of K each) run on the consumers' CUDA cores.
// Shared memory: ring 128 KB, activations 64 x 512 x 2 B = 64 KB, encodes
// 12 KB, heads 8 KB, the producer's chunk table 4.6 KB: 217 KB of the 227
// KB a block may use.
// Widths pad to multiples of 64; padding weights and biases are zero, so
// padding columns stay 0.

#include "fused_mlp_cluster.cuh"
#include "fused_mlp_wide_tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::wide;
using f32tc::head_row;
using f32tc::head_sum;

constexpr int kClusterW = 2;   // CTAs that share the weight stream
// The ring: 4 stages of 32 KB, a pass's chunk each (wide::layer_chunks).
// (8 stages of 16 KB, half the rows a chunk, measured slower with the
// one-accumulator kernel: tools/torch_wide_k1_profile.py.)
constexpr int kStagesW = 4;

// Shared memory, in bytes from the dynamic base.
constexpr int kActOff = kStagesW * kStageBytesW;              // ring first
constexpr int kEncXOff = kActOff + kBlock * kWideMaxWidth * 2;
constexpr int kEncDOff = kEncXOff + kBlock * kEncX * 2;
constexpr int kHeadOff = kEncDOff + kBlock * kEncD * 2;       // alpha [512], rgb [512][3] f32
constexpr int kChunkOff = kHeadOff + 4 * kWideMaxWidth * 4;   // the producer's chunk table
constexpr int kBarOff = kChunkOff + kMaxFwdChunks * 8;         // full[kStagesW], empty[kStagesW]
constexpr int kSmemBytes = kBarOff + 2 * kStagesW * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

// Layer i's segments in the order the kernel reads them: i < depth the
// trunk layers (a skip layer's encode part first), then the bottleneck and
// the view layer (its dir-encode part second).
struct LayerIo {
  int off1, off2;   // segments in the pack (-1: none)
  int k1, k2, n;
};

__device__ __forceinline__ LayerIo layer_io(const WideLayout& L, int i, int nw, int nv) {
  if (i == 0) return {static_cast<int>(L.w_dense[0]), -1, kEncX, 0, nw};
  if (i < L.depth) {
    if (L.w_skip[i] >= 0) {
      return {static_cast<int>(L.w_skip[i]), static_cast<int>(L.w_dense[i]), kEncX, nw, nw};
    }
    return {static_cast<int>(L.w_dense[i]), -1, nw, 0, nw};
  }
  if (i == L.depth) return {static_cast<int>(L.w_bneck), -1, nw, 0, nw};
  return {static_cast<int>(L.w_view), static_cast<int>(L.w_view_dir), nw, kEncD, nv};
}

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
  const int tiles = static_cast<int>((n + kBlock - 1) / kBlock);
  const int tid = threadIdx.x;
  const int layers = kSigmaOnly ? L.depth : L.depth + 2;
  // The cluster's CTAs share the ring; its tiles are base + rank, base
  // the same in every CTA (tiles past the last: zeros, stores masked).
  const int rank = static_cast<int>(cluster::ctarank());
  const int first_base = static_cast<int>(blockIdx.x) - rank;

  if (tid == 0) {
    cluster::init_ring<kStagesW, kClusterW>(bars);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The producer thread's chunk table (wide::layer_chunks), built while it
  // has the registers: after setmaxnreg it only walks it.
  Chunk* chunks = reinterpret_cast<Chunk*>(smem + kChunkOff);
  int count = 0;
  if (tid == kConsumers) {
    for (int i = 0; i < layers; ++i) {
      const LayerIo io = layer_io(L, i, nw, nv);
      layer_chunks(io.off1, io.k1, io.off2, io.k2, io.n,
                   [&](long long off, uint32_t run_bytes, int runs, int stride) {
                     chunks[count++] = ring_chunk(off, run_bytes, runs, stride);
                   });
    }
  }
  for (int k = tid; k < L.ldw; k += kThreadsTc) w_alpha[k] = load1(w + L.w_alpha + k);
  for (int k = tid; k < 3 * L.ldv; k += kThreadsTc) w_rgb[k] = load1(w + L.w_rgb + k);
  cluster::cluster_sync();   // every CTA's barriers, before any copy or remote arrive

  // The role split on a warp-uniform value, rejoined only at the cluster
  // barrier before the exit.
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
  if (warp >= kConsumers / 32) {
    // Producer warpgroup: one thread copies its slices of the chunks in
    // the consumers' order; the warpgroup hands its registers to the
    // consumers.
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      cluster::ClusterProducer<kStagesW, kStageBytesW, kClusterW> pr{
          smem_u32(smem), bars, {static_cast<uint16_t>((1 << kClusterW) - 1), rank}, 0, 0u};
      for (int base = first_base; base < tiles; base += gridDim.x) {
        for (int e = 0; e < count; ++e) {
          const Chunk ch = chunks[e];
          pr.put(w + ch.off, ch.run16 * 16u, ch.runs, 128LL * ch.n8);
        }
      }
    }
    cluster::cluster_sync();
    return;
  }

  // Consumers. Every branch below is uniform across a warp, or guards
  // stores only.
  reg_alloc<kConsumerRegs>();
  const int g = warp >> 2;
  cluster::ClusterPipe<kStagesW, kStageBytesW, kClusterW> q{smem_u32(smem), bars, 0, 0u};
  const uint32_t a_act = smem_u32(act), a_ex = smem_u32(enc_x), a_ed = smem_u32(enc_d);
  const int hrow = head_row();
  auto row = [&](int i) { return ld_act(act, hrow, i); };

  for (int base = first_base; base < tiles; base += gridDim.x) {
    const long long tile = base + rank;
    // The tile's encode. (The last tile's reads of the encodes ended
    // behind its layers' barriers.)
    encode_tile(pts, dirs, n, dir_div, tile, enc_x, enc_d);
    fence_async_smem();
    consumers_barrier();

    // The trunk, then (unless sigma-only) the bottleneck (no activation)
    // and the view layer (bottleneck part plus dir-encode part, ReLU),
    // from one call site: with a call site a kind of layer, ptxas spilled.
    const long long s = tile * kBlock + hrow;
    const bool mine = !(tid & 3) && s < n;   // the first of the row's four threads stores
    for (int i = 0; i < layers; ++i) {
      const LayerIo io = layer_io(L, i, nw, nv);
      const bool view = i == L.depth + 1;
      const bool enc = i == 0 || (i < L.depth && L.w_skip[i] >= 0);
      const long long b = i < L.depth ? L.b_dense[i] : (view ? L.b_view : L.b_bneck);
      wide_layer_in_place(q, enc ? a_ex : a_act, io.k1, view ? a_ed : a_act, io.k2, io.n,
                          bias + b, view ? L.ldv : L.ldw, i != L.depth, act, g);
      if (i != L.depth - 1) continue;
      // Sigma head. The barriers inside the next layer keep these reads
      // before its writes.
      const float sig =
          fmaxf(head_sum(row, L.ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha), 0.f);
      if (mine) sigma[s] = sig;
      if (kSigmaOnly && mine) {
        rgb[s * 3] = 0.f;
        rgb[s * 3 + 1] = 0.f;
        rgb[s * 3 + 2] = 0.f;
      }
    }
    if constexpr (!kSigmaOnly) {
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
  cluster::cluster_sync();   // no CTA leaves while its peers may arrive on its barriers
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const __nv_bfloat16* w, const float* bias, const WideLayout& L, float* rgb,
                   float* sigma, int device, cudaStream_t stream) {
  auto kernel = fused_mlp_wide_tc_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  (void)device;
  // Clusters of kClusterW CTAs, as many as fit the card at once (one CTA
  // an SM) and the tiles need.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterW;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterW);
  cfg.blockDim = dim3(kThreadsTc);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (n + kBlock - 1) / kBlock;
  const long long need = (tiles + kClusterW - 1) / kClusterW;
  cfg.gridDim = dim3(static_cast<unsigned>((need < fit ? need : fit) * kClusterW));
  const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the pack
  const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
  err = cudaLaunchKernelEx(&cfg, kernel, pts, dirs, n, dir_div, w, bias, L, nw, nv, rgb, sigma);
  if (err != cudaSuccess) return err;
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
