// Fused NeRF MLP forward in float32 on Hopper's tensor cores (sm_90a),
// split-f32: the positional encode, the trunk with its skip layer, the
// sigma head and, unless sigma_only, the bottleneck, the view layer and
// the rgb head, in one persistent kernel. Activations never leave the SM.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call at fused_mlp.py:779 -> :795, _kernel_body -> _mlp_chain) for
// dtype="float32"; bf16 is fused_mlp_tc.cu.
//
// Numerics: float32. Every layer product is bf16x6 on the tensor cores
// (fused_mlp_f32tc.cuh: three bf16 pieces an operand, six piece products
// in a fixed order, f32 accumulation), the JAX kernel's Precision.HIGHEST
// counterpart, within about 2^-22 of the f32 product; the encode (exact
// sincosf), bias, ReLU, the two heads (N = 1 and 3, fmaf on the CUDA
// cores) and the sigmoid are true f32.
//
// What bounds it on the H100: the tensor cores. A fine sample costs 1.187
// MFLOP of f32 products, six bf16 passes each: 7.12 MFLOP at 989 TFLOP/s,
// 11.3 ms a 8192 x 192 call (the CUDA cores' f32 peak would take 27.9 ms).
// The design, K1 bf16's (fused_mlp_tc.cu) with split operands:
// - a persistent grid, one CTA of 256 threads an SM, walking 64-sample
//   tiles: two warpgroups, each on half of every layer's columns
//   (fused_mlp_f32tc.cuh: two f32 accumulators a piece, so two pieces a
//   warpgroup);
// - thread 0 copies each layer's pieces, 16 K-rows of three bf16 planes
//   (24 KB at width 256) at a time, with one cp.async.bulk onto an
//   mbarrier, into a ring of 3 stages: the chunk in use, the one its
//   wgmmas may still read, and the next, copied one ahead across layers
//   and tiles (f32tc::FedPipe: no producer warpgroup, whose launch bounds
//   would leave the consumers too few registers);
// - the A operands are the block's activations and encodes as bf16 hi,
//   mid and lo planes in shared memory (96 KB for the activations, which
//   each layer overwrites, 36 KB for the encodes, filled once a tile),
//   split once a value in the epilogues; f32 activations need no buffer of
//   their own, the planes sum to them exactly.
// The pieces stream from L2 once per tile: 3.57 MB for the lego fine
// network, 88 GB a fine call (K1 bf16, 128-sample tiles: 14.6 GB).
// Widths pad to multiples of 64 (the wgmma N of one piece); padding
// weights and biases are zero, so padding columns stay 0.
//
// The pack: PackedMLP.weights_f32tc (bf16 pieces) at the offsets of
// layout_f32tc (in Layout's order; the heads' entries unused), the two
// heads from PackedMLP.weights (f32) at layout's offsets, the biases.
//
// Record mode (nerf_fused_mlp_f32tc_record) is the f32 backward's
// recompute (fused_mlp_bwd_tc.cu): the same kernel over a round of
// 128-sample tiles writes every trunk layer's, the bottleneck's and the
// view layer's output to those tiles' workspace (fused_mlp_f32tc.cuh's
// ws_index layout) instead of computing the heads, so the backward
// differentiates K1's own activations, bit for bit.

#include "fused_mlp_f32tc.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::f32tc;

constexpr int kStages = 3;
constexpr int kBlock = 64;                 // samples a tile
constexpr int kActPlane = kBlock * kMaxWidth * 2;   // bytes a plane of activations
constexpr int kEncXPlane = kBlock * kEncX * 2, kEncDPlane = kBlock * kEncD * 2;

// Shared memory, in bytes from the dynamic base.
constexpr int kActOff = kStages * kStageBytesF;            // ring first
constexpr int kEncXOff = kActOff + 3 * kActPlane;
constexpr int kEncDOff = kEncXOff + 3 * kEncXPlane;
constexpr int kInOff = kEncDOff + 3 * kEncDPlane;          // [6][kRows] points, dirs
constexpr int kHeadOff = kInOff + 6 * kRows * 4;           // alpha [256], rgb [256][3] f32
constexpr int kSegOff = kHeadOff + 4 * kMaxWidth * 4;      // the chunk table
// full[kStages], empty[kStages], then the table's length.
constexpr int kBarOff = kSegOff + kMaxSegs * static_cast<int>(sizeof(Seg));
constexpr int kCountOff = kBarOff + 2 * kStages * 8;
constexpr int kSmemBytes = kCountOff + 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

// Tiles of 64 samples from row0 (rows samples; those from n on read
// zeros and are never stored); kRecord: into the workspace rec, whose
// first tile is row0's.
template <bool kSigmaOnly, bool kRecord>
__global__ void __launch_bounds__(kConsumers, 1)
fused_mlp_f32tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
                       long long dir_div, const float* __restrict__ w,
                       const __nv_bfloat16* __restrict__ pw, const float* __restrict__ bias,
                       const Layout L, const Layout P, const int nw, const int nv,
                       float* __restrict__ rgb, float* __restrict__ sigma, long long row0,
                       long long rows, float* __restrict__ rec) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const Planes act{smem + kActOff, kActPlane};
  const Planes enc_x{smem + kEncXOff, kEncXPlane}, enc_d{smem + kEncDOff, kEncDPlane};
  float* xin = reinterpret_cast<float*>(smem + kInOff);
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kMaxWidth;
  Seg* segs = reinterpret_cast<Seg*>(smem + kSegOff);
  int* n_segs = reinterpret_cast<int*>(smem + kCountOff);
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (rows + kBlock - 1) / kBlock;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int c = trunk_segments(P, nw, segs, 0);
    *n_segs = kSigmaOnly ? c : color_segments(P, nw, nv, segs, c);
  }
  for (int k = tid; k < L.ldw; k += kConsumers) w_alpha[k] = load1(w + L.w_alpha + k);
  for (int k = tid; k < 3 * L.ldv; k += kConsumers) w_rgb[k] = load1(w + L.w_rgb + k);
  __syncthreads();

  // Every branch below is uniform across a warp, or guards stores only.
  const int npw = nw / kPiece, npv = nv / kPiece;
  // The ring walks the chunk table once for each of this CTA's tiles.
  FedPipe<kStages> q{{smem_u32(smem), bars, 0, 0u, -1}, 0, 0u, 0, {}, pw};
  q.start(segs, *n_segs,
          static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x));
  const int hrow = head_row();
  const long long rec_stride = ws_stride(L.depth, L.ldw, L.ldv);
  auto row = [&](int i) { return act.get(hrow, i); };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Layer outputs: the activation planes and, recording, workspace slot
    // i of the tile's 128-sample tile (ld columns).
    float* rec_tile = kRecord ? rec + (tile >> 1) * rec_stride : nullptr;
    const int rec_row = static_cast<int>(tile & 1) * kBlock;
    auto out = [&](int i, int ld) {
      return [&, i, ld](int r, int col, float2 v) {
        act.put(r, col, v);
        if (kRecord && col < ld) {
          float* slot = ws_slot(rec_tile, i, L.ldw);
          slot[ws_index(rec_row + r, col, ld >> 3)] = v.x;
          slot[ws_index(rec_row + r, col + 1, ld >> 3)] = v.y;
        }
      };
    };
    // Inputs of the tile; samples past n read zeros and are never stored.
    // (The last layer's reads of the encodes ended behind its barriers.)
    for (int i = tid; i < 6 * kBlock; i += kConsumers) {
      const int r = i % kBlock, c = i / kBlock;
      const long long s = row0 + tile * kBlock + r;
      float v = 0.f;
      if (s < n) v = c < 3 ? pts[s * 3 + c] : dirs[(s / dir_div) * 3 + (c - 3)];
      xin[c * kRows + r] = v;
    }
    consumers_barrier();
    fill_encode(xin, enc_x, kSigmaOnly ? Planes{nullptr, 0} : enc_d);

    // Trunk.
    layer_any(npw, q, enc_x, kEncX, enc_x, 0, nw, bias + L.b_dense[0], L.ldw, true, out(0, L.ldw));
    for (int i = 1; i < L.depth; ++i) {
      if (L.w_skip[i] >= 0) {
        layer_any(npw, q, enc_x, kEncX, act, nw, nw, bias + L.b_dense[i], L.ldw, true,
                  out(i, L.ldw));
      } else {
        layer_any(npw, q, act, nw, act, 0, nw, bias + L.b_dense[i], L.ldw, true, out(i, L.ldw));
      }
    }

    // Sigma head. Its reads end before the bottleneck's epilogue, behind
    // its first barrier.
    const long long s = row0 + tile * kBlock + hrow;
    const bool mine = !kRecord && !(tid & 3) && s < n;   // the first of the four stores
    if (!kRecord) {
      const float sig = fmaxf(head_sum(row, L.ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha), 0.f);
      if (mine) sigma[s] = sig;
    }
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
    layer_any(npw, q, act, nw, act, 0, nw, bias + L.b_bneck, L.ldw, false, out(L.depth, L.ldw));
    layer_any(npv, q, act, nw, enc_d, kEncD, nv, bias + L.b_view, L.ldv, true,
              out(L.depth + 1, L.ldv));

    // Rgb head with sigmoid; its reads end before the next tile's first
    // epilogue.
    if (!kRecord) {
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
}

template <bool kSigmaOnly, bool kRecord>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* w, const __nv_bfloat16* pw, const float* bias, const Layout& L,
                   const Layout& P, float* rgb, float* sigma, long long row0, long long rows,
                   float* rec, int device, cudaStream_t stream) {
  auto kernel = fused_mlp_f32tc_kernel<kSigmaOnly, kRecord>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + kBlock - 1) / kBlock;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  const int nw = (L.ldw + kPiece - 1) / kPiece * kPiece;   // widths in the pack
  const int nv = (L.ldv + kPiece - 1) / kPiece * kPiece;
  kernel<<<grid, kConsumers, kSmemBytes, stream>>>(pts, dirs, n, dir_div, w, pw, bias, L, P, nw, nv,
                                                   rgb, sigma, row0, rows, rec);
  return cudaGetLastError();
}

// The entries' checks; false for what the kernel does not take.
bool parse(const long long* layout, const long long* layout_pieces, int layout_len, int ldw,
           int ldv, int depth, long long n, long long dir_div, const void* pieces, Layout* L,
           Layout* P) {
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, L) ||
      !parse_layout(layout_pieces, layout_len, ldw, ldv, depth, P) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(pieces) % 16 != 0) {
    return false;
  }
  for (int i = 0; i < 2 * kMaxDepth + 5; ++i) {   // the weight segments
    const bool needed = i < depth || (i >= 2 * kMaxDepth + 1 && i < 2 * kMaxDepth + 4);
    // Layer segments start on 16-byte boundaries, as the bulk copies need.
    if ((needed && layout_pieces[i] < 0) || (layout_pieces[i] >= 0 && layout_pieces[i] % 8 != 0)) {
      return false;
    }
  }
  return layout[2 * kMaxDepth] >= 0 && layout[2 * kMaxDepth + 4] >= 0;   // the heads
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; weights (f32) and biases (f32) as pack_params writes them,
// with layout, their kLayoutLen host int64 offsets; pieces: the split
// pack (PackedMLP.weights_f32tc, bf16, 16-byte aligned) with
// layout_pieces, its offsets in the same order (layer segments only);
// rgb (n, 3) and sigma (n,) f32 outputs. Returns a cudaError_t value
// (0 = launched).
extern "C" int nerf_fused_mlp_f32tc_forward(const void* pts, const void* dirs, long long n,
                                            long long dir_div, const void* weights,
                                            const void* pieces, const void* biases,
                                            const long long* layout,
                                            const long long* layout_pieces, int layout_len,
                                            int ldw, int ldv, int depth, int sigma_only, void* rgb,
                                            void* sigma, int device, void* stream) {
  Layout L, P;
  if (!parse(layout, layout_pieces, layout_len, ldw, ldv, depth, n, dir_div, pieces, &L, &P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* w = static_cast<const float*>(weights);
  const auto* pw = static_cast<const __nv_bfloat16*>(pieces);
  const float* b = static_cast<const float*>(biases);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only
            ? launch<true, false>(p, d, n, dir_div, w, pw, b, L, P, o_rgb, o_sigma, 0, n, nullptr,
                                  device, s)
            : launch<false, false>(p, d, n, dir_div, w, pw, b, L, P, o_rgb, o_sigma, 0, n, nullptr,
                                   device, s);
  return static_cast<int>(err);
}

// The f32 backward's recompute for one round: samples [row0, row0 + rows)
// (row0 a multiple of 128, rows one of 128 unless the round ends at n;
// samples from n on read zeros) as nerf_fused_mlp_f32tc_forward computes
// them, every layer's output into the workspace ws (fused_mlp_f32tc.cuh:
// ws_stride(depth, ldw, ldv) f32 a 128-sample tile, from row0's); no heads.
// Returns a cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_f32tc_record(const void* pts, const void* dirs, long long n,
                                           long long dir_div, const void* weights,
                                           const void* pieces, const void* biases,
                                           const long long* layout, const long long* layout_pieces,
                                           int layout_len, int ldw, int ldv, int depth,
                                           int sigma_only, long long row0, long long rows, void* ws,
                                           int device, void* stream) {
  Layout L, P;
  if (!parse(layout, layout_pieces, layout_len, ldw, ldv, depth, n, dir_div, pieces, &L, &P) ||
      row0 < 0 || row0 % 128 != 0 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* w = static_cast<const float*>(weights);
  const auto* pw = static_cast<const __nv_bfloat16*>(pieces);
  const float* b = static_cast<const float*>(biases);
  float* rec = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true, true>(p, d, n, dir_div, w, pw, b, L, P, nullptr, nullptr, row0,
                                        rows, rec, device, s)
                   : launch<false, true>(p, d, n, dir_div, w, pw, b, L, P, nullptr, nullptr, row0,
                                         rows, rec, device, s);
  return static_cast<int>(err);
}
