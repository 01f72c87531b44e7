// Fused NeRF MLP forward for Hopper (sm_90a): positional encode, the trunk
// with its skip layer, the sigma head and, unless sigma_only, the view
// branch and the rgb head, in one kernel. Activations never leave the SM.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call) and its kernel body _kernel_body -> _mlp_chain. It computes the
// same function, not the same blocks: the TPU kernel's 128-lane padding,
// VMEM-resident weight blob, matmul encode and polynomial sine answered
// Mosaic and v5e limits and are not carried over.
//
// What bounds it on the H100: arithmetic. A fine sample costs about
// 1.2 MFLOP of products against 24 bytes of input and 16 bytes of output,
// and the packed weights (about 2.9 MB in f32, 1.5 MB in bf16) stay in the
// 50 MB L2. This first version keeps to CUDA cores with f32 accumulation:
// - one CTA of 256 threads per tile of 64 samples;
// - the tile's encode and its activations stay in shared memory, the
//   activations ping-ponging between two buffers;
// - each thread owns an 8-output x 8-sample register tile, so each
//   weight it reads from L2 (through L1) feeds 8 FMAs, and each weight
//   is fetched once per CTA (the 8 threads that share it sit in one warp
//   and read the same address);
// - the skip and view layers are two products summed, with no concat.
// This kernel serves float32, the parity mode; bf16 runs on the tensor
// cores (fused_mlp_tc.cu).
//
// Numerics: true f32 throughout with exact sinf/cosf (no fast math: the
// encode's arguments reach 2^9*|x|).
//
// The packed-weight layout and the shared device helpers are in
// fused_mlp_common.cuh.

#include "fused_mlp_common.cuh"

namespace {

using namespace nerf;

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 long long n, long long dir_div, const float* __restrict__ w,
                 const float* __restrict__ bias, const Layout L,
                 float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xin = smem;                       // [6][kTile] points, dirs
  float* enc = xin + 6 * kTile;            // [kEncRows][kTile]
  const int cap = L.ldw > L.ldv ? L.ldw : L.ldv;
  float* buf_a = enc + kEncRows * kTile;   // [cap][kTile]
  float* buf_b = buf_a + cap * kTile;      // [cap][kTile]
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int tid = threadIdx.x;

  // Inputs of the tile; samples past n (the ragged last tile) read zeros
  // and are never stored.
  for (int idx = tid; idx < 6 * kTile; idx += kThreads) {
    const int c = idx / kTile, t = idx % kTile;
    const long long s = base + t;
    float v = 0.f;
    if (s < n) v = c < 3 ? pts[s * 3 + c] : dirs[(s / dir_div) * 3 + (c - 3)];
    xin[idx] = v;
  }
  __syncthreads();

  // Encode: rows [0, 63) points (L=10), [64, 91) dirs (L=4); padding rows
  // are zero. A warp covers 32 samples of one row, so branches are uniform.
  for (int idx = tid; idx < kEncRows * kTile; idx += kThreads) {
    const int r = idx / kTile, t = idx % kTile;
    float v = 0.f;
    if (r < 63) {
      const float p[3] = {xin[t], xin[kTile + t], xin[2 * kTile + t]};
      v = encode(p, r);
    } else if (r >= kEncX && r < kEncX + 27) {
      const float d[3] = {xin[3 * kTile + t], xin[4 * kTile + t], xin[5 * kTile + t]};
      v = encode(d, r - kEncX);
    }
    enc[idx] = v;
  }
  __syncthreads();

  // Trunk.
  dense<float, false>(w + L.w_dense[0], enc, kTile, kEncX, nullptr, nullptr, 0, 0,
                      bias + L.b_dense[0], L.ldw, true, buf_a, kTile, nullptr);
  __syncthreads();
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int i = 1; i < L.depth; ++i) {
    const bool skip = L.w_skip[i] >= 0;
    dense<float, false>(w + L.w_dense[i], cur, kTile, L.ldw, skip ? w + L.w_skip[i] : nullptr,
                        enc, kTile, kEncX, bias + L.b_dense[i], L.ldw, true, nxt, kTile, nullptr);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // Sigma head: four threads per sample, each a strided quarter of the
  // dot product, summed by shuffles inside their quad.
  {
    const int t = tid >> 2, part = tid & 3;
    float acc = 0.f;
    for (int k = part; k < L.ldw; k += 4) acc = fmaf(load1(w + L.w_alpha + k), cur[k * kTile + t], acc);
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
    const long long s = base + t;
    if (part == 0 && s < n) sigma[s] = fmaxf(acc + __ldg(bias + L.b_alpha), 0.f);
  }

  if (kSigmaOnly) {
    for (int idx = tid; idx < 3 * kTile; idx += kThreads) {
      const long long s = base + idx / 3;
      if (s < n) rgb[base * 3 + idx] = 0.f;
    }
    return;
  }

  // Bottleneck (no activation), then the view layer: bottleneck part plus
  // dir-encode part, ReLU. The sigma head's reads of `cur` end before the
  // barrier after the bottleneck, so the view layer may overwrite it.
  dense<float, false>(w + L.w_bneck, cur, kTile, L.ldw, nullptr, nullptr, 0, 0, bias + L.b_bneck,
                      L.ldw, false, nxt, kTile, nullptr);
  __syncthreads();
  dense<float, false>(w + L.w_view, nxt, kTile, L.ldw, w + L.w_view_dir, enc + kEncX * kTile,
                      kTile, kEncD, bias + L.b_view, L.ldv, true, cur, kTile, nullptr);
  __syncthreads();

  // Rgb head with sigmoid: one thread per (sample, channel).
  if (tid < 3 * kTile) {
    const int t = tid / 3, c = tid % 3;
    float acc = 0.f;
    for (int k = 0; k < L.ldv; ++k) acc = fmaf(load1(w + L.w_rgb + k * 3 + c), cur[k * kTile + t], acc);
    const long long s = base + t;
    if (s < n) rgb[s * 3 + c] = 1.f / (1.f + expf(-(acc + __ldg(bias + L.b_rgb + c))));
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* w, const float* bias, const Layout& L, float* rgb,
                   float* sigma, cudaStream_t stream) {
  const int cap = L.ldw > L.ldv ? L.ldw : L.ldv;
  const size_t smem = sizeof(float) * kTile * (6 + kEncRows + 2 * cap);
  auto kernel = fused_mlp_kernel<kSigmaOnly>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      pts, dirs, n, dir_div, w, bias, L, rgb, sigma);
  return cudaGetLastError();
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; weights and biases (f32) as packed by pack_params; layout:
// kLayoutLen host int64 offsets; rgb (n, 3) and sigma (n,) f32 outputs.
// Returns a cudaError_t value (0 = launched). bf16 packs go to the
// tensor-core kernel, nerf_fused_mlp_tc_forward (fused_mlp_tc.cu).
extern "C" int nerf_fused_mlp_forward(const void* pts, const void* dirs, long long n,
                                      long long dir_div, const void* weights,
                                      const void* biases, const long long* layout,
                                      int layout_len, int ldw, int ldv, int depth,
                                      int sigma_only, void* rgb, void* sigma, int device,
                                      void* stream) {
  Layout L;
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* w = static_cast<const float*>(weights);
  const float* b = static_cast<const float*>(biases);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, s)
                   : launch<false>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, s);
  return static_cast<int>(err);
}
