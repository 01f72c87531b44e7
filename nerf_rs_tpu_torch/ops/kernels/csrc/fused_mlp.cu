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
// Tensor cores (wgmma), TMA weight staging and a persistent grid are work
// for later versions.
//
// Numerics: f32 mode is true f32 throughout with exact sinf/cosf (no fast
// math: the encode's arguments reach 2^9*|x|). bf16 mode rounds the encode,
// the weights (packed as bf16) and each layer's input activations to bf16,
// and accumulates in f32. Heads read the rounded activations and write f32.
//
// Layout contract with ops/kernels/fused_mlp.py::pack_params: every weight
// segment is a K-major (K, ld) matrix, w[k * ld + o], at an offset that is
// a multiple of 8 elements; trunk ld = ldw = width rounded up to 8, view
// branch ld = ldv. The layout array holds the offsets in this order:
//   [0, 16)  dense layer i's main segment (K = 64 for layer 0, ldw after)
//   [16, 32) dense layer i's encode segment (K = 64), -1 if not a skip layer
//   32 alpha (ldw, 1), 33 bottleneck (ldw, ldw), 34 viewdirs (ldw, ldv),
//   35 viewdirs' dir-encode part (32, ldv), 36 rgb (ldv, 3)
//   [37, 53) dense layer i's bias (ldw), 53 alpha bias, 54 bottleneck bias,
//   55 viewdirs bias (ldv), 56 rgb bias (3)
// Padding entries of every segment are zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxDepth = 16;
constexpr int kLayoutLen = 57;
constexpr int kMaxWidth = 256;
constexpr int kTile = 64;                  // samples per CTA
constexpr int kThreads = 256;
constexpr int kEncX = 64;                  // 63 point-encode rows, padded
constexpr int kEncD = 32;                  // 27 dir-encode rows, padded
constexpr int kEncRows = kEncX + kEncD;    // dir rows start at kEncX

struct Layout {
  long long w_dense[kMaxDepth];
  long long w_skip[kMaxDepth];
  long long w_alpha, w_bneck, w_view, w_view_dir, w_rgb;
  long long b_dense[kMaxDepth];
  long long b_alpha, b_bneck, b_view, b_rgb;
  int ldw, ldv, depth;
};

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Eight consecutive weights (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  // A bf16 value is the high half of the f32 with the same value; element
  // 2i sits in the low half of word i (little endian).
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

template <bool kBf16>
__device__ __forceinline__ float round_act(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// acc[i][j] += sum_k w[k * ld + o0 + i] * in[k * kTile + t0 + j]
template <typename WT>
__device__ __forceinline__ void gemm_acc(float (&acc)[8][8], const WT* __restrict__ w,
                                         int ld, int o0, const float* in, int K, int t0) {
  const WT* wp = w + o0;
  const float* ip = in + t0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float wv[8];
    load8(wp + static_cast<long long>(k) * ld, wv);
    const float4 a = *reinterpret_cast<const float4*>(ip + k * kTile);
    const float4 b = *reinterpret_cast<const float4*>(ip + k * kTile + 4);
    const float hv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], hv[j], acc[i][j]);
    }
  }
}

// out[o][t] = act(sum_k w1[k][o] in1[k][t] + sum_k w2[k][o] in2[k][t] + bias[o])
// for o < n_out (a multiple of 8, <= kMaxWidth); w2 may be null.
template <typename WT, bool kBf16>
__device__ __forceinline__ void dense(const WT* __restrict__ w1, const float* in1, int k1,
                                      const WT* __restrict__ w2, const float* in2, int k2,
                                      const float* __restrict__ bias, int n_out, bool relu,
                                      float* out) {
  const int o0 = (threadIdx.x >> 3) * 8;  // 32 groups of 8 outputs
  const int t0 = (threadIdx.x & 7) * 8;   // 8 groups of 8 samples
  if (o0 >= n_out) return;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  gemm_acc(acc, w1, n_out, o0, in1, k1, t0);
  if (w2 != nullptr) gemm_acc(acc, w2, n_out, o0, in2, k2, t0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float b = __ldg(bias + o0 + i);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = acc[i][j] + b;
      if (relu) x = fmaxf(x, 0.f);
      v[j] = round_act<kBf16>(x);
    }
    float4* dst = reinterpret_cast<float4*>(out + (o0 + i) * kTile + t0);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Encode row j of one input triple (identity, then per band a sin triple
// and a cos triple at frequency 2^band, no pi).
__device__ __forceinline__ float encode(const float* xyz, int j) {
  if (j < 3) return xyz[j];
  const int band = (j - 3) / 6;
  const int o = (j - 3) % 6;
  const float arg = xyz[o % 3] * static_cast<float>(1 << band);  // exact scale
  return o < 3 ? sinf(arg) : cosf(arg);
}

template <typename WT, bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 long long n, long long dir_div, const WT* __restrict__ w,
                 const float* __restrict__ bias, const Layout L,
                 float* __restrict__ rgb, float* __restrict__ sigma) {
  constexpr bool kBf16 = sizeof(WT) == 2;
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
    enc[idx] = round_act<kBf16>(v);
  }
  __syncthreads();

  // Trunk.
  dense<WT, kBf16>(w + L.w_dense[0], enc, kEncX, nullptr, nullptr, 0,
                   bias + L.b_dense[0], L.ldw, true, buf_a);
  __syncthreads();
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int i = 1; i < L.depth; ++i) {
    const bool skip = L.w_skip[i] >= 0;
    dense<WT, kBf16>(w + L.w_dense[i], cur, L.ldw, skip ? w + L.w_skip[i] : nullptr,
                     enc, kEncX, bias + L.b_dense[i], L.ldw, true, nxt);
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
  dense<WT, kBf16>(w + L.w_bneck, cur, L.ldw, nullptr, nullptr, 0, bias + L.b_bneck, L.ldw,
                   false, nxt);
  __syncthreads();
  dense<WT, kBf16>(w + L.w_view, nxt, L.ldw, w + L.w_view_dir, enc + kEncX * kTile, kEncD,
                   bias + L.b_view, L.ldv, true, cur);
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

template <typename WT, bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const void* w, const float* bias, const Layout& L, float* rgb,
                   float* sigma, cudaStream_t stream) {
  const int cap = L.ldw > L.ldv ? L.ldw : L.ldv;
  const size_t smem = sizeof(float) * kTile * (6 + kEncRows + 2 * cap);
  auto kernel = fused_mlp_kernel<WT, kSigmaOnly>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      pts, dirs, n, dir_div, static_cast<const WT*>(w), bias, L, rgb, sigma);
  return cudaGetLastError();
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; weights (bf16 != 0: bf16, else f32) and biases (f32) as
// packed by pack_params; layout: kLayoutLen host int64 offsets; rgb (n, 3)
// and sigma (n,) f32 outputs. Returns a cudaError_t value (0 = launched).
extern "C" int nerf_fused_mlp_forward(const void* pts, const void* dirs, long long n,
                                      long long dir_div, const void* weights,
                                      const void* biases, const long long* layout,
                                      int layout_len, int ldw, int ldv, int depth, int bf16,
                                      int sigma_only, void* rgb, void* sigma, int device,
                                      void* stream) {
  if (layout_len != kLayoutLen || depth < 1 || depth > kMaxDepth || ldw < 8 ||
      ldw > kMaxWidth || ldw % 8 != 0 || ldv < 8 || ldv > kMaxWidth || ldv % 8 != 0 ||
      dir_div < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Layout L;
  for (int i = 0; i < kMaxDepth; ++i) {
    L.w_dense[i] = layout[i];
    L.w_skip[i] = layout[kMaxDepth + i];
    L.b_dense[i] = layout[2 * kMaxDepth + 5 + i];
  }
  L.w_alpha = layout[2 * kMaxDepth];
  L.w_bneck = layout[2 * kMaxDepth + 1];
  L.w_view = layout[2 * kMaxDepth + 2];
  L.w_view_dir = layout[2 * kMaxDepth + 3];
  L.w_rgb = layout[2 * kMaxDepth + 4];
  L.b_alpha = layout[3 * kMaxDepth + 5];
  L.b_bneck = layout[3 * kMaxDepth + 6];
  L.b_view = layout[3 * kMaxDepth + 7];
  L.b_rgb = layout[3 * kMaxDepth + 8];
  L.ldw = ldw;
  L.ldv = ldv;
  L.depth = depth;
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* b = static_cast<const float*>(biases);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    err = sigma_only
              ? launch<__nv_bfloat16, true>(p, d, n, dir_div, weights, b, L, o_rgb, o_sigma, s)
              : launch<__nv_bfloat16, false>(p, d, n, dir_div, weights, b, L, o_rgb, o_sigma, s);
  } else {
    err = sigma_only ? launch<float, true>(p, d, n, dir_div, weights, b, L, o_rgb, o_sigma, s)
                     : launch<float, false>(p, d, n, dir_div, weights, b, L, o_rgb, o_sigma, s);
  }
  return static_cast<int>(err);
}
