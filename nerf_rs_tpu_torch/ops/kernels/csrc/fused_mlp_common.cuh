// Pieces shared by the fused NeRF MLP kernels (fused_mlp.cu and
// fused_mlp_tc.cu, K1; fused_mlp_bwd_tc.cu and fused_mlp_bwd_bf16.cu, K2):
// the packed-weight layout, weight loads, the bf16 rounding of
// activations, the positional encode and its gradient, the f32 forward's
// CUDA-core product with an 8-output x 8-sample register tile per thread,
// and the backward's fixed-order sum of per-CTA partials.
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace nerf {

constexpr int kMaxDepth = 16;
constexpr int kLayoutLen = 57;
constexpr int kMaxWidth = 256;
constexpr int kTile = 64;                  // samples per tile
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

// False for offsets or widths the kernels do not take.
inline bool parse_layout(const long long* layout, int layout_len, int ldw, int ldv, int depth,
                         Layout* L) {
  if (layout_len != kLayoutLen || depth < 1 || depth > kMaxDepth || ldw < 8 ||
      ldw > kMaxWidth || ldw % 8 != 0 || ldv < 8 || ldv > kMaxWidth || ldv % 8 != 0) {
    return false;
  }
  for (int i = 0; i < kMaxDepth; ++i) {
    L->w_dense[i] = layout[i];
    L->w_skip[i] = layout[kMaxDepth + i];
    L->b_dense[i] = layout[2 * kMaxDepth + 5 + i];
  }
  L->w_alpha = layout[2 * kMaxDepth];
  L->w_bneck = layout[2 * kMaxDepth + 1];
  L->w_view = layout[2 * kMaxDepth + 2];
  L->w_view_dir = layout[2 * kMaxDepth + 3];
  L->w_rgb = layout[2 * kMaxDepth + 4];
  L->b_alpha = layout[3 * kMaxDepth + 5];
  L->b_bneck = layout[3 * kMaxDepth + 6];
  L->b_view = layout[3 * kMaxDepth + 7];
  L->b_rgb = layout[3 * kMaxDepth + 8];
  L->ldw = ldw;
  L->ldv = ldv;
  L->depth = depth;
  return true;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Eight consecutive weights (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

template <bool kBf16>
__device__ __forceinline__ float round_act(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// acc[i][j] += sum_k w[k * ld + o0 + i] * in[k * in_ld + t0 + j]
__device__ __forceinline__ void gemm_acc(float (&acc)[8][8], const float* __restrict__ w,
                                         int ld, int o0, const float* in, int in_ld, int K,
                                         int t0) {
  const float* wp = w + o0;
  const float* ip = in + t0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float wv[8];
    load8(wp + static_cast<long long>(k) * ld, wv);
    const float4 a = *reinterpret_cast<const float4*>(ip + k * in_ld);
    const float4 b = *reinterpret_cast<const float4*>(ip + k * in_ld + 4);
    const float hv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], hv[j], acc[i][j]);
    }
  }
}

// out[o][t] = act(sum_k w1[k][o] in1[k][t] + sum_k w2[k][o] in2[k][t] + bias[o])
// for o < n_out (a multiple of 8, <= kMaxWidth); w2 may be null. Row
// strides: in1_ld, in2_ld and out_ld floats in shared memory.
__device__ __forceinline__ void dense(const float* __restrict__ w1, const float* in1, int in1_ld,
                                      int k1, const float* __restrict__ w2, const float* in2,
                                      int in2_ld, int k2, const float* __restrict__ bias,
                                      int n_out, bool relu, float* out, int out_ld) {
  const int o0 = (threadIdx.x >> 3) * 8;  // 32 groups of 8 outputs
  const int t0 = (threadIdx.x & 7) * 8;   // 8 groups of 8 samples
  if (o0 >= n_out) return;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  gemm_acc(acc, w1, n_out, o0, in1, in1_ld, k1, t0);
  if (w2 != nullptr) gemm_acc(acc, w2, n_out, o0, in2, in2_ld, k2, t0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float b = __ldg(bias + o0 + i);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = acc[i][j] + b;
      if (relu) x = fmaxf(x, 0.f);
      v[j] = x;
    }
    float4* dst = reinterpret_cast<float4*>(out + (o0 + i) * out_ld + t0);
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

// d(input coordinate c) of sample s from the encode gradient de (row
// stride s_de): identity rows contribute 1, sin rows 2^b cos(2^b x), cos
// rows -2^b sin(2^b x).
__device__ __forceinline__ float encode_vjp(const float* de, int s_de, int s, int c, float x,
                                            int bands) {
  const float* d = de + s * s_de;
  float v = d[c];
  for (int b = 0; b < bands; ++b) {
    const float scale = static_cast<float>(1 << b);
    float sn, cs;
    sincosf(x * scale, &sn, &cs);
    v = v + d[3 + 6 * b + c] * (scale * cs);
    v = v - d[6 + 6 * b + c] * (scale * sn);
  }
  return v;
}

// The backward kernels' second launch: out[e] = sum over p of
// partials[p * stride + e], p in order; the first n_w sums are the weight
// gradients, the rest the bias gradients. (A template, so that each
// kernel source may instantiate it.)
template <typename F>
__global__ void reduce_partials(const F* __restrict__ partials, int parts, long long stride,
                                long long n_w, F* __restrict__ dweights, F* __restrict__ dbiases) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < stride;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    F s = 0;
    for (int p = 0; p < parts; ++p) s += partials[p * stride + e];
    if (e < n_w) {
      dweights[e] = s;
    } else {
      dbiases[e - n_w] = s;
    }
  }
}

template <typename F>
cudaError_t launch_reduce_partials(const F* partials, int parts, long long stride, long long n_w,
                                   F* dweights, F* dbiases, cudaStream_t stream) {
  const long long blocks = (stride + 255) / 256;
  reduce_partials<F><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      partials, parts, stride, n_w, dweights, dbiases);
  return cudaGetLastError();
}

}  // namespace nerf
