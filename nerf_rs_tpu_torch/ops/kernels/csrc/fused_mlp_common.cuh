// Pieces shared by the fused NeRF MLP kernels (fused_mlp_f32tc.cu and
// fused_mlp_tc.cu, K1; fused_mlp_bwd_tc.cu and fused_mlp_bwd_bf16.cu, K2):
// the packed-weight layout, weight loads, the bf16 rounding of
// activations, the positional encode's gradient, and the backward's
// fixed-order sum of per-CTA partials.
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

template <bool kBf16>
__device__ __forceinline__ float round_act(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
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
