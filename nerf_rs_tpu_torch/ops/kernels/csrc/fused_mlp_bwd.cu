// Fused NeRF MLP backward for Hopper (sm_90a): per tile of samples,
// recompute the forward, backpropagate through the rgb head, the view
// layer, the bottleneck, the sigma head and the trunk with its skip layer,
// and sum every layer's weight and bias gradient over the samples; with
// input gradients requested, also d(points) and d(dirs) through the encode.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_backward_t (the Pallas
// call) and its kernel body _kernel_bwd. It computes the same function,
// with its own choices for what the TPU design left to VMEM:
// - The activations of a tile do not fit on chip: a 64-sample tile needs
//   every trunk layer's output (about 10 x 64 KB at width 256) against
//   227 KB of shared memory. The forward recompute writes each trunk
//   layer's output to a per-CTA workspace in device memory, and the
//   backward stages one layer's input at a time back into shared memory.
//   The bottleneck and view outputs are used at once and never leave the SM.
// - The TPU kernel sums dW into one VMEM-resident output across a
//   sequential grid. Here each CTA walks a contiguous range of tiles and
//   adds into its own partial (the packed weight and bias layout, f32) in
//   device memory; a second launch sums the partials in a fixed order. No
//   atomics: two identical calls give bitwise-equal gradients.
// - Packed weights are K-major (K, ld); the input-gradient product W . dz
//   reads a transposed copy (pack_params' weights_t), so its loads stay
//   16-byte vectors along a row, as in the forward.
// - Samples past n in the ragged last tile get zero cotangents, so they add
//   exactly zero to dW, db and dx.
// - sigma_only zeroes the rgb cotangent in the JAX package; here the
//   variant skips the color branch, and its gradients stay exactly zero.
//
// What bounds it on the H100: arithmetic, as in the forward. A full sample
// costs about three times the forward's 1.2 MFLOP (recompute, dW, input
// gradients). Each tile also reads and writes the CTA's partial once
// (2.4 MB in each direction for the canonical network), which the 64-sample
// tile amortises over 64 samples. This first version keeps to CUDA cores:
// - dW: a warp owns 8 input rows and all outputs (lane + 32 j); the input
//   rows are broadcast reads, the gradient rows sit 68 floats apart so the
//   eight rows of a 16-byte shared-memory phase hit distinct banks;
// - input gradients: the forward's 8 x 8 register tile on the transposed
//   weights.
// Tensor cores (wgmma), TMA staging and a tile larger than 64 samples for
// the dW products are work for later versions.
//
// Numerics (the JAX kernel's): f32 mode is true f32 with exact sinf/cosf.
// bf16 mode recomputes exactly what the bf16 forward computes, rounds each
// layer's output gradient to bf16 after the ReLU mask (and the heads'
// gradients after the sigmoid and ReLU derivatives), and accumulates dW,
// db and the encode gradient in f32.

#include "fused_mlp_common.cuh"

namespace {

using namespace nerf;

constexpr int kLdG = kTile + 4;  // row stride of the gradient buffers (floats)
constexpr int kLayoutTLen = 2 * kMaxDepth + 3;

// Offsets of the transposed (ld, K) segments: [0, 16) dense layer i,
// [16, 32) dense layer i's encode part (-1 if not a skip layer),
// 32 bottleneck, 33 viewdirs, 34 viewdirs' dir-encode part.
struct LayoutT {
  long long w_dense[kMaxDepth];
  long long w_skip[kMaxDepth];
  long long w_bneck, w_view, w_view_dir;
};

// dw[k * ld + o] += sum_t h[k * h_ld + t] * g[o * g_ld + t] for k < K (a
// multiple of 8) and o < n_out. Warp w takes rows k0 = 8 w, 8 w + 64, ...;
// lane l takes outputs l + 32 j. One thread owns each entry, so successive
// tiles add their tile sums in tile order. The entries' old values are
// loaded before the products, all at once: their latency (the partials
// live in device memory) hides behind the arithmetic, where a
// load-add-store per entry would wait for each load in turn.
__device__ __forceinline__ void outer_acc(float* __restrict__ dw, int ld, int K, int n_out,
                                          const float* h, int h_ld, const float* g, int g_ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k0 = warp * 8; k0 < K; k0 += kThreads / 4) {
    float old[8][8], acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = lane + 32 * j;
        old[i][j] = o < n_out ? dw[static_cast<long long>(k0 + i) * ld + o] : 0.f;
        acc[i][j] = 0.f;
      }
    }
#pragma unroll 2
    for (int t = 0; t < kTile; t += 4) {
      float4 hv[8], gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = *reinterpret_cast<const float4*>(h + (k0 + i) * h_ld + t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = lane + 32 * j;
        gv[j] = o < n_out ? *reinterpret_cast<const float4*>(g + o * g_ld + t)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = acc[i][j];
          a = fmaf(hv[i].x, gv[j].x, a);
          a = fmaf(hv[i].y, gv[j].y, a);
          a = fmaf(hv[i].z, gv[j].z, a);
          acc[i][j] = fmaf(hv[i].w, gv[j].w, a);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = lane + 32 * j;
        if (o < n_out) dw[static_cast<long long>(k0 + i) * ld + o] = old[i][j] + acc[i][j];
      }
    }
  }
}

// db[o] += sum_t g[o * g_ld + t] for o < n_out.
__device__ __forceinline__ void bias_acc(float* db, int n_out, const float* g, int g_ld) {
  const int o = threadIdx.x;
  if (o >= n_out) return;
  float s = 0.f;
  for (int t = 0; t < kTile; t += 4) {
    const float4 v = *reinterpret_cast<const float4*>(g + o * g_ld + t);
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  db[o] += s;
}

// Gradient with respect to a layer's input:
//   out[k][t] = round(mask(sum_o wt[o * k_out + k] g[o][t] + w_alpha[k] gs[t]))
// for k < k_out; wt is the transposed (n_red, k_out) segment, w_alpha (the
// sigma head, ldw x 1) may be null, mask (the layer input, ReLU) may be
// null, and to_bf16 rounds to bf16 in bf16 mode.
template <typename WT, bool kBf16>
__device__ __forceinline__ void din(const WT* __restrict__ wt, int k_out, const float* g,
                                    int g_ld, int n_red, const WT* __restrict__ w_alpha,
                                    const float* gs, const float* mask, int mask_ld, bool to_bf16,
                                    float* out, int out_ld) {
  const int k0 = (threadIdx.x >> 3) * 8;
  const int t0 = (threadIdx.x & 7) * 8;
  if (k0 >= k_out) return;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  gemm_acc(acc, wt, k_out, k0, g, g_ld, n_red, t0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float wa = w_alpha != nullptr ? load1(w_alpha + k0 + i) : 0.f;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = acc[i][j];
      if (w_alpha != nullptr) x = x + wa * gs[t0 + j];
      if (mask != nullptr && !(mask[(k0 + i) * mask_ld + t0 + j] > 0.f)) x = 0.f;
      v[j] = to_bf16 ? round_act<kBf16>(x) : x;
    }
    float4* dst = reinterpret_cast<float4*>(out + (k0 + i) * out_ld + t0);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// d(input coordinate) of the encode rows' gradient de (rows of kTile
// floats): identity rows contribute 1, sin rows 2^b cos(2^b x), cos rows
// -2^b sin(2^b x). Thread tid < 3 kTile takes coordinate tid / kTile of
// sample tid % kTile.
__device__ __forceinline__ float encode_vjp(const float* de, const float* x, int bands) {
  const int c = threadIdx.x / kTile, t = threadIdx.x % kTile;
  const float xv = x[c * kTile + t];
  float s = de[c * kTile + t];
  for (int b = 0; b < bands; ++b) {
    const float scale = static_cast<float>(1 << b);
    float sn, cs;
    sincosf(xv * scale, &sn, &cs);
    s += de[(3 + 6 * b + c) * kTile + t] * (scale * cs);
    s -= de[(6 + 6 * b + c) * kTile + t] * (scale * sn);
  }
  return s;
}

// Copy rows [0, rows) of a layer output from the CTA's workspace, which
// this kernel wrote: loads go through L2 (__ldcg), never the read-only path.
__device__ __forceinline__ void stage(float* dst, const float* src, int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int idx = threadIdx.x; idx < rows * kTile / 4; idx += kThreads) d[idx] = __ldcg(s + idx);
}


// One CTA walks tiles [ntiles * b / grid, ntiles * (b + 1) / grid) and adds
// into its partial: n_w weight-gradient floats in the packed weight layout,
// then the bias gradients in the packed bias layout (part_stride apart).
template <typename WT, bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
                     long long dir_div, const float* __restrict__ g_rgb,
                     const float* __restrict__ g_sigma, const WT* __restrict__ w,
                     const WT* __restrict__ wt, const float* __restrict__ bias, const Layout L,
                     const LayoutT LT, float* act_ws, float* partials, long long n_w,
                     long long part_stride, long long ntiles, float* __restrict__ dpts,
                     float* __restrict__ ddirs) {
  constexpr bool kBf16 = sizeof(WT) == 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* enc = smem;                            // [kEncRows][kTile]
  float* hbuf = enc + kEncRows * kTile;         // [kMaxWidth][kTile] staged input, or de
  float* gbuf_a = hbuf + kMaxWidth * kTile;     // [kMaxWidth][kLdG]
  float* gbuf_b = gbuf_a + kMaxWidth * kLdG;    // [kMaxWidth][kLdG]
  float* xin = gbuf_b + kMaxWidth * kLdG;       // [6][kTile] points, dirs
  float* gs = xin + 6 * kTile;                  // [kTile] sigma cotangent, then d(pre-ReLU)
  float* gr = gs + kTile;                       // [3][kTile] rgb cotangent, then d(pre-sigmoid)
  const int tid = threadIdx.x;
  const int ldw = L.ldw, ldv = L.ldv, depth = L.depth;
  const bool want_dx = dpts != nullptr;
  float* dW = partials + static_cast<long long>(blockIdx.x) * part_stride;
  float* dB = dW + n_w;
  float* act = act_ws + static_cast<long long>(blockIdx.x) * depth * ldw * kTile;
  const long long t_begin = ntiles * blockIdx.x / gridDim.x;
  const long long t_end = ntiles * (blockIdx.x + 1) / gridDim.x;

  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long base = tile * kTile;
    // Inputs and cotangents of the tile; samples past n read zeros.
    for (int idx = tid; idx < 6 * kTile; idx += kThreads) {
      const int c = idx / kTile, t = idx % kTile;
      const long long s = base + t;
      float v = 0.f;
      if (s < n) v = c < 3 ? pts[s * 3 + c] : dirs[(s / dir_div) * 3 + (c - 3)];
      xin[idx] = v;
    }
    for (int idx = tid; idx < 4 * kTile; idx += kThreads) {
      const int c = idx / kTile, t = idx % kTile;
      const long long s = base + t;
      float v = 0.f;
      if (s < n) v = c < 3 ? g_rgb[s * 3 + c] : g_sigma[s];
      if (c < 3) {
        gr[c * kTile + t] = v;
      } else {
        gs[t] = v;
      }
    }
    __syncthreads();
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

    // Forward recompute, as the forward kernel computes it; trunk layer i's
    // output also goes to workspace slot i.
    float* cur = gbuf_a;
    float* nxt = gbuf_b;
    dense<WT, kBf16>(w + L.w_dense[0], enc, kTile, kEncX, nullptr, nullptr, 0, 0,
                     bias + L.b_dense[0], ldw, true, cur, kLdG, act);
    __syncthreads();
    for (int i = 1; i < depth; ++i) {
      const bool skip = L.w_skip[i] >= 0;
      dense<WT, kBf16>(w + L.w_dense[i], cur, kLdG, ldw, skip ? w + L.w_skip[i] : nullptr, enc,
                       kTile, kEncX, bias + L.b_dense[i], ldw, true, nxt, kLdG,
                       act + static_cast<long long>(i) * ldw * kTile);
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    // Sigma head: gs becomes d(pre-ReLU sigma).
    {
      const int t = tid >> 2, part = tid & 3;
      float acc = 0.f;
      for (int k = part; k < ldw; k += 4) {
        acc = fmaf(load1(w + L.w_alpha + k), cur[k * kLdG + t], acc);
      }
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
      if (part == 0) {
        const float pre = acc + __ldg(bias + L.b_alpha);
        gs[t] = round_act<kBf16>(pre > 0.f ? gs[t] : 0.f);
      }
    }

    float dxp = 0.f, dxd = 0.f;  // this thread's d(point) and d(dir) coordinate
    float* g;                     // gradient of the current trunk layer's output
    float* spare;
    if (!kSigmaOnly) {
      // Bottleneck (no activation) into nxt, the view layer into hbuf.
      dense<WT, kBf16>(w + L.w_bneck, cur, kLdG, ldw, nullptr, nullptr, 0, 0, bias + L.b_bneck,
                       ldw, false, nxt, kLdG, nullptr);
      __syncthreads();
      dense<WT, kBf16>(w + L.w_view, nxt, kLdG, ldw, w + L.w_view_dir, enc + kEncX * kTile,
                       kTile, kEncD, bias + L.b_view, ldv, true, hbuf, kTile, nullptr);
      __syncthreads();
      // Rgb head: gr becomes d(pre-sigmoid rgb).
      if (tid < 3 * kTile) {
        const int t = tid / 3, c = tid % 3;
        float acc = 0.f;
        for (int k = 0; k < ldv; ++k) {
          acc = fmaf(load1(w + L.w_rgb + k * 3 + c), hbuf[k * kTile + t], acc);
        }
        // sigmoid' = sg (1 - sg), with 1 - sg as sigmoid(-pre): no
        // cancellation where the sigmoid saturates.
        const float pre = acc + __ldg(bias + L.b_rgb + c);
        const float sg = 1.f / (1.f + expf(-pre));
        const float sg_neg = 1.f / (1.f + expf(pre));
        gr[c * kTile + t] = round_act<kBf16>(gr[c * kTile + t] * sg * sg_neg);
      }
      __syncthreads();
      // Rgb head backward; d(view output) goes to cur (h_last stays in the
      // workspace).
      for (int idx = tid; idx < 3 * ldv; idx += kThreads) {
        const int k = idx / 3, c = idx % 3;
        float s = 0.f;
        for (int t = 0; t < kTile; ++t) s = fmaf(hbuf[k * kTile + t], gr[c * kTile + t], s);
        dW[L.w_rgb + idx] += s;
      }
      if (tid < 3) {
        float s = 0.f;
        for (int t = 0; t < kTile; ++t) s += gr[tid * kTile + t];
        dB[L.b_rgb + tid] += s;
      }
      for (int idx = tid; idx < ldv * kTile; idx += kThreads) {
        const int k = idx / kTile, t = idx % kTile;
        float v = 0.f;
        if (hbuf[idx] > 0.f) {
          v = load1(w + L.w_rgb + k * 3) * gr[t];
          v = fmaf(load1(w + L.w_rgb + k * 3 + 1), gr[kTile + t], v);
          v = fmaf(load1(w + L.w_rgb + k * 3 + 2), gr[2 * kTile + t], v);
        }
        cur[k * kLdG + t] = round_act<kBf16>(v);
      }
      __syncthreads();
      // View layer: inputs bottleneck (nxt) and dir encode; output gradient cur.
      outer_acc(dW + L.w_view, ldv, ldw, ldv, nxt, kLdG, cur, kLdG);
      outer_acc(dW + L.w_view_dir, ldv, kEncD, ldv, enc + kEncX * kTile, kTile, cur, kLdG);
      bias_acc(dB + L.b_view, ldv, cur, kLdG);
      __syncthreads();
      // d(bottleneck) into nxt (no activation); d(dir encode) into hbuf.
      din<WT, kBf16>(wt + LT.w_view, ldw, cur, kLdG, ldv, nullptr, nullptr, nullptr, 0, true, nxt,
                     kLdG);
      if (want_dx) {
        din<WT, kBf16>(wt + LT.w_view_dir, kEncD, cur, kLdG, ldv, nullptr, nullptr, nullptr, 0,
                       false, hbuf, kTile);
      }
      __syncthreads();
      if (want_dx && tid < 3 * kTile) dxd = encode_vjp(hbuf, xin + 3 * kTile, 4);
      __syncthreads();
      stage(hbuf, act + static_cast<long long>(depth - 1) * ldw * kTile, ldw);
      __syncthreads();
      // Bottleneck and sigma head: input h_last (hbuf), output gradients
      // nxt and gs; d(h_last) into cur.
      outer_acc(dW + L.w_bneck, ldw, ldw, ldw, hbuf, kTile, nxt, kLdG);
      bias_acc(dB + L.b_bneck, ldw, nxt, kLdG);
      if (tid < ldw) {
        float s = 0.f;
        for (int t = 0; t < kTile; ++t) s = fmaf(hbuf[tid * kTile + t], gs[t], s);
        dW[L.w_alpha + tid] += s;
      }
      din<WT, kBf16>(wt + LT.w_bneck, ldw, nxt, kLdG, ldw, w + L.w_alpha, gs, hbuf, kTile, true,
                     cur, kLdG);
      g = cur;
      spare = nxt;
    } else {
      __syncthreads();
      // Sigma head only: input h_last (cur); d(h_last) into nxt.
      if (tid < ldw) {
        float s = 0.f;
        for (int t = 0; t < kTile; ++t) s = fmaf(cur[tid * kLdG + t], gs[t], s);
        dW[L.w_alpha + tid] += s;
      }
      din<WT, kBf16>(wt, ldw, nxt, kLdG, 0, w + L.w_alpha, gs, cur, kLdG, true, nxt, kLdG);
      g = nxt;
      spare = cur;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int t = 0; t < kTile; ++t) s += gs[t];
      dB[L.b_alpha] += s;
    }
    __syncthreads();

    // Trunk, from the last layer down to layer 1.
    for (int i = depth - 1; i >= 1; --i) {
      const bool skip = L.w_skip[i] >= 0;
      stage(hbuf, act + static_cast<long long>(i - 1) * ldw * kTile, ldw);
      __syncthreads();
      outer_acc(dW + L.w_dense[i], ldw, ldw, ldw, hbuf, kTile, g, kLdG);
      if (skip) outer_acc(dW + L.w_skip[i], ldw, kEncX, ldw, enc, kTile, g, kLdG);
      bias_acc(dB + L.b_dense[i], ldw, g, kLdG);
      din<WT, kBf16>(wt + LT.w_dense[i], ldw, g, kLdG, ldw, nullptr, nullptr, hbuf, kTile, true,
                     spare, kLdG);
      __syncthreads();
      if (want_dx && skip) {
        din<WT, kBf16>(wt + LT.w_skip[i], kEncX, g, kLdG, ldw, nullptr, nullptr, nullptr, 0, false,
                       hbuf, kTile);
        __syncthreads();
        if (tid < 3 * kTile) dxp += encode_vjp(hbuf, xin, 10);
        __syncthreads();
      }
      float* t = g;
      g = spare;
      spare = t;
    }
    // Layer 0: input the point encode.
    outer_acc(dW + L.w_dense[0], ldw, kEncX, ldw, enc, kTile, g, kLdG);
    bias_acc(dB + L.b_dense[0], ldw, g, kLdG);
    if (want_dx) {
      din<WT, kBf16>(wt + LT.w_dense[0], kEncX, g, kLdG, ldw, nullptr, nullptr, nullptr, 0, false,
                     hbuf, kTile);
      __syncthreads();
      if (tid < 3 * kTile) {
        dxp += encode_vjp(hbuf, xin, 10);
        const int c = tid / kTile;
        const long long s = base + tid % kTile;
        if (s < n) {
          dpts[s * 3 + c] = dxp;
          ddirs[s * 3 + c] = dxd;
        }
      }
    }
    __syncthreads();
  }
}

// out[e] = sum over p of partials[p * stride + e], p in order; the first
// n_w sums are the weight gradients, the rest the bias gradients.
__global__ void reduce_partials(const float* __restrict__ partials, int parts, long long stride,
                                long long n_w, float* __restrict__ dweights,
                                float* __restrict__ dbiases) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < stride;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += partials[p * stride + e];
    if (e < n_w) {
      dweights[e] = s;
    } else {
      dbiases[e - n_w] = s;
    }
  }
}

constexpr size_t kSmemBytes =
    sizeof(float) * (kEncRows * kTile + kMaxWidth * kTile + 2 * kMaxWidth * kLdG + 10 * kTile);
static_assert(kSmemBytes <= 232448, "K2's tile exceeds the 227 KB a block may use");

template <typename WT, bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* g_rgb, const float* g_sigma, const void* w, const void* wt,
                   const float* bias, const Layout& L, const LayoutT& LT, float* act_ws,
                   float* partials, long long n_w, long long n_b, int grid, float* dweights,
                   float* dbiases, float* dpts, float* ddirs, cudaStream_t stream) {
  auto kernel = fused_mlp_bwd_kernel<WT, kSigmaOnly>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long stride = n_w + n_b;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      pts, dirs, n, dir_div, g_rgb, g_sigma, static_cast<const WT*>(w),
      static_cast<const WT*>(wt), bias, L, LT, act_ws, partials, n_w, stride, ntiles, dpts,
      ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks = (stride + kThreads - 1) / kThreads;
  reduce_partials<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      partials, grid, stride, n_w, dweights, dbiases);
  return cudaGetLastError();
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; g_rgb (n, 3) and g_sigma (n,) f32 cotangents; weights,
// weights_t (bf16 != 0: bf16, else f32) and biases (f32) as packed by
// pack_params, with their host int64 offset tables layout (kLayoutLen) and
// layout_t (kLayoutTLen); act_ws: grid * depth * ldw * 64 f32 of scratch;
// partials: grid * (n_w + n_b) f32, zeroed; dweights (n_w) and dbiases
// (n_b) f32 outputs; dpts and ddirs (n, 3) f32 outputs (per sample), or
// both null for no input gradients. 1 <= grid. Returns a cudaError_t value
// (0 = launched).
extern "C" int nerf_fused_mlp_backward(
    const void* pts, const void* dirs, long long n, long long dir_div, const void* g_rgb,
    const void* g_sigma, const void* weights, const void* weights_t, const void* biases,
    const long long* layout, int layout_len, const long long* layout_t, int layout_t_len,
    int ldw, int ldv, int depth, int bf16, int sigma_only, void* act_ws, void* partials,
    long long n_w, long long n_b, int grid, void* dweights, void* dbiases, void* dpts,
    void* ddirs, int device, void* stream) {
  Layout L;
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, &L) || layout_t_len != kLayoutTLen ||
      dir_div < 1 || n < 1 || grid < 1 || n_w < 1 || n_b < 1 ||
      (dpts == nullptr) != (ddirs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LayoutT LT;
  for (int i = 0; i < kMaxDepth; ++i) {
    LT.w_dense[i] = layout_t[i];
    LT.w_skip[i] = layout_t[kMaxDepth + i];
  }
  LT.w_bneck = layout_t[2 * kMaxDepth];
  LT.w_view = layout_t[2 * kMaxDepth + 1];
  LT.w_view_dir = layout_t[2 * kMaxDepth + 2];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const float* gr = static_cast<const float*>(g_rgb);
  const float* gsg = static_cast<const float*>(g_sigma);
  const float* b = static_cast<const float*>(biases);
  float* ws = static_cast<float*>(act_ws);
  float* part = static_cast<float*>(partials);
  float* dw = static_cast<float*>(dweights);
  float* db = static_cast<float*>(dbiases);
  float* dp = static_cast<float*>(dpts);
  float* dd = static_cast<float*>(ddirs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    err = sigma_only ? launch<__nv_bfloat16, true>(p, d, n, dir_div, gr, gsg, weights, weights_t, b,
                                                   L, LT, ws, part, n_w, n_b, grid, dw, db, dp, dd, s)
                     : launch<__nv_bfloat16, false>(p, d, n, dir_div, gr, gsg, weights, weights_t,
                                                    b, L, LT, ws, part, n_w, n_b, grid, dw, db, dp,
                                                    dd, s);
  } else {
    err = sigma_only ? launch<float, true>(p, d, n, dir_div, gr, gsg, weights, weights_t, b, L, LT,
                                           ws, part, n_w, n_b, grid, dw, db, dp, dd, s)
                     : launch<float, false>(p, d, n, dir_div, gr, gsg, weights, weights_t, b, L,
                                            LT, ws, part, n_w, n_b, grid, dw, db, dp, dd, s);
  }
  return static_cast<int>(err);
}
