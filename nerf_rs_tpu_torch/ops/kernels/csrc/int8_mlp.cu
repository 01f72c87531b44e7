// W8A8 NeRF MLP forward for Hopper (sm_90a): positional encode, then every
// dense layer as int8 codes x int8 codes -> int32, dequantized and
// requantized per sample between layers, in one kernel. Activations never
// leave the SM.
//
// Replaces tools/pallas_int8_probe.py::main -> make -> go, the Pallas call
// at :66: a chain of int8 x int8 -> int32 products with the weights
// resident, each followed by a ReLU in f32 and a per-sample absmax
// requantize back to int8. Here the chain is the real W8A8 NeRF MLP of
// nerf_rs_tpu/models/quant.py::int8_nerf_mlp(fake=False), whose plain
// version is nerf_rs_tpu_torch/models/quant.py::int8_nerf_mlp. Per dense
// layer, with x the layer's f32 input row of one sample (width K, the skip
// layer's [h0, h] and the view layer's [bottleneck, dirs_enc] included):
//   sx   = max(max_j |x_j| / 127, 1e-12)
//   q_j  = clamp(rint(x_j / sx), -127, 127)
//   acc  = sum_j q_j * wq[j, n]                       (int32, exact)
//   y_n  = ((float)acc * sx) * sw[n] + b[n]           (three rounded ops)
// then ReLU (trunk, alpha, view layer), nothing (bottleneck) or sigmoid
// (rgb). The weight codes and their per-column scales come from the pack
// (ops/kernels/int8_mlp.py::pack_int8_params).
//
// What bounds it on the H100: operations. A fine sample costs 1.187 M
// multiply-adds counted as two operations each, against 24 bytes of input
// and 16 of output; the packed codes (0.6 MB) stay in L2. This first
// version runs the products on the CUDA cores with __dp4a (four int8
// products and their sum into an int32 per instruction, exact):
// - one CTA of 256 threads per tile of 64 samples, up to two CTAs per SM;
// - the tile's f32 encode, its f32 layer output, the per-sample scales and
//   the int8 codes of the current layer input stay in shared memory;
// - each thread owns an 8-output x 8-sample register tile of int32 sums,
//   so each code word it loads feeds 8 dp4a;
// - a layer's whole output is written before the next layer's row absmax
//   is taken (a barrier between them), since that absmax spans the row.
// Tensor cores (mma / wgmma on s8 operands) and TMA weight staging are
// work for later versions.
//
// Numerics: every division is __fdiv_rn, every dequant op __fmul_rn or
// __fadd_rn (no FMA contraction), rounding is rintf (half to even, as
// torch.round); the encode is K1's exact sinf/cosf. Built without fast
// math. So the codes, the accumulators and sigma equal the plain version's
// bit for bit; rgb differs only where expf differs from torch's sigmoid.
//
// Weight layout contract with pack_int8_params: each layer is a K-major
// matrix of int32 words, word[k4 * ld + n] holding the codes of rows
// 4 k4 .. 4 k4 + 3 of column n in its bytes 0..3; ld is the output width
// rounded up to 8 (8 for the heads); K is the padded input width in rows:
// 64 for dense0 (63 encode rows), ldw + 64 for a skip layer (the encode
// rows first), ldw for the other trunk layers, alpha and the bottleneck,
// ldw + 32 for the view layer (27 dir-encode rows after the bottleneck's),
// ldv for rgb. Padding codes, scales and biases are zero. The int64
// layout array holds, in this order:
//   [0, 16)  dense layer i's word offset        [16, 32) its scale/bias offset
//   [32, 48) 1 if dense layer i takes the encode rows first (skip), else 0
//   48 alpha, 49 bottleneck, 50 viewdirs, 51 rgb word offsets
//   52 alpha, 53 bottleneck, 54 viewdirs, 55 rgb scale/bias offsets

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxDepth = 16;
constexpr int kLayoutLen = 56;
constexpr int kMaxWidth = 256;
constexpr int kTile = 64;                  // samples per tile
constexpr int kThreads = 256;
constexpr int kEncX = 64;                  // 63 point-encode rows, padded
constexpr int kEncD = 32;                  // 27 dir-encode rows, padded
constexpr int kEncRows = kEncX + kEncD;    // dir rows start at kEncX
constexpr int kHeadLd = 8;                 // column stride of alpha and rgb

struct QLayout {
  long long w_dense[kMaxDepth];
  long long sb_dense[kMaxDepth];
  int skip[kMaxDepth];
  long long w_alpha, w_bneck, w_view, w_rgb;
  long long sb_alpha, sb_bneck, sb_view, sb_rgb;
  int ldw, ldv, depth;
};

bool parse_layout(const long long* layout, int layout_len, int ldw, int ldv, int depth,
                  QLayout* L) {
  if (layout_len != kLayoutLen || depth < 1 || depth > kMaxDepth || ldw < 8 ||
      ldw > kMaxWidth || ldw % 8 != 0 || ldv < 8 || ldv > kMaxWidth || ldv % 8 != 0) {
    return false;
  }
  for (int i = 0; i < kMaxDepth; ++i) {
    L->w_dense[i] = layout[i];
    L->sb_dense[i] = layout[kMaxDepth + i];
    L->skip[i] = static_cast<int>(layout[2 * kMaxDepth + i]);
  }
  L->w_alpha = layout[48];
  L->w_bneck = layout[49];
  L->w_view = layout[50];
  L->w_rgb = layout[51];
  L->sb_alpha = layout[52];
  L->sb_bneck = layout[53];
  L->sb_view = layout[54];
  L->sb_rgb = layout[55];
  L->ldw = ldw;
  L->ldv = ldv;
  L->depth = depth;
  return L->skip[0] == 0;
}

// Encode row j of one input triple (identity, then per band a sin triple
// and a cos triple at frequency 2^band, no pi), as K1 computes it.
__device__ __forceinline__ float encode(const float* xyz, int j) {
  if (j < 3) return xyz[j];
  const int band = (j - 3) / 6;
  const int o = (j - 3) % 6;
  const float arg = xyz[o % 3] * static_cast<float>(1 << band);  // exact scale
  return o < 3 ? sinf(arg) : cosf(arg);
}

// Row r of a layer input that is the concatenation of a (ka rows) and b.
__device__ __forceinline__ float input_row(const float* a, int ka, const float* b, int r, int t) {
  return r < ka ? a[r * kTile + t] : b[(r - ka) * kTile + t];
}

// The int8 codes of the layer input [a; b] (ka + kb rows, both multiples
// of 4, row stride kTile) into xw[k4 * kTile + t], and each sample's scale
// into sx[t]. Called by every thread of the CTA; ends behind a barrier.
__device__ void quantize(const float* a, int ka, const float* b, int kb, float* sx, int* xw) {
  const int tid = threadIdx.x;
  const int k = ka + kb;
  {
    // Row absmax: four threads per sample, each a strided quarter of the
    // row, combined by shuffles inside their quad (max is exact).
    const int t = tid >> 2, part = tid & 3;
    float m = 0.f;
    for (int r = part; r < k; r += 4) m = fmaxf(m, fabsf(input_row(a, ka, b, r, t)));
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 2));
    if (part == 0) sx[t] = fmaxf(__fdiv_rn(m, 127.f), 1e-12f);
  }
  __syncthreads();
  for (int idx = tid; idx < (k / 4) * kTile; idx += kThreads) {
    const int k4 = idx / kTile, t = idx % kTile;
    const float s = sx[t];
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float q = rintf(__fdiv_rn(input_row(a, ka, b, 4 * k4 + j, t), s));
      q = fminf(fmaxf(q, -127.f), 127.f);
      word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * j);
    }
    xw[idx] = static_cast<int>(word);
  }
  __syncthreads();
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

// out[n][t] = act(dequant(sum_k4 dp4a(w[k4 * ld + n], xw[k4 * kTile + t])))
// for n < ld (a multiple of 8, <= kMaxWidth); row stride kTile.
__device__ __forceinline__ void qdense(const int* __restrict__ w, int ld, int k4n, const int* xw,
                                       const float* sx, const float* __restrict__ sw,
                                       const float* __restrict__ bias, bool relu, float* out) {
  const int o0 = (threadIdx.x >> 3) * 8;  // 32 groups of 8 outputs
  const int t0 = (threadIdx.x & 7) * 8;   // 8 groups of 8 samples
  if (o0 >= ld) return;
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
  }
  const int* wp = w + o0;
  const int* xp = xw + t0;
#pragma unroll 4
  for (int k = 0; k < k4n; ++k) {
    const int4 wa = __ldg(reinterpret_cast<const int4*>(wp + static_cast<long long>(k) * ld));
    const int4 wb = __ldg(reinterpret_cast<const int4*>(wp + static_cast<long long>(k) * ld) + 1);
    const int4 xa = *reinterpret_cast<const int4*>(xp + k * kTile);
    const int4 xb = *reinterpret_cast<const int4*>(xp + k * kTile + 4);
    const int wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const int xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(wv[i], xv[j], acc[i][j]);
    }
  }
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = sx[t0 + j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float c = __ldg(sw + o0 + i), b = __ldg(bias + o0 + i);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = dequant(acc[i][j], s[j], c, b);
      v[j] = relu ? fmaxf(y, 0.f) : y;
    }
    float4* dst = reinterpret_cast<float4*>(out + (o0 + i) * kTile + t0);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 2)
int8_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long n,
                long long dir_div, const int* __restrict__ w, const float* __restrict__ scale,
                const float* __restrict__ bias, const QLayout L, float* __restrict__ rgb,
                float* __restrict__ sigma) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cap = L.ldw > L.ldv ? L.ldw : L.ldv;
  float* xin = smem;                       // [6][kTile] points, dirs
  float* enc = xin + 6 * kTile;            // [kEncRows][kTile] f32 encode
  float* act = enc + kEncRows * kTile;     // [cap][kTile] f32 layer output
  float* sx = act + cap * kTile;           // [kTile] per-sample scales
  int* xw = reinterpret_cast<int*>(sx + kTile);  // [(kEncX + cap) / 4][kTile] codes
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const int ldw = L.ldw, ldv = L.ldv;

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
  // are zero, so they never raise an absmax and quantize to zero codes.
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

  // Trunk. A layer's products overwrite act only after the barrier that
  // ends quantize, which read it.
  for (int i = 0; i < L.depth; ++i) {
    int k;
    if (i == 0) {
      quantize(enc, kEncX, nullptr, 0, sx, xw);
      k = kEncX;
    } else if (L.skip[i]) {
      quantize(enc, kEncX, act, ldw, sx, xw);
      k = kEncX + ldw;
    } else {
      quantize(act, ldw, nullptr, 0, sx, xw);
      k = ldw;
    }
    qdense(w + L.w_dense[i], ldw, k / 4, xw, sx, scale + L.sb_dense[i], bias + L.sb_dense[i],
           true, act);
    __syncthreads();
  }

  // The codes of h serve both the sigma head and the bottleneck.
  quantize(act, ldw, nullptr, 0, sx, xw);

  // Sigma head: four threads per sample, each a strided quarter of the
  // int32 dot product, summed by shuffles inside their quad (exact).
  {
    const int t = tid >> 2, part = tid & 3;
    const int* wa = w + L.w_alpha;
    int acc = 0;
    for (int k = part; k < ldw / 4; k += 4) acc = __dp4a(__ldg(wa + k * kHeadLd), xw[k * kTile + t], acc);
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
    const long long s = base + t;
    if (part == 0 && s < n) {
      sigma[s] = fmaxf(dequant(acc, sx[t], __ldg(scale + L.sb_alpha), __ldg(bias + L.sb_alpha)),
                       0.f);
    }
  }

  if (kSigmaOnly) {
    for (int idx = tid; idx < 3 * kTile; idx += kThreads) {
      const long long s = base + idx / 3;
      if (s < n) rgb[base * 3 + idx] = 0.f;
    }
    return;
  }

  // Bottleneck (no activation), then the view layer over [bottleneck,
  // dirs_enc] with one scale per sample for the whole row.
  qdense(w + L.w_bneck, ldw, ldw / 4, xw, sx, scale + L.sb_bneck, bias + L.sb_bneck, false, act);
  __syncthreads();
  quantize(act, ldw, enc + kEncX * kTile, kEncD, sx, xw);
  qdense(w + L.w_view, ldv, (ldw + kEncD) / 4, xw, sx, scale + L.sb_view, bias + L.sb_view, true,
         act);
  __syncthreads();
  quantize(act, ldv, nullptr, 0, sx, xw);

  // Rgb head with sigmoid: one thread per (sample, channel).
  if (tid < 3 * kTile) {
    const int t = tid / 3, c = tid % 3;
    const int* wr = w + L.w_rgb + c;
    int acc = 0;
    for (int k = 0; k < ldv / 4; ++k) acc = __dp4a(__ldg(wr + k * kHeadLd), xw[k * kTile + t], acc);
    const long long s = base + t;
    if (s < n) {
      const float y = dequant(acc, sx[t], __ldg(scale + L.sb_rgb + c), __ldg(bias + L.sb_rgb + c));
      rgb[s * 3 + c] = 1.f / (1.f + expf(-y));
    }
  }
}

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const int* w, const float* scale, const float* bias, const QLayout& L,
                   float* rgb, float* sigma, cudaStream_t stream) {
  const int cap = L.ldw > L.ldv ? L.ldw : L.ldv;
  const size_t smem = sizeof(float) * kTile * (6 + kEncRows + cap + 1) +
                      sizeof(int) * kTile * ((kEncX + cap) / 4);
  auto kernel = int8_mlp_kernel<kSigmaOnly>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(pts, dirs, n, dir_div, w,
                                                                   scale, bias, L, rgb, sigma);
  return cudaGetLastError();
}

}  // namespace

// pts (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; words (int32), scales and biases (f32) as packed by
// pack_int8_params; layout: kLayoutLen host int64 offsets; rgb (n, 3) and
// sigma (n,) f32 outputs. Returns a cudaError_t value (0 = launched).
extern "C" int nerf_int8_mlp_forward(const void* pts, const void* dirs, long long n,
                                     long long dir_div, const void* words, const void* scales,
                                     const void* biases, const long long* layout, int layout_len,
                                     int ldw, int ldv, int depth, int sigma_only, void* rgb,
                                     void* sigma, int device, void* stream) {
  QLayout L;
  if (!parse_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(pts);
  const float* d = static_cast<const float*>(dirs);
  const int* w = static_cast<const int*>(words);
  const float* sc = static_cast<const float*>(scales);
  const float* b = static_cast<const float*>(biases);
  float* o_rgb = static_cast<float*>(rgb);
  float* o_sigma = static_cast<float*>(sigma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, sc, b, L, o_rgb, o_sigma, s)
                   : launch<false>(p, d, n, dir_div, w, sc, b, L, o_rgb, o_sigma, s);
  return static_cast<int>(err);
}
