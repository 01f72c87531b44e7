// Fused NeRF MLP forward in float32 on the CUDA cores (sm_90a) for networks
// past width 512: trunk or view widths from 513 up to 1024, up to 32 dense
// layers (fused_mlp_wide1k.cuh). The positional encode, the trunk with its
// skip layer, the sigma head and, unless sigma_only, the bottleneck, the
// view layer and the rgb head, in one persistent kernel; activations never
// leave the SM.
//
// Replaces nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t (the Pallas
// call at fused_mlp.py:779 -> :795) for dtype="float32" where the wide f32
// kernel (fused_mlp_wide_f32.cu: widths up to 512) stops; the JAX kernel
// serves any width that is a multiple of 128 (fused_mlp.py::supports_arch).
// fused_mlp_wide_f32.cu is unchanged and still serves every network up to
// width 512 (and runs the wide K2's record pass). This kernel has no record
// mode: K2 stops at width 512.
//
// Numerics: fused_mlp_wide_f32.cu's, true float32. Every product is an f32
// fmaf on the CUDA cores, summed over K in order (a skip layer's encode
// rows before its trunk rows, the view layer's trunk rows before its
// dir-encode rows), then the bias; the encode (exact sincosf), ReLU, the
// heads and the sigmoid are f32. Only the summation order differs from the
// plain version.
//
// What bounds it on the H100: the CUDA cores. At 1024/512/8 a fine sample
// costs 18.1 MFLOP, 425 ms a 8192 x 192 call at the 67 TFLOP/s f32 peak.
// The <= 512 kernel's 64-sample tile does not fit at width 1024 (256 KB of
// f32 activations); this kernel is that kernel on a tile of half the rows:
// - a persistent grid, one CTA of 256 threads an SM, walking 32-sample
//   tiles; warp w owns rows 8 (w % 4) .. + 7 and half h = w / 4 of every
//   layer's 128-column groups (the even groups, or the odd), lane l the
//   columns 4 l + 128 (2 j + h) + e (j, e < 4): 128 f32 accumulators a
//   thread, fed per k by two broadcast float4 loads of A and up to four
//   conflict-free float4 loads of B. Interleaving the groups keeps the two
//   halves' work within one group of each other at every width;
// - the activations (32 x 1024 f32, 128 KB) and encodes (32 x 96 f32) lie
//   in shared memory transposed, K-major ([k][row]), which each layer's
//   epilogue overwrites in place behind a barrier of the CTA;
// - thread 0 copies the weights, 8 K-rows of a segment wider than 512 or 16
//   of a narrower one (PackedMLP.weights, K-major (K, ld): one contiguous
//   run, at most 32 KB) at a time, with one cp.async.bulk onto an mbarrier,
//   into a ring of 2 stages, one chunk ahead across layers and tiles, each
//   stage refilled once the CTA has passed the barrier after its last reads.
// The f32 pack streams from L2 once per 32-sample tile: 36.2 MB a tile at
// 1024/512/8, 1.78 TB a fine 8192 x 192 call.
// Shared memory: ring 64 KB, activations 128 KB, encodes 12 KB, heads 16 KB,
// the chunk table 1 KB: 221 KB of the 227 KB a block may use.

#include "fused_mlp_f32tc.cuh"
#include "fused_mlp_wide1k.cuh"

namespace {

using namespace nerf;
using namespace nerf::tc;
using namespace nerf::wide1k;
using f32tc::enc_at;
using f32tc::head_row;
using f32tc::head_sum;

constexpr int kBlock = 32;                                 // samples a tile
constexpr int kThreads = 256;                              // 4 row groups x 2 column halves
constexpr int kRingStages = 2;
constexpr int kRingFloats = 8 * kWide1kMaxWidth;           // 32 KB a stage
constexpr int kMaxSegs = 2 * kWideMaxDepth + 3;           // segments a forward reads

// K rows a ring chunk of a segment nn columns wide holds (32 KB at most; a
// multiple of 8, as every segment's K is).
__device__ __forceinline__ int chunk_rows(int nn) { return nn > kWide1kMaxWidth / 2 ? 8 : 16; }

struct Seg {
  long long off;
  int k, n;
};

// Shared memory, in bytes from the dynamic base.
constexpr int kActOff = kRingStages * kRingFloats * 4;         // ring first
constexpr int kEncXOff = kActOff + kWide1kMaxWidth * kBlock * 4;
constexpr int kEncDOff = kEncXOff + kEncX * kBlock * 4;
constexpr int kHeadOff = kEncDOff + kEncD * kBlock * 4;        // alpha [1024], rgb [1024][3]
constexpr int kSegOff = kHeadOff + 4 * kWide1kMaxWidth * 4;    // the chunk table
constexpr int kBarOff = kSegOff + kMaxSegs * static_cast<int>(sizeof(Seg));
constexpr int kSmemBytes = kBarOff + kRingStages * 8;          // full[kRingStages]
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

// The weight ring. All threads walk the chunks in order (it: chunks
// consumed); thread 0 also copies them, `laps` times over the segment
// table (i, c: the next chunk to copy).
struct Ring {
  const float* ring;
  uint32_t ring_s, bars;
  const float* w;
  const Seg* segs;
  int count, i, c;
  long long laps, it;

  // Thread 0: copies the next chunk, if any, into stage `stage`.
  __device__ __forceinline__ void put(int stage) {
    if (laps <= 0) return;
    const Seg& sg = segs[i];
    const int ck = chunk_rows(sg.n);
    const uint32_t bytes = static_cast<uint32_t>(min(ck, sg.k - c) * sg.n * 4);
    mbar_expect_tx(bars + 8 * stage, bytes);
    bulk_copy(ring_s + stage * kRingFloats * 4, w + sg.off + static_cast<long long>(c) * sg.n,
              bytes, bars + 8 * stage);
    c += ck;
    if (c >= sg.k) {
      c = 0;
      if (++i == count) {
        i = 0;
        --laps;
      }
    }
  }
  // Waits for the next chunk; returns it (rows of its segment's n floats).
  __device__ __forceinline__ const float* acquire() {
    const int stage = static_cast<int>(it & 1);
    mbar_wait(bars + 8 * stage, static_cast<uint32_t>((it >> 1) & 1));
    return ring + stage * kRingFloats;
  }
  // After every thread's reads of the acquired chunk: refills its stage.
  __device__ __forceinline__ void release() {
    __syncthreads();
    if (threadIdx.x == 0) put(static_cast<int>(it & 1));
    ++it;
  }
};

// A layer input: K rows of 32 samples, a[k * 32 + row].
struct Src {
  const float* a;
  int k;
};

// acc (rows 8 (w % 4) + r, columns 4 lane + 128 (2 j + h) + e at
// acc[r][4 j + e]) += the input times the next chunks of a segment n
// columns wide. kJ: the number of this warp's column groups when n is a
// multiple of 128 (all of them valid), else 0 (each group checked against
// n). Each 8 rows of a chunk are unrolled with no check, so that ptxas can
// issue a row's loads ahead of the last row's products.
template <int kJ>
__device__ __forceinline__ void accumulate(float (&acc)[8][16], Ring& q, const Src& src, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 8, h = warp >> 2;
  const int ck = chunk_rows(n);
  for (int c = 0; c < src.k; c += ck) {
    const float* b = q.acquire();
    auto step = [&](int kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(src.a + (c + kk) * kBlock + row0);
      const float4 a1 = *reinterpret_cast<const float4*>(src.a + (c + kk) * kBlock + row0 + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < (kJ ? kJ : 4); ++j) {
        const int col = 4 * lane + 128 * (2 * j + h);
        if (kJ || col < n) {
          const float4 bv = *reinterpret_cast<const float4*>(b + kk * n + col);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc[r][4 * j] = fmaf(av[r], bv.x, acc[r][4 * j]);
            acc[r][4 * j + 1] = fmaf(av[r], bv.y, acc[r][4 * j + 1]);
            acc[r][4 * j + 2] = fmaf(av[r], bv.z, acc[r][4 * j + 2]);
            acc[r][4 * j + 3] = fmaf(av[r], bv.w, acc[r][4 * j + 3]);
          }
        }
      }
    };
    const int kc = min(ck, src.k - c);
    for (int kk0 = 0; kk0 < kc; kk0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) step(kk0 + u);
    }
    q.release();
  }
}

// accumulate<this warp's groups or 0> for a runtime n, inlined so that the
// accumulators stay in registers.
__device__ __forceinline__ void accumulate_any(float (&acc)[8][16], Ring& q, const Src& src,
                                               int n) {
  const int h = threadIdx.x >> 7;   // warp / 4, uniform across the warp
  switch (n % 128 ? 0 : (n / 128 + 1 - h) / 2) {
    case 1: accumulate<1>(acc, q, src, n); break;
    case 2: accumulate<2>(acc, q, src, n); break;
    case 3: accumulate<3>(acc, q, src, n); break;
    case 4: accumulate<4>(acc, q, src, n); break;
    default: accumulate<0>(acc, q, src, n); break;
  }
}

// One layer of n output columns: act = relu?(s1 w1 [+ s2 w2] + bias), in
// place (the ring's barrier after the last chunk ends every read of the
// inputs); then a barrier for what reads the output.
__device__ __forceinline__ void dense_layer(Ring& q, const Src& s1, const Src& s2, int n,
                                            const float* __restrict__ bias, bool relu,
                                            float* act) {
  float acc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[r][e] = 0.f;
  }
  accumulate_any(acc, q, s1, n);
  if (s2.k > 0) accumulate_any(acc, q, s2, n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 8, h = warp >> 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col0 = 4 * lane + 128 * (2 * j + h);
    if (col0 >= n) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float b = __ldg(bias + col0 + e);
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        v[r] = acc[r][4 * j + e] + b;
        if (relu) v[r] = fmaxf(v[r], 0.f);
      }
      float* dst = act + (col0 + e) * kBlock + row0;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();
}

// Tiles of 32 samples (rows past n read zeros and are never stored).
template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_wide1k_f32_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                            long long n, long long dir_div, const float* __restrict__ w,
                            const float* __restrict__ bias, const WideLayout L,
                            float* __restrict__ rgb, float* __restrict__ sigma) {
  extern __shared__ __align__(1024) uint8_t smem[];
  float* act = reinterpret_cast<float*>(smem + kActOff);
  float* enc_x = reinterpret_cast<float*>(smem + kEncXOff);
  float* enc_d = reinterpret_cast<float*>(smem + kEncDOff);
  float* w_alpha = reinterpret_cast<float*>(smem + kHeadOff);
  float* w_rgb = w_alpha + kWide1kMaxWidth;
  Seg* segs = reinterpret_cast<Seg*>(smem + kSegOff);
  const uint32_t bars = smem_u32(smem + kBarOff);
  const long long tiles = (n + kBlock - 1) / kBlock;
  const int tid = threadIdx.x;
  const int ldw = L.ldw, ldv = L.ldv;

  // The segments in the order the layers read them (thread 0's table).
  int count = 0;
  auto add = [&](long long off, int k, int nn) {
    if (tid == 0) segs[count] = {off, k, nn};
    ++count;
  };
  add(L.w_dense[0], kEncX, ldw);
  for (int i = 1; i < L.depth; ++i) {
    if (L.w_skip[i] >= 0) add(L.w_skip[i], kEncX, ldw);
    add(L.w_dense[i], ldw, ldw);
  }
  if (!kSigmaOnly) {
    add(L.w_bneck, ldw, ldw);
    add(L.w_view, ldw, ldv);
    add(L.w_view_dir, kEncD, ldv);
  }
  for (int k = tid; k < ldw; k += kThreads) w_alpha[k] = __ldg(w + L.w_alpha + k);
  for (int k = tid; k < 3 * ldv; k += kThreads) w_rgb[k] = __ldg(w + L.w_rgb + k);
  Ring q{reinterpret_cast<const float*>(smem), smem_u32(smem), bars, w, segs, count, 0, 0,
         (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x, 0};
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the heads' weights, the chunk table and the barriers
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) q.put(s);
  }

  // The heads: threads 4 i .. 4 i + 3 (warps 0-3) on row i.
  const bool heads = tid < 4 * kBlock;
  const int hrow = head_row();
  auto row = [&](int i) { return act[i * kBlock + hrow]; };
  const Src ex{enc_x, kEncX}, ed{enc_d, kEncD}, trunk{act, ldw}, none{nullptr, 0};

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // The tile's encode, rows past n zeros. (The last tile's reads of the
    // encodes ended behind its layers' barriers.)
    for (int i = tid; i < kBlock * (kEncX + kEncD); i += kThreads) {
      const int r = i & (kBlock - 1), j = i / kBlock;
      const bool dir = j >= kEncX;
      const long long s = tile * kBlock + r;
      float x[3] = {0.f, 0.f, 0.f};
      if (s < n) {
        const float* src = dir ? dirs + (s / dir_div) * 3 : pts + s * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = src[c];
      }
      if (dir) {
        enc_d[(j - kEncX) * kBlock + r] = enc_at(x[0], x[1], x[2], j - kEncX, 3 + 6 * kDBands);
      } else {
        enc_x[j * kBlock + r] = enc_at(x[0], x[1], x[2], j, 3 + 6 * kXBands);
      }
    }
    __syncthreads();

    // The trunk, then (unless sigma-only) the bottleneck (no activation)
    // and the view layer (bottleneck part plus dir-encode part, ReLU), from
    // one call site: each instance of the layer is large.
    const long long s = tile * kBlock + hrow;
    const bool mine = heads && !(tid & 3) && s < n;   // the first of the row's four threads
    for (int i = 0; i < (kSigmaOnly ? L.depth : L.depth + 2); ++i) {
      const bool skip = i > 0 && i < L.depth && L.w_skip[i] >= 0;
      const Src s1 = (i == 0 || skip) ? ex : trunk;
      const Src s2 = skip ? trunk : (i == L.depth + 1 ? ed : none);
      const long long b = i < L.depth ? L.b_dense[i] : (i == L.depth ? L.b_bneck : L.b_view);
      dense_layer(q, s1, s2, i == L.depth + 1 ? ldv : ldw, bias + b, i != L.depth, act);
      if (i == L.depth - 1 && heads) {
        // Sigma head. Its reads end before the next epilogue (the
        // bottleneck's, or the next tile's first), behind the ring's
        // barriers.
        const float sig =
            fmaxf(head_sum(row, ldw, w_alpha, 1, 0) + __ldg(bias + L.b_alpha), 0.f);
        if (mine) sigma[s] = sig;
        if (kSigmaOnly && mine) {
          rgb[s * 3] = 0.f;
          rgb[s * 3 + 1] = 0.f;
          rgb[s * 3 + 2] = 0.f;
        }
      }
    }
    if (!kSigmaOnly && heads) {
      // Rgb head with sigmoid; its reads end before the next tile's first
      // epilogue, behind the ring's barriers.
      float out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = head_sum(row, ldv, w_rgb, 3, c) + __ldg(bias + L.b_rgb + c);
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

template <bool kSigmaOnly>
cudaError_t launch(const float* pts, const float* dirs, long long n, long long dir_div,
                   const float* w, const float* bias, const WideLayout& L, float* rgb,
                   float* sigma, int device, cudaStream_t stream) {
  auto kernel = fused_mlp_wide1k_f32_kernel<kSigmaOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kBlock - 1) / kBlock;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(pts, dirs, n, dir_div, w, bias, L, rgb, sigma);
  return cudaGetLastError();
}

}  // namespace

// nerf_fused_mlp_wide_f32_forward's contract for widths up to 1024: pts
// (n, 3) f32; dirs (ceil(n / dir_div), 3) f32, sample s reads row
// s / dir_div; weights (f32, 16-byte aligned) and biases (f32) as
// pack_params writes them, layout: its kWideLayoutLen host int64 offsets;
// rgb (n, 3) and sigma (n,) f32 outputs. Returns a cudaError_t value (0 =
// launched).
extern "C" int nerf_fused_mlp_wide1k_f32_forward(const void* pts, const void* dirs, long long n,
                                                 long long dir_div, const void* weights,
                                                 const void* biases, const long long* layout,
                                                 int layout_len, int ldw, int ldv, int depth,
                                                 int sigma_only, void* rgb, void* sigma,
                                                 int device, void* stream) {
  WideLayout L;
  if (!parse_wide1k_layout(layout, layout_len, ldw, ldv, depth, &L) || dir_div < 1 || n < 0 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
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
  err = sigma_only ? launch<true>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, device, s)
                   : launch<false>(p, d, n, dir_div, w, b, L, o_rgb, o_sigma, device, s);
  return static_cast<int>(err);
}
