// The split-f32 tensor-core device code of the fused NeRF MLP's float32
// mode, shared by the forward (fused_mlp_f32tc.cu, K1) and the f32
// backward's recompute (fused_mlp_bwd_tc.cu, K2), so that K2 recomputes
// K1's activations bit for bit: the same operand planes, instruction
// shape, k-order, epilogue and head sums.
//
// Arithmetic (bf16x6, the counterpart of the JAX kernel's
// Precision.HIGHEST, which runs f32 as bf16 passes on the MXU): each f32
// operand x splits into three bf16 pieces, hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid), rounded to nearest even (both
// subtractions are exact, and hi + mid + lo = x). A layer's product takes
// six of the nine piece products, each one wgmma m64n64k16 (bf16 in, f32
// accumulate), per k-step of 16 in this order:
//   x.lo w.hi, x.hi w.lo, x.mid w.mid, x.mid w.hi, x.hi w.mid  -> small
//   x.hi w.hi                                                  -> big
// into two f32 accumulators, and the layer's output is (big + small) +
// bias. The three products dropped are below 2^-24 of the product. Each
// wgmma rounds its accumulator once; the small terms (below 2^-7 of the
// product) round in their own accumulator, so the big one takes one
// rounding a k-step, not six (the CPU tests' emulation: with one
// accumulator, 2.2x the plain f32 product's distance from float64 on the
// lego fine network; with two, 0.3x). A layer with two inputs runs the
// k-steps of its first source, then of its second, into the same
// accumulators: a skip layer's encode part before its trunk part, the
// view layer's trunk part before its dir-encode part.
//
// Operands, both from shared memory. B, the weights: the pack
// (PackedMLP.weights_f32tc, fused_mlp.py::f32tc_tile) holds each layer
// segment as chunks of 16 k-rows, each chunk its hi, mid and lo planes
// back to back in wgmma's no-swizzle K-major core-matrix order: one
// contiguous run that one cp.async.bulk copies into a ring stage (24 KB at
// width 256). A, the activations or the encode: a 64-row block's hi, mid
// and lo planes (Planes), which each layer's epilogue writes (split once
// per value) for the next layer to read, and which hold the f32 values
// exactly (hi + mid + lo), so the heads read them back unrounded. With A
// from registers instead, split each k-step, ptxas serialized the wgmmas
// of any layer with more than one accumulator in flight (C7512).
//
// Rows and columns. The two accumulators of 64 columns take 64 registers
// a piece, so a warpgroup holds two pieces: a layer runs on a block of 64
// rows, consumer warpgroup g (threads 128 g ..) on pieces 2 g and 2 g + 1
// (columns 128 g .. + 127) of all 64. The two warpgroups meet at a
// barrier of all 256 consumer threads before the epilogue overwrites the
// block's planes, and after it.

#pragma once

#include <string.h>

#include "fused_mlp_tc.cuh"

namespace nerf {
namespace f32tc {

using namespace tc;

constexpr int kStepK = 16;                                     // k rows a chunk: one k-step
constexpr int kPlanes = 3;                                     // hi, mid, lo
constexpr int kStageBytesF = kPlanes * kStepK * kMaxWidth * 2; // 24 KB
constexpr int kMaxSegs = 2 * kMaxDepth + 3;           // segments a forward reads

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// hi, mid and lo of the pair (x.x in the low half), as bf16x2 registers.
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x.x, hf.x), r1 = __fsub_rn(x.y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
}

__device__ __forceinline__ float pick(float x0, float x1, float x2, int i) {
  return i == 0 ? x0 : (i == 1 ? x1 : x2);
}

// Entry j of the positional encode of (x0, x1, x2): the identity, then
// per band a sin triple and a cos triple at frequency 2^band (no pi); 0
// from `count` on (the padding).
__device__ __forceinline__ float enc_at(float x0, float x1, float x2, int j, int count) {
  if (j >= count) return 0.f;
  if (j < 3) return pick(x0, x1, x2, j);
  const int band = (j - 3) / 6, o = j - 3 - 6 * band;
  const float arg = pick(x0, x1, x2, o % 3) * __int_as_float((127 + band) << 23);   // exact
  float s, c;
  sincosf(arg, &s, &c);
  return o < 3 ? s : c;
}

// ---- A operands: three bf16 planes of a 64-row block in shared memory ----

// Byte offset of (row, col) in a 64-row plane, wgmma's no-swizzle K-major
// core-matrix order: 8 x 8 blocks of 16-byte rows, the eight row groups
// of one 8-column group contiguous (1 KB), column groups 1 KB apart.
__device__ __forceinline__ uint32_t p_off(int row, int col) {
  return (col >> 3) * 1024 + (row >> 3) * 128 + (row & 7) * 16 + (col & 7) * 2;
}

// The hi, mid and lo planes of a block's activations or encode, `stride`
// bytes apart from `base` (16-byte aligned).
struct Planes {
  uint8_t* base;
  int stride;
  // The wgmma descriptor of k-step k0 of plane q.
  __device__ __forceinline__ uint64_t desc_at(int q, int k0) const {
    return desc(smem_u32(base + q * stride) + (k0 >> 3) * 1024, 1024, 128);
  }
  // Stores the split of v at (row, col) and (row, col + 1), col even.
  __device__ __forceinline__ void put(int row, int col, float2 v) const {
    uint32_t h, m, l;
    split3(v, h, m, l);
    const uint32_t off = p_off(row, col);
    *reinterpret_cast<uint32_t*>(base + off) = h;
    *reinterpret_cast<uint32_t*>(base + stride + off) = m;
    *reinterpret_cast<uint32_t*>(base + 2 * stride + off) = l;
  }
  // The f32 value at (row, col): (hi + mid) + lo, exact.
  __device__ __forceinline__ float get(int row, int col) const {
    const uint32_t off = p_off(row, col);
    const float h = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(base + off));
    const float m = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(base + stride + off));
    const float l =
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(base + 2 * stride + off));
    return (h + m) + l;
  }
};

// The consumer threads' barrier (threads 0-255, named barrier 3).
__device__ __forceinline__ void consumers_barrier() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// Fills the encode planes of a 64-row block from its inputs x (rows of
// [6][kRows], points then dirs): the points' (count 63 of 64 columns,
// unless ex.base is null) and the dirs' (27 of 32, unless ed.base is
// null), split; ends behind a barrier that makes them visible to wgmma.
__device__ __forceinline__ void fill_encode(const float* x, const Planes& ex, const Planes& ed) {
  for (int i = threadIdx.x; i < 64 * (kEncX + kEncD) / 2; i += kConsumers) {
    const int row = i & 63, col = 2 * (i >> 6);
    const bool dirs = col >= kEncX;
    const Planes& pl = dirs ? ed : ex;
    if (pl.base == nullptr) continue;
    const int c0 = dirs ? 3 : 0, j = dirs ? col - kEncX : col;
    const int count = dirs ? 3 + 6 * kDBands : 3 + 6 * kXBands;
    const float x0 = x[c0 * kRows + row], x1 = x[(c0 + 1) * kRows + row];
    const float x2 = x[(c0 + 2) * kRows + row];
    pl.put(row, j, make_float2(enc_at(x0, x1, x2, j, count), enc_at(x0, x1, x2, j + 1, count)));
  }
  fence_async_smem();
  consumers_barrier();
}

// Keeps the compiler from moving accumulator accesses across the wgmmas.
template <int NP>
__device__ __forceinline__ void fence_acc2(float (&big)[2][32], float (&small)[2][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(big[p][i]), "+f"(small[p][i])::"memory");
  }
}

// One k-step: the six products of A's k-step k0 into this warpgroup's NP
// pieces (from piece p0 on), from a chunk at shared address b of a
// segment n columns wide (plane q at b + 32 n q).
template <int NP>
__device__ __forceinline__ void k_step(float (&big)[2][32], float (&small)[2][32], const Planes& a,
                                       int k0, uint32_t b, int n, int p0, bool first) {
  constexpr int kA[6] = {2, 0, 1, 1, 0, 0};   // x piece of product j
  constexpr int kB[6] = {0, 2, 1, 0, 1, 0};   // w plane of product j
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const uint64_t da = a.desc_at(kA[j], k0);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint64_t db = desc(b + kB[j] * (n * kStepK * 2) + (p0 + p) * 1024, n * 16, 128);
      if (j < 5) {
        wgmma_64<0, 0>(small[p], da, db, (first && j == 0) ? 0 : 1);
      } else {
        wgmma_64<0, 0>(big[p], da, db, first ? 0 : 1);
      }
    }
  }
}

// Accumulates A (k columns, a multiple of 16) times the next k / 16 ring
// chunks into the NP pieces; every consumer walks every chunk.
template <int NP, class Q>
__device__ __forceinline__ void products(float (&big)[2][32], float (&small)[2][32], Q& q,
                                         const Planes& a, int k, int n, int p0, bool& first) {
#pragma unroll 1
  for (int k0 = 0; k0 < k; k0 += kStepK) {
    const uint32_t b = q.acquire();
    if constexpr (NP > 0) k_step<NP>(big, small, a, k0, b, n, p0, first);
    first = false;
    wgmma_commit();
    q.advance();
  }
}

// One layer on a 64-row block: out(row, col, v0, v1) gets act(a1 w1 [+
// a2 w2] + bias) at columns col and col + 1 (n_valid: columns with a
// bias; the rest add 0), rows 0-63 of the block, for this warpgroup's NP
// pieces from piece p0. The outputs may overwrite a1's planes: they are
// written once every wgmma of the block has read them.
template <int NP, class Q, class Out>
__device__ __forceinline__ void layer(Q& q, const Planes& a1, int k1, const Planes& a2, int k2,
                                      int n, int p0, const float* __restrict__ bias, int n_valid,
                                      bool relu, Out&& out) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float big[2][32], small[2][32];
  fence_acc2<NP>(big, small);
  bool first = true;
  products<NP>(big, small, q, a1, k1, n, p0, first);
  if (k2 > 0) products<NP>(big, small, q, a2, k2, n, p0, first);
  wgmma_wait<0>();
  fence_acc2<NP>(big, small);
  q.release();
  consumers_barrier();   // every wgmma of the block has read its A
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // Accumulator element 4 j + 2 r + e sits at row r0 + 8 r and
      // column 8 j + 2 (lane % 4) + e of the piece.
      const int col = (p0 + p) * kPiece + j * 8 + 2 * (lane & 3);
      float2 b = make_float2(0.f, 0.f);
      if (col < n_valid) b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v0 = (big[p][4 * j + 2 * r] + small[p][4 * j + 2 * r]) + b.x;
        float v1 = (big[p][4 * j + 2 * r + 1] + small[p][4 * j + 2 * r + 1]) + b.y;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        out(r0 + 8 * r, col, make_float2(v0, v1));
      }
    }
  }
  fence_async_smem();
  consumers_barrier();   // the block's outputs, whole, for what reads them next
}

// The layer for this warpgroup's share of np pieces (np in 1..4: pieces
// 2 g and 2 g + 1, where they exist), inlined at each call site.
template <class Q, class Out>
__device__ __forceinline__ void layer_any(int np, Q& q, const Planes& a1, int k1, const Planes& a2,
                                          int k2, int n, const float* __restrict__ bias,
                                          int n_valid, bool relu, Out&& out) {
  const int p0 = 2 * ((threadIdx.x >> 7) & 1);
  switch (min(max(np - p0, 0), 2)) {
    case 0: layer<0>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, out); break;
    case 1: layer<1>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, out); break;
    default: layer<2>(q, a1, k1, a2, k2, n, p0, bias, n_valid, relu, out); break;
  }
}

// The row of a 64-row block a consumer thread's head sums work on:
// threads 4 i .. 4 i + 3 take row i.
__device__ __forceinline__ int head_row() { return (threadIdx.x & 255) >> 2; }

// Head column c's sum for head_row(): the row (x(i), i < k, k a multiple
// of 4) dot w[i * stride + c]; the four threads sum one quarter each, in
// order, and add the quarters as (q0 + q1) + (q2 + q3), so all four hold
// the same value.
template <class Row>
__device__ __forceinline__ float head_sum(const Row& x, int k, const float* w, int stride, int c) {
  const int h = k >> 2, i0 = (threadIdx.x & 3) * h;
  float acc = 0.f;
  for (int i = i0; i < i0 + h; ++i) acc = fmaf(x(i), w[i * stride + c], acc);
  acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
  return acc + __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
}

// ---- The f32 backward's workspace (fused_mlp_bwd_tc.cu) ----

// A tile of 128 samples holds, in this order, its point encode (64
// features), its dir encode (32), each trunk layer's output and the
// bottleneck's (ldw each), the view layer's (ldv): ws_stride(...) floats.
// A slot of f features keeps the samples (k) x features (n) in the
// B-fragment order of fused_mlp.py::mma_tile (blocks of 16 samples x 8
// features; lane 4 g + t holds four samples of feature 8 nb + g), so that
// the backward's dW products load a block with one vector load a lane.
// The index of (sample row, feature col) in a slot of n8 feature blocks:
__device__ __forceinline__ int ws_index(int row, int col, int n8) {
  const int r = row & 15;
  return (((row >> 4) * n8 + (col >> 3)) * 32 + 4 * (col & 7) + (r & 3)) * 4 + (r >> 2);
}

__host__ __device__ __forceinline__ long long ws_stride(int depth, int ldw, int ldv) {
  return 128LL * (kEncX + kEncD + (depth + 1) * ldw + ldv);
}

// Slot i of a tile's workspace: i < depth the trunk layers, depth the
// bottleneck, depth + 1 the view layer.
__device__ __forceinline__ float* ws_slot(float* tile_ws, int i, int ldw) {
  return tile_ws + 128 * (kEncX + kEncD + i * ldw);
}

// ---- The weight chunks ----

struct Seg {
  long long off;
  int k, n;
};

// The segments of the trunk, in the order its layers read them: layer
// 0, then per layer its encode part (skip layers) and its trunk part,
// appended at segs[c]; P: the pack's offsets (layout_f32tc). -> the new
// count.
__device__ __forceinline__ int trunk_segments(const Layout& P, int nw, Seg* segs, int c) {
  segs[c++] = {P.w_dense[0], kEncX, nw};
  for (int i = 1; i < P.depth; ++i) {
    if (P.w_skip[i] >= 0) segs[c++] = {P.w_skip[i], kEncX, nw};
    segs[c++] = {P.w_dense[i], nw, nw};
  }
  return c;
}

// The color branch's: the bottleneck, the view layer's trunk and
// dir-encode parts.
__device__ __forceinline__ int color_segments(const Layout& P, int nw, int nv, Seg* segs, int c) {
  segs[c++] = {P.w_bneck, nw, nw};
  segs[c++] = {P.w_view, nw, nv};
  segs[c++] = {P.w_view_dir, kEncD, nv};
  return c;
}

// A walk over the chunks of a segment table, `laps` times over.
struct Chunks {
  const Seg* segs;
  int count, laps, i, c;
  __device__ __forceinline__ bool valid() const { return laps > 0; }
  __device__ __forceinline__ const __nv_bfloat16* src(const __nv_bfloat16* w) const {
    return w + segs[i].off + static_cast<long long>(c) * kPlanes * kStepK * segs[i].n;
  }
  __device__ __forceinline__ uint32_t bytes() const {
    return static_cast<uint32_t>(kPlanes * kStepK * segs[i].n * 2);
  }
  __device__ __forceinline__ void next() {
    if (++c * kStepK >= segs[i].k) {
      c = 0;
      if (++i == count) {
        i = 0;
        --laps;
      }
    }
  }
};

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// The weight ring, fed by thread 0 of the 256 consumer threads: the
// kernels have no producer warpgroup, so the launch bounds give every
// thread the registers the two accumulators and wgmma's pipeline need
// (with a producer warpgroup, the consumers have 168). Thread 0 copies in
// acquire(), where its warp waits for the chunk anyway: the chunk about to
// be acquired, if it is not copied yet (waiting for its stage), then the
// next one if its stage is already free, so one chunk runs ahead. (Copies
// issued as stages were released, in advance(), kept up to three ahead but
// delayed warp 0, and with it its warpgroup's wgmmas: 33.7 ms a fine call
// against 25.1, timed with tools/torch_k1_ablation.py.) start()
// walks a segment table `laps` times.
template <int S>
struct FedPipe {
  Pipe<S, kStageBytesF> q;             // the consumers' side
  int fill_stage;                      // thread 0's side: the next stage to fill,
  uint32_t fill_phase;                 // its phase,
  int ahead;                           // and the chunks copied, not yet acquired
  Chunks ch;
  const __nv_bfloat16* w;

  __device__ __forceinline__ void start(const Seg* segs, int count, int laps) {
    ch = Chunks{segs, count, laps, 0, 0};
  }
  // Thread 0: copies the next chunk into the fill stage, once it is free
  // (at once, or not at all unless `wait`).
  __device__ __forceinline__ void put(bool wait) {
    const uint32_t full = q.bars + 8 * fill_stage, empty = q.bars + 8 * (S + fill_stage);
    if (!wait && !mbar_test(empty, fill_phase ^ 1)) return;
    mbar_wait(empty, fill_phase ^ 1);
    mbar_expect_tx(full, ch.bytes());
    bulk_copy(q.ring + fill_stage * kStageBytesF, ch.src(w), ch.bytes(), full);
    ch.next();
    ++ahead;
    if (++fill_stage == S) {
      fill_stage = 0;
      fill_phase ^= 1;
    }
  }
  __device__ __forceinline__ uint32_t acquire() {
    if (threadIdx.x == 0) {
      if (ahead == 0) put(true);
      --ahead;
      if (ahead == 0 && ch.valid()) put(false);
    }
    return q.acquire();   // (its __syncwarp rejoins thread 0)
  }
  // After the wgmmas on the acquired chunk are committed: the chunk
  // before retires (an unconditional wait, so that ptxas sees it), and is
  // released.
  __device__ __forceinline__ void advance() {
    wgmma_wait<1>();
    if (q.pending >= 0) mbar_arrive(q.bars + 8 * (S + q.pending));
    q.pending = q.stage;
    if (++q.stage == S) {
      q.stage = 0;
      q.phase ^= 1;
    }
  }
  __device__ __forceinline__ void release() { q.release(); }
};

}  // namespace f32tc
}  // namespace nerf
