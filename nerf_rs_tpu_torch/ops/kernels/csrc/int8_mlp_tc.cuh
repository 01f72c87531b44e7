// The int8 W8A8 NeRF MLP's device code that both of its kernels run: the
// narrow one (int8_mlp_tc.cu: trunk and view widths up to 256, up to 16
// dense layers) and the wide one (int8_mlp_wide_tc.cu: up to 512 and 32).
// The same encode (sinf/cosf), the same row scale (__fdiv_rn), the same
// requantize (code_bits: the quotient rounded to nearest, then half to
// even, without a division), the same dequant as three rounded ops, the
// same s8 wgmma and the same 64-row code planes, so that the two kernels'
// arithmetic is one and the same (int8_mlp_tc.cu's header states it).

#pragma once

#include "fused_mlp_tc.cuh"

namespace nerf {
namespace int8 {

constexpr int kPiece = 64;                 // wgmma N of one instruction
constexpr int kRows = 64;                  // samples a tile (one wgmma M)
constexpr int kEncX = 64;                  // 63 point-encode rows, padded
constexpr int kEncD = 32;                  // 27 dir-encode rows, padded
constexpr int kEncStride = 100;            // f32 encode row stride: banks 4 apart a row

// The f32 encode of one tile row into er (points in [0, 63), dirs in
// [64, 91), the padding columns zero), split between the row's two
// threads with the same code in both: the first half writes the points'
// identity and bands 0-6, the second the dirs' identity and bands 0-3 and
// the points' bands 7-9 (42 sinf/cosf pairs each); each half's absmax of
// the point encode into mx and of the dir encode into md. A band is a sin
// triple and a cos triple at frequency 2^band (no pi), sinf and cosf as
// the plain version computes them.
__device__ __forceinline__ void encode_row(float* er, bool half, const float (&p)[3],
                                           const float (&d)[3], float& mx, float& md) {
  float* ibuf = er + (half ? kEncX : 0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = half ? d[c] : p[c];
    ibuf[c] = v;
    if (half) {
      md = fmaxf(md, fabsf(v));
    } else {
      mx = fmaxf(mx, fabsf(v));
    }
  }
#pragma unroll
  for (int z = 0; z < 5; ++z) ibuf[half ? 27 + z : 63] = 0.f;
#pragma unroll
  for (int u = 0; u < 7; ++u) {
    const bool dir_unit = half && u >= 3;
    const int band = half ? (u < 3 ? 7 + u : u - 3) : u;
    const float scale = __int_as_float((127 + band) << 23);   // 2^band, exact
    float* buf = er + (dir_unit ? kEncX : 0);
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = (dir_unit ? d[c] : p[c]) * scale;
      const float sv = sinf(x), cv = cosf(x);
      buf[3 + 6 * band + c] = sv;
      buf[6 + 6 * band + c] = cv;
      m = fmaxf(m, fmaxf(fabsf(sv), fabsf(cv)));
    }
    if (dir_unit) {
      md = fmaxf(md, m);
    } else {
      mx = fmaxf(mx, m);
    }
  }
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

// A row scale and its reciprocal rounded to nearest, __frcp_rn(s).
struct Scale {
  float s, rs;
};

__device__ __forceinline__ Scale row_scale(float m) {
  const float s = fmaxf(__fdiv_rn(m, 127.f), 1e-12f);
  return {s, __frcp_rn(s)};
}

// The int8 code of x at row scale s, clamp(rint(x / s), -127, 127) with
// x / s rounded to nearest as __fdiv_rn rounds it, in the low byte of the
// returned bits; without a division instruction, a conversion or a
// branch. The quotient: q0 = x * rs, then two corrections by its
// remainder, each r = x - s q exact by an FMA and q' = q + r rs rounded
// once (Markstein's theorem: with rs = 1/s rounded to nearest, a
// correction of a quotient within one ulp gives the quotient rounded to
// nearest; the first takes q0, within 1.5 ulps, within one). s is the
// row's absmax / 127 (or the 1e-12 floor, above it), so |x / s| <= 127 /
// (1 - 2^-24): no step overflows, the code never needs its clamp, and
// where x is small enough for a remainder to lose bits to underflow,
// |x / s| < 2^-60 and every candidate rounds to code 0. The quotient
// rounds to an integer, half to even, in the addition of 1.5 * 2^23 (whose
// ulp is 1): the sum's bits are 0x4B400000 plus the code, whose low byte
// is the code's. (A plain __fdiv_rn for every element, then a rintf and a
// conversion, was the first design's largest cost: its checked path
// branches, and zeros, half of a ReLU output, take its slow path.)
__device__ __forceinline__ uint32_t code_bits(float x, Scale sc) {
  float q = __fmul_rn(x, sc.rs);
  q = __fmaf_rn(__fmaf_rn(-sc.s, q, x), sc.rs, q);
  q = __fmaf_rn(__fmaf_rn(-sc.s, q, x), sc.rs, q);
  return __float_as_uint(__fadd_rn(q, 12582912.f));   // 1.5 * 2^23
}

// The codes of x and y in bytes 0 and 1.
__device__ __forceinline__ uint32_t code_pair(float x, float y, Scale sc) {
  return __byte_perm(code_bits(x, sc), code_bits(y, sc), 0x0040);
}

__device__ __forceinline__ uint32_t pack4(const float* x, Scale sc) {
  return __byte_perm(code_pair(x[0], x[1], sc), code_pair(x[2], x[3], sc), 0x5410);
}

// Byte offset of (row, col) in a 64-row code plane in K-major core-matrix
// order: 8 x 16 blocks of 16-byte rows, the 8 row groups of one 16-column
// group contiguous (1 KB). A k-step's two column groups lie 1 KB apart.
__device__ __forceinline__ int plane_off(int row, int col) {
  return (col >> 4) * (kRows * 16) + (row >> 3) * 128 + (row & 7) * 16 + (col & 15);
}

// d (64 x 64, s32) = a (64 x 32, s8) * b (32 x 64, s8) + (kAcc ? d : 0),
// both operands K-major from shared memory. kAcc is a constant, so the
// first k-step of a layer (kAcc = 0) does not read d: the epilogue may
// overwrite the accumulator registers without serializing the wgmmas.
template <int kAcc>
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(kAcc));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas.
template <int NP>
__device__ __forceinline__ void fence_acc(int (&acc)[4][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[p][i])::"memory");
  }
}

// The codes of 16 f32 values at scale s, as one 16-byte plane row.
__device__ __forceinline__ void store16(uint8_t* dst, const float* x, Scale s) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack4(x, s), pack4(x + 4, s), pack4(x + 8, s),
                                              pack4(x + 12, s));
}

}  // namespace int8
}  // namespace nerf
