// Error-compensated TF32 matrix products on Hopper's tensor cores, shared
// by K7 (flash_attention.cu) and K9 (ssd.cu).
//
// A float32 operand x is split into two TF32 values (10 explicit mantissa
// bits each), hi = rna(x) and lo = rna(x - hi), rna rounding to the
// nearest TF32 value with ties away from zero, as cvt.rna.tf32.f32 does.
// x - hi is exact in float32, |x - hi| <= 2^-11 |x| and |x - (hi + lo)|
// <= 2^-22 |x|. A product a.b is then three TF32 tensor-core products
// into one float32 accumulator, the small terms first:
//
//   d += lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b)
//
// Each TF32 product is exact in float32 (11 x 11 significant bits), and
// what is dropped (lo(a).lo(b) and the splits' residues) stays below
// 2^-21 |a||b|, where one TF32 product alone is off by up to 2^-10 |a||b|
// (5e-4 relative on unit-normal data, which K7's 1e-4 and K9's 1e-5
// tolerances do not admit). tests/test_torch_tf32x3.py emulates both in
// torch and holds K7's and K9's plain math through them to the
// reference. The tensor cores' own float32 accumulation truncates: a sum
// carried through them over many products drifts by up to an ulp of the
// running sum per product, so K9 sums every 16 terms from zero and adds
// them to its float32 sums with rounding to nearest.
//
// The route is mma.sync.m16n8k8 (a warp-wide 16 x 8 x 8 product with
// operands in registers) rather than wgmma: it takes fragments from any
// shared-memory layout, so V (K7's P.V) and x.dt (K9's y) are read
// row-major as they arrive, widths that are not a multiple of 8 are
// zero-padded in shared memory, and a fragment can be scaled, masked or
// built (K9's decay matrix) in registers between the load and the split.
// It reaches part of the dense TF32 rate, and every operand fragment is
// split in registers by each warp that reads it.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C/D (16 x 8):          c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// The k index of a product is a sum index, so a kernel may map the
// fragment's k = t and k = t + 4 onto any two columns, as long as A and
// B use the same map: with k = t -> 2t and k = t + 4 -> 2t + 1, a C/D
// fragment is an A fragment as it stands (K7's scores become P.V's A
// operand without a shuffle).
#pragma once

#include <stdint.h>

namespace tf32x3 {

// x rounded to the nearest TF32 value, ties away from zero, as float32
// bits with the low 13 mantissa bits zero: what cvt.rna.tf32.f32 gives
// for finite x, in two integer operations (half of the dropped bits'
// weight added to the magnitude bits, then the dropped bits cleared;
// cvt.rna compiles to four on sm_90a, a NaN/inf test and a select
// besides). The kernels' operands are finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// d += a.b, one TF32 tensor-core product of a 16 x 8 and an 8 x 8 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in float32 accuracy: the three TF32 products of the split
// operands, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

}  // namespace tf32x3
