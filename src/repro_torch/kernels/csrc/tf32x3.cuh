// Split-TF32 ("3xTF32") products on Hopper's tensor cores, for kernels that
// take and return f32 and are held to f32 tolerances (flash_prefill.cu,
// ssd_chunk.cu).
//
// An f32 operand a is written as big + small, big = tf32(a) and
// small = tf32(a - big), each rounded to nearest (cvt.rna.tf32.f32: 10
// mantissa bits, ties away from zero). a - big is exact in f32, so
// |a - (big + small)| <= 2^-22 |a|. A product is then taken as
//   a b ~ small_a big_b + big_a small_b + big_a big_b,
// three TF32 products with f32 accumulation, the small terms first and
// big.big last (CUTLASS's OpMultiplyAddFastF32 order). The dropped
// small_a small_b and the two rounding errors of the smalls leave each
// product within ~3 * 2^-22 of a b relative: a dot product of K terms errs
// by about sqrt(K) of that, the same order as an f32 FMA chain's own
// rounding of its partial sums. tests/test_torch_tf32x3.py emulates this on
// the CPU (tf32 rounding on the bit pattern, three rounded products summed
// in f32) and holds it against flash_prefill's and ssd_chunk's plain
// versions at their 1e-5 and 1e-4 tolerances; one TF32 product misses both.
//
// The cost is three tensor-core products per product: 495 / 3 = 165
// TFLOP/s of f32 work at the H100's dense TF32 rate (data sheet), against
// 67 TFLOP/s of f32 FMAs on the CUDA cores.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, per warp: D (16 x 8)
// += A (16 x 8, row-major) B (8 x 8, column-major). With g = lane / 4 and
// q = lane % 4, a thread holds
//   A: a[0] (g, q)   a[1] (g + 8, q)   a[2] (g, q + 4)   a[3] (g + 8, q + 4)
//   B: b[0] (k = q, n = g)             b[1] (k = q + 4, n = g)
//   C: c[0] (g, 2q)  c[1] (g, 2q + 1)  c[2] (g + 8, 2q)  c[3] (g + 8, 2q + 1)
// (row, column) of its fragment. Since the product sums over k, a kernel may
// map the 8 logical k of a step onto its 8 physical indices in any order, as
// long as A and B use the same map (ssd_chunk.cu maps k = q to 2q and
// k = q + 4 to 2q + 1, which turns a C fragment into an A fragment).
#pragma once

#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ~ big + small, both TF32 bit patterns.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

struct FragA {                            // a 16 x 8 A fragment, split
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(int i, float x) {
    split(x, big[i], small[i]);
  }
};

struct FragB {                            // an 8 x 8 B fragment, split
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(int i, float x) {
    split(x, big[i], small[i]);
  }
};

// Four 8 x 4 f32 blocks from shared memory in one instruction
// (ldmatrix: lane l gives the address of row l % 8 of block l / 8, 16 bytes
// of 4 floats); lane (g, q) receives r[i] = element (g, q) of block i, the
// bits of an f32, so block order (rows 0-7 | rows 8-15) x (columns 0-3 |
// 4-7) yields an A fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b, one TF32 tensor-core product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, one TF32 tensor-core product from a zero accumulator.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a b in split TF32: the small terms first, big.big last.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// d = a b in split TF32, from zero: one step's sum, which the caller adds
// to its f32 accumulator with a rounded add.
__device__ __forceinline__ void mma3_fresh(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_zero(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

}  // namespace tf32x3
