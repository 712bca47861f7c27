// Float32 products on the tensor cores in 3xTF32, and the cp.async copies
// that feed them: shared by kernels 5 and 6 (csrc/flash_attention.cu), kernel 3
// (csrc/matmul.cu) and kernel 2 (csrc/fused_stage.cu).
//
// One TF32 product keeps 10 bits of mantissa and breaks the float32 contracts
// the kernels are held to, so each float32 operand x splits into big =
// tf32(x) and small = x - big, and big*big' + big*small' + small*big'
// accumulate in float32 (the dropped small*small' is 2^-22 relative).  All go
// through mma.sync m16n8k8 (row.col, f32 += tf32 * tf32), whose operands sit
// in registers, where the split happens.
//
// The MMA's float32 accumulation rounds toward zero, so a long chain of MMAs
// into one accumulator drifts toward zero (on an H100, with |q|, |k| ~ 10 and
// d = 64, kernel 6's gradients came out about 1.2e-4 smaller in magnitude:
// the scores had lost about 16 ulp).  Callers sum a few k-steps at a time in
// a fresh accumulator and add it to their totals in float32, which rounds to
// nearest.
//
// Fragment layout (g = lane / 4, t = lane % 4): A (16 x 8) holds rows g and
// g + 8 at k indices t and t + 4; B (8 x 8, k x n) k indices t and t + 4 of
// column g; C rows g and g + 8 at columns 2t and 2t + 1.  A product's sum over
// k does not depend on which physical k an index names, so callers permute
// the k order (the same way for both operands) to fetch a thread's values in
// one vector load.
#pragma once

#include <stdint.h>

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small: big = tf32(x) (cvt.rna: round to nearest, ties away) and
// small = x - big, exact in float32; the MMA reads small's top 19 bits, so
// big + small keeps x to about 2^-21 of |x|.  (Rounding small with a second
// cvt cost 12 % of kernel 6's time on an H100 and gained nothing the
// tolerance can see.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the small cross terms first, then big * big.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// The A fragment from a thread's pair of k values in row g (lo) and row g + 8
// (hi): k index t <- .x and t + 4 <- .y.
__device__ __forceinline__ void frag_a_pairs(float2 lo, float2 hi, uint32_t (&big)[4], uint32_t (&small)[4]) {
  split_tf32(lo.x, big[0], small[0]);
  split_tf32(hi.x, big[1], small[1]);
  split_tf32(lo.y, big[2], small[2]);
  split_tf32(hi.y, big[3], small[3]);
}

// The A fragment (16 x 8, row-major) of a product at p = &M[g][2t] with row
// pitch ld: rows g and g + 8, k index t <- column 2t and t + 4 <- 2t + 1 (one
// 8-byte load per row).
__device__ __forceinline__ void frag_a(const float* p, int ld, uint32_t (&big)[4], uint32_t (&small)[4]) {
  frag_a_pairs(*reinterpret_cast<const float2*>(p), *reinterpret_cast<const float2*>(p + 8 * ld), big, small);
}

// The B fragment (8 x 8, k x n) from two values: k index t and t + 4 of column g.
__device__ __forceinline__ void frag_b(float lo, float hi, uint32_t (&big)[2], uint32_t (&small)[2]) {
  split_tf32(lo, big[0], small[0]);
  split_tf32(hi, big[1], small[1]);
}

// Component j of a float4: a B column picked from one vector load of a weight row.
__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// An accumulator tile (rows g, g + 8; columns 2t, 2t + 1) as the A operand of
// a product over its columns, k index t <- column 2t and t + 4 <- 2t + 1.
__device__ __forceinline__ void frag_a_from_acc(const float (&c)[4], uint32_t (&big)[4], uint32_t (&small)[4]) {
  frag_a_pairs(make_float2(c[0], c[1]), make_float2(c[2], c[3]), big, small);
}
