// The helpers of the low-precision forms (csrc/fused_stage_lowp.cu's
// 2-bf16 and 2-int8, csrc/fused_mlp.cu's 4-bf16, csrc/matmul.cu's 3-bf16):
// 16-byte cp.async with zero fill, ldmatrix, and rounding to bf16.
//
// The A fragment of mma.sync m16n8k16 (bf16) and m16n8k32 (int8), and of
// wgmma's register A in both types, is 16 rows x 32 bytes of K (g = lane / 4,
// t = lane % 4): bytes 4t..4t+3 of rows g, g + 8 in registers 0, 1 and bytes
// 16 + 4t.. of the same rows in 2, 3; so one ldmatrix x4 (8 x 16-byte rows a
// matrix) loads it from rows of K-contiguous bytes.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// 16 bytes global -> shared, zero-filled when !in (the source is then not read).
__device__ __forceinline__ void lp_cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void lp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void lp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices: lanes 8q .. 8q + 7 give the row addresses of matrix q.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// x rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
