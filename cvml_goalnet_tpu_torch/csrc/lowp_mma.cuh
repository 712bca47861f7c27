// bf16 products on the tensor cores by mma.sync, and the copies that feed
// them: shared by the low-precision forms still on mma.sync, 2-bf16
// (csrc/fused_stage_lowp.cu) and 4-bf16 (csrc/fused_mlp.cu); 2-int8 also
// stages its input tile with lp_cp_async16 and loads its wgmma A fragments
// with ldsm_x4, and bf16_round serves every bf16 form.
//
// m16n8k16, f32 += bf16 * bf16 (each product exact in float32), with an
// operand k-step of 32 bytes.  Fragments (g = lane / 4, t = lane % 4): A
// (16 rows x 32 bytes, row-major) holds bytes 4t..4t+3 of rows g, g + 8 in
// registers 0, 1 and bytes 16 + 4t.. of the same rows in 2, 3; B (32 bytes of
// k x 8 columns) bytes 4t..4t+3 of k of column g, then 16 + 4t.. .  So one
// ldmatrix x4 (8 x 16-byte rows per matrix) loads an A fragment from rows of
// k-contiguous bytes, and one loads two n8 B fragments from columns stored
// as k-contiguous rows.  The same byte layout is the A fragment of int8
// m16n8k32 and of wgmma's 8-bit register A.
// Accumulators: c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8.
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to the nearest bf16 (ties to even), as a float.
__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
