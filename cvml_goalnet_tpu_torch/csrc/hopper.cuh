// Hopper's machinery for kernels that feed wgmma from TMA, shared by the
// redesigned head (csrc/matmul.cu, 3-bf16), the conv-pool stage's bf16 and
// int8 forms (csrc/fused_stage_lowp.cu, 2-bf16 and 2-int8) and the bf16
// fusion MLP (csrc/fused_mlp.cu, 4-bf16); kernel 1
// (csrc/fused_preprocess.cu) takes its mbarrier helpers and bulk copy from
// here too.
//
//   * Tensor maps are encoded on the host by the driver's
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so a
//     library built with nvcc and loaded by ctypes needs no -lcuda.  A kernel
//     takes a map as `const __grid_constant__ CUtensorMap` (it must live in
//     parameter space, not host memory).  TMA wants a 16-byte-aligned base and
//     row strides that are multiples of 16 bytes; a box past the tensor's
//     bounds is zero-filled, which stands in for padding.
//   * A ring of stages: each stage has a `full` mbarrier (the producer's
//     arrive.expect_tx, completed by the TMA bytes landing) and an `empty`
//     one (one arrival per consumer warp once its wgmma have read the stage).
//     A wait that never completes traps rather than hangs the card.
//   * wgmma: shared-memory descriptors (start >> 4, LBO, SBO, swizzle mode;
//     a stage's swizzle atom must start on a 1024-byte boundary for the
//     descriptor's base offset of 0 to hold), fence / commit / wait, and
//     setmaxnreg to move registers from the head's producer warpgroup to its
//     consumers (the conv-pool template has no producer warpgroup: see its note).
//     The descriptor's swizzle must be the TMA box's.
//   * ptxas serializes wgmma (C7518) around any branch on the thread while
//     a group is in flight, so the waits spin inside one asm block and the
//     copies and arrivals one thread makes are predicated inside theirs.
// Everything here needs sm_90a (wgmma and setmaxnreg exist only there).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: the driver entry is looked up at run time)
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------- host: tensor maps

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once (null when the driver lacks it).
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 2-D map of a row-major array of `rows` rows of `cols` elements, `row_bytes` apart, read in boxes of
// box_cols x box_rows elements (box_cols * element size must be the swizzle's span when swizzled), zero
// past the bounds.  Returns a CUDA error code: invalid value for a base or row stride TMA cannot take.
inline int make_tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, uint64_t cols,
                              uint64_t rows, uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows,
                              CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || row_bytes % 16 != 0 || cols == 0 || rows == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 4-D map of an array of dims[0] x dims[1] x dims[2] x dims[3] elements (dims[0] innermost, contiguous;
// strides[i] bytes between steps of dims[i + 1]), read in boxes of box[0..3] elements (box[0] * element
// size the swizzle's span), zero outside the array: box coordinates may be negative.
inline int make_tensor_map_4d(CUtensorMap* map, const void* base, CUtensorMapDataType type, const uint64_t* dims,
                              const uint64_t* strides, const uint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t d[4], st[3];
  cuuint32_t b[4];
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    if (dims[i] == 0 || box[i] == 0 || box[i] > 256 || (i < 3 && strides[i] % 16 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    d[i] = dims[i];
    b[i] = box[i];
    if (i < 3) st[i] = strides[i];
  }
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), d, st, b, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- device: shared memory and mbarriers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `p` rounded up to the next multiple of `align` bytes in the shared window.
__device__ __forceinline__ uint8_t* smem_align(uint8_t* p, unsigned align) {
  const unsigned a = smem_u32(p);
  return p + (((a + align - 1) & ~(align - 1)) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA) and the other threads' waits.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's arrival, announcing `bytes` of copies that complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait for phase `parity` of `bar`; a copy that never lands traps rather than hangs.  The spin is one asm
// block, so the compiler sees no divergent loop (which would make ptxas serialize wgmma in flight around it).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      " .reg .u32 spins;\n"
      " mov.u32 spins, 0;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @done bra DONE;\n"
      " add.u32 spins, spins, 1;\n"
      " setp.lt.u32 done, spins, 16777216;\n"
      " @done bra WAIT;\n"
      " trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// mbar_arrive by the threads where `pred` holds, without a branch around it.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// One bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both addresses 16-byte aligned) into shared
// memory, completing on `bar`, which expects it.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// The box of `map` at element coordinates (c0 along the rows, c1 across them) into shared memory at `dst`,
// completing on `bar` (whose expect_tx counts its bytes).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// tma_load_2d with its expect_tx of `bytes`, by the threads where `pred` holds, without a branch around it.
__device__ __forceinline__ void tma_expect_load_2d_if(bool pred, void* dst, const CUtensorMap* map, int c0, int c1,
                                                      uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%2], %6;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      "}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(static_cast<int>(pred)),
      "r"(bytes)
      : "memory");
}

// The arrival with expect_tx of `bytes` alone, by the threads where `pred` holds (the copies follow with
// tma_load_2d_if), without a branch around it.
__device__ __forceinline__ void mbar_expect_tx_if(bool pred, uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %2;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(static_cast<int>(pred)), "r"(bytes)
      : "memory");
}

// tma_load_2d by the threads where `pred` holds, without a branch around it.
__device__ __forceinline__ void tma_load_2d_if(bool pred, void* dst, const CUtensorMap* map, int c0, int c1,
                                               uint64_t* bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      "}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(static_cast<int>(pred))
      : "memory");
}

// The box of 4-D `map` at element coordinates c0..c3 (c0 innermost) by the threads where `pred` holds, completing
// on `bar`, without a branch around it.
__device__ __forceinline__ void tma_load_4d_if(bool pred, void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                               int c3, uint64_t* bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %7, 0;\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Orders this thread's ordinary (generic-proxy) writes to shared memory, its own block's or a cluster
// peer's, before later reads by the async proxy (wgmma operands, TMA): a kernel that stores an operand
// with st.shared fences before the barrier that hands it on.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// ---------------------------------------------------------------- device: wgmma

constexpr unsigned kSwizzle128B = 1, kSwizzle64B = 2;   // a descriptor's layout type

// The shared-memory descriptor of an operand at `p`: `lbo` and `sbo` bytes (leading and stride byte offsets:
// for a K-major swizzled operand SBO is the step between 8-row groups and LBO unused; for an MN-major one LBO
// is the step between swizzle atoms along MN and SBO between 8-row groups along K), swizzle `layout`.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo, unsigned sbo, unsigned layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(layout) << 62);
}

// Orders the warpgroup's register and shared-memory writes before the wgmma that read them.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups of this warpgroup's wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register across a wgmma wait or fence:
// the asm "writes" it in program order.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Registers per thread of the executing warpgroup, raised (consumers) or lowered (the producer).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The accumulator layout of m64nN (float32 or int32): thread t of the warpgroup (warp w = t / 32, g = (t % 32)
// / 4, q = t % 4) holds d[4j + e] at row 16w + g + 8(e / 2), column 8j + 2q + e % 2.  For register A (8-bit,
// k32, or 16-bit, k16: 32 bytes of K either way) each warp gives its 16 rows as mma.sync's A fragment
// (m16n8k32 s8, m16n8k16 bf16): a0 rows g, bytes 4q..4q+3; a1 rows g + 8; a2, a3 the same at bytes
// 16 + 4q: what ldmatrix x4 loads from rows lane % 16 at byte 16(lane / 16).

// D (64 x 256 float32, 128 a thread) += A (64 x 16 bf16, K-major) * B (16 x 256 bf16, N-major), both in
// shared memory through their descriptors (B transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n256k16_bf16_ss_bmn(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 128 int32, 64 a thread) += A (64 x 32 int8, K-major, in registers: the m16n8k32 fragment of
// each warp's 16 rows) * B (32 x 128 int8, K-major, in shared memory through its descriptor).
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64 int32, 32 a thread) += A (64 x 32 int8, K-major, in registers: the m16n8k32 fragment of
// each warp's 16 rows) * B (32 x 64 int8, K-major, in shared memory through its descriptor).
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128 float32, 64 a thread) += A (64 x 16 bf16, K-major, in registers: the m16n8k16 fragment of
// each warp's 16 rows) * B (16 x 128 bf16, N-major, in shared memory through its descriptor: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs_bmn(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64 float32, 32 a thread) += A (64 x 16 bf16, K-major, in registers: the m16n8k16 fragment of
// each warp's 16 rows) * B (16 x 64 bf16, N-major, in shared memory through its descriptor: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs_bmn(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64 float32, 32 a thread) += A (64 x 16 bf16, M-major: imm-trans-a = 1) * B (16 x 64 bf16,
// K-major), both in shared memory through their descriptors; D is overwritten (not added to) where
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ss_amn(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32 float32, 16 a thread) += A (64 x 16 bf16, M-major: imm-trans-a = 1) * B (16 x 32 bf16,
// K-major), both in shared memory through their descriptors; D is overwritten (not added to) where
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n32k16_bf16_ss_amn(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 16 float32, 8 a thread) += A (64 x 16 bf16, M-major: imm-trans-a = 1) * B (16 x 16 bf16,
// K-major), both in shared memory through their descriptors; D is overwritten (not added to) where
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n16k16_bf16_ss_amn(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
