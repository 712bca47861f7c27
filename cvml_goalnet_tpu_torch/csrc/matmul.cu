// y = ReLU?(x @ w + b), float32, on the tensor cores in 3xTF32, split over K
// with a deterministic second pass.
//
// Replaces cvml_goalnet_tpu/ops/pallas/matmul.py::head_matmul_pallas (its
// _kernel): the visual head, (M, 41472) @ (41472, 512) after batchnorm
// folding, M = 1050 for a summarization batch and 5400 for a match.  On the
// TPU one grid row walks K in order and carries the sum in a VMEM
// accumulator; on Hopper blocks run in parallel and in no order, so nothing
// can be carried between them.
//
// What bounds it on an H100: operations (2*41472*512 = 42.5 MFLOP per row
// against 166 KB of x per row; the 85 MB of w are read once per batch when
// the row tiles share them through L2).  A float32 product on the FP32 cores
// tops out at 67 TFLOP/s; in 3xTF32 (csrc/tf32_mma.cuh) it is three products
// at the 495 TFLOP/s of the TF32 tensor cores, and keeps the float32 contract.
//
// Design:
//   * pass 1: block (n-tile, m-tile, split) computes a 128 x 128 tile over
//     its K range.  8 warps as 2 x 4, each owning 64 x 32: 4 x 4 MMA tiles of
//     m16n8k8, so each A fragment's split serves 4 n-tiles and each B
//     fragment's 4 m-tiles;
//   * x (BM x 32) and w (32 x BN) tiles come through a 4-stage ring of
//     16-byte cp.async copies, zero-filled past M, N and the split's K range;
//     a copy's address is a base, a stage offset and a compile-time constant;
//   * k order: within 16 k a thread's k indices t and t + 4 name physical k
//     4t, 4t + 1 in the first k-step and 4t + 2, 4t + 3 in the second, for A
//     and B alike, so a thread fetches a row of A for two k-steps in one
//     16-byte load.  B's MMA column g of n-tile j is output column 4g + j of
//     the warp's 32, so one 16-byte load of a w row gives all 4 n-tiles, and
//     a thread's accumulators are 8 adjacent output columns (two 16-byte
//     stores per row);
//   * shared memory is swizzled by 16-byte chunk (x: chunk ^ 4 on odd rows;
//     w: chunk ^ 2((row / 4) % 4)), so every fragment load of a quarter warp
//     hits 32 distinct banks;
//   * each stage (4 k-steps) is summed in a fresh accumulator and added to
//     the float32 totals, since the MMA's accumulation rounds toward zero
//     (tests/test_torch_head_kernel3.py holds that scheme to the tolerance
//     where one accumulator over all of K is not);
//   * it writes float32 partial sums to a workspace (splits, M, N) that the
//     caller owns; pass 2 adds the splits in a fixed order, then the bias and
//     the ReLU.  No atomics, so results repeat bit for bit.  The split plan
//     (ops/cuda/matmul.py::head_plan) takes the card's SMs and the kernel's
//     resident blocks per SM.
// K and N must be multiples of 4 and every pointer 16-byte aligned (the
// wrapper pads smaller operands that are not).
#include "common.cuh"
#include "hopper.cuh"
#include "lowp_mma.cuh"   // bf16_round
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;                     // 8 warps: 2 along M x 4 along N
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 4;
constexpr int kXStage = kBM * kBK;                // floats of one x tile, rows of 32
constexpr int kWStage = kBK * kBN;                // floats of one w tile, rows of 128
constexpr size_t kSmemBytes = sizeof(float) * kStages * (kXStage + kWStage);
static_assert(kBM * kBK / 4 % kThreads == 0 && kBK * kBN / 4 % kThreads == 0, "whole copy rounds");

__global__ void __launch_bounds__(kThreads, 1) splitk_tc_gemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ part, int M, int K, int N,
    int k_chunk) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);   // [kStages][kBM][kBK]
  float* sw = sx + kStages * kXStage;            // [kStages][kBK][kBN]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int n_k = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // copies: x rows tid / 8 + 32i at chunk tid % 8; w rows tid / 32 + 8i at chunk tid % 32
  const int xr = tid / 8, xc = tid % 8, wr = tid / 32, wc = tid % 32;
  // (a copy that is out of range reads nothing; its source is the operand's first element)
  const float* xg = x + static_cast<size_t>(m0 + xr) * K + k_begin + 4 * xc;
  const float* wg = w + static_cast<size_t>(k_begin + wr) * N + n0 + 4 * wc;
  const bool w_col_in = n0 + 4 * wc < N;
  const int xs_off = xr * kBK + 4 * (xc ^ ((xr & 1) << 2));
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const bool x_k_in = k_begin + k0 + 4 * xc < k_end;
    float* dx = sx + stage * kXStage + xs_off;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const bool in = x_k_in && m0 + xr + 32 * i < M;
      cp_async16(dx + 32 * i * kBK, in ? xg + static_cast<size_t>(32 * i) * K + k0 : x, in);
    }
    float* dw = sw + stage * kWStage;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      const int row = wr + 8 * i;
      const bool in = w_col_in && k_begin + k0 + row < k_end;
      cp_async16(dw + row * kBN + 4 * (wc ^ (((row >> 2) & 3) << 1)),
                 in ? wg + static_cast<size_t>(k0 + 8 * i) * N : w, in);
    }
  };

  // fragments: the warp's 64 x 32 at (64 wm, 32 wn); rows g (+ 8) of each 16, chunk t of each 16 k
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int a_off = (64 * wm + g) * kBK + 4 * (t ^ ((g & 1) << 2));   // the first 16 k; the second: chunk ^ 4
  const int b_off = 4 * t * kBN + 4 * (8 * wn + (g ^ (2 * t)));       // row 4t of the first 16 k

  float acc[4][4][4] = {};
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed for every thread, and stage kt - 1 is free
    if (kt + kStages - 1 < n_k) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const float* xs = sx + (kt % kStages) * kXStage;
    const float* ws = sw + (kt % kStages) * kWStage;
    float fresh[4][4][4] = {};
#pragma unroll
    for (int h = 0; h < kBK / 16; ++h) {
      float4 alo[4], ahi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = xs + ((a_off + 16 * i * kBK) ^ (16 * h));
        alo[i] = *reinterpret_cast<const float4*>(p);
        ahi[i] = *reinterpret_cast<const float4*>(p + 8 * kBK);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          frag_a_pairs(ks ? make_float2(alo[i].z, alo[i].w) : make_float2(alo[i].x, alo[i].y),
                       ks ? make_float2(ahi[i].z, ahi[i].w) : make_float2(ahi[i].x, ahi[i].y), ab[i], as[i]);
        const float* wrow = ws + b_off + (16 * h + 2 * ks) * kBN;
        const float4 b_lo = *reinterpret_cast<const float4*>(wrow);
        const float4 b_hi = *reinterpret_cast<const float4*>(wrow + kBN);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[2], bs[2];
          frag_b(lane_of(b_lo, j), lane_of(b_hi, j), bb, bs);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma3(fresh[i][j], ab[i], as[i], bb, bs);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += fresh[i][j][e];
  }
  cp_async_wait<0>();

  // rows g and g + 8 of each m-tile; columns 8t .. 8t + 7 of the warp's 32: c0 (c2) of n-tiles 0..3, then c1 (c3)
  float* p = part + static_cast<size_t>(blockIdx.z) * M * N;
  const int col = n0 + 32 * wn + 8 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 64 * wm + 16 * i + 8 * half + g;
      if (row >= M) continue;
      float* out = p + static_cast<size_t>(row) * N + col;
      if (col < N)
        *reinterpret_cast<float4*>(out) = make_float4(acc[i][0][2 * half], acc[i][1][2 * half],
                                                      acc[i][2][2 * half], acc[i][3][2 * half]);
      if (col + 4 < N)
        *reinterpret_cast<float4*>(out + 4) = make_float4(acc[i][0][2 * half + 1], acc[i][1][2 * half + 1],
                                                          acc[i][2][2 * half + 1], acc[i][3][2 * half + 1]);
    }
}

// y = ReLU?(sum of the splits in order + b), four outputs a thread.
__global__ void __launch_bounds__(256) reduce_bias_kernel(const float4* __restrict__ part,
                                                          const float4* __restrict__ b, float4* __restrict__ y,
                                                          int N4, long long total4, int splits, int relu) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= total4) return;
  float4 s = part[e];
  for (int z = 1; z < splits; ++z) {
    const float4 v = part[z * total4 + e];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 bb = __ldg(b + e % N4);
  s.x += bb.x;
  s.y += bb.y;
  s.z += bb.z;
  s.w += bb.w;
  if (relu) s = make_float4(fmaxf(s.x, 0.f), fmaxf(s.y, 0.f), fmaxf(s.z, 0.f), fmaxf(s.w, 0.f));
  y[e] = s;
}

// The bf16 form (3-bf16): replaces head_matmul_pallas at bf16 (the JAX package's bf16 eval forward computes the
// head as XLA's bf16 convolution, models/visual.py:140-163: float32 sums over K rounded once to bf16, + the bf16
// bias rounded again, ReLU).  What bounds it: operations, 989 TFLOP/s of bf16 tensor cores, dense, against
// 130 MB of x and w at 3.35 TB/s (0.045 and 0.039 ms at M = 1050): x and w each have to come from memory
// about once, and the products have to run on wgmma, the only way to the tensor cores' full rate.
// Design (csrc/hopper.cuh's machinery):
//   * a block computes a 128 x 256 output tile over its split of K: two consumer warpgroups, each one
//     wgmma m64n256k16 per 16 of K into 128 float32 accumulators a thread, and a producer warpgroup whose
//     one thread keeps the ring full;
//   * the ring: 4 stages of 64 of K, each an x box (128 rows x 128 bytes) and four w boxes (64 of K x 64
//     columns), 48 KB, loaded by TMA in the 128-byte swizzle, completing on the stage's full mbarrier; each
//     consumer warp arrives on its empty mbarrier once the wgmma that read it are done (one group stays in
//     flight);
//   * x is K-major as stored; w is used as stored, (K, N) row-major, that is N-major, through the
//     descriptor's transpose bit, so the 42.5 MB of w are never repacked;
//   * zero fill past M, N and K replaces padding; a split's K range is a whole number of 64-deep steps, so
//     splits never overlap;
//   * split-K from the card's SMs (ops/cuda/matmul.py::head_bf16_plan: tiles x splits about one wave of
//     one block an SM, 9 x 2 x 7 = 126 at M = 1050); float32 partials go to the caller's workspace and
//     reduce_bias_bf16_kernel adds them in split order, so results repeat bit for bit;
//   * the grid walks n fastest, so the two column tiles of a row tile share its x through L2, and all the
//     row tiles of a split run together and share its w;
//   * 128 x 128 tiles (m64n128, 6 stages) ran slower at M = 1050 and 5400 in a variant build.
// K and N multiples of 8 (16-byte row strides for TMA), x and w 16-byte aligned.
constexpr int kHBM = 128, kHBN = 256, kHBK = 64, kHStages = 4;
constexpr int kHThreads = 384;                       // warpgroups 0, 1: consumers; 2: the producer
constexpr int kHAStage = kHBM * kHBK * 2;            // 16 KB: x rows of 128 bytes
constexpr int kHWBox = kHBK * 64 * 2;                // 8 KB: 64 of K x 64 columns
constexpr int kHStage = kHAStage + 4 * kHWBox;       // 48 KB
constexpr size_t kHSmemBytes = 1024 + static_cast<size_t>(kHStages) * kHStage + 2 * kHStages * sizeof(uint64_t);
static_assert(kHSmemBytes <= kMaxSmemBytes, "the ring fits a block");

__global__ void __launch_bounds__(kHThreads, 1) head_bf16_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap, float* __restrict__ part,
    int M, int N, int steps, int steps_per_split) {
  extern __shared__ float4 smem4[];
  uint8_t* ring = smem_align(reinterpret_cast<uint8_t*>(smem4), 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kHStages * kHStage);
  uint64_t* empty = full + kHStages;

  const int n0 = blockIdx.x * kHBN, m0 = blockIdx.y * kHBM;
  const int s0 = blockIdx.z * steps_per_split;
  const int n_k = min(steps, s0 + steps_per_split) - s0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // the 8 consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {   // the producer: one thread issues every load; the rest of the warpgroup leaves
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kHStages;
        if (i >= kHStages) mbar_wait(&empty[s], ((i / kHStages) & 1) ^ 1);   // its last use was read
        uint8_t* st = ring + s * kHStage;
        const int k = (s0 + i) * kHBK;
        mbar_expect_tx(&full[s], kHStage);
        tma_load_2d(st, &xmap, k, m0, &full[s]);
#pragma unroll
        for (int c = 0; c < 4; ++c) tma_load_2d(st + kHAStage + c * kHWBox, &wmap, n0 + 64 * c, k, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kHStages;
    mbar_wait(&full[s], (i / kHStages) & 1);
    const uint8_t* st = ring + s * kHStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHBK / 16; ++kk) {
      // x: this warpgroup's 64 rows, 16 of K at byte 32 kk of each 128-byte row; w: rows 16 kk .. of each box
      const uint64_t da = smem_desc(st + wg * 64 * 128 + 32 * kk, 16, 1024, kSwizzle128B);
      const uint64_t db = smem_desc(st + kHAStage + 16 * kk * 128, kHWBox, 1024, kSwizzle128B);
      wgmma_m64n256k16_bf16_ss_bmn(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's group is done: release it
    if (i > 0) mbar_arrive_if(&empty[(i - 1) % kHStages], lane == 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);

  // acc[4j + e]: row 64 wg + 16 w + g + 8 (e / 2), column 8 j + 2 q + e % 2
  const int t = threadIdx.x % 128, w = t / 32, g = (t % 32) / 4, q = t % 4;
  float* p = part + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 64 * wg + 16 * w + g + 8 * h;
    if (row >= M) continue;
    float* out = p + static_cast<size_t>(row) * N + n0 + 2 * q;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (n0 + 8 * j + 2 * q < N)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// y = ReLU?(bf16(bf16(sum of the splits in order) + b)), four outputs a thread.
__global__ void __launch_bounds__(256) reduce_bias_bf16_kernel(const float4* __restrict__ part,
                                                               const __nv_bfloat16* __restrict__ b,
                                                               __nv_bfloat16* __restrict__ y, int N, long long total4,
                                                               int splits, int relu) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= total4) return;
  float4 s = part[e];
  for (int z = 1; z < splits; ++z) {
    const float4 v = part[z * total4 + e];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int col = static_cast<int>((4 * e) % N);
  const float in[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v = bf16_round(__fadd_rn(bf16_round(in[c]), __bfloat162float(b[col + c])));
    if (relu) v = fmaxf(v, 0.f);
    y[4 * e + c] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// x: (M, K); w: (K, N); b: (N,); part: (splits, M, N) workspace; y: (M, N);
// K and N multiples of 4, every pointer 16-byte aligned.  k_chunk must be a
// multiple of 32 with splits * k_chunk >= K.  Two launches, each checked.
extern "C" int head_matmul(const void* x, const void* w, const void* b, void* part, void* y, int M, int K, int N,
                           int splits, int k_chunk, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0 || splits < 1 || k_chunk <= 0 || k_chunk % kBK != 0 ||
      static_cast<long long>(splits) * k_chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_dynamic_smem(splitk_tc_gemm_kernel, kSmemBytes);
  if (err) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  splitk_tc_gemm_kernel<<<grid, kThreads, kSmemBytes, s>>>(static_cast<const float*>(x),
                                                           static_cast<const float*>(w),
                                                           static_cast<float*>(part), M, K, N, k_chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long total4 = static_cast<long long>(M) * N / 4;
  reduce_bias_kernel<<<static_cast<unsigned>((total4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float4*>(part), static_cast<const float4*>(b), static_cast<float4*>(y), N / 4, total4,
      splits, relu);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the GEMM pass an SM of the current card keeps resident, into *out.
extern "C" int head_matmul_blocks_per_sm(int* out) {
  const int err = allow_dynamic_smem(splitk_tc_gemm_kernel, kSmemBytes);
  if (err) return err;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, splitk_tc_gemm_kernel, kThreads, kSmemBytes));
}

// The bf16 form: x (M, K), w (K, N), b (N,), y (M, N) bf16; part: (splits, M, N) float32 workspace;
// K and N multiples of 8, x and w 16-byte aligned; k_chunk a multiple of 64 with every split non-empty
// (splits * k_chunk >= K > (splits - 1) * k_chunk).  Two launches, each checked.
extern "C" int head_matmul_bf16(const void* x, const void* w, const void* b, void* part, void* y, int M, int K,
                                int N, int splits, int k_chunk, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || splits < 1 || k_chunk <= 0 || k_chunk % kHBK != 0 ||
      static_cast<long long>(splits) * k_chunk < K || static_cast<long long>(splits - 1) * k_chunk >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  int err = make_tensor_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, 2ull * K, kHBK, kHBM,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = make_tensor_map_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, K, 2ull * N, 64, kHBK,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = allow_dynamic_smem(head_bf16_wgmma_kernel, kHSmemBytes);
  if (err) return err;
  const dim3 grid((N + kHBN - 1) / kHBN, (M + kHBM - 1) / kHBM, splits);
  head_bf16_wgmma_kernel<<<grid, kHThreads, kHSmemBytes, s>>>(xmap, wmap, static_cast<float*>(part), M, N,
                                                               (K + kHBK - 1) / kHBK, k_chunk / kHBK);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long total4 = static_cast<long long>(M) * N / 4;
  reduce_bias_bf16_kernel<<<static_cast<unsigned>((total4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float4*>(part), static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), N,
      total4, splits, relu);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the bf16 GEMM pass an SM of the current card keeps resident, into *out.
extern "C" int head_matmul_bf16_blocks_per_sm(int* out) {
  const int err = allow_dynamic_smem(head_bf16_wgmma_kernel, kHSmemBytes);
  if (err) return err;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, head_bf16_wgmma_kernel, kHThreads, kHSmemBytes));
}
