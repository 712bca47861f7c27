// y = ReLU?(x @ w + b), float32, split over K with a deterministic second pass.
//
// Replaces cvml_goalnet_tpu/ops/pallas/matmul.py::head_matmul_pallas (its
// _kernel): the visual head, (N, 41472) @ (41472, 512) after batchnorm
// folding.  On the TPU one grid row walks K in order and carries the sum in a
// VMEM accumulator; on Hopper blocks run in parallel and in no order, so
// nothing can be carried between them.
//
// What bounds it on an H100: operations (2*41472*512 = 42.5 MFLOP per row
// against 166 KB of activations per row; the 85 MB of weights are read once
// per batch when row tiles share them through L2), float32 on the FP32 cores.
// The narrow N = 512 over a huge K gives few output tiles (8 per 64 rows),
// too few to fill 132 SMs, so K is split across blocks:
//   * pass 1: block (n-tile, m-tile, split) computes a 64x64 tile over its K
//     range: 256 threads, a 4x4 register tile each, 16-deep K steps staged in
//     shared memory (A transposed so both operands read as float4); it writes
//     float32 partial sums to a workspace (splits, M, N) that the caller owns;
//   * pass 2: one thread per output adds the splits in a fixed order, then
//     the bias and the ReLU.  No atomics, so results repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 16;

__global__ void __launch_bounds__(kThreads) splitk_gemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ part, int M,
    int K, int N, int k_chunk) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // loader coordinates: A tile 64 rows x 16 k, B tile 16 k x 64 cols, 4 values each
  const int a_row = threadIdx.x / 4, a_k = (threadIdx.x % 4) * 4;
  const int b_k = threadIdx.x / 16, b_col = (threadIdx.x % 16) * 4;

  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    {
      const int m = m0 + a_row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + a_k + j;
        As[a_k + j][a_row] = (m < M && k < k_end) ? __ldg(x + static_cast<long long>(m) * K + k) : 0.f;
      }
      const int k = k0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_col + j;
        Bs[b_k][b_col + j] = (k < k_end && n < N) ? __ldg(w + static_cast<long long>(k) * N + n) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* p = part + static_cast<long long>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) p[static_cast<long long>(m) * N + n] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) reduce_bias_kernel(
    const float* __restrict__ part, const float* __restrict__ b, float* __restrict__ y, int M,
    int N, int splits, int relu) {
  const long long total = static_cast<long long>(M) * N;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * total + e];
    s += __ldg(b + e % N);
    y[e] = relu ? fmaxf(s, 0.f) : s;
  }
}

}  // namespace

// x: (M, K); w: (K, N); b: (N,); part: (splits, M, N) workspace; y: (M, N).
// k_chunk must be a multiple of 16 with splits * k_chunk >= K.
extern "C" int head_matmul(const void* x, const void* w, const void* b, void* part, void* y,
                           int M, int K, int N, int splits, int k_chunk, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_chunk % kBK != 0 || static_cast<long long>(splits) * k_chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  splitk_gemm_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(part), M, K, N, k_chunk);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long total = static_cast<long long>(M) * N;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  reduce_bias_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(part),
                                                 static_cast<const float*>(b),
                                                 static_cast<float*>(y), M, N, splits, relu);
  return static_cast<int>(cudaGetLastError());
}
