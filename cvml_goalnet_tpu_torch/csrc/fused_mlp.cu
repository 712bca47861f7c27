// The fusion MLP in one launch: up to 8 chained linears with ReLU between,
// then (hi - lo) * sigmoid + lo (or the raw logits), float32.
//
// Replaces cvml_goalnet_tpu/ops/pallas/fused_mlp.py::fused_fusion_mlp (its
// _kernel): 640 -> 512 -> 512 -> 256 -> 128 -> 1 at the reference width.
//
// What bounds it on an H100: neither rate.  It is ~1.5 MFLOP per row, and the
// 3 MB of float32 weights are read once per batch (from device memory into
// L2); launch and latency dominate at the sizes the pipeline gives it.  The
// TPU kernel holds all weights in VMEM; 3 MB does not fit in one SM, so here:
//   * one block per tile of 8 rows keeps the activations in shared memory,
//     ping-ponging between two buffers, so hidden layers never leave the SM;
//   * each thread owns output columns; for every input feature it reads one
//     weight (consecutive threads read consecutive columns, so the weight
//     stream from L2 is coalesced) and applies it to all 8 rows from shared
//     memory (a broadcast read);
//   * all layers and the squashing run in this one launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kMaxLayers = 8;

struct MlpArgs {
  const float* w[kMaxLayers];  // (dims[l], dims[l+1]) row-major, (in, out)
  const float* b[kMaxLayers];  // (dims[l+1],)
  int dims[kMaxLayers + 1];
  int n_layers;
  int width;  // largest of dims: the row stride of the activation buffers
};

__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const float* __restrict__ x,
                                                             float* __restrict__ y, int M,
                                                             MlpArgs args, int squash, float lo,
                                                             float hi) {
  extern __shared__ float4 smem4[];
  float* buf[2] = {reinterpret_cast<float*>(smem4),
                   reinterpret_cast<float*>(smem4) + kRows * args.width};
  const int row0 = blockIdx.x * kRows;
  const int d0 = args.dims[0];
  for (int e = threadIdx.x; e < kRows * d0; e += kThreads) {
    const int r = e / d0, k = e % d0;
    buf[0][r * args.width + k] = row0 + r < M ? __ldg(x + static_cast<long long>(row0 + r) * d0 + k) : 0.f;
  }
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < args.n_layers; ++l) {
    const int K = args.dims[l], N = args.dims[l + 1];
    const float* __restrict__ W = args.w[l];
    const float* in = buf[cur];
    float* outb = buf[cur ^ 1];
    const bool last = l == args.n_layers - 1;
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float acc[kRows] = {};
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(W + static_cast<long long>(k) * N + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(in[r * args.width + k], wv, acc[r]);
      }
      const float bj = __ldg(args.b[l] + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = acc[r] + bj;
        if (!last) {
          v = fmaxf(v, 0.f);
        } else if (squash) {
          v = (hi - lo) * (1.f / (1.f + expf(-v))) + lo;
        }
        outb[r * args.width + j] = v;
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  const int n_out = args.dims[args.n_layers];
  for (int e = threadIdx.x; e < kRows * n_out; e += kThreads) {
    const int r = e / n_out, j = e % n_out;
    if (row0 + r < M) y[static_cast<long long>(row0 + r) * n_out + j] = buf[cur][r * args.width + j];
  }
}

}  // namespace

// x: (M, dims[0]); y: (M, dims[n_layers]).  w_ptrs, b_ptrs and dims are HOST
// arrays of n_layers device pointers and n_layers + 1 widths.
extern "C" int fused_mlp(const void* x, void* y, int M, int n_layers, const void* const* w_ptrs,
                         const void* const* b_ptrs, const int* dims, int squash, float lo,
                         float hi, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  MlpArgs args = {};
  args.n_layers = n_layers;
  args.width = 0;
  for (int l = 0; l <= n_layers; ++l) {
    args.dims[l] = dims[l];
    if (dims[l] > args.width) args.width = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    args.w[l] = static_cast<const float*>(w_ptrs[l]);
    args.b[l] = static_cast<const float*>(b_ptrs[l]);
  }
  const size_t bytes = static_cast<size_t>(2 * kRows * args.width) * sizeof(float);
  const int err = allow_dynamic_smem(fused_mlp_kernel, bytes);
  if (err) return err;
  const int blocks = (M + kRows - 1) / kRows;
  fused_mlp_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), M, args, squash, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
