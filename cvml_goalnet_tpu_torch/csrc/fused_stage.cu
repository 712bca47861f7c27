// conv(3x3, stride 1, pad 1) + spatial bias -> ReLU -> maxpool(3x3, stride 1),
// float32, NHWC activations, HWIO weights; only the pooled tile is written.
//
// Replaces cvml_goalnet_tpu/ops/pallas/fused_stage.py::fused_conv_pool_stage
// (its _kernel), which is conv1 (13x13, 64->256) and conv2 (11x11, 256->512)
// of the visual trunk after batchnorm folding.
//
// What bounds it on an H100: operations.  Per frame conv1 is
// 2*13*13*64*256*9 = 49.8 MFLOP and conv2 2*11*11*256*512*9 = 285.5 MFLOP,
// against ~0.2 MB of input and output per frame; the work is float32, so the
// ceiling is the 67 TFLOP/s of the FP32 cores (the tensor cores would round
// to TF32).  The design keeps the FMA units fed from shared memory and keeps
// the conv output out of device memory:
//   * one block owns one frame and a slice of 64 output channels (grid =
//     frames x Cout/64), 256 threads; each thread holds a register tile of
//     TM positions x 4 channels (positions strided by 16 over the frame);
//   * Cin is walked in chunks of 16 channels: the zero-padded (H+2)x(W+2)x16
//     input chunk and the 3x3x16x64 weight chunk go to shared memory (the
//     padded 13x13x256 conv2 input alone would be 173 KB, so Cin is tiled);
//     each staged value feeds 4 (weight) or TM (input) FMAs from registers;
//   * after the last chunk the pre-pool HxWx64 conv tile (+ bias, ReLU) is
//     written to shared memory, max-pooled there, and only the
//     (H-2)x(W-2)x64 pooled tile goes to device memory.
#include "common.cuh"

#include <cfloat>

namespace {

constexpr int kThreads = 256;
constexpr int kCo = 64;      // output channels per block
constexpr int kCk = 16;      // input channels per shared-memory chunk
constexpr int kPosGroups = kThreads / (kCo / 4);  // 16 position groups

template <int TM>
__global__ void __launch_bounds__(kThreads) conv_pool_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int Cin, int Cout, int co_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Hp = H + 2, Wp = W + 2, HW = H * W;
  float* in_s = smem;                  // [(H+2)*(W+2)][kCk]
  float* w_s = smem + Hp * Wp * kCk;   // [9][kCk][kCo]

  const int n = blockIdx.x / co_tiles;
  const int co_base = (blockIdx.x % co_tiles) * kCo;
  const int tx = threadIdx.x % (kCo / 4);  // channel group: 4 channels
  const int ty = threadIdx.x / (kCo / 4);  // position group

  int base[TM];  // offset of each owned position's top-left tap in in_s
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = min(ty + kPosGroups * i, HW - 1);
    base[i] = ((p / W) * Wp + (p % W)) * kCk;
  }
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float* xn = x + static_cast<long long>(n) * HW * Cin;
  for (int c0 = 0; c0 < Cin; c0 += kCk) {
    __syncthreads();
    for (int e = threadIdx.x; e < Hp * Wp * kCk; e += kThreads) {
      const int ci = e % kCk, pp = e / kCk;
      const int yy = pp / Wp - 1, xx = pp % Wp - 1, c = c0 + ci;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < Cin) v = __ldg(xn + (yy * W + xx) * Cin + c);
      in_s[e] = v;
    }
    for (int e = threadIdx.x; e < 9 * kCk * kCo; e += kThreads) {
      const int co = e % kCo, r = e / kCo;
      const int ci = r % kCk, tap = r / kCk;
      const int c = c0 + ci, gco = co_base + co;
      float v = 0.f;
      if (c < Cin && gco < Cout) v = __ldg(w + (static_cast<long long>(tap) * Cin + c) * Cout + gco);
      w_s[e] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * Wp + (tap % 3)) * kCk;
      const float* wt = w_s + tap * kCk * kCo + tx * 4;
#pragma unroll
      for (int ci = 0; ci < kCk; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(wt + ci * kCo);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = in_s[base[i] + toff + ci];
          acc[i][0] = fmaf(a, wv.x, acc[i][0]);
          acc[i][1] = fmaf(a, wv.y, acc[i][1]);
          acc[i][2] = fmaf(a, wv.z, acc[i][2]);
          acc[i][3] = fmaf(a, wv.w, acc[i][3]);
        }
      }
    }
  }

  // epilogue: + spatial bias, ReLU into shared memory, then the 3x3 max pool
  __syncthreads();
  float* conv_s = smem;  // [H*W][kCo], reuses the staging buffers
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = ty + kPosGroups * i;
    if (p < HW) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = tx * 4 + j, gco = co_base + co;
        const float b = gco < Cout ? __ldg(bias + static_cast<long long>(p) * Cout + gco) : 0.f;
        conv_s[p * kCo + co] = fmaxf(acc[i][j] + b, 0.f);
      }
    }
  }
  __syncthreads();
  const int OH = H - 2, OW = W - 2;
  float* on = out + static_cast<long long>(n) * OH * OW * Cout;
  for (int e = threadIdx.x; e < OH * OW * kCo; e += kThreads) {
    const int co = e % kCo, q = e / kCo;
    const int oy = q / OW, ox = q % OW;
    float m = -FLT_MAX;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, conv_s[((oy + dy) * W + ox + dx) * kCo + co]);
    if (co_base + co < Cout) on[static_cast<long long>(q) * Cout + co_base + co] = m;
  }
}

template <int TM>
int launch(const float* x, const float* w, const float* b, float* out, int n, int H, int W,
           int Cin, int Cout, cudaStream_t s) {
  const size_t stage = static_cast<size_t>((H + 2) * (W + 2) * kCk + 9 * kCk * kCo);
  const size_t pool = static_cast<size_t>(H * W * kCo);
  const size_t bytes = (stage > pool ? stage : pool) * sizeof(float);
  const int err = allow_dynamic_smem(conv_pool_kernel<TM>, bytes);
  if (err) return err;
  const int co_tiles = (Cout + kCo - 1) / kCo;
  conv_pool_kernel<TM><<<n * co_tiles, kThreads, bytes, s>>>(x, w, b, out, H, W, Cin, Cout, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, H, W, Cin); w: (3, 3, Cin, Cout); b: (H, W, Cout); out: (n, H-2, W-2, Cout).
// Requires 3 <= H, W and H*W <= 256 (one frame's conv tile per block).
extern "C" int fused_conv_pool_stage(const void* x, const void* w, const void* b, void* out,
                                     int n, int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  const int tm = (H * W + kPosGroups - 1) / kPosGroups;
  if (H < 3 || W < 3 || tm > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (tm <= 4) return launch<4>(xf, wf, bf, of, n, H, W, Cin, Cout, s);
  if (tm <= 8) return launch<8>(xf, wf, bf, of, n, H, W, Cin, Cout, s);
  if (tm <= 12) return launch<12>(xf, wf, bf, of, n, H, W, Cin, Cout, s);
  return launch<16>(xf, wf, bf, of, n, H, W, Cin, Cout, s);
}
