// conv(3x3, stride 1, pad 1) + spatial bias -> ReLU -> maxpool(3x3, stride 1)
// in bf16 and in int8: the low-precision forms of kernel 2 (csrc/fused_stage.cu
// is its float32 form).  NHWC activations; only the pooled tile is written.
//
// Replaces, on conv1 (13x13, 64->256) and conv2 (11x11, 256->512) of the
// folded visual trunk:
//   * bf16: cvml_goalnet_tpu/ops/pallas/fused_stage.py::fused_conv_pool_stage
//     at bf16, where the JAX package's eval forward (models/visual.py:134-137)
//     runs XLA's bf16 convolution: bf16 x and w, float32 sums rounded once to
//     bf16, + the bf16 spatial bias (corr) rounded again, ReLU, pool;
//   * int8: ops/quant.py::quantized_conv2d + corr (models/visual.py:128-131,
//     under quantized_inference), which the JAX package leaves to XLA's int8
//     convolution; here it is a kernel because it takes kernel 2's place on
//     the same two stages.  int8 activations (one scale for the whole batch
//     tensor) and per-output-channel int8 weights, exact int32 sums; the
//     epilogue dequantizes as acc_f32 * (s_x * s_w[co]), casts to the
//     activation dtype (float32 or bf16), adds corr in that dtype, ReLU, pool.
// quantize_kernel is the activation quantization: round(x / s_x) (ties to
// even, by division as the JAX package does) clipped to +-127.
//
// What bounds it on an H100: operations.  Per frame conv1 and conv2 are
// 335.3 MFLOP against ~0.1 MB (bf16) of input and output; the tensor cores
// give 989 TFLOP/s in bf16 and 1,979 TOPS in int8 (dense).
//
// Design (a simple first form; no wgmma or TMA yet): kernel 2's
// shifted-window implicit GEMM, M = the conv positions of a block's tile,
// N = 64 output channels, K = 9 taps x Cin, with the tiling of
// ops/cuda/fused_stage.py::lowp_stage_plan (whole frames when 64 * MI conv
// positions hold them, else tiles of a frame with a recomputed 2-wide halo).
//   * 8 warps: 4 along M, each MI m16 tiles, x 2 along N, each 4 n8 tiles;
//   * a stage is 32 bytes of input channels (16 bf16 or 32 int8: one MMA
//     k-step at each of the 9 taps) for the block's input tile, and the
//     weights that meet them, stored [channel][tap][32 bytes] (the wrapper
//     lays w out as (Cout, 3, 3, Cin), so a B column is k-contiguous);
//     a 3-stage ring of 16-byte cp.async copies, out-of-frame positions
//     zero-filled;
//   * fragments by ldmatrix: an A row is the input position under a conv
//     position at a tap (rows padded to 48 bytes, weight rows to 304, so
//     the 8 rows of a matrix hit distinct banks);
//   * epilogue: the rounding of the form above into a conv tile in shared
//     memory (reusing the ring), max-pooled there.
// The wrapper pads Cin to a multiple of 32 bytes and Cout to a multiple of 64.
#include "common.cuh"
#include "lowp_mma.cuh"

#include <cfloat>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;               // 8 warps: 4 along M x 2 along N
constexpr int kWarpsM = 4;
constexpr int kBN = 64;                     // output channels per block
constexpr int kKB = 32;                     // bytes of input channels per stage
constexpr int kStages = 3;
constexpr int kXPitch = kKB + 16;           // bytes per input position of a stage
constexpr int kWRow = 9 * kKB + 16;         // bytes per output channel of a stage's weights
constexpr int kWStage = kBN * kWRow;        // bytes of one stage's weights
constexpr int kCPitch = kBN + 4;            // floats per conv position in the epilogue

struct Geometry {
  int n, H, W, Cin, Cout;  // Cin padded (a multiple of 32 bytes), Cout the real count
  int frames, rows, cols;  // the pooled tile of a block
  int tiles_y, tiles_x, co_tiles, n_steps;
};

// Bytes of the block's dynamic shared memory (ops/cuda/fused_stage.py::lowp_smem_bytes mirrors it).
inline size_t lowp_stage_bytes(int frames, int rows, int cols) {
  const size_t m = static_cast<size_t>(frames) * (rows + 2) * (cols + 2);
  const size_t p = static_cast<size_t>(frames) * (rows + 4) * (cols + 4);
  const size_t ring = kStages * (kWStage + p * kXPitch) + 4 * p;  // + the input offset table
  const size_t epi = 4 * m * kCPitch;
  return ring > epi ? ring : epi;
}

template <typename T>
struct Form;

template <>
struct Form<bf16> {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
};

template <>
struct Form<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_s8(c, a, b0, b1);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The conv value before ReLU, rounded where the JAX package rounds.
__device__ __forceinline__ float conv_value(float acc, float, float bias, bf16*) {
  return bf16_round(__fadd_rn(bf16_round(acc), bias));
}
__device__ __forceinline__ float conv_value(int acc, float scale, float bias, float*) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}
__device__ __forceinline__ float conv_value(int acc, float scale, float bias, bf16*) {
  return bf16_round(__fadd_rn(bf16_round(__fmul_rn(__int2float_rn(acc), scale)), bias));
}

// T: bf16 or int8_t operands; TOut: the output and bias dtype (bf16 for T = bf16; float or bf16 for int8).
// wq: (Cout padded to 64, 3, 3, Cin padded) in T.  s_x: the activation scale (int8), s_w: (Cout padded,)
// weight scales (int8); both unread for bf16.
template <typename T, typename TOut, int MI>
__global__ void __launch_bounds__(kThreads, MI == 4 ? 1 : 2) conv_pool_lowp_kernel(
    const T* __restrict__ x, const T* __restrict__ wq, const TOut* __restrict__ bias, const float* __restrict__ s_x,
    const float* __restrict__ s_w, TOut* __restrict__ out, const Geometry g) {
  using Acc = typename Form<T>::Acc;
  constexpr int kE = kKB / static_cast<int>(sizeof(T));   // channels per stage
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int Rc = g.rows + 2, Cc = g.cols + 2, Ri = g.rows + 4, Ci = g.cols + 4;
  const int m_blk = g.frames * Rc * Cc, p_in = g.frames * Ri * Ci;
  const int slot = kWStage + p_in * kXPitch;
  char* ring = smem;                                               // kStages x [weights | input]
  int* src_of = reinterpret_cast<int*>(ring + kStages * slot);     // [p_in]: the input position in x, or -1

  int b = blockIdx.x;
  const int ct = b % g.co_tiles;
  b /= g.co_tiles;
  const int tx = b % g.tiles_x;
  b /= g.tiles_x;
  const int ty = b % g.tiles_y;
  const int frame0 = (b / g.tiles_y) * g.frames, oy0 = ty * g.rows, ox0 = tx * g.cols, co0 = ct * kBN;
  const int tid = threadIdx.x;

  for (int p = tid; p < p_in; p += kThreads) {
    const int f = p / (Ri * Ci), r = p % (Ri * Ci);
    const int yy = oy0 - 1 + r / Ci, xx = ox0 - 1 + r % Ci, fr = frame0 + f;
    src_of[p] = fr < g.n && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W ? (fr * g.H + yy) * g.W + xx : -1;
  }
  __syncthreads();

  // (a copy that is out of range reads nothing; its source is x's first element)
  const T* w_block = wq + static_cast<long long>(co0) * 9 * g.Cin;
  auto load_stage = [&](int s, int step) {
    const int c0 = step * kE;
    char* ws = ring + s * slot;
    char* xs = ws + kWStage;
    for (int e = tid; e < kBN * 9 * 2; e += kThreads) {   // (channel, tap, half)
      const int half = e & 1, tap = (e >> 1) % 9, co = (e >> 1) / 9;
      lp_cp_async16(ws + co * kWRow + tap * kKB + 16 * half,
                    w_block + (static_cast<long long>(co) * 9 + tap) * g.Cin + c0 + half * (kE / 2), true);
    }
    for (int e = tid; e < p_in * 2; e += kThreads) {
      const int src = src_of[e >> 1], half = e & 1;
      const bool in = src >= 0;
      lp_cp_async16(xs + (e >> 1) * kXPitch + 16 * half,
                    in ? x + static_cast<long long>(src) * g.Cin + c0 + half * (kE / 2) : x, in);
    }
  };

  // ldmatrix rows: A row (lane % 16) of each m-tile at byte half lane / 16; B rows of two n8 tiles
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  int arow[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    int m = (wm * MI + i) * 16 + lane % 16;
    if (m >= m_blk) m = 0;  // padding rows compute a copy of row 0, never read
    const int f = m / (Rc * Cc), r = m % (Rc * Cc);
    arow[i] = ((f * Ri + r / Cc) * Ci + r % Cc) * kXPitch + 16 * (lane / 16);
  }
  const int q = lane / 8;
  const int b_off = (32 * wn + 8 * (q / 2) + lane % 8) * kWRow + 16 * (q % 2);   // + 16 * kWRow for n-tiles 2, 3

  Acc acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_steps = g.n_steps;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    lp_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    lp_wait<kStages - 2>();
    __syncthreads();  // stage `step` has landed for every thread, and stage step - 1 is free
    if (step + kStages - 1 < n_steps) load_stage((step + kStages - 1) % kStages, step + kStages - 1);
    lp_commit();

    const char* ws = ring + (step % kStages) * slot;
    const char* xs = ws + kWStage;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * Ci + tap % 3) * kXPitch;
      uint32_t bf[2][4];
      ldsm_x4(bf[0], ws + b_off + tap * kKB);
      ldsm_x4(bf[1], ws + b_off + 16 * kWRow + tap * kKB);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t af[4];
        ldsm_x4(af, xs + arow[i] + toff);
#pragma unroll
        for (int j = 0; j < 4; ++j) Form<T>::mma(acc[i][j], af, bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
      }
    }
  }
  lp_wait<0>();
  __syncthreads();  // every copy has landed and every warp is done with the ring: the conv tile reuses it

  // epilogue: acc[i][j][e] is row g + 8 (e / 2) of m-tile i, channel 32 wn + 8 j + 2 t + e % 2
  float* conv = reinterpret_cast<float*>(smem);  // [m_blk][kCPitch]
  const float sx = s_x != nullptr ? *s_x : 1.f;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm * MI + i) * 16 + gq + 8 * h;
      if (m >= m_blk) continue;
      const int r = m % (Rc * Cc), cy = oy0 + r / Cc, cx = ox0 + r % Cc;
      const bool pos_in = cy < g.H && cx < g.W;  // conv rows past the frame feed no pooled output
      const TOut* bp = bias + (static_cast<long long>(cy) * g.W + cx) * g.Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 32 * wn + 8 * j + 2 * t + e, co = co0 + cl;
          const bool live = pos_in && co < g.Cout;
          const float scale = s_w != nullptr ? __fmul_rn(sx, s_w[co]) : 1.f;
          const float v = conv_value(acc[i][j][2 * h + e], scale, live ? to_f32(bp[co]) : 0.f,
                                     static_cast<TOut*>(nullptr));
          conv[m * kCPitch + cl] = fmaxf(v, 0.f);
        }
    }
  __syncthreads();

  const int OH = g.H - 2, OW = g.W - 2, per_frame = g.rows * g.cols;
  for (int e = tid; e < g.frames * per_frame * kBN; e += kThreads) {
    const int co = e % kBN, qq = e / kBN;
    const int f = qq / per_frame, r = qq % per_frame, py = r / g.cols, px = r % g.cols;
    const int fr = frame0 + f, oy = oy0 + py, ox = ox0 + px;
    if (fr >= g.n || oy >= OH || ox >= OW || co0 + co >= g.Cout) continue;
    const float* c = conv + ((f * Rc + py) * Cc + px) * kCPitch + co;
    float mx = -FLT_MAX;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, c[(dy * Cc + dx) * kCPitch]);
    store(out + ((static_cast<long long>(fr) * OH + oy) * OW + ox) * g.Cout + co0 + co, mx);
  }
}

// q[r, c] = clip(round(x[r, c] / s), -127, 127) for c < C, 0 for C <= c < CP (the padded channels).
template <typename TIn>
__global__ void __launch_bounds__(256) quantize_kernel(const TIn* __restrict__ x, int8_t* __restrict__ q,
                                                       const float* __restrict__ s, long long total, int C, int CP) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= total) return;
  const int c = static_cast<int>(e % CP);
  const long long r = e / CP;
  float v = 0.f;
  if (c < C) v = rintf(__fdiv_rn(to_f32(x[r * C + c]), *s));
  q[e] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

template <typename T, typename TOut>
int launch(const void* x, const void* wq, const void* b, const void* s_x, const void* s_w, void* out,
           const Geometry& g, int m_tiles, cudaStream_t s) {
  using Kernel = void (*)(const T*, const T*, const TOut*, const float*, const float*, TOut*, const Geometry);
  Kernel kernel = m_tiles == 2 ? conv_pool_lowp_kernel<T, TOut, 2>
                               : (m_tiles == 3 ? conv_pool_lowp_kernel<T, TOut, 3> : conv_pool_lowp_kernel<T, TOut, 4>);
  const size_t bytes = lowp_stage_bytes(g.frames, g.rows, g.cols);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((g.n + g.frames - 1) / g.frames) * g.tiles_y * g.tiles_x * g.co_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_dynamic_smem(kernel, bytes);
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq), static_cast<const TOut*>(b),
      static_cast<const float*>(s_x), static_cast<const float*>(s_w), static_cast<TOut*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form: 0 = bf16 (x, w, b, out bf16); 1 = int8 with float32 b and out; 2 = int8 with bf16 b and out.
// x: (n, H, W, Cin) with Cin a multiple of 16 (bf16) or 32 (int8); wq: (Cout rounded up to 64, 3, 3, Cin);
// b: (H, W, Cout); out: (n, H-2, W-2, Cout); s_x: one float, s_w: (Cout rounded up to 64,) floats (int8
// forms).  The plan (ops/cuda/fused_stage.py::lowp_stage_plan): `frames` per block, pooled tiles of rows x
// cols, m_tiles in {2, 3, 4} with frames * (rows + 2) * (cols + 2) <= 64 * m_tiles.  One launch, checked.
extern "C" int fused_conv_pool_stage_lowp(int form, const void* x, const void* wq, const void* b, const void* s_x,
                                          const void* s_w, void* out, int n, int H, int W, int Cin, int Cout,
                                          int frames, int rows, int cols, int m_tiles, void* stream) {
  const int elem = form == 0 ? 2 : 1;
  if (form < 0 || form > 2 || n < 1 || H < 3 || W < 3 || Cin < 1 || (Cin * elem) % kKB != 0 || Cout < 1 ||
      frames < 1 || rows < 1 || rows > H - 2 || cols < 1 || cols > W - 2 || m_tiles < 2 || m_tiles > 4 ||
      frames * (rows + 2) * (cols + 2) > 64 * m_tiles || static_cast<long long>(n) * H * W >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      (form != 0 && (s_x == nullptr || s_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.n = n, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  g.frames = frames, g.rows = rows, g.cols = cols;
  g.tiles_y = (H - 2 + rows - 1) / rows, g.tiles_x = (W - 2 + cols - 1) / cols, g.co_tiles = (Cout + kBN - 1) / kBN;
  g.n_steps = Cin * elem / kKB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) return launch<bf16, bf16>(x, wq, b, nullptr, nullptr, out, g, m_tiles, s);
  if (form == 1) return launch<int8_t, float>(x, wq, b, s_x, s_w, out, g, m_tiles, s);
  return launch<int8_t, bf16>(x, wq, b, s_x, s_w, out, g, m_tiles, s);
}

// q (rows, CP) int8 = clip(round(x / *s), -127, 127), zero in channels C..CP-1; x (rows, C) float32 (bf16 = 0)
// or bf16 (bf16 = 1).  One launch, checked.
extern "C" int quantize_activations(const void* x, void* q, const void* s, long long rows, int C, int CP, int is_bf16,
                                    void* stream) {
  if (rows < 0 || C < 1 || CP < C) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * CP;
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if (is_bf16)
    quantize_kernel<bf16><<<blocks, 256, 0, st>>>(static_cast<const bf16*>(x), static_cast<int8_t*>(q),
                                                  static_cast<const float*>(s), total, C, CP);
  else
    quantize_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                                                   static_cast<const float*>(s), total, C, CP);
  return static_cast<int>(cudaGetLastError());
}
