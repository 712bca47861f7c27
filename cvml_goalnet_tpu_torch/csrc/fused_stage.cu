// conv(3x3, stride 1, pad 1) + spatial bias -> ReLU -> maxpool(3x3, stride 1),
// float32, NHWC activations, HWIO weights; only the pooled tile is written.
//
// Replaces cvml_goalnet_tpu/ops/pallas/fused_stage.py::fused_conv_pool_stage
// (its _kernel), which is conv1 (13x13, 64->256) and conv2 (11x11, 256->512)
// of the visual trunk after batchnorm folding, at N = 1050 frames for a
// summarization batch and 5400 for a match.
//
// What bounds it on an H100: operations.  Per frame conv1 is
// 2*13*13*64*256*9 = 49.8 MFLOP and conv2 2*11*11*256*512*9 = 285.5 MFLOP,
// against ~0.2 MB of input and output per frame.  On the FP32 cores the
// ceiling is 67 TFLOP/s; in 3xTF32 (csrc/tf32_mma.cuh: big = tf32(x), small
// = x - big, three products) the tensor cores give 495 / 3 and keep the
// float32 contract.
//
// Design: a shifted-window implicit GEMM, M = the conv positions of a
// block's tile, N = output channels, K = 9 * Cin walked as (chunk of 8
// input channels, tap).  Nothing is materialised as im2col: the A row of
// conv position (y, x) at tap (dy, dx) is input position (y + dy, x + dx) of
// the block's input tile (Ci wide) in shared memory.
//   * Tiles (ops/cuda/fused_stage.py::stage_plan): a block owns a tile of
//     rows x cols pooled positions of `frames` frames and 64 output
//     channels; it computes the (rows + 2) x (cols + 2) conv positions the
//     pool reads, from (rows + 4) x (cols + 4) input positions.  A whole frame
//     is rows = H - 2, cols = W - 2; a frame too large for one block is cut
//     into tiles that recompute the 2-wide halo, so any H, W >= 3 runs.
//   * 8 warps: 4 along M, each MI m16 tiles (M up to 64 * MI = 128, 192 or
//     256 positions), x 2 along N, each 4 n8 tiles (32 channels).
//   * A first pass packs w stage by stage as the main kernel's shared
//     memory holds it (72 rows (tap, k) x 64 channels, zero-padded to whole
//     stages and channel slices) into a workspace, so each stage's weights
//     are one contiguous run of 16-byte copies with no bounds to check.
//   * Operands are split where it costs least.  A staged input value feeds
//     9 taps and both warps along N, so after a stage lands the block splits
//     its input tile once into shared memory, a float4 per (position, t)
//     holding big and small of channels 2t and 2t + 1: an A fragment is two
//     float4 loads and no arithmetic.  A staged weight feeds only the MI
//     m-tiles of a warp, so weights are split in registers (two float4
//     loads and 8 splits per tap): pre-split weight planes doubled the
//     weights' shared-memory loads, and the MMA loop is bound by those loads
//     and the mma.sync issue, so they ran slower on an H100.
//   * A ring of STAGES (2 or 3) stages fed by cp.async: each stage holds 8
//     input channels of the input tile (16-byte copies where Cin is a
//     multiple of 4, zero-filled 4-byte copies where not; zero padding and
//     frames past N are zero-filled copies) and the 9 x 8 x 64 weights that
//     meet them.  Two barriers a stage: after it lands, and after its split.
//   * k order: within a stage's 8 channels a thread's k indices t and t + 4
//     are physical channels 2t and 2t + 1.  B column g of n-tile j is output
//     channel 4g + j of the warp's 32, so one float4 of a weight row gives
//     all 4 n-tiles.  Weight rows are padded to 68 floats so the float4
//     loads of a quarter warp hit distinct banks.
//   * The MMA's float32 accumulation rounds toward zero: each stage (9
//     k-steps) sums into a fresh accumulator that is added to the totals in
//     float32 (tests/test_torch_stage_kernel2.py holds the scheme to the
//     tolerance).
//   * Epilogue: totals + spatial bias, ReLU, into a conv tile in shared
//     memory (reusing the ring), max-pooled there; only the pooled tile is
//     written.
#include "common.cuh"
#include "tf32_mma.cuh"

#include <cfloat>

namespace {

constexpr int kThreads = 256;               // 8 warps: 4 along M x 2 along N
constexpr int kWarpsM = 4;
constexpr int kBN = 64;                     // output channels per block
constexpr int kNJ = 4;                      // n8 tiles per warp
constexpr int kCk = 8;                      // input channels per stage, a multiple of 8: k-steps at each tap
constexpr int kWRows = 9 * kCk;             // weight rows (tap, k) of a stage
constexpr int kWPitch = kBN + 4;            // floats per weight row in shared memory
constexpr int kWStage = kWRows * kWPitch;   // floats of one stage's weights in shared memory
constexpr int kWPack = kWRows * kBN;        // floats of one stage's packed weights in the workspace
constexpr int kCPitch = kBN + 4;            // floats per conv position in the epilogue

struct Geometry {
  int n, H, W, Cin, Cout;
  int frames, rows, cols;  // the pooled tile of a block
  int tiles_y, tiles_x, co_tiles, n_steps;
  int vec_x;               // 16-byte copies of x (Cin % 4 == 0)
};

// Floats of the block's dynamic shared memory (ops/cuda/fused_stage.py::smem_bytes mirrors it).
inline size_t stage_floats(int frames, int rows, int cols, int stages) {
  const size_t m = static_cast<size_t>(frames) * (rows + 2) * (cols + 2);
  const size_t p = static_cast<size_t>(frames) * (rows + 4) * (cols + 4);
  const size_t ring = stages * (kWStage + p * kCk) + 2 * p * kCk + p;  // + the split input tile and the table
  const size_t epi = m * kCPitch;
  return ring > epi ? ring : epi;
}

// wp[co tile][stage][72 rows (tap, k)][64 channels] = w, zero past Cin and Cout.
__global__ void __launch_bounds__(256) pack_weights_kernel(const float* __restrict__ w, float* __restrict__ wp,
                                                           int Cin, int Cout, int n_steps, long long total) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= total) return;
  const int col = static_cast<int>(e % kBN);
  const long long r = e / kBN;
  const int row = static_cast<int>(r % kWRows);
  const long long st = r / kWRows;  // co tile * n_steps + stage
  const int step = static_cast<int>(st % n_steps), ct = static_cast<int>(st / n_steps);
  const int c = step * kCk + row % kCk, co = ct * kBN + col;
  wp[st * kWPack + row * kBN + col] =
      c < Cin && co < Cout ? __ldg(w + (static_cast<long long>(row / kCk) * Cin + c) * Cout + co) : 0.f;
}

template <int MI, int STAGES>
__global__ void __launch_bounds__(kThreads, MI == 2 ? 2 : 1) conv_pool_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ wp, const float* __restrict__ bias,
    float* __restrict__ out, const Geometry g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Rc = g.rows + 2, Cc = g.cols + 2, Ri = g.rows + 4, Ci = g.cols + 4;
  const int m_blk = g.frames * Rc * Cc, p_in = g.frames * Ri * Ci;
  const int in_stage = p_in * kCk, slot = kWStage + in_stage;
  float* ring = smem;                    // STAGES x [weights (72 x kWPitch) | raw input (p_in x 8)]
  float* a_split = ring + STAGES * slot;  // [p_in][t][big 2t, big 2t + 1, small 2t, small 2t + 1]
  int* src_of = reinterpret_cast<int*>(a_split + 2 * in_stage);  // [p_in]: the input position in x, or -1

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

  // (an input copy that is out of range reads nothing; its source is x's first element)
  const float* wp_block = wp + static_cast<long long>(ct) * g.n_steps * kWPack;
  auto load_stage = [&](int s, int step) {
    const int c0 = step * kCk;
    float* ws = ring + s * slot;
    float* xs = ws + kWStage;
    const float* src = wp_block + static_cast<long long>(step) * kWPack;
#pragma unroll
    for (int i = 0; i < (kWPack / 4 + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (e < kWPack / 4) cp_async16(ws + (e / (kBN / 4)) * kWPitch + 4 * (e % (kBN / 4)), src + 4 * e, true);
    }
    if (g.vec_x) {
      for (int e = tid; e < p_in * (kCk / 4); e += kThreads) {
        const int src = src_of[e / (kCk / 4)], c = c0 + 4 * (e % (kCk / 4));
        const bool in = src >= 0 && c < g.Cin;
        cp_async16(xs + 4 * e, in ? x + static_cast<long long>(src) * g.Cin + c : x, in);
      }
    } else {
      for (int e = tid; e < in_stage; e += kThreads) {
        const int src = src_of[e / kCk], c = c0 + e % kCk;
        const bool in = src >= 0 && c < g.Cin;
        cp_async4(xs + e, in ? x + static_cast<long long>(src) * g.Cin + c : x, in);
      }
    }
  };

  // fragments: rows g (+ 8) of the warp's m-tiles at conv position m -> split tile offset of tap (0, 0), t
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  int arow[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = (wm * MI + i) * 16 + gq + 8 * h;
      if (m >= m_blk) m = 0;  // padding rows compute a copy of row 0, never read
      const int f = m / (Rc * Cc), r = m % (Rc * Cc);
      arow[i][h] = ((f * Ri + r / Cc) * Ci + r % Cc) * 2 * kCk + 4 * t;
    }
  const int b_off = 2 * t * kWPitch + 32 * wn + 4 * gq;

  const int n_steps = g.n_steps;
  float acc[MI][kNJ][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `step` has landed for every thread; the previous stage and the split tile are free
    if (step + STAGES - 1 < n_steps) load_stage((step + STAGES - 1) % STAGES, step + STAGES - 1);
    cp_async_commit();

    const float* ws = ring + (step % STAGES) * slot;
    const float2* raw = reinterpret_cast<const float2*>(ws + kWStage);
    for (int e = tid; e < in_stage / 2; e += kThreads) {   // one (position, channel pair) each
      const float2 v = raw[e];
      uint32_t b0, s0, b1, s1;
      split_tf32(v.x, b0, s0);
      split_tf32(v.y, b1, s1);
      reinterpret_cast<float4*>(a_split)[e] =
          make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(s0), __uint_as_float(s1));
    }
    __syncthreads();

    float fresh[MI][kNJ][4] = {};
#pragma unroll
    for (int ks = 0; ks < kWRows / 8; ++ks) {   // k-step: 8 channels at one tap
      const int tap = ks / (kCk / 8);
      const int toff = ((tap / 3) * Ci + tap % 3) * 2 * kCk + 16 * (ks % (kCk / 8));
      const float* wrow = ws + b_off + 8 * ks * kWPitch;
      const float4 lo = *reinterpret_cast<const float4*>(wrow);
      const float4 hi = *reinterpret_cast<const float4*>(wrow + kWPitch);
      uint32_t bb[kNJ][2], bs[kNJ][2];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) frag_b(lane_of(lo, j), lane_of(hi, j), bb[j], bs[j]);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float4 al = *reinterpret_cast<const float4*>(a_split + arow[i][0] + toff);
        const float4 ah = *reinterpret_cast<const float4*>(a_split + arow[i][1] + toff);
        const uint32_t ab[4] = {__float_as_uint(al.x), __float_as_uint(ah.x), __float_as_uint(al.y),
                                __float_as_uint(ah.y)};
        const uint32_t as[4] = {__float_as_uint(al.z), __float_as_uint(ah.z), __float_as_uint(al.w),
                                __float_as_uint(ah.w)};
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mma3(fresh[i][j], ab, as, bb[j], bs[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += fresh[i][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed and every warp is done with the ring: the conv tile reuses it

  // epilogue: rows g (+ 8) of each m-tile; c[2h] is channel 32 wn + 8t + j of n-tile j, c[2h + 1] that + 4
  float* conv = smem;  // [m_blk][kCPitch]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm * MI + i) * 16 + gq + 8 * h;
      if (m >= m_blk) continue;
      const int r = m % (Rc * Cc), cy = oy0 + r / Cc, cx = ox0 + r % Cc;
      const bool pos_in = cy < g.H && cx < g.W;  // conv rows past the frame feed no pooled output
      const float* bp = bias + (static_cast<long long>(cy) * g.W + cx) * g.Cout;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 32 * wn + 8 * t + 4 * e;
        float v[kNJ];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int co = co0 + cl + j;
          v[j] = fmaxf(acc[i][j][2 * h + e] + (pos_in && co < g.Cout ? __ldg(bp + co) : 0.f), 0.f);
        }
        *reinterpret_cast<float4*>(conv + m * kCPitch + cl) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  __syncthreads();

  const int OH = g.H - 2, OW = g.W - 2, per_frame = g.rows * g.cols;
  for (int e = tid; e < g.frames * per_frame * kBN; e += kThreads) {
    const int co = e % kBN, q = e / kBN;
    const int f = q / per_frame, r = q % per_frame, py = r / g.cols, px = r % g.cols;
    const int fr = frame0 + f, oy = oy0 + py, ox = ox0 + px;
    if (fr >= g.n || oy >= OH || ox >= OW || co0 + co >= g.Cout) continue;
    const float* c = conv + ((f * Rc + py) * Cc + px) * kCPitch + co;
    float mx = -FLT_MAX;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, c[(dy * Cc + dx) * kCPitch]);
    out[((static_cast<long long>(fr) * OH + oy) * OW + ox) * g.Cout + co0 + co] = mx;
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, float*, const Geometry);

KernelFn kernel_of(int m_tiles, int stages) {
  switch (m_tiles * 10 + stages) {
    case 22: return conv_pool_tc_kernel<2, 2>;
    case 23: return conv_pool_tc_kernel<2, 3>;
    case 32: return conv_pool_tc_kernel<3, 2>;
    case 33: return conv_pool_tc_kernel<3, 3>;
    case 42: return conv_pool_tc_kernel<4, 2>;
    case 43: return conv_pool_tc_kernel<4, 3>;
    default: return nullptr;
  }
}

}  // namespace

// x: (n, H, W, Cin); w: (3, 3, Cin, Cout); b: (H, W, Cout); out: (n, H-2, W-2, Cout); wp: a workspace of
// ceil(Cout / 64) * ceil(Cin / 8) * 4608 floats, 16-byte aligned.  The plan
// (ops/cuda/fused_stage.py::stage_plan): `frames` per block, pooled tiles of rows x cols, m_tiles in {2, 3, 4}
// with frames * (rows + 2) * (cols + 2) <= 64 * m_tiles, stages in {2, 3}.  Two launches, each checked.
extern "C" int fused_conv_pool_stage(const void* x, const void* w, const void* b, void* wp, void* out, int n, int H,
                                     int W, int Cin, int Cout, int frames, int rows, int cols, int m_tiles,
                                     int stages, void* stream) {
  const KernelFn kernel = kernel_of(m_tiles, stages);
  if (!kernel || n < 1 || H < 3 || W < 3 || Cin < 1 || Cout < 1 || frames < 1 || rows < 1 || rows > H - 2 ||
      cols < 1 || cols > W - 2 || frames * (rows + 2) * (cols + 2) > 64 * m_tiles ||
      static_cast<long long>(n) * H * W >= (1LL << 31) || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * stage_floats(frames, rows, cols, stages);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.n = n, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  g.frames = frames, g.rows = rows, g.cols = cols;
  g.tiles_y = (H - 2 + rows - 1) / rows, g.tiles_x = (W - 2 + cols - 1) / cols, g.co_tiles = (Cout + kBN - 1) / kBN;
  g.n_steps = (Cin + kCk - 1) / kCk;
  g.vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long blocks = static_cast<long long>((n + frames - 1) / frames) * g.tiles_y * g.tiles_x * g.co_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(g.co_tiles) * g.n_steps * kWPack;
  pack_weights_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(wp), Cin, Cout, g.n_steps, total);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = allow_dynamic_smem(kernel, bytes);
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(static_cast<const float*>(x),
                                                               static_cast<const float*>(wp),
                                                               static_cast<const float*>(b), static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the (m_tiles, stages) kernel an SM of the current card keeps resident at `smem` bytes of
// dynamic shared memory, into *out.
extern "C" int fused_conv_pool_stage_blocks_per_sm(int m_tiles, int stages, int smem, int* out) {
  const KernelFn kernel = kernel_of(m_tiles, stages);
  if (!kernel || smem < 0 || static_cast<size_t>(smem) > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_dynamic_smem(kernel, static_cast<size_t>(smem));
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, smem));
}
