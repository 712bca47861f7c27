// conv(3x3, stride 1, pad 1) + spatial bias -> ReLU -> maxpool(3x3, stride 1)
// in bf16 and in int8: the low-precision forms of kernel 2 (csrc/fused_stage.cu
// is its float32 form).  NHWC activations; only the pooled tile is written.
//
// Replaces, on conv1 (13x13, 64->256) and conv2 (11x11, 256->512) of the
// folded visual trunk:
//   * bf16 (2-bf16): cvml_goalnet_tpu/ops/pallas/fused_stage.py::
//     fused_conv_pool_stage at bf16, where the JAX package's eval forward
//     (models/visual.py:134-137) runs XLA's bf16 convolution: bf16 x and w,
//     float32 sums rounded once to bf16, + the bf16 spatial bias (corr)
//     rounded again, ReLU, pool;
//   * int8 (2-int8): ops/quant.py::quantized_conv2d + corr
//     (models/visual.py:128-131, under quantized_inference), which the JAX
//     package leaves to XLA's int8 convolution; here it is a kernel because
//     it takes kernel 2's place on the same two stages.  int8 activations (one
//     scale for the whole batch tensor, max(amax / 127, 1e-12)) and
//     per-output-channel int8 weights (round(w / s) by division, ties to
//     even, clipped to +-127), exact int32 sums; the epilogue dequantizes as
//     acc_f32 * (s_x * s_w[co]), casts to the activation dtype (float32 or
//     bf16), adds corr in that dtype, ReLU, pool.
//
// What bounds them on an H100: operations.  Per frame conv1 and conv2 are
// 335.3 MFLOP against ~0.1 MB (bf16) of input and output; the tensor cores
// give 989 TFLOP/s in bf16 and 1,979 TOPS in int8 (dense).  conv1 with
// float32 activations is bound by its bytes (45 MB in, 130 MB out at
// N = 1050).
//
// 2-bf16 (a first form, not yet redesigned): kernel 2's shifted-window
// implicit GEMM on mma.sync m16n8k16 fed by cp.async and ldmatrix, M = the
// conv positions of a block's tile, N = 64 output channels, K = 9 taps x Cin,
// with the tiling of ops/cuda/fused_stage.py::lowp_stage_plan (whole frames
// when 64 * MI conv positions hold them, else tiles of a frame with a
// recomputed 2-wide halo); 8 warps, 4 along M x 2 along N; a 3-stage ring of
// 32 bytes of input channels at every tap; the rounding above into a conv
// tile in shared memory (reusing the ring), max-pooled there.
//
// 2-int8 (redesigned on wgmma fed by TMA, csrc/hopper.cuh): four launches a
// call, all from one C entry.
//   * amax_scale_kernel: |x|'s largest bit pattern by an exact atomicMax
//     (non-negative floats order as their bits), then in the last block the
//     scale, as the plain version's float32 division and clamp;
//   * quantize_kernel: x -> int8 (n, H, W, Cin_p), zero in the padded
//     channels (Cin_p: Cin rounded up to 64);
//   * pack_int8_weights_kernel: per output channel the amax, the scale and
//     the values, written straight into the (Cout, 3, 3, Cin_p) layout the
//     conv reads, with the scales; weights are packed every call (the JAX
//     package quantizes them every call; a cache would be state a reload
//     must invalidate);
//   * conv_pool_int8_kernel<MT, BN, TOut>: a block computes the conv tile of
//     its pooled tile (frames, or a tile of a frame with a recomputed halo:
//     ops/cuda/fused_stage.py::int8_stage_plan) for BN output channels.  Two
//     warpgroups own m64 tiles 2i + wg (i < MT) of the conv positions and
//     run wgmma m64nBNk32 s8 into int32 accumulators, one stage's group in
//     flight while the next stage's A fragments load (two register sets).
//   * The weights stream through a ring of (64 input channels x 1 tap x BN
//     channels) stages by TMA in the 64-byte swizzle (Cin = 64 is conv1's
//     whole K a tap, so a 128-byte stage would double its K with zeros).
//     Thread 0 refills a slot once all 8 warps have released it; every
//     thread waits for that and thread 0 issues the copy under a predicate,
//     since a branch on the thread with wgmma in flight makes ptxas
//     serialize them (C7518).  There is no producer warpgroup: with one,
//     ptxas held every thread to 168 registers, too few for 128 accumulators
//     and two A sets (it serialized the wgmma, C7512); 256 threads may take
//     255.  A cluster of 2 CTAs sharing each stage by TMA multicast halved
//     the weights' L2 traffic but ran slower (the two CTAs step in lockstep).
//   * The block's whole int8 input tile (all its channels, zero outside the
//     frames: the conv's padding) is staged once by cp.async, rows padded to
//     Cin_p + 16 bytes.  A tap shifts the A rows by 1 or 2 positions, not a
//     whole number of 8-row core matrices, so A cannot be a canonical
//     shared-memory operand: each warp loads its 16 rows of A by ldmatrix
//     from the shifted rows, as mma.sync's A fragment, which is wgmma's
//     register-A layout (TMA's im2col mode would need a box per tap and row
//     band of the tile; the staged tile serves all 9 taps and every channel
//     slice from one copy).
//   * Epilogue: the dequantization (the scales and one frame's bias tile are
//     staged in shared memory with the input tile) into a float32 conv tile
//     (reusing the ring and the input tile), max-pooled there separably: a
//     thread walks a pooled column of four channels down the rows.
//   * What holds it back on an H100 (variant builds, PERF.md section 6): a
//     block re-reads its 295 KB of weights, its input and bias tiles from L2
//     (about 3.7 TB/s across the card with the products switched off), and
//     one block an SM leaves the epilogue unoverlapped.
// The bf16 wrapper pads Cin to a multiple of 16 and Cout to one of 64.
#include "common.cuh"
#include "hopper.cuh"
#include "lowp_mma.cuh"

#include <cfloat>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- 2-bf16

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

template <int MI>
__global__ void __launch_bounds__(kThreads, MI == 4 ? 1 : 2) conv_pool_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wq, const bf16* __restrict__ bias, bf16* __restrict__ out,
    const Geometry g) {
  constexpr int kE = kKB / 2;   // channels per stage
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
  const bf16* w_block = wq + static_cast<long long>(co0) * 9 * g.Cin;
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

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
      }
    }
  }
  lp_wait<0>();
  __syncthreads();  // every copy has landed and every warp is done with the ring: the conv tile reuses it

  // epilogue: acc[i][j][e] is row g + 8 (e / 2) of m-tile i, channel 32 wn + 8 j + 2 t + e % 2
  float* conv = reinterpret_cast<float*>(smem);  // [m_blk][kCPitch]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm * MI + i) * 16 + gq + 8 * h;
      if (m >= m_blk) continue;
      const int r = m % (Rc * Cc), cy = oy0 + r / Cc, cx = ox0 + r % Cc;
      const bool pos_in = cy < g.H && cx < g.W;  // conv rows past the frame feed no pooled output
      const bf16* bp = bias + (static_cast<long long>(cy) * g.W + cx) * g.Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 32 * wn + 8 * j + 2 * t + e, co = co0 + cl;
          const bool live = pos_in && co < g.Cout;
          const float bias_v = live ? __bfloat162float(bp[co]) : 0.f;
          const float v = bf16_round(__fadd_rn(bf16_round(acc[i][j][2 * h + e]), bias_v));
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
    out[((static_cast<long long>(fr) * OH + oy) * OW + ox) * g.Cout + co0 + co] = __float2bfloat16_rn(mx);
  }
}


// ---------------------------------------------------------------- 2-int8

constexpr int kIThreads = 256;   // two warpgroups; thread 0 also issues the weight loads
constexpr int kIKC = 64;         // Cin is padded to a multiple of this many bytes (int8 channels)
constexpr int kIRingBytes = 64 * 1024;   // weights in flight

// A weight stage: KC bytes of input channels (64 or 128, where Cin_p allows) at one tap for BN output channels,
// in the KC-byte swizzle; stages of 64 KB in all.
template <int BN, int KC>
struct I8Ring {
  static constexpr int kStageBytes = BN * KC;
  static constexpr int kStages = kIRingBytes / kStageBytes;
  static constexpr unsigned kLayout = KC == 128 ? kSwizzle128B : kSwizzle64B;
};

struct I8Geometry {
  int n, H, W, Cin_p, Cout;  // Cin_p: Cin rounded up to 64
  int frames, rows, cols;    // the pooled tile of a block
  int tiles_y, tiles_x, co_tiles;
};

// The parts of a block's dynamic shared memory after 1024 bytes of alignment slack
// (ops/cuda/fused_stage.py::int8_smem_bytes mirrors them): the weight ring and the input tile, which the
// epilogue's float32 conv tile [positions][BN + 4] reuses; then the bias tile of one frame's conv positions
// [Rc * Cc][BN + 16 bytes] (room for float32), the BN dequantization scales and the barriers.
struct I8Smem {
  size_t body, bias, scales, barriers, total;
};

__host__ __device__ inline I8Smem int8_smem(int bn, int frames, int rows, int cols, int cin_p) {
  const size_t stages = kIRingBytes / (bn * kIKC);   // the most barriers a ring of stages of KC >= 64 takes
  const size_t per_frame = static_cast<size_t>(rows + 2) * (cols + 2);
  const size_t p = static_cast<size_t>(frames) * (rows + 4) * (cols + 4);
  const size_t ring_and_input = kIRingBytes + p * (cin_p + 16);
  const size_t conv = 4 * frames * per_frame * (bn + 4);
  I8Smem s;
  s.body = ((ring_and_input > conv ? ring_and_input : conv) + 15) / 16 * 16;
  s.bias = s.body;
  s.scales = s.bias + per_frame * (4 * bn + 16);
  s.barriers = s.scales + 4 * bn;
  s.total = 1024 + s.barriers + 2 * stages * sizeof(uint64_t);
  return s;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The conv value before ReLU, rounded where the JAX package rounds: float32 out, or bf16 (the product
// rounded, then the sum with the bias).
__device__ __forceinline__ float conv_value(int acc, float scale, float bias, float*) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}
__device__ __forceinline__ float conv_value(int acc, float scale, float bias, bf16*) {
  return bf16_round(__fadd_rn(bf16_round(__fmul_rn(__int2float_rn(acc), scale)), bias));
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}
__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(amax_bits), 127.f), 1e-12f);
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_m64n128k32_s8_rs(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_m64n64k32_s8_rs(d, a, desc_b);
}

// xq: (n, H, W, Cin_p) int8; wmap: the packed weights (Cout rows of 9 * Cin_p bytes) in boxes of 64 bytes x BN
// rows; bias (H, W, Cout) and out (n, H - 2, W - 2, Cout) in TOut; s_x one float, s_w (Cout,) floats.
template <int MT, int BN, int KC, typename TOut>
__global__ void __launch_bounds__(kIThreads, 1) conv_pool_int8_kernel(
    const __grid_constant__ CUtensorMap wmap, const int8_t* __restrict__ xq, const TOut* __restrict__ bias,
    const float* __restrict__ s_x, const float* __restrict__ s_w, TOut* __restrict__ out, const I8Geometry g) {
  constexpr int S = I8Ring<BN, KC>::kStages, SB = I8Ring<BN, KC>::kStageBytes, KK = KC / 32;
  extern __shared__ float4 smem4[];
  uint8_t* base = smem_align(reinterpret_cast<uint8_t*>(smem4), 1024);
  const int Rc = g.rows + 2, Cc = g.cols + 2, Ri = g.rows + 4, Ci = g.cols + 4;
  const int m_blk = g.frames * Rc * Cc, p_in = g.frames * Ri * Ci, pitch = g.Cin_p + 16;
  const I8Smem lay = int8_smem(BN, g.frames, g.rows, g.cols, g.Cin_p);
  constexpr int kBP = BN + 16 / static_cast<int>(sizeof(TOut));   // bias tile pitch, elements
  uint8_t* ring = base;                                            // S stages of BN rows x 64 bytes
  uint8_t* xs = base + S * SB;                                     // the input tile, [p_in][pitch]
  TOut* bias_s = reinterpret_cast<TOut*>(base + lay.bias);         // [Rc * Cc][kBP]
  float* scale_s = reinterpret_cast<float*>(base + lay.scales);    // [BN]: s_x * s_w[co]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.barriers);
  uint64_t* empty = full + S;

  int b = blockIdx.x;
  const int ct = b % g.co_tiles;
  b /= g.co_tiles;
  const int tx = b % g.tiles_x;
  b /= g.tiles_x;
  const int ty = b % g.tiles_y;
  const int frame0 = (b / g.tiles_y) * g.frames, oy0 = ty * g.rows, ox0 = tx * g.cols, co0 = ct * BN;
  const int n_stages = 9 * (g.Cin_p / KC);   // channel chunk major, then tap

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // the 8 warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0 keeps the weight ring S stages ahead: stage i lands in slot i % S once every warp has released
  // that slot's previous stage
  auto load_stage = [&](int i) {
    tma_expect_load_2d_if(threadIdx.x == 0, ring + (i % S) * SB, &wmap, (i % 9) * g.Cin_p + (i / 9) * KC, co0,
                          &full[i % S], SB);
  };
  const int tid = threadIdx.x, wg = tid / 128;
  for (int i = 0; i < S && i < n_stages; ++i) load_stage(i);

  // the input tile, every channel: 16-byte copies, zero outside the frames
  const int per_pos = g.Cin_p / 16;
  for (int e = tid; e < p_in * per_pos; e += kIThreads) {
    const int p = e / per_pos, c16 = e % per_pos;
    const int f = p / (Ri * Ci), r = p % (Ri * Ci);
    const int yy = oy0 - 1 + r / Ci, xx = ox0 - 1 + r % Ci, fr = frame0 + f;
    const bool in = fr < g.n && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
    lp_cp_async16(xs + p * pitch + 16 * c16,
                  in ? xq + (static_cast<long long>(fr * g.H + yy) * g.W + xx) * g.Cin_p + 16 * c16 : xq, in);
  }
  // the bias of one frame's conv positions (the same for every frame), zero outside the frame and past Cout
  const bool vec_bias = (g.Cout * sizeof(TOut)) % 16 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  if (vec_bias) {
    constexpr int kPer16 = 16 / static_cast<int>(sizeof(TOut));
    for (int e = tid; e < Rc * Cc * (BN / kPer16); e += kIThreads) {
      const int r = e / (BN / kPer16), c = kPer16 * (e % (BN / kPer16));
      const int cy = oy0 + r / Cc, cx = ox0 + r % Cc;
      const bool in = cy < g.H && cx < g.W && co0 + c < g.Cout;
      const TOut* src = in ? bias + (static_cast<long long>(cy) * g.W + cx) * g.Cout + co0 + c : bias;
      lp_cp_async16(bias_s + r * kBP + c, src, in);
    }
  } else {
    for (int e = tid; e < Rc * Cc * BN; e += kIThreads) {
      const int r = e / BN, c = e % BN;
      const int cy = oy0 + r / Cc, cx = ox0 + r % Cc;
      bias_s[r * kBP + c] = cy < g.H && cx < g.W && co0 + c < g.Cout
                                ? bias[(static_cast<long long>(cy) * g.W + cx) * g.Cout + co0 + c]
                                : TOut{};
    }
  }
  if (tid < BN) scale_s[tid] = co0 + tid < g.Cout ? __fmul_rn(*s_x, s_w[co0 + tid]) : 0.f;
  lp_commit();
  lp_wait<0>();
  __syncthreads();   // the whole tile, the bias tile and the scales are in place for both warpgroups

  // A rows: this warp's 16 rows of each m64 tile 2i + wg, at byte half lane / 16 of a k32 step
  const int w = (tid % 128) / 32, lane = tid % 32;
  int arow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int m = (2 * i + wg) * 64 + 16 * w + lane % 16;
    if (m >= m_blk) m = 0;   // padding rows compute a copy of row 0, never read
    const int f = m / (Rc * Cc), r = m % (Rc * Cc);
    arow[i] = ((f * Ri + r / Cc) * Ci + r % Cc) * pitch + 16 * (lane / 16);
  }

  int acc[MT][BN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      acc[i][j] = 0;
      fence_operand(acc[i][j]);
    }
  // one stage: its A fragments into `af` (free: the stage two back is done), its wgmma, then once the previous
  // stage's wgmma are done its slot is released and thread 0 refills it
  auto stage = [&](int st, uint32_t (&af)[MT][KK][4]) {
    const int s = st % S, tap = st % 9;
    const int aoff = ((tap / 3) * Ci + tap % 3) * pitch + (st / 9) * KC;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) ldsm_x4(af[i][kk], xs + arow[i] + aoff + 32 * kk);
    mbar_wait(&full[s], (st / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t db = smem_desc(ring + s * SB + 32 * kk, 16, 8 * KC, I8Ring<BN, KC>::kLayout);
#pragma unroll
      for (int i = 0; i < MT; ++i) wgmma_s8<BN>(acc[i], af[i][kk], db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    // no branch on the thread here (a divergent path with wgmma in flight makes ptxas serialize them, C7518):
    // every thread waits for the slot, and only thread 0's predicates issue the load
    if (st > 0) {
      const int prev = st - 1;
      mbar_arrive_if(&empty[prev % S], lane == 0);
      if (prev + S < n_stages) {
        mbar_wait(&empty[prev % S], (prev / S) & 1);
        load_stage(prev + S);
      }
    }
  };
  uint32_t af0[MT][KK][4], af1[MT][KK][4];
  int st = 0;
  for (; st + 1 < n_stages; st += 2) {
    stage(st, af0);
    stage(st + 1, af1);
  }
  if (st < n_stages) stage(st, af0);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) fence_operand(acc[i][j]);
  __syncthreads();   // both warpgroups are done with the ring and the input tile: the conv tile reuses them

  // acc[i][4j + e]: row 16 w + gq + 8 (e / 2) of m64 tile 2i + wg, channel 8 j + 2 q + e % 2
  constexpr int kCP = BN + 4;    // floats per conv position
  float* conv = reinterpret_cast<float*>(base);
  const int gq = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (2 * i + wg) * 64 + 16 * w + gq + 8 * h;
      if (m >= m_blk) continue;
      const TOut* bp = bias_s + (m % (Rc * Cc)) * kBP;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * q;
        const float v0 = conv_value(acc[i][4 * j + 2 * h], scale_s[cl], to_f32(bp[cl]), static_cast<TOut*>(nullptr));
        const float v1 =
            conv_value(acc[i][4 * j + 2 * h + 1], scale_s[cl + 1], to_f32(bp[cl + 1]), static_cast<TOut*>(nullptr));
        *reinterpret_cast<float2*>(conv + m * kCP + cl) = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
  __syncthreads();

  // the pool, separable: a thread walks one pooled column of four channels down its frame's conv rows, keeping
  // the last three rows' maxima over the window's columns
  const int OH = g.H - 2, OW = g.W - 2;
  auto row_max = [&](const float* c) {
    const float4 a = *reinterpret_cast<const float4*>(c), b = *reinterpret_cast<const float4*>(c + kCP),
                 d = *reinterpret_cast<const float4*>(c + 2 * kCP);
    return make_float4(fmaxf(fmaxf(a.x, b.x), d.x), fmaxf(fmaxf(a.y, b.y), d.y), fmaxf(fmaxf(a.z, b.z), d.z),
                       fmaxf(fmaxf(a.w, b.w), d.w));
  };
  for (int e = tid; e < g.frames * g.cols * (BN / 4); e += kIThreads) {
    const int c4 = 4 * (e % (BN / 4)), qq = e / (BN / 4);
    const int f = qq / g.cols, px = qq % g.cols;
    const int fr = frame0 + f, ox = ox0 + px, co = co0 + c4;
    if (fr >= g.n || ox >= OW || co >= g.Cout) continue;
    const float* c = conv + (f * Rc * Cc + px) * kCP + c4;
    float4 h0 = row_max(c), h1 = row_max(c + Cc * kCP);
    TOut* o = out + ((static_cast<long long>(fr) * OH + oy0) * OW + ox) * g.Cout + co;
    for (int py = 0; py < g.rows && oy0 + py < OH; ++py) {
      const float4 h2 = row_max(c + (py + 2) * Cc * kCP);
      const float4 mx = make_float4(fmaxf(fmaxf(h0.x, h1.x), h2.x), fmaxf(fmaxf(h0.y, h1.y), h2.y),
                                    fmaxf(fmaxf(h0.z, h1.z), h2.z), fmaxf(fmaxf(h0.w, h1.w), h2.w));
      TOut* op = o + static_cast<long long>(py) * OW * g.Cout;
      if (co + 4 <= g.Cout && g.Cout % 4 == 0) {
        store4(op, mx);
      } else {
        const float m4[4] = {mx.x, mx.y, mx.z, mx.w};
        for (int k = 0; k < 4 && co + k < g.Cout; ++k) store1(op + k, m4[k]);
      }
      h0 = h1;
      h1 = h2;
    }
  }
}

// The activation scale: ws[0] = the largest bit pattern of |x| (zeroed before the launch), ws[1] = blocks
// done; the last block writes *s_x = max(amax / 127, 1e-12).  x 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(256) amax_scale_kernel(const T* __restrict__ x, long long total,
                                                         unsigned* __restrict__ ws, float* __restrict__ s_out) {
  __shared__ unsigned red[8];
  unsigned m = 0;
  const long long stride = static_cast<long long>(gridDim.x) * 256, first = blockIdx.x * 256LL + threadIdx.x;
  const long long total4 = total / 4;
  for (long long e = first; e < total4; e += stride) {
    float v[4];
    if constexpr (sizeof(T) == 4) {
      const float4 f = reinterpret_cast<const float4*>(x)[e];
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint2 u = reinterpret_cast<const uint2*>(x)[e];
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) m = max(m, __float_as_uint(fabsf(v[k])));
  }
  for (long long e = 4 * total4 + first; e < total; e += stride) m = max(m, __float_as_uint(fabsf(to_f32(x[e]))));
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < 8; ++i) m = max(m, red[i]);
    atomicMax(ws, m);
    __threadfence();
    if (atomicAdd(ws + 1, 1u) == gridDim.x - 1) *s_out = scale_of(atomicMax(ws, 0u));
  }
}

// q[r, c] = clip(round(x[r, c] / s), -127, 127) for c < C, 0 for C <= c < CP; four bytes a thread (CP a
// multiple of 64; x 16-byte aligned).
template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                                       const float* __restrict__ s, long long rows, int C, int CP) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  const int words = CP / 4;
  if (e >= rows * words) return;
  const long long r = e / words;
  const int c = 4 * static_cast<int>(e % words);
  const float sv = *s;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (C == CP) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(x + r * C + c);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(x + r * C + c);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < C) v[k] = to_f32(x[r * C + c + k]);
  }
  char4 o;
  o.x = c < C ? quantize(v[0], sv) : 0;
  o.y = c + 1 < C ? quantize(v[1], sv) : 0;
  o.z = c + 2 < C ? quantize(v[2], sv) : 0;
  o.w = c + 3 < C ? quantize(v[3], sv) : 0;
  *reinterpret_cast<char4*>(q + r * CP + c) = o;
}

// wq (Cout, 9, Cin_p) int8 and s_w (Cout,) float32 from w (3, 3, Cin, Cout) float32 (HWIO): 8 output channels a
// block, 128 rows of K at a time.  Per channel s = max(amax / 127, 1e-12) and q = clip(round(w / s), -127, 127),
// zero in the padded input channels; each thread writes 16 bytes of a channel's row.
constexpr int kPackThreads = 1024, kPackRows = kPackThreads / 8;

__global__ void __launch_bounds__(kPackThreads) pack_int8_weights_kernel(const float* __restrict__ w,
                                                                         int8_t* __restrict__ wq,
                                                                         float* __restrict__ s_w, int Cin, int Cin_p,
                                                                         int Cout) {
  __shared__ unsigned red[kPackRows][8];
  __shared__ float scale[8];
  const int j = threadIdx.x % 8, kq = threadIdx.x / 8;   // the block's channel j; rows kq, kq + 128, ... of K
  const int co = blockIdx.x * 8 + j;
  unsigned m = 0;
  if (co < Cout) {
#pragma unroll 4
    for (int k = kq; k < 9 * Cin; k += kPackRows)
      m = max(m, __float_as_uint(fabsf(w[static_cast<long long>(k) * Cout + co])));
  }
  red[kq][j] = m;
  __syncthreads();
  if (kq == 0) {
    for (int i = 1; i < kPackRows; ++i) m = max(m, red[i][j]);
    scale[j] = scale_of(m);
    if (co < Cout) s_w[co] = scale[j];
  }
  __syncthreads();
  if (co >= Cout) return;
  const float s = scale[j];
  int8_t* row = wq + static_cast<long long>(co) * 9 * Cin_p;
  for (int gi = kq; gi < 9 * Cin_p / 16; gi += kPackRows) {
    const int tap = 16 * gi / Cin_p, c0 = 16 * gi % Cin_p;
    uint32_t word[4];
#pragma unroll
    for (int b4 = 0; b4 < 4; ++b4) {
      uint32_t packed = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ci = c0 + 4 * b4 + k;
        const int8_t v = ci < Cin ? quantize(w[(static_cast<long long>(tap) * Cin + ci) * Cout + co], s) : 0;
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * k);
      }
      word[b4] = packed;
    }
    *reinterpret_cast<uint4*>(row + 16 * gi) = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

inline size_t round256(size_t bytes) { return (bytes + 255) / 256 * 256; }

// The int8 form's workspace (ops/cuda/fused_stage.py::int8_workspace_bytes mirrors it), each part at a
// 256-byte boundary: wq (Cout, 9, Cin_p) int8 | s_w (Cout,) float32 | xq (positions, Cin_p) int8 | amax bits,
// blocks done, s_x.
struct I8Workspace {
  int8_t* wq;
  float* s_w;
  int8_t* xq;
  unsigned* scalars;
  float* s_x;
};

inline I8Workspace int8_workspace(void* ws, long long positions, int cin_p, int cout) {
  uint8_t* p = static_cast<uint8_t*>(ws);
  I8Workspace out;
  out.wq = reinterpret_cast<int8_t*>(p);
  p += round256(static_cast<size_t>(cout) * 9 * cin_p);
  out.s_w = reinterpret_cast<float*>(p);
  p += round256(static_cast<size_t>(cout) * 4);
  out.xq = reinterpret_cast<int8_t*>(p);
  p += round256(static_cast<size_t>(positions) * cin_p);
  out.scalars = reinterpret_cast<unsigned*>(p);
  out.s_x = reinterpret_cast<float*>(p + 8);
  return out;
}

int launch_act_scale(const void* x, long long total, int is_bf16, unsigned* scalars, float* s_x, cudaStream_t s) {
  int err = static_cast<int>(cudaMemsetAsync(scalars, 0, 2 * sizeof(unsigned), s));
  if (err) return err;
  const long long want = (total / 4 + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want < 4LL * sm_count() ? want : 4LL * sm_count()));
  if (is_bf16)
    amax_scale_kernel<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(x), total, scalars, s_x);
  else
    amax_scale_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), total, scalars, s_x);
  return static_cast<int>(cudaGetLastError());
}

int launch_pack(const void* w, int8_t* wq, float* s_w, int cin, int cin_p, int cout, cudaStream_t s) {
  pack_int8_weights_kernel<<<(cout + 7) / 8, kPackThreads, 0, s>>>(static_cast<const float*>(w), wq, s_w, cin, cin_p,
                                                                    cout);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int BN, int KC, typename TOut>
int launch_int8(const I8Workspace& p, const void* b, void* out, const I8Geometry& g, cudaStream_t s) {
  CUtensorMap wmap;
  int err = make_tensor_map_2d(&wmap, p.wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 9ull * g.Cin_p, g.Cout, 9ull * g.Cin_p,
                               KC, BN, KC == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  const size_t bytes = int8_smem(BN, g.frames, g.rows, g.cols, g.Cin_p).total;
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((g.n + g.frames - 1) / g.frames) * g.tiles_y * g.tiles_x * g.co_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_pool_int8_kernel<MT, BN, KC, TOut>;
  err = allow_dynamic_smem(kernel, bytes);
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kIThreads, bytes, s>>>(wmap, p.xq, static_cast<const TOut*>(b), p.s_x,
                                                                 p.s_w, static_cast<TOut*>(out), g);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// The bf16 form: x (n, H, W, Cin) with Cin a multiple of 16; wq: (Cout rounded up to 64, 3, 3, Cin); b: (H, W,
// Cout); out: (n, H-2, W-2, Cout); all bf16.  The plan (ops/cuda/fused_stage.py::lowp_stage_plan): `frames`
// per block, pooled tiles of rows x cols, m_tiles in {2, 3, 4} with frames * (rows + 2) * (cols + 2) <=
// 64 * m_tiles.  One launch, checked.
extern "C" int fused_conv_pool_stage_bf16(const void* x, const void* wq, const void* b, void* out, int n, int H,
                                          int W, int Cin, int Cout, int frames, int rows, int cols, int m_tiles,
                                          void* stream) {
  if (n < 1 || H < 3 || W < 3 || Cin < 1 || (Cin * 2) % kKB != 0 || Cout < 1 || frames < 1 || rows < 1 ||
      rows > H - 2 || cols < 1 || cols > W - 2 || m_tiles < 2 || m_tiles > 4 ||
      frames * (rows + 2) * (cols + 2) > 64 * m_tiles || static_cast<long long>(n) * H * W >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.n = n, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  g.frames = frames, g.rows = rows, g.cols = cols;
  g.tiles_y = (H - 2 + rows - 1) / rows, g.tiles_x = (W - 2 + cols - 1) / cols, g.co_tiles = (Cout + kBN - 1) / kBN;
  g.n_steps = Cin * 2 / kKB;
  using Kernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*, const Geometry);
  Kernel kernel = m_tiles == 2   ? conv_pool_bf16_kernel<2>
                  : m_tiles == 3 ? conv_pool_bf16_kernel<3>
                                 : conv_pool_bf16_kernel<4>;
  const size_t bytes = lowp_stage_bytes(g.frames, g.rows, g.cols);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>((n + frames - 1) / frames) * g.tiles_y * g.tiles_x * g.co_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_dynamic_smem(kernel, bytes);
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq), static_cast<const bf16*>(b), static_cast<bf16*>(out),
      g);
  return static_cast<int>(cudaGetLastError());
}

// The int8 form, the whole call: x (n, H, W, Cin) float32 (is_bf16 = 0) or bf16, 16-byte aligned; w (3, 3, Cin,
// Cout) float32; b (H, W, Cout) and out (n, H-2, W-2, Cout) in x's dtype; ws: the workspace above.  The plan
// (ops/cuda/fused_stage.py::int8_stage_plan): `frames` per block, pooled tiles of rows x cols, (m_tiles,
// block_n) in {(2, 128), (4, 64)} with frames * (rows + 2) * (cols + 2) <= 128 * m_tiles.  Four launches (after a
// 8-byte memset): the scale, the activations, the weights, the conv; each checked.
extern "C" int fused_conv_pool_stage_int8(const void* x, const void* w, const void* b, void* out, void* ws, int n,
                                          int H, int W, int Cin, int Cout, int is_bf16, int frames, int rows, int cols,
                                          int m_tiles, int block_n, void* stream) {
  const bool shape_ok = (m_tiles == 2 && block_n == 128) || (m_tiles == 4 && block_n == 64);
  if (!shape_ok || n < 1 || H < 3 || W < 3 || Cin < 1 || Cout < 1 || frames < 1 || rows < 1 || rows > H - 2 ||
      cols < 1 || cols > W - 2 || frames * (rows + 2) * (cols + 2) > 128 * m_tiles ||
      static_cast<long long>(n) * H * W >= (1LL << 31) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cin_p = (Cin + kIKC - 1) / kIKC * kIKC;
  const long long positions = static_cast<long long>(n) * H * W;
  const I8Workspace p = int8_workspace(ws, positions, cin_p, Cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_act_scale(x, positions * Cin, is_bf16, p.scalars, p.s_x, s);
  if (err) return err;
  const long long words = positions * (cin_p / 4);
  const unsigned qblocks = static_cast<unsigned>((words + 255) / 256);
  if (is_bf16)
    quantize_kernel<bf16><<<qblocks, 256, 0, s>>>(static_cast<const bf16*>(x), p.xq, p.s_x, positions, Cin, cin_p);
  else
    quantize_kernel<float><<<qblocks, 256, 0, s>>>(static_cast<const float*>(x), p.xq, p.s_x, positions, Cin, cin_p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_pack(w, p.wq, p.s_w, Cin, cin_p, Cout, s);
  if (err) return err;
  I8Geometry g;
  g.n = n, g.H = H, g.W = W, g.Cin_p = cin_p, g.Cout = Cout;
  g.frames = frames, g.rows = rows, g.cols = cols;
  g.tiles_y = (H - 2 + rows - 1) / rows, g.tiles_x = (W - 2 + cols - 1) / cols;
  g.co_tiles = (Cout + block_n - 1) / block_n;
  // (2, 128) takes stages of 128 bytes of channels where Cin_p allows (half the stages and their barriers; its two
  // A register sets are then 64 registers); (4, 64) keeps 64 (four m64 tiles' sets would not fit)
  if (m_tiles == 2 && cin_p % 128 == 0)
    return is_bf16 ? launch_int8<2, 128, 128, bf16>(p, b, out, g, s) : launch_int8<2, 128, 128, float>(p, b, out, g, s);
  if (m_tiles == 2)
    return is_bf16 ? launch_int8<2, 128, 64, bf16>(p, b, out, g, s) : launch_int8<2, 128, 64, float>(p, b, out, g, s);
  return is_bf16 ? launch_int8<4, 64, 64, bf16>(p, b, out, g, s) : launch_int8<4, 64, 64, float>(p, b, out, g, s);
}

// The weight pass alone: wq (Cout, 3, 3, Cin_p) int8 and s_w (Cout,) float32 from w (3, 3, Cin, Cout) float32,
// Cin_p = Cin rounded up to 64, wq 16-byte aligned.  One launch, checked.
extern "C" int int8_pack_weights(const void* w, void* wq, void* s_w, int Cin, int Cout, void* stream) {
  if (Cin < 1 || Cout < 1 || reinterpret_cast<uintptr_t>(wq) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pack(w, static_cast<int8_t*>(wq), static_cast<float*>(s_w), Cin, (Cin + kIKC - 1) / kIKC * kIKC, Cout,
                     static_cast<cudaStream_t>(stream));
}

// The activation scale alone: *s_x = max(max|x| / 127, 1e-12) over `total` values of x (float32 or bf16, 16-byte
// aligned); scratch: two unsigned.  One launch after an 8-byte memset, checked.
extern "C" int int8_act_scale(const void* x, void* scratch, void* s_x, long long total, int is_bf16, void* stream) {
  if (total < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_act_scale(x, total, is_bf16, static_cast<unsigned*>(scratch), static_cast<float*>(s_x),
                          static_cast<cudaStream_t>(stream));
}
