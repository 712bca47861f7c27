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
// Both forms run one kernel, conv_pool_wgmma_kernel<Form, MT, BN, KB>, on
// wgmma fed by TMA (csrc/hopper.cuh); the form (Int8Form<TOut>, Bf16Form)
// gives the element type, the weight stage's TMA boxes and descriptor, the
// wgmma instruction and the epilogue's rounding.
//   * A block computes the conv tile of its pooled tile (frames, or a tile
//     of a frame with a recomputed halo: ops/cuda/fused_stage.py::
//     int8_stage_plan and bf16_stage_plan) for BN output channels.  Two
//     warpgroups own m64 tiles 2i + wg (i < MT) of the conv positions and
//     run wgmma (m64nBNk32 s8 into int32, m64nBNk16 bf16 into float32), one
//     stage's group in flight while the next stage's A fragments load (two
//     register sets).  A stage is KB bytes of input channels (32 channels of
//     bf16 at KB = 64, 64 at 128) at one tap.
//   * The block's input tile (its frames' positions from (oy0 - 1, ox0 - 1)
//     with the conv's halo, zero outside the frames: the conv's padding)
//     arrives by TMA, one KB-byte chunk of channels at a time, as a 4-D box
//     (KB bytes, Ci, Ri, frames) of x as stored, in the KB-byte swizzle,
//     through a ring of two chunk buffers: chunk c + 2 loads once every warp
//     has read chunk c.  A tap shifts the A rows by 1 or 2 positions, not a
//     whole number of 8-row core matrices, so A cannot be a canonical
//     shared-memory operand: each warp loads its 16 rows of A by ldmatrix
//     from the shifted rows (the swizzle undone in the address), as
//     mma.sync's A fragment, which is wgmma's register-A layout for 32 bytes
//     of K in both element types (TMA's im2col mode would need a box per tap
//     and row band of the tile; the staged chunk serves all 9 taps).
//   * The weights stream through a ring of stages by TMA.  int8: the packed
//     (Cout, 9, Cin_p) weights, K-major, one box of KB bytes x BN rows in the
//     KB-byte swizzle (Cin = 64 is conv1's whole K a tap, so a 128-byte stage
//     would double its K with zeros).  bf16: w as stored, HWIO, which as a
//     matrix is (9 Cin, Cout) row-major: N-major, BN / 64 boxes of 64
//     columns (128 bytes, the 128-byte swizzle) x KB / 2 rows of K, read
//     through wgmma's transpose bit (LBO = the step between 64-column boxes,
//     SBO = 8 rows of K), so w is never repacked; Cin a multiple of KB / 2
//     keeps a box inside its tap.
//   * Thread 0 refills a slot once all 8 warps have released it; every
//     thread waits for that and thread 0 issues the copy under a predicate,
//     since a branch on the thread with wgmma in flight makes ptxas
//     serialize them (C7518).  There is no producer warpgroup: with one,
//     ptxas held every thread to 168 registers, too few for 128 accumulators
//     and two A sets (it serialized the wgmma, C7512); 256 threads may take
//     255.  A cluster of 2 CTAs sharing each stage by TMA multicast halved
//     the weights' L2 traffic but ran slower (the two CTAs step in lockstep).
//   * Epilogue into a float32 conv tile (reusing the ring and the input
//     tile), max-pooled there separably: a thread walks a pooled column of
//     four channels down the rows.  int8 dequantizes (the scales and one
//     frame's bias tile are staged in shared memory by cp.async); bf16
//     rounds bf16(bf16(acc) + corr) with one frame's corr tile brought by
//     TMA at the block's start (read from global memory in the epilogue, it
//     made conv1's epilogue far slower than the int8 form's).
//   * What holds them back on an H100 (variant builds, tools/lowp_variants.py,
//     PERF.md section 6): a block re-reads its weights (295 KB at conv2 in
//     int8, 590 KB in bf16), its input and bias tiles from L2, and one block
//     an SM leaves the epilogue unoverlapped.  The plans weigh rows a block
//     against those bytes.
#include "common.cuh"
#include "hopper.cuh"
#include "lowp_mma.cuh"

#include <cfloat>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWThreads = 256;   // two warpgroups; thread 0 also issues the weight and input loads

struct WgGeometry {
  int n, H, W, Cin, Cout;    // Cin: channels a position as stored (int8: Cin_p, a multiple of 64; bf16: of 64)
  int frames, rows, cols;    // the pooled tile of a block
  int tiles_y, tiles_x, co_tiles;
};

// The parts of a block's dynamic shared memory after 1024 bytes of alignment slack
// (ops/cuda/fused_stage.py::int8_smem_bytes and bf16_smem_bytes mirror them): the weight ring and the input ring
// (min(2, chunks) buffers of one chunk of the input tile: KB bytes x its positions, each a multiple of 1024),
// which the epilogue's float32 conv tile [positions][BN + 4] reuses; then the bias tile of one frame's conv
// positions: the int8 form's [Rc * Cc][BN + 16 bytes] (room for float32) and its BN dequantization scales, or
// the bf16 form's BN / 64 TMA boxes of [Rc * Cc][64 channels] in the 128-byte swizzle, each a multiple of 1024;
// then the barriers (the weight ring's full and empty ones, room for the most stages, the input ring's and the
// bias tile's).
enum BiasTile { kStagedBias = 1, kTmaBias = 2 };

struct WgSmem {
  size_t input, input_buf, body, bias, bias_box, scales, barriers, total;
};

__host__ __device__ inline WgSmem wg_smem(int ring_bytes, int bias_tile, int bn, int kb, int frames, int rows,
                                          int cols, int row_bytes) {
  const size_t stages = ring_bytes / (bn * 64);   // the most barriers a ring of stages of KB >= 64 takes
  const size_t per_frame = static_cast<size_t>(rows + 2) * (cols + 2);
  const size_t p = static_cast<size_t>(frames) * (rows + 4) * (cols + 4);
  const size_t bufs = row_bytes / kb < 2 ? 1 : 2;
  const size_t conv = 4 * frames * per_frame * (bn + 4);
  WgSmem s;
  s.input = ring_bytes;
  s.input_buf = (kb * p + 1023) / 1024 * 1024;
  const size_t rings = s.input + bufs * s.input_buf;
  s.body = ((rings > conv ? rings : conv) + 15) / 16 * 16;
  s.bias_box = (per_frame * 128 + 1023) / 1024 * 1024;
  if (bias_tile == kTmaBias) {
    s.bias = (s.body + 1023) / 1024 * 1024;
    s.scales = s.bias + bn / 64 * s.bias_box;
  } else {
    s.bias = s.body;
    s.scales = s.bias + per_frame * (4 * bn + 16);
  }
  s.barriers = s.scales + (bias_tile == kStagedBias ? 4 * bn : 0);
  s.total = 1024 + s.barriers + (2 * stages + 5) * sizeof(uint64_t);
  return s;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The int8 conv value before ReLU, rounded where the JAX package rounds: float32 out, or bf16 (the product
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

// ---------------------------------------------------------------- the two forms

// 2-int8: int8 x (quantized), packed int8 weights (Cout rows of 9 * Cin_p bytes) in boxes of KB bytes x BN rows;
// int32 sums; bias (H, W, Cout) and out in TOut (float32 or bf16); the scales s_x (one float) and s_w (Cout,).
template <typename TOut>
struct Int8Form {
  using Elem = int8_t;
  using Acc = int;
  using Out = TOut;
  static constexpr int kRingBytes = 64 * 1024;   // weights in flight
  static constexpr int kBias = kStagedBias;   // cp.async into a padded tile, beside the scales

  template <int BN, int KB>
  __device__ static void load(bool pred, uint8_t* dst, const CUtensorMap* map, int tap, int chunk,
                              const WgGeometry& g, int co0, uint64_t* bar) {
    tma_expect_load_2d_if(pred, dst, map, tap * g.Cin + chunk * KB, co0, bar, BN * KB);
  }
  // K-major: k32 step kk is 32 bytes into each BN row of KB bytes; SBO = 8 rows
  template <int BN, int KB>
  __device__ static uint64_t desc(const uint8_t* stage, int kk) {
    return smem_desc(stage + 32 * kk, 16, 8 * KB, KB == 128 ? kSwizzle128B : kSwizzle64B);
  }
  template <int BN>
  __device__ static void mma(int (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (BN == 128)
      wgmma_m64n128k32_s8_rs(d, a, db);
    else
      wgmma_m64n64k32_s8_rs(d, a, db);
  }
};

// 2-bf16: bf16 x and w (w as stored, HWIO: (9 Cin, Cout) row-major) in boxes of 64 columns x KB / 2 rows of K;
// float32 sums; bias (H, W, Cout) and out bf16.
struct Bf16Form {
  using Elem = bf16;
  using Acc = float;
  using Out = bf16;
  static constexpr int kRingBytes = 96 * 1024;   // weights in flight
  static constexpr int kBias = kTmaBias;         // TMA boxes of 64 channels

  template <int BN, int KB>
  __device__ static void load(bool pred, uint8_t* dst, const CUtensorMap* map, int tap, int chunk,
                              const WgGeometry& g, int co0, uint64_t* bar) {
    mbar_expect_tx_if(pred, bar, BN * KB);
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load_2d_if(pred, dst + c * 64 * KB, map, co0 + 64 * c, tap * g.Cin + chunk * (KB / 2), bar);
  }
  // N-major (transposed): k16 step kk is 16 rows of 128 bytes into each box; LBO = a box, SBO = 8 rows
  template <int BN, int KB>
  __device__ static uint64_t desc(const uint8_t* stage, int kk) {
    return smem_desc(stage + 16 * 128 * kk, 64 * KB, 1024, kSwizzle128B);
  }
  template <int BN>
  __device__ static void mma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (BN == 128)
      wgmma_m64n128k16_bf16_rs_bmn(d, a, db);
    else
      wgmma_m64n64k16_bf16_rs_bmn(d, a, db);
  }
};

// ---------------------------------------------------------------- the kernel

// xmap: x (n, H, W, Cin) in the form's element type as a 4-D map in boxes of (KB bytes of channels, Ci, Ri,
// frames) in the KB-byte swizzle; wmap: the form's weight map; bias (H, W, Cout) and out (n, H - 2, W - 2, Cout)
// in the form's output type; bmap: the bf16 form's bias, (H, W, C) with C a multiple of 8, in boxes of (64
// channels, Cc, Rc) in the 128-byte swizzle; s_x, s_w: the int8 form's scales (unused by bf16).
template <class Form, int MT, int BN, int KB>
__global__ void __launch_bounds__(kWThreads, 1) conv_pool_wgmma_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap bmap, const typename Form::Out* __restrict__ bias, const float* __restrict__ s_x, const float* __restrict__ s_w,
    typename Form::Out* __restrict__ out, const WgGeometry g) {
  using TOut = typename Form::Out;
  using Acc = typename Form::Acc;
  constexpr int SB = BN * KB, S = Form::kRingBytes / SB, KK = KB / 32;
  constexpr int kElems = KB / static_cast<int>(sizeof(typename Form::Elem));   // channels of a chunk
  extern __shared__ float4 smem4[];
  uint8_t* base = smem_align(reinterpret_cast<uint8_t*>(smem4), 1024);
  const int Rc = g.rows + 2, Cc = g.cols + 2, Ri = g.rows + 4, Ci = g.cols + 4;
  const int row_bytes = g.Cin * static_cast<int>(sizeof(typename Form::Elem));
  const int m_blk = g.frames * Rc * Cc;
  const WgSmem lay = wg_smem(Form::kRingBytes, Form::kBias, BN, KB, g.frames, g.rows, g.cols, row_bytes);
  constexpr int kBP = BN + 16 / static_cast<int>(sizeof(TOut));   // staged bias tile pitch, elements
  uint8_t* ring = base;                                            // S stages of SB bytes
  uint8_t* xin = base + lay.input;                                 // the input ring, [2][input_buf]
  TOut* bias_s = reinterpret_cast<TOut*>(base + lay.bias);         // int8: [Rc * Cc][kBP]; bf16: TMA boxes
  float* scale_s = reinterpret_cast<float*>(base + lay.scales);    // int8: [BN]: s_x * s_w[co]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.barriers);
  uint64_t* empty = full + S;
  uint64_t* xfull = full + 2 * (Form::kRingBytes / (BN * 64));     // [2]
  uint64_t* xempty = xfull + 2;                                    // [2]
  uint64_t* bbar = xempty + 2;                                     // the bf16 form's bias tile

  int b = blockIdx.x;
  const int ct = b % g.co_tiles;
  b /= g.co_tiles;
  const int tx = b % g.tiles_x;
  b /= g.tiles_x;
  const int ty = b % g.tiles_y;
  const int frame0 = (b / g.tiles_y) * g.frames, oy0 = ty * g.rows, ox0 = tx * g.cols, co0 = ct * BN;
  const int chunks = row_bytes / KB, n_stages = 9 * chunks;   // channel chunk major, then tap
  const int xbytes = KB * g.frames * Ri * Ci;                 // one chunk of the input tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // the 8 warps
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], 8);
    }
    mbar_init(bbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0 keeps the weight ring S stages ahead (stage i lands in slot i % S once every warp has released that
  // slot's previous stage) and the input ring two chunks ahead: chunk c of the tile (its channels c * kElems ..,
  // positions from (oy0 - 1, ox0 - 1) of frame0 on, zero outside the frames: the conv's padding) lands in buffer
  // c % 2 once every warp has loaded its A fragments from chunk c - 2
  auto load_stage = [&](int i) {
    Form::template load<BN, KB>(threadIdx.x == 0, ring + (i % S) * SB, &wmap, i % 9, i / 9, g, co0, &full[i % S]);
  };
  auto load_chunk = [&](int c) {
    mbar_expect_tx_if(threadIdx.x == 0, &xfull[c % 2], xbytes);
    tma_load_4d_if(threadIdx.x == 0, xin + (c % 2) * lay.input_buf, &xmap, c * kElems, ox0 - 1, oy0 - 1, frame0,
                   &xfull[c % 2]);
  };
  const int tid = threadIdx.x, wg = tid / 128;
  for (int c = 0; c < 2 && c < chunks; ++c) load_chunk(c);
  for (int i = 0; i < S && i < n_stages; ++i) load_stage(i);

  if constexpr (Form::kBias == kTmaBias) {
    // the bias of one frame's conv positions (the same for every frame) from (oy0, ox0), zero outside the frame
    mbar_expect_tx_if(tid == 0, bbar, BN / 64 * Rc * Cc * 128);
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load_4d_if(tid == 0, base + lay.bias + c * lay.bias_box, &bmap, co0 + 64 * c, ox0, oy0, 0, bbar);
  } else {
    // the bias of one frame's conv positions (the same for every frame), zero outside the frame and past Cout
    const bool vec_bias = (g.Cout * sizeof(TOut)) % 16 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
    if (vec_bias) {
      constexpr int kPer16 = 16 / static_cast<int>(sizeof(TOut));
      for (int e = tid; e < Rc * Cc * (BN / kPer16); e += kWThreads) {
        const int r = e / (BN / kPer16), c = kPer16 * (e % (BN / kPer16));
        const int cy = oy0 + r / Cc, cx = ox0 + r % Cc;
        const bool in = cy < g.H && cx < g.W && co0 + c < g.Cout;
        const TOut* src = in ? bias + (static_cast<long long>(cy) * g.W + cx) * g.Cout + co0 + c : bias;
        lp_cp_async16(bias_s + r * kBP + c, src, in);
      }
    } else {
      for (int e = tid; e < Rc * Cc * BN; e += kWThreads) {
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
    __syncthreads();   // the bias tile and the scales are in place for both warpgroups
  }

  // A rows: the input position of this warp's row lane % 16 of each m64 tile 2i + wg (tap 0), read at 16-byte
  // chunk lane / 16 of a 32-byte k-step; the tile's chunk buffer holds position p at p * KB bytes, its 16-byte
  // chunk j at j ^ (p * KB / 128 mod KB / 16) (TMA's KB-byte swizzle)
  const int w = (tid % 128) / 32, lane = tid % 32;
  int prow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int m = (2 * i + wg) * 64 + 16 * w + lane % 16;
    if (m >= m_blk) m = 0;   // padding rows compute a copy of row 0, never read
    const int f = m / (Rc * Cc), r = m % (Rc * Cc);
    prow[i] = (f * Ri + r / Cc) * Ci + r % Cc;
  }

  Acc acc[MT][BN / 2];
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
    const int s = st % S, tap = st % 9, c = st / 9;
    const int toff = (tap / 3) * Ci + tap % 3;
    const uint8_t* xs = xin + (c % 2) * lay.input_buf;
    mbar_wait(&xfull[c % 2], (c / 2) & 1);   // this stage's chunk of the input tile has landed
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int p = prow[i] + toff;
      const int sw = (p * KB / 128) & (KB / 16 - 1);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) ldsm_x4(af[i][kk], xs + p * KB + 16 * ((2 * kk + lane / 16) ^ sw));
    }
    if (tap == 8 && c + 2 < chunks) {   // every warp is done with this chunk: thread 0 loads chunk c + 2 in its place
      mbar_arrive_if(&xempty[c % 2], lane == 0);
      mbar_wait(&xempty[c % 2], (c / 2) & 1);
      load_chunk(c + 2);
    }
    mbar_wait(&full[s], (st / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t db = Form::template desc<BN, KB>(ring + s * SB, kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) Form::template mma<BN>(acc[i], af[i][kk], db);
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
  if constexpr (Form::kBias == kTmaBias) mbar_wait(bbar, 0);

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
      const int r = m % (Rc * Cc);
      if constexpr (Form::kBias == kStagedBias) {
        const TOut* bp = bias_s + r * kBP;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + 2 * q;
          const float v0 = conv_value(acc[i][4 * j + 2 * h], scale_s[cl], to_f32(bp[cl]), static_cast<TOut*>(nullptr));
          const float v1 =
              conv_value(acc[i][4 * j + 2 * h + 1], scale_s[cl + 1], to_f32(bp[cl + 1]), static_cast<TOut*>(nullptr));
          *reinterpret_cast<float2*>(conv + m * kCP + cl) = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      } else {
        // bf16(bf16(acc) + corr): channels cl, cl + 1 of position r are 4 bytes of 16-byte chunk (cl % 64) / 8 of
        // its 128-byte row in box cl / 64, stored at chunk ((cl % 64) / 8) ^ (r % 8)
        const uint8_t* bb = base + lay.bias + r * 128;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + 2 * q;
          const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(
              bb + (cl >> 6) * lay.bias_box + ((((cl & 63) >> 3) ^ (r & 7)) << 4) + (cl & 7) * 2);
          const float v0 = bf16_round(__fadd_rn(bf16_round(acc[i][4 * j + 2 * h]), __bfloat162float(b2.x)));
          const float v1 = bf16_round(__fadd_rn(bf16_round(acc[i][4 * j + 2 * h + 1]), __bfloat162float(b2.y)));
          *reinterpret_cast<float2*>(conv + m * kCP + cl) = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
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
  for (int e = tid; e < g.frames * g.cols * (BN / 4); e += kWThreads) {
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

// One launch of the kernel for `wmap` (the form's weight map) on x (n, H, W, Cin) in the form's element type,
// checked.
template <class Form, int MT, int BN, int KB>
int launch_wgmma(const CUtensorMap& wmap, const CUtensorMap& bmap, const void* x, const void* b, const float* s_x,
                 const float* s_w, void* out, const WgGeometry& g, cudaStream_t s) {
  using Elem = typename Form::Elem;
  const int row_bytes = g.Cin * static_cast<int>(sizeof(Elem));
  const size_t bytes = wg_smem(Form::kRingBytes, Form::kBias, BN, KB, g.frames, g.rows, g.cols, row_bytes).total;
  if (bytes > kMaxSmemBytes || row_bytes % KB != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((g.n + g.frames - 1) / g.frames) * g.tiles_y * g.tiles_x * g.co_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  const uint64_t dims[4] = {static_cast<uint64_t>(g.Cin), static_cast<uint64_t>(g.W), static_cast<uint64_t>(g.H),
                            static_cast<uint64_t>(g.n)};
  const uint64_t strides[3] = {static_cast<uint64_t>(row_bytes), static_cast<uint64_t>(row_bytes) * g.W,
                               static_cast<uint64_t>(row_bytes) * g.W * g.H};
  const uint32_t box[4] = {static_cast<uint32_t>(KB / sizeof(Elem)), static_cast<uint32_t>(g.cols + 4),
                           static_cast<uint32_t>(g.rows + 4), static_cast<uint32_t>(g.frames)};
  int err = make_tensor_map_4d(&xmap, x, sizeof(Elem) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                               dims, strides, box, KB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  auto kernel = conv_pool_wgmma_kernel<Form, MT, BN, KB>;
  err = allow_dynamic_smem(kernel, bytes);
  if (err) return err;
  using TOut = typename Form::Out;
  kernel<<<static_cast<unsigned>(blocks), kWThreads, bytes, s>>>(wmap, xmap, bmap, static_cast<const TOut*>(b), s_x,
                                                                 s_w, static_cast<TOut*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

WgGeometry geometry(int n, int H, int W, int cin, int cout, int frames, int rows, int cols, int block_n) {
  WgGeometry g;
  g.n = n, g.H = H, g.W = W, g.Cin = cin, g.Cout = cout;
  g.frames = frames, g.rows = rows, g.cols = cols;
  g.tiles_y = (H - 2 + rows - 1) / rows, g.tiles_x = (W - 2 + cols - 1) / cols;
  g.co_tiles = (cout + block_n - 1) / block_n;
  return g;
}

bool tile_ok(int n, int H, int W, int frames, int rows, int cols, int m_tiles) {
  return n >= 1 && H >= 3 && W >= 3 && frames >= 1 && rows >= 1 && rows <= H - 2 && cols >= 1 && cols <= W - 2 &&
         frames * (rows + 2) * (cols + 2) <= 128 * m_tiles && static_cast<long long>(n) * H * W < (1LL << 31);
}

// ---------------------------------------------------------------- the int8 form's passes around the conv

constexpr int kIKC = 64;   // Cin is padded to a multiple of this many bytes (int8 channels)


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
int launch_int8(const I8Workspace& p, const void* b, void* out, const WgGeometry& g, cudaStream_t s) {
  CUtensorMap wmap;
  const int err = make_tensor_map_2d(&wmap, p.wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 9ull * g.Cin, g.Cout, 9ull * g.Cin,
                                     KC, BN, KC == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  return launch_wgmma<Int8Form<TOut>, MT, BN, KC>(wmap, wmap, p.xq, b, p.s_x, p.s_w, out, g, s);   // (no bias map)
}

}  // namespace

// The bf16 form: x (n, H, W, Cin) bf16 with Cin a multiple of 64; w (3, 3, Cin, c_cols) and b (H, W, c_cols) bf16
// (w in HWIO; c_cols >= Cout a multiple of 8, w's and b's channels past Cout zero); out (n, H-2, W-2, Cout) bf16;
// x, w and b 16-byte aligned.  The plan (ops/cuda/fused_stage.py::bf16_stage_plan): `frames` per block, pooled
// tiles of rows x cols, (m_tiles, block_n) in {(2, 128), (4, 64)} with frames * (rows + 2) * (cols + 2) <=
// 128 * m_tiles.  One launch, checked.
extern "C" int fused_conv_pool_stage_bf16(const void* x, const void* w, const void* b, void* out, int n, int H,
                                          int W, int Cin, int Cout, int c_cols, int frames, int rows, int cols,
                                          int m_tiles, int block_n, void* stream) {
  const bool shape_ok = (m_tiles == 2 && block_n == 128) || (m_tiles == 4 && block_n == 64);
  if (!shape_ok || !tile_ok(n, H, W, frames, rows, cols, m_tiles) || Cin < 64 || Cin % 64 != 0 || Cout < 1 ||
      c_cols < Cout || c_cols % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // (2, 128) takes stages of 64 channels (128 bytes of A); (4, 64) 32 channels (four m64 tiles' two A register
  // sets would not fit at 64)
  const int kb = m_tiles == 2 ? 128 : 64;
  CUtensorMap wmap, bmap;
  int err = make_tensor_map_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c_cols, 9ull * Cin, 2ull * c_cols, 64,
                               kb / 2, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const uint64_t dims[4] = {static_cast<uint64_t>(c_cols), static_cast<uint64_t>(W), static_cast<uint64_t>(H), 1};
  const uint64_t strides[3] = {2ull * c_cols, 2ull * c_cols * W, 2ull * c_cols * W * H};
  const uint32_t box[4] = {64, static_cast<uint32_t>(cols + 2), static_cast<uint32_t>(rows + 2), 1};
  err = make_tensor_map_4d(&bmap, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const WgGeometry g = geometry(n, H, W, Cin, Cout, frames, rows, cols, block_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_tiles == 2) return launch_wgmma<Bf16Form, 2, 128, 128>(wmap, bmap, x, b, nullptr, nullptr, out, g, s);
  return launch_wgmma<Bf16Form, 4, 64, 64>(wmap, bmap, x, b, nullptr, nullptr, out, g, s);
}

// The int8 form, the whole call: x (n, H, W, Cin) float32 (is_bf16 = 0) or bf16, 16-byte aligned; w (3, 3, Cin,
// Cout) float32; b (H, W, Cout) and out (n, H-2, W-2, Cout) in x's dtype; ws: the workspace above.  The plan
// (ops/cuda/fused_stage.py::int8_stage_plan): `frames` per block, pooled tiles of rows x cols, (m_tiles,
// block_n) in {(2, 128), (4, 64)} with frames * (rows + 2) * (cols + 2) <= 128 * m_tiles.  Four launches (after a
// 8-byte memset): the scale, the activations, the weights, the conv; each checked.  s_given: null, or a float32 on
// the card that is the activation scale to quantize with (a data-parallel batch's, over every block): then the
// scale's launch and its memset are skipped.
extern "C" int fused_conv_pool_stage_int8(const void* x, const void* w, const void* b, void* out, void* ws, int n,
                                          int H, int W, int Cin, int Cout, int is_bf16, int frames, int rows, int cols,
                                          int m_tiles, int block_n, const void* s_given, void* stream) {
  const bool shape_ok = (m_tiles == 2 && block_n == 128) || (m_tiles == 4 && block_n == 64);
  if (!shape_ok || !tile_ok(n, H, W, frames, rows, cols, m_tiles) || Cin < 1 || Cout < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(ws) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cin_p = (Cin + kIKC - 1) / kIKC * kIKC;
  const long long positions = static_cast<long long>(n) * H * W;
  I8Workspace p = int8_workspace(ws, positions, cin_p, Cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (s_given)
    p.s_x = const_cast<float*>(static_cast<const float*>(s_given));
  else
    err = launch_act_scale(x, positions * Cin, is_bf16, p.scalars, p.s_x, s);
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
  const WgGeometry g = geometry(n, H, W, cin_p, Cout, frames, rows, cols, block_n);
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
