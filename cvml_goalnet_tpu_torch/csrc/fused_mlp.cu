// The fusion MLP in one launch: up to 8 chained linears with ReLU between,
// then (hi - lo) * sigmoid + lo (or the raw logits), float32 throughout.
//
// Replaces cvml_goalnet_tpu/ops/pallas/fused_mlp.py::fused_fusion_mlp (its
// _kernel): 640 -> 512 -> 512 -> 256 -> 128 -> 1 at the reference width,
// the whole chain per row tile with the hidden activations on chip.
//
// What bounds it on an H100: arithmetic.  A row costs 753,792 FMAs at the
// reference widths, so M = 1050 rows are 1.583 GFLOP: 23.6 us at the
// 67 TFLOP/s float32 rate of the CUDA cores (no tensor cores: TF32 would
// break the 1e-5 contract).  The 3.02 MB of weights cost 0.9 us from HBM.
// The TPU kernel holds every weight in VMEM; 3 MB does not fit in one SM, and
// a block that streams all of them from L2 for a few rows is bound by L2
// instead.  So here:
//   * a thread-block cluster of C blocks (C <= 8) owns one tile of BM rows,
//     and each block computes a slice of about N / C columns of every layer:
//     each block streams only its own weight columns, so the weights cross
//     L2 ceil(M / BM) times per call, not once per few rows;
//   * after each layer every block writes its slice, bias and ReLU applied,
//     into the next activation buffer of every block of its cluster through
//     distributed shared memory, then the cluster synchronises: hidden
//     activations never leave the cluster, as in the TPU kernel;
//   * activations live k-major in shared memory ([k][row]); the tile's input
//     and the weight chunks (32 rows of K by up to 256 columns) arrive by
//     cp.async, the chunks through a three-stage ring with one __syncthreads
//     per chunk; a thread's copies of a chunk are a few adds, no divisions;
//   * each thread accumulates an 8 x 8 tile in registers (rows 4r..4r+3 and
//     BM/2 + 4r.., columns 4c..4c+3 and half a pass further, so every float4
//     load of a quarter-warp is contiguous): 4 float4 shared loads per 64
//     FMAs;
//   * a pass has fewer 8 x 8 tiles than threads when a block's slice is
//     narrow (always, at the path's shapes: 16 rows by 256 columns are 64
//     tiles), so G = 2^j thread groups split each chunk's K and their partial
//     sums, parked in the free ring, are added in a fixed order; the 128 -> 1
//     layer is a reduction over up to 32 groups, not one thread's chain;
//   * no atomics anywhere, so two calls on the same inputs give equal bits.
// (BM, C) comes from the caller's tile plan (ops/cuda/fused_mlp.py::tile_plan):
// a cost model fitted to every plan's time, with the card's count of clusters
// that run at once (a cluster lives in one GPC: 30 clusters of 4 at a time).
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, PERF.md):
// 0.08-0.10 ms at M = 1050 (plan 16 x 2, 132 blocks), about half the time
// of a chain of addmm.  A block takes about 41 us whatever its share
// (pipeline fills at each layer, cluster syncs, the epilogues), then runs
// its FMAs near the FP32 rate; the weight copies and the FMAs' shared loads
// share the SM's shared-memory bandwidth and add up rather than overlap.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "lowp_mma.cuh"   // bf16_round

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;
constexpr int kMaxCluster = 8;
constexpr int kStages = 3;
constexpr int kChunkK = 32;                          // K rows per weight chunk
constexpr int kPassCols = 256;                       // columns per pass: the stage's row stride
constexpr int kStageFloats = kChunkK * kPassCols;    // 32 KB; the ring also holds up to 64 KB of partial sums
constexpr size_t kSmemLimit = 232448;
static_assert(kStages * kStageFloats >= kThreads * 64, "between passes the ring holds every thread's 8 x 8 partial sums");

struct MlpArgs {
  const float* w[kMaxLayers];  // (dims[l], dims[l+1]) row-major, (in, out)
  const float* b[kMaxLayers];  // (dims[l+1],)
  int dims[kMaxLayers + 1];
  int vec[kMaxLayers];  // 1 when rows of w[l] take 16-byte copies: N % 4 == 0 and w 16-byte aligned
  int n_layers;
  int width[2];  // k extents of the two activation buffers (inputs of the even and the odd layers)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [k0, k0 + kc) and columns [col0, col0 + nc) of W (K, N) into a stage laid out [kk][kPassCols].
// With 16-byte copies a thread owns one column quad (tid % 64) and every fourth row from tid / 64: the
// copies of a chunk cost a few adds, no divisions.
__device__ __forceinline__ void load_chunk(float* stage, const float* __restrict__ W, int N, bool vec, int k0,
                                           int kc, int col0, int nc) {
  static_assert(kThreads == 4 * (kPassCols / 4), "one column quad per thread for four rows at a time");
  const int tid = threadIdx.x;
  if (vec) {  // nc % 4 == 0, col0 % 4 == 0
    const int j = 4 * (tid & 63), kr = tid >> 6;
    if (j >= nc) return;
    const float* src = W + static_cast<size_t>(k0 + kr) * N + col0 + j;
    float* dst = stage + kr * kPassCols + j;
#pragma unroll
    for (int s = 0; s < kChunkK / 4; ++s) {
      if (kr + 4 * s < kc) cp_async16(dst + 4 * s * kPassCols, src + 4 * s * static_cast<size_t>(N));
    }
  } else if (tid < nc) {
    for (int kk = 0; kk < kc; ++kk) {
      cp_async4(stage + kk * kPassCols + tid, W + static_cast<size_t>(k0 + kk) * N + col0 + tid);
    }
  }
}

// One k of the 8 x 8 tile: rows a[0..3], a[half..half+3]; columns w[0..3], w[wh..wh+3].
template <int BM>
__device__ __forceinline__ void fma8x8(float (&acc)[8][8], const float* a, const float* w, int wh) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + BM / 2);
  const float4 w0 = *reinterpret_cast<const float4*>(w);
  const float4 w1 = *reinterpret_cast<const float4*>(w + wh);
  const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
  }
}

// A group's share of one full chunk: KPG k-steps, unrolled.
template <int BM, int KPG>
__device__ __forceinline__ void fma_steps(float (&acc)[8][8], const float* a, const float* w, int wh) {
#pragma unroll
  for (int kk = 0; kk < KPG; ++kk) fma8x8<BM>(acc, a + kk * BM, w + kk * kPassCols, wh);
}

template <int BM>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const float* __restrict__ x,
                                                             float* __restrict__ y, int M, MlpArgs args,
                                                             int squash, float lo, float hi) {
  constexpr int NRG = BM / 8;  // row groups: a thread's 8 rows are 4rg.. and BM/2 + 4rg..
  extern __shared__ float4 smem4[];
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const buf1 = buf0 + BM * args.width[0];
  float* const ring = buf1 + BM * args.width[1];  // kStages chunks; between passes, the partial sums

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / C * BM;
  const int tid = threadIdx.x;

  // the tile's input, k-major (buf0[k * BM + r]), as the oldest copy group; rows past M are zeros
  const int d0 = args.dims[0];
  for (int e = tid; e < BM * d0; e += kThreads) {
    const int k = e / BM, r = e - k * BM;
    if (row0 + r < M) {
      cp_async4(buf0 + e, x + static_cast<size_t>(row0 + r) * d0 + k);
    } else {
      buf0[e] = 0.f;
    }
  }
  cp_async_commit();
  // every block of the cluster runs (its shared memory exists) before any remote write
  cluster.sync();

  for (int l = 0; l < args.n_layers; ++l) {
    const int K = args.dims[l], N = args.dims[l + 1];
    const bool last = l == args.n_layers - 1;
    const bool vec = args.vec[l] != 0;
    const float* __restrict__ W = args.w[l];
    const float* in = (l & 1) ? buf1 : buf0;
    float* out = (l & 1) ? buf0 : buf1;
    const int ncta = ((N + C - 1) / C + 3) & ~3;  // columns per block, a multiple of 4
    const int n0 = rank * ncta;
    const int n_mine = min(ncta, N - n0);  // <= 0: no columns of this layer here
    const int n_chunks = (K + kChunkK - 1) / kChunkK;

    for (int c0 = 0; c0 < n_mine; c0 += kPassCols) {
      const int nc = min(kPassCols, n_mine - c0);
      const int ncg = (nc + 7) >> 3;  // column groups of 8: 4cg.. and 4 ncg + 4cg..
      const int tiles = NRG * ncg;
      int G = 1;  // thread groups splitting K: a power of two, at most kChunkK
      while (G < kChunkK && 2 * G * tiles <= kThreads) G *= 2;
      const int kpg = kChunkK / G;
      const bool active = tid < G * tiles;
      const int g = tid / tiles, m = tid - g * tiles;
      const int rg = m % NRG, cgi = m / NRG;
      const int wh = 4 * ncg;
      float acc[8][8] = {};

#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_chunks) {
          load_chunk(ring + s * kStageFloats, W, N, vec, s * kChunkK, min(kChunkK, K - s * kChunkK), n0 + c0, nc);
        }
        cp_async_commit();
      }
      for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait<kStages - 2>();  // this thread's copies of chunk c (and of the input) have landed
        __syncthreads();               // everyone's have, and everyone is done with chunk c - 1
        const int cn = c + kStages - 1;
        if (cn < n_chunks) {
          load_chunk(ring + (cn % kStages) * kStageFloats, W, N, vec, cn * kChunkK, min(kChunkK, K - cn * kChunkK),
                     n0 + c0, nc);
        }
        cp_async_commit();
        if (active) {
          const float* a = in + c * kChunkK * BM + 4 * rg;
          const float* w = ring + (c % kStages) * kStageFloats + 4 * cgi;
          const int kc = min(kChunkK, K - c * kChunkK);
          const int kb = g * kpg;
          if (kc == kChunkK) {
            switch (kpg) {
              case 32: fma_steps<BM, 32>(acc, a, w, wh); break;
              case 16: fma_steps<BM, 16>(acc, a + kb * BM, w + kb * kPassCols, wh); break;
              case 8: fma_steps<BM, 8>(acc, a + kb * BM, w + kb * kPassCols, wh); break;
              case 4: fma_steps<BM, 4>(acc, a + kb * BM, w + kb * kPassCols, wh); break;
              case 2: fma_steps<BM, 2>(acc, a + kb * BM, w + kb * kPassCols, wh); break;
              default: fma_steps<BM, 1>(acc, a + kb * BM, w + kb * kPassCols, wh); break;
            }
          } else {
            const int ke = min(kc, kb + kpg);
#pragma unroll 4
            for (int kk = kb; kk < ke; ++kk) fma8x8<BM>(acc, a + kk * BM, w + kk * kPassCols, wh);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring is free: it takes the partial sums, [group][column][row]

      float* red = ring;
      const int red_stride = 8 * ncg * BM;
      if (active) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* dst = red + g * red_stride + (j < 4 ? 4 * cgi + j : wh + 4 * cgi + j - 4) * BM + 4 * rg;
          *reinterpret_cast<float4*>(dst) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          *reinterpret_cast<float4*>(dst + BM / 2) = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
        }
      }
      __syncthreads();
      const float* __restrict__ bias = args.b[l];
      for (int q = tid; q < (BM / 4) * nc; q += kThreads) {
        const int col = q / (BM / 4), rq = q - col * (BM / 4);
        const float* p = red + col * BM + 4 * rq;
        float4 v = *reinterpret_cast<const float4*>(p);
        for (int gg = 1; gg < G; ++gg) {  // groups in order: the same bits on every call
          const float4 u = *reinterpret_cast<const float4*>(p + gg * red_stride);
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        const int gc = n0 + c0 + col;
        const float bj = __ldg(bias + gc);
        const float r[4] = {v.x + bj, v.y + bj, v.z + bj, v.w + bj};
        if (last) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = row0 + 4 * rq + i;
            const float t = squash ? (hi - lo) * (1.f / (1.f + expf(-r[i]))) + lo : r[i];
            if (row < M) y[static_cast<size_t>(row) * N + gc] = t;
          }
        } else {
          const float4 o = make_float4(fmaxf(r[0], 0.f), fmaxf(r[1], 0.f), fmaxf(r[2], 0.f), fmaxf(r[3], 0.f));
          for (int peer = 0; peer < C; ++peer) {
            float* dst = cluster.map_shared_rank(out, peer);
            *reinterpret_cast<float4*>(dst + gc * BM + 4 * rq) = o;
          }
        }
      }
      __syncthreads();  // the partial sums are read before the next pass refills the ring
    }
    // every slice of layer l is in every block's buffer, and nobody reads layer l's input any more
    if (!last) cluster.sync();
  }
}

int fill_args(MlpArgs* args, int n_layers, const void* const* w_ptrs, const void* const* b_ptrs, const int* dims) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  *args = {};
  args->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    args->dims[l] = dims[l];
    if (l < n_layers && dims[l] > args->width[l & 1]) args->width[l & 1] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    args->w[l] = static_cast<const float*>(w_ptrs[l]);
    args->b[l] = static_cast<const float*>(b_ptrs[l]);
    args->vec[l] = dims[l + 1] % 4 == 0 && reinterpret_cast<uintptr_t>(w_ptrs[l]) % 16 == 0;
  }
  return 0;
}

// The same count as ops/cuda/fused_mlp.py::smem_bytes.
size_t smem_bytes(int block_rows, const MlpArgs& args) {
  return sizeof(float) *
         (static_cast<size_t>(block_rows) * (args.width[0] + args.width[1]) + kStages * kStageFloats);
}

cudaLaunchConfig_t launch_config(int blocks, size_t bytes, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr, int threads = kThreads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BM>
int launch(const float* x, float* y, int M, const MlpArgs& args, int cluster, int squash, float lo, float hi,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(BM, args);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_dynamic_smem(fused_mlp_kernel<BM>, bytes);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config((M + BM - 1) / BM * cluster, bytes, cluster, stream, &attr);
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, fused_mlp_kernel<BM>, x, y, M, args, squash, lo, hi));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int max_clusters(const MlpArgs& args, int cluster, int* out) {
  const size_t bytes = smem_bytes(BM, args);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_dynamic_smem(fused_mlp_kernel<BM>, bytes);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, bytes, cluster, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fused_mlp_kernel<BM>, &cfg));
}

}  // namespace

// x: (M, dims[0]); y: (M, dims[n_layers]).  w_ptrs, b_ptrs and dims are HOST
// arrays of n_layers device pointers and n_layers + 1 widths.  block_rows
// (8, 16, 24 or 32) and cluster (1 to 8) are the tile plan.
extern "C" int fused_mlp(const void* x, void* y, int M, int n_layers, const void* const* w_ptrs,
                         const void* const* b_ptrs, const int* dims, int squash, float lo, float hi,
                         int block_rows, int cluster, void* stream) {
  MlpArgs args;
  const int err = fill_args(&args, n_layers, w_ptrs, b_ptrs, dims);
  if (err) return err;
  if (M < 1 || cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 8: return launch<8>(xf, yf, M, args, cluster, squash, lo, hi, s);
    case 16: return launch<16>(xf, yf, M, args, cluster, squash, lo, hi, s);
    case 24: return launch<24>(xf, yf, M, args, cluster, squash, lo, hi, s);
    case 32: return launch<32>(xf, yf, M, args, cluster, squash, lo, hi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of this plan the card runs at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int fused_mlp_max_clusters(int n_layers, const int* dims, int block_rows, int cluster, int* out) {
  MlpArgs args;
  const void* none[kMaxLayers] = {};
  const int err = fill_args(&args, n_layers, none, none, dims);
  if (err) return err;
  if (cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  switch (block_rows) {
    case 8: return max_clusters<8>(args, cluster, out);
    case 16: return max_clusters<16>(args, cluster, out);
    case 24: return max_clusters<24>(args, cluster, out);
    case 32: return max_clusters<32>(args, cluster, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 form (4-bf16): replaces fused_fusion_mlp at bf16 inputs, as the JAX package's bf16 eval forward
// runs the chain (XLA, models/avm.py:163-175 via layers.py:53-56): each layer bf16(bf16(x . w) + b) from
// float32 sums, ReLU between, then the squash in bf16 op by op: e = bf16(exp(-x)), d = bf16(1 + e),
// s = bf16(1 / d), out = bf16(bf16((hi - lo) s) + lo), so the scores lie on the bf16 grid.
// What bounds it on an H100: 1.58 GFLOP at M = 1050 is 1.6 us of bf16 tensor cores and its 1.5 MB of
// weights 0.5 us from HBM, so what a design can lose is the weights' path through L2 (a block of a few rows
// that streams all 1.5 MB is bound by it) and the chain's serial steps.  So, as the float32 form:
//   * a thread-block cluster of C CTAs (C <= 8) owns a tile of R rows (16, 32 or 64), and each CTA computes
//     the 64-column tiles t = rank, rank + C, ... of every layer but the last, streaming only those columns
//     of w: each weight crosses L2 once per row tile;
//   * the products are wgmma with the roles swapped: A is w's 64 output columns, read by TMA from w as stored
//     ((in, out) row-major: M-major, through the transpose bit), B is the tile's activations, K-major, so
//     wgmma's N is the row tile and a tile can be 16 or 32 rows where 64 would leave the card idle
//     (m64nRk16, float32 accumulators, R / 2 a thread); each 64 of K goes into a fresh accumulator added to
//     the sum in float32 (one accumulator over K = 640 left several times as many outputs past 2 bf16 ulps
//     of a float64-sum chain as the plain version; tools/mlp_bf16_accuracy.py measures both sides);
//   * activations live in shared memory as bf16 in wgmma's canonical K-major layout, 128-byte swizzle: a
//     panel of R rows x 64 columns (R x 128 bytes) per 64 of K; the input tile arrives by TMA in that layout
//     (zero past M and past the width), and a CTA's output tile t of a layer is the next layer's panel t, so
//     it writes it, bias, rounding and ReLU applied, into its own buffer and copies it to every other CTA of
//     the cluster through distributed shared memory, then the cluster synchronises;
//   * the weights stream through a ring of 8 stages of 64 K x 64 columns (8 KB) across layers and tiles: one
//     thread keeps it 8 stages ahead, predicated (csrc/hopper.cuh: no branch on the thread with wgmma in
//     flight), so the next layer's weights load during a layer's epilogue and cluster sync;
//   * the last layer (128 -> 1: a 2-byte row stride TMA cannot take, and N below wgmma's least) runs on the
//     CUDA cores from the shared activations: its R x N outputs are spread over the cluster's CTAs, each
//     summed by a group of up to 32 lanes in a fixed order (strided partial sums, then a shuffle tree);
//   * one launch a call, no workspace, no atomics: two calls on the same inputs give equal bits.
// (R, C) comes from ops/cuda/fused_mlp.py::bf16_mlp_plan with the card's count of clusters at once.
namespace {

constexpr int kB16Threads = 128;                // one warpgroup; its thread 0 also issues the weight loads
constexpr int kB16Stages = 8;                   // the weight ring
constexpr int kB16StageBytes = 64 * 64 * 2;     // 64 of K x 64 output columns, bf16
constexpr int kB16MaxLast = 16;                 // the widest last layer (CUDA cores)

struct MlpBf16Args {
  const __nv_bfloat16* b[kMaxLayers];   // (dims[l + 1],)
  const __nv_bfloat16* w_last;          // (dims[L - 1], dims[L]) row-major
  int dims[kMaxLayers + 1];             // the chain's widths
  int n_layers;
  int panels[2];                        // 64-wide K panels of the two activation buffers
};

// x: (M, x_cols) in boxes of 64 columns x R rows; w[l] (l < L - 1): (dims[l], cols[l]) in boxes of 64 x 64
struct MlpBf16Maps {
  CUtensorMap x;
  CUtensorMap w[kMaxLayers - 1];
};

__device__ __forceinline__ float squash_bf16(float v, float scale, float lo) {
  const float e = bf16_round(expf(-v));
  const float d = bf16_round(__fadd_rn(1.f, e));
  const float s = bf16_round(__fdiv_rn(1.f, d));
  return bf16_round(__fadd_rn(bf16_round(__fmul_rn(scale, s)), lo));
}

// Byte offset of (row r, column k < 64) in a K-major panel in the 128-byte swizzle: 16-byte chunk k / 8 of
// row r is stored at chunk (k / 8) ^ (r % 8).
__device__ __forceinline__ int panel_offset(int r, int k) { return r * 128 + ((((k >> 3) ^ (r & 7)) << 4) | ((k & 7) << 1)); }

template <int R>
__device__ __forceinline__ void wgmma_rows(float (&d)[R / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (R == 64)
    wgmma_m64n64k16_bf16_ss_amn(d, da, db, accumulate);
  else if constexpr (R == 32)
    wgmma_m64n32k16_bf16_ss_amn(d, da, db, accumulate);
  else
    wgmma_m64n16k16_bf16_ss_amn(d, da, db, accumulate);
}

// The ring's position in this CTA's stream of weight stages: layer l (< L - 1), its tile t, K chunk kc.
struct Cursor {
  int l, t, kc;
};

template <int R>
__global__ void __launch_bounds__(kB16Threads, 1) fused_mlp_bf16_kernel(const __grid_constant__ MlpBf16Maps maps,
                                                                        __nv_bfloat16* __restrict__ y, int M,
                                                                        const MlpBf16Args a, int squash,
                                                                        float scale, float lo) {
  constexpr int PB = R * 128;   // bytes of one panel
  constexpr int S = kB16Stages, SB = kB16StageBytes;
  extern __shared__ float4 smem4[];
  uint8_t* base = smem_align(reinterpret_cast<uint8_t*>(smem4), 1024);
  uint8_t* const buf0 = base;
  uint8_t* const buf1 = base + a.panels[0] * PB;
  uint8_t* const ring = buf1 + a.panels[1] * PB;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SB);
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / C * R;
  const int tid = threadIdx.x, lane = tid % 32;
  const int n_tc = a.n_layers - 1;   // layers on the tensor cores

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the 4 warps
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the tile's input, panel by panel
  const int xp = (a.dims[0] + 63) / 64;
  mbar_expect_tx_if(tid == 0, xbar, xp * PB);
  for (int p = 0; p < xp; ++p) tma_load_2d_if(tid == 0, buf0 + p * PB, &maps.x, 64 * p, row0, xbar);

  // the weight stream: every thread walks it (the same for all), thread 0 issues
  auto settle = [&](Cursor& c) {   // past the layers where this CTA has no tile
    while (c.l < n_tc && c.t >= (a.dims[c.l + 1] + 63) / 64) {
      ++c.l;
      c.t = rank;
    }
  };
  auto advance = [&](Cursor& c) {
    if (++c.kc == (a.dims[c.l] + 63) / 64) {
      c.kc = 0;
      c.t += C;
      settle(c);
    }
  };
  auto issue = [&](const Cursor& c, int slot) {
    tma_expect_load_2d_if(tid == 0, ring + slot * SB, &maps.w[c.l], 64 * c.t, 64 * c.kc, &full[slot], SB);
  };
  Cursor pc = {0, rank, 0};
  settle(pc);
  for (int s = 0; s < S && pc.l < n_tc; ++s) {
    issue(pc, s);
    advance(pc);
  }
  // stage j's slot is free once every warp's wgmma that read it are done: refill it with stage j + S
  auto release = [&](int j) {
    mbar_arrive_if(&empty[j % S], lane == 0);
    if (pc.l < n_tc) {
      mbar_wait(&empty[j % S], (j / S) & 1);
      issue(pc, j % S);
      advance(pc);
    }
  };
  cluster.sync();   // every CTA of the cluster runs (its shared memory exists) before any remote write
  mbar_wait(xbar, 0);

  const int w = tid / 32, g = lane / 4, q = lane % 4;
  int i = 0;   // weight stages consumed
  for (int l = 0; l < n_tc; ++l) {
    const uint8_t* in = (l & 1) ? buf1 : buf0;
    uint8_t* next = (l & 1) ? buf0 : buf1;
    const int N = a.dims[l + 1], n_k = (a.dims[l] + 63) / 64, n_t = (N + 63) / 64;
    for (int t = rank; t < n_t; t += C) {
      // each 64-deep chunk into a fresh accumulator (p0, p1 in turns), added to acc in float32 once its group is
      // done: one accumulator over all of K drifts from float32 sums (wgmma's adds do not round to nearest)
      float acc[R / 2], p0[R / 2], p1[R / 2];
#pragma unroll
      for (int j = 0; j < R / 2; ++j) {
        acc[j] = p0[j] = p1[j] = 0.f;
        fence_operand(acc[j]);
        fence_operand(p0[j]);
        fence_operand(p1[j]);
      }
      // no register of a group in flight is touched, and no branch holds a register op (C7518): prev is the
      // previous chunk's, zero before the first
      auto chunk = [&](int kc, float (&p)[R / 2], float (&prev)[R / 2]) {
        const int s = i % S;
        mbar_wait(&full[s], (i / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: w's 16 K rows kk of the stage (M-major, one 64-column atom); B: 16 K of every row of panel kc
          const uint64_t da = smem_desc(ring + s * SB + 16 * 128 * kk, SB, 1024, kSwizzle128B);
          const uint64_t db = smem_desc(in + kc * PB + 32 * kk, 16, 1024, kSwizzle128B);
          wgmma_rows<R>(p, da, db, kk);
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < R / 2; ++j) {
          fence_operand(prev[j]);
          acc[j] += prev[j];
        }
        if (kc > 0) release(i - 1);
        ++i;
      };
      int kc = 0;
      for (; kc + 1 < n_k; kc += 2) {
        chunk(kc, p0, p1);
        chunk(kc + 1, p1, p0);
      }
      if (kc < n_k) chunk(kc, p0, p1);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < R / 2; ++j) {
        fence_operand(p0[j]);
        fence_operand(p1[j]);
        acc[j] += (n_k & 1) ? p0[j] : p1[j];
      }
      release(i - 1);
      // acc[4j + e]: output column 64t + 16w + g + 8(e / 2) of row 8j + 2q + e % 2: into panel t of `next`
      const __nv_bfloat16* bias = a.b[l];
      float bv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 64 * t + 16 * w + g + 8 * h;
        bv[h] = n < N ? __bfloat162float(bias[n]) : 0.f;   // columns past N are zero: w's are zero-filled
      }
      uint8_t* panel = next + t * PB;
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * q + (e & 1), k = 16 * w + g + 8 * (e >> 1);
          const float v = bf16_round(__fadd_rn(bf16_round(acc[4 * j + e]), bv[e >> 1]));
          *reinterpret_cast<__nv_bfloat16*>(panel + panel_offset(r, k)) = __float2bfloat16_rn(fmaxf(v, 0.f));
        }
    }
    __syncthreads();   // this CTA's panels of layer l are whole: copy them to the rest of the cluster
    for (int t = rank; t < n_t; t += C) {
      const uint4* src = reinterpret_cast<const uint4*>(next + t * PB);
      for (int e = tid; e < (PB / 16) * (C - 1); e += kB16Threads) {
        const int pi = e / (PB / 16), c = e % (PB / 16);
        uint4* dst = reinterpret_cast<uint4*>(cluster.map_shared_rank(next + t * PB, pi < rank ? pi : pi + 1));
        dst[c] = src[c];
      }
    }
    fence_proxy_async();   // the panels, local and remote, are read next by wgmma (the async proxy)
    cluster.sync();        // every panel of layer l is in every CTA, and nobody reads layer l's input any more
    fence_proxy_async();
  }

  // the last layer on the CUDA cores: output o = rank + C u (row o / N, column o % N) of this CTA, summed by G
  // lanes over K strided by G, then a shuffle tree; rows past M are not stored
  const int l = a.n_layers - 1, K = a.dims[l], N = a.dims[l + 1];
  const uint8_t* in = (l & 1) ? buf1 : buf0;
  const int outs = (R * N - rank + C - 1) / C;
  int G = 1;
  while (G < 32 && 2 * G * outs <= kB16Threads) G *= 2;
  const int sub = tid % G;
  for (int u0 = 0; u0 < outs; u0 += kB16Threads / G) {
    const int u = u0 + tid / G, o = rank + C * u;
    const bool live = u < outs;
    const int r = live ? o / N : 0, n = live ? o % N : 0;
    float sum = 0.f;
    for (int k = sub; live && k < K; k += G) {
      const float v = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(in + (k >> 6) * PB + panel_offset(r, k & 63)));
      sum = fmaf(v, __bfloat162float(a.w_last[static_cast<size_t>(k) * N + n]), sum);
    }
    for (int d = G / 2; d >= 1; d /= 2) sum += __shfl_down_sync(0xffffffffu, sum, d, G);
    if (live && sub == 0 && row0 + r < M) {
      float v = bf16_round(__fadd_rn(bf16_round(sum), __bfloat162float(a.b[l][n])));
      if (squash) v = squash_bf16(v, scale, lo);
      y[static_cast<size_t>(row0 + r) * N + n] = __float2bfloat16_rn(v);
    }
  }
}

// The widths and panels of a chain (the same checks as ops/cuda/fused_mlp.py::bf16_dims).
int fill_bf16_args(MlpBf16Args* a, int n_layers, const void* const* b_ptrs, const void* w_last, const int* dims) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  *a = {};
  a->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    a->dims[l] = dims[l];
    if (l < n_layers && (dims[l] + 63) / 64 > a->panels[l & 1]) a->panels[l & 1] = (dims[l] + 63) / 64;
  }
  if (dims[n_layers] > kB16MaxLast) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_layers && b_ptrs; ++l) a->b[l] = static_cast<const __nv_bfloat16*>(b_ptrs[l]);
  a->w_last = static_cast<const __nv_bfloat16*>(w_last);
  return 0;
}

// The same count as ops/cuda/fused_mlp.py::bf16_smem_bytes.
size_t bf16_smem_bytes(int rows, const MlpBf16Args& a) {
  return 1024 + static_cast<size_t>(a.panels[0] + a.panels[1]) * rows * 128 +
         static_cast<size_t>(kB16Stages) * kB16StageBytes + (2 * kB16Stages + 1) * sizeof(uint64_t);
}

template <int R>
int launch_bf16(const MlpBf16Maps& maps, void* y, int M, const MlpBf16Args& a, int cluster, int squash, float scale,
                float lo, cudaStream_t stream) {
  const size_t bytes = bf16_smem_bytes(R, a);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_dynamic_smem(fused_mlp_bf16_kernel<R>, bytes);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config((M + R - 1) / R * cluster, bytes, cluster, stream, &attr, kB16Threads);
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, fused_mlp_bf16_kernel<R>, maps, static_cast<__nv_bfloat16*>(y), M,
                                            a, squash, scale, lo));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int max_clusters_bf16(const MlpBf16Args& a, int cluster, int* out) {
  const size_t bytes = bf16_smem_bytes(R, a);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_dynamic_smem(fused_mlp_bf16_kernel<R>, bytes);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, bytes, cluster, nullptr, &attr, kB16Threads);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fused_mlp_bf16_kernel<R>, &cfg));
}

}  // namespace

// The bf16 form, one launch.  x: (M, x_cols) bf16 (x_cols a multiple of 8 >= dims[0], its columns past dims[0]
// zero); y: (M, dims[n_layers]) bf16; w_ptrs[l]: (dims[l], cols[l]) bf16, where cols[l] >= dims[l + 1] is a
// multiple of 8 for every layer but the last (its columns past dims[l + 1] zero) and the last layer's is
// dims[n_layers] <= 16; b_ptrs[l]: (dims[l + 1],) bf16; x and every w but the last 16-byte aligned; rows (16, 32
// or 64) and cluster (1 to 8) the plan; scale = bf16(hi - lo), lo = bf16(lo).  w_ptrs, b_ptrs, dims and cols are
// HOST arrays.  Checked.
extern "C" int fused_mlp_bf16(const void* x, void* y, int M, int x_cols, int n_layers, const void* const* w_ptrs,
                              const int* cols, const void* const* b_ptrs, const int* dims, int rows, int cluster,
                              int squash, float scale, float lo, void* stream) {
  MlpBf16Args a;
  int err = fill_bf16_args(&a, n_layers, b_ptrs, w_ptrs[n_layers - 1], dims);
  if (err) return err;
  if (M < 1 || cluster < 1 || cluster > kMaxCluster || x_cols < dims[0] || x_cols % 8 != 0 ||
      (rows != 16 && rows != 32 && rows != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  MlpBf16Maps maps;
  err = make_tensor_map_2d(&maps.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x_cols, M, 2ull * x_cols, 64, rows,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  for (int l = 0; l + 1 < n_layers; ++l) {
    if (cols[l] < dims[l + 1] || cols[l] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = make_tensor_map_2d(&maps.w[l], w_ptrs[l], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols[l], dims[l],
                             2ull * cols[l], 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 16: return launch_bf16<16>(maps, y, M, a, cluster, squash, scale, lo, s);
    case 32: return launch_bf16<32>(maps, y, M, a, cluster, squash, scale, lo, s);
    default: return launch_bf16<64>(maps, y, M, a, cluster, squash, scale, lo, s);
  }
}

// How many clusters of the bf16 form's plan (rows, cluster) the card runs at once, into *out.
extern "C" int fused_mlp_bf16_max_clusters(int n_layers, const int* dims, int rows, int cluster, int* out) {
  MlpBf16Args a;
  const int err = fill_bf16_args(&a, n_layers, nullptr, nullptr, dims);
  if (err) return err;
  if (cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16: return max_clusters_bf16<16>(a, cluster, out);
    case 32: return max_clusters_bf16<32>(a, cluster, out);
    case 64: return max_clusters_bf16<64>(a, cluster, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
