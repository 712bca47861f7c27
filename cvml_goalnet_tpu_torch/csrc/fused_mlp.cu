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
#include "lowp_mma.cuh"

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
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
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

// The bf16 form: replaces fused_fusion_mlp at bf16 inputs, as the JAX package's bf16 eval forward runs the
// chain (XLA, models/avm.py:163-175 via layers.py:53-56): each layer bf16(bf16(x . w) + b) from float32
// sums, ReLU between, then the squash in bf16 op by op: e = bf16(exp(-x)), d = bf16(1 + e),
// s = bf16(1 / d), out = bf16(bf16((hi - lo) s) + lo), so the scores lie on the bf16 grid.
// What bounds it on an H100: the weights' path to each block (1.5 MB of bf16 weights through L2 per block
// of rows); 1.58 GFLOP at M = 1050 is 1.6 us of bf16 tensor cores.  Design (a simple first form): one block
// of 8 warps owns 16 rows (one m16 tile), or 8 when 16-row blocks would leave SMs idle, for the whole
// chain; activations stay in shared memory as bf16 (rows padded to an odd count of 16-byte chunks, so
// ldmatrix's 8 rows hit distinct banks); each warp takes n8 tiles of a layer eight at a time and walks K
// in chunks of 32 with two mma.sync m16n8k16 each.  The B fragments come straight from the weights, which
// a first launch (prep_bf16_kernel) lays out transposed ((out, in), each row k-contiguous) and zero-padded
// to multiples of 32 in a workspace (one launch for all layers: the wrapper's host work stays two calls): one
// 16-byte load gives a thread both k-steps of a chunk (physical k 8t .. 8t + 7), and the activations are
// stored with each 32-column group permuted (kPermPos) so that ldmatrix hands A the same k order.
namespace {

constexpr int kB16Rows = 16;   // rows of the MMA tile; a block owns 8 or 16 of them

struct MlpBf16Args {
  const __nv_bfloat16* wt[kMaxLayers];  // (np[l], kp[l]) row-major: w transposed, zero-padded
  const __nv_bfloat16* b[kMaxLayers];   // (np[l],), zero-padded
  int kp[kMaxLayers], np[kMaxLayers];   // multiples of 32, np[l] == kp[l + 1]
  int n_layers, d_in, n_out, pitch;     // pitch: bf16 values per activation row in shared memory
};

// Where physical column q of a 32-column group is stored: q = 8t + 4s + 2h + e is logical k 8h + 2t + e of
// k-step s, the k that thread t's 16-byte weight load (physical 8t .. 8t + 7) feeds.
__device__ __forceinline__ int perm_pos(int q) {
  return 16 * ((q >> 2) & 1) + 8 * ((q >> 1) & 1) + 2 * (q >> 3) + (q & 1);
}

__device__ __forceinline__ int act_pos(int col) { return (col & ~31) + perm_pos(col & 31); }

__device__ __forceinline__ float squash_bf16(float v, float scale, float lo) {
  const float e = bf16_round(expf(-v));
  const float d = bf16_round(__fadd_rn(1.f, e));
  const float s = bf16_round(__fdiv_rn(1.f, d));
  return bf16_round(__fadd_rn(bf16_round(__fmul_rn(scale, s)), lo));
}

__global__ void __launch_bounds__(kThreads) fused_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                                  __nv_bfloat16* __restrict__ y, int M, int rows,
                                                                  const MlpBf16Args a, int squash, float scale,
                                                                  float lo) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem4);   // two buffers [16][pitch]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * rows;
  const int k0 = a.kp[0];
  for (int e = tid; e < kB16Rows * k0; e += kThreads) {
    const int r = e / k0, c = e % k0;
    act[r * a.pitch + act_pos(c)] = r < rows && r0 + r < M && c < a.d_in ? x[static_cast<size_t>(r0 + r) * a.d_in + c]
                                                                          : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  for (int l = 0; l < a.n_layers; ++l) {
    const __nv_bfloat16* in = act + (l & 1) * kB16Rows * a.pitch;
    __nv_bfloat16* next = act + ((l + 1) & 1) * kB16Rows * a.pitch;
    const bool last = l == a.n_layers - 1;
    const int kp = a.kp[l], n_tiles = a.np[l] / 8;
    const __nv_bfloat16* wt = a.wt[l];
    const __nv_bfloat16* bias = a.b[l];
    const __nv_bfloat16* arow = in + (lane % 16) * a.pitch + 8 * (lane / 16);
    for (int tile0 = warp; tile0 < n_tiles; tile0 += 64) {   // tiles tile0 + 8q, q < 8, of this warp
      float acc[8][4] = {};
#pragma unroll 2
      for (int kc = 0; kc < kp; kc += 32) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, arow + kc);
        ldsm_x4(a1, arow + kc + 16);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int tile = tile0 + 8 * q;
          if (tile < n_tiles) {   // the same for the whole warp
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(wt + static_cast<size_t>(8 * tile + g) * kp + kc + 8 * t));
            mma_bf16(acc[q], a0, u.x, u.y);
            mma_bf16(acc[q], a1, u.z, u.w);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int tile = tile0 + 8 * q;
        if (tile >= n_tiles) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e / 2), col = 8 * tile + 2 * t + e % 2;
          float v = bf16_round(__fadd_rn(bf16_round(acc[q][e]), __bfloat162float(bias[col])));
          if (!last) {
            next[row * a.pitch + act_pos(col)] = __float2bfloat16_rn(fmaxf(v, 0.f));
          } else if (row < rows && r0 + row < M && col < a.n_out) {
            if (squash) v = squash_bf16(v, scale, lo);
            y[static_cast<size_t>(r0 + row) * a.n_out + col] = __float2bfloat16_rn(v);
          }
        }
      }
    }
    __syncthreads();
  }
}

// The weights as the MMAs read them, in one launch: wt[l] (np, kp) = w[l] (k, n) transposed and zero-padded,
// bp[l] (np,) = b[l] zero-padded; layer l's pair starts at element off[l] of one workspace.
struct MlpBf16Prep {
  const __nv_bfloat16* w[kMaxLayers];
  const __nv_bfloat16* b[kMaxLayers];
  int k[kMaxLayers], n[kMaxLayers], kp[kMaxLayers], np[kMaxLayers];
  long long off[kMaxLayers + 1];
  int n_layers;
};

__global__ void __launch_bounds__(256) prep_bf16_kernel(__nv_bfloat16* __restrict__ ws, const MlpBf16Prep p) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= p.off[p.n_layers]) return;
  int l = 0;
  while (e >= p.off[l + 1]) ++l;
  const long long r = e - p.off[l];
  const int kp = p.kp[l], np = p.np[l];
  __nv_bfloat16 v = __float2bfloat16_rn(0.f);
  if (r < static_cast<long long>(np) * kp) {
    const int n = static_cast<int>(r / kp), k = static_cast<int>(r % kp);
    if (n < p.n[l] && k < p.k[l]) v = p.w[l][static_cast<size_t>(k) * p.n[l] + n];
  } else {
    const int n = static_cast<int>(r - static_cast<long long>(np) * kp);
    if (n < p.n[l]) v = p.b[l][n];
  }
  ws[e] = v;
}

}  // namespace

// The bf16 form.  x: (M, dims[0]) bf16; y: (M, dims[n_layers]) bf16; w_ptrs[l]: (dims[l], dims[l + 1]) bf16;
// b_ptrs[l]: (dims[l + 1],) bf16; ws: a 16-byte aligned workspace of sum over l of np * (kp + 1) bf16 values
// (kp, np: dims[l], dims[l + 1] rounded up to 32) that the first launch fills with the weights transposed and
// zero-padded, then the biases; rows per block 8 or 16; scale = bf16(hi - lo), lo = bf16(lo).  Two launches,
// each checked.
extern "C" int fused_mlp_bf16(const void* x, void* y, int M, int n_layers, const void* const* w_ptrs,
                              const void* const* b_ptrs, const int* dims, void* ws, int rows, int squash,
                              float scale, float lo, void* stream) {
  if (M < 1 || n_layers < 1 || n_layers > kMaxLayers || (rows != 8 && rows != kB16Rows) ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpBf16Prep p;
  MlpBf16Args a;
  p.off[0] = 0;
  int widest = 0;
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(ws);
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] < 1 || dims[l + 1] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.w[l] = static_cast<const __nv_bfloat16*>(w_ptrs[l]);
    p.b[l] = static_cast<const __nv_bfloat16*>(b_ptrs[l]);
    p.k[l] = dims[l], p.n[l] = dims[l + 1];
    p.kp[l] = a.kp[l] = (dims[l] + 31) / 32 * 32;
    p.np[l] = a.np[l] = (dims[l + 1] + 31) / 32 * 32;
    a.wt[l] = base + p.off[l];
    a.b[l] = base + p.off[l] + static_cast<long long>(a.np[l]) * a.kp[l];
    p.off[l + 1] = p.off[l] + static_cast<long long>(a.np[l]) * a.kp[l] + a.np[l];
    widest = a.kp[l] > widest ? a.kp[l] : widest;
  }
  p.n_layers = a.n_layers = n_layers;
  a.d_in = dims[0], a.n_out = dims[n_layers];
  a.pitch = widest + 8;   // an odd count of 16-byte chunks
  const size_t bytes = sizeof(__nv_bfloat16) * 2 * kB16Rows * a.pitch;
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  prep_bf16_kernel<<<static_cast<unsigned>((p.off[n_layers] + 255) / 256), 256, 0, s>>>(base, p);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = allow_dynamic_smem(fused_mlp_bf16_kernel, bytes);
  if (err) return err;
  fused_mlp_bf16_kernel<<<(M + rows - 1) / rows, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), M, rows, a, squash, scale, lo);
  return static_cast<int>(cudaGetLastError());
}
