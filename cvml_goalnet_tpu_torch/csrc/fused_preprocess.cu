// Per-frame min-max normalisation + bilinear resize on thread-block clusters.
//
// Replaces cvml_goalnet_tpu/ops/pallas/fused_preprocess.py::fused_preprocess_frames
// (its _kernel).  The Pallas kernel casts the uint8 frame to float32 outside
// the kernel and resizes with two dense products against interpolation
// matrices; here each output value is computed from its 2x2 source taps,
// resize first: (sum of taps - lo) / (hi - lo + eps), which equals resizing
// the normalised frame because each axis's two weights sum to one.
//
// What bounds it on an H100: bytes.  A 180x320x3 uint8 frame is 172,800 bytes
// read and 40x40x3 float32 = 19,200 bytes written, against a handful of
// operations per byte.  The first port (one 256-thread block per frame, a
// min/max pass, then a second pass reading each output's four taps) reached
// 23-62 % of that bound: variant builds timed on the card showed its min/max
// pass alone 3.8x the bound at 150 frames (one block per SM, too few bytes
// in flight), and at 5400 frames the two passes adding up (the tap rows read
// again, nothing overlapping them).  So here:
//   * a cluster of S CTAs (S in 1, 2, 4, 8, from the host's plan) owns a
//     frame; CTA s streams rows [floor(sH/S), floor((s+1)H/S)) of it, a
//     contiguous byte range, so small batches still put many CTAs to work (a
//     band may be empty when H < S).  The grid is only as many clusters as
//     the card runs at once; each loops over frames q, q + clusters, ..., and
//     its CTAs stream the bands of all their frames as one run of chunks;
//   * each CTA streams its band through a ring of two stages of whole rows in
//     shared memory, each filled by one bulk copy (TMA, cp.async.bulk) that
//     completes on the stage's mbarrier: one chunk lands while the other is
//     read, and both are in flight during a frame's epilogue.  The CTA takes
//     min/max of each chunk (Hopper's three-input 16x2 min/max for uint8);
//   * while a row sits in the ring, the CTA computes the horizontal taps of
//     every tap slot (k, a) whose source row ih[k][a] it holds, cols[k][a] =
//     ww0 * x[iw0] + ww1 * x[iw1]; work goes by slot, not by row, since an
//     upscale or a clamped edge (ih[0][a] == ih[1][a]) feeds several slots
//     from one row.  Each byte of the frame is read from memory once;
//   * after cluster.sync() the CTAs reduce lo/hi across the cluster through
//     distributed shared memory, and each combines v = wh0 * cols[0][a] +
//     wh1 * cols[1][a] for its share of the output rows, reading the slots
//     from the CTAs that own them, divides by (hi - lo + eps) and writes its
//     rows, coalesced; a second cluster.sync() keeps every CTA's slots alive
//     until its peers have read them.
// Every product and sum is rounded as the plain version rounds it (no FMA
// contraction, a true division), so the two agree bit for bit.
//
// What the design was chosen from (variant builds and plan sweeps on the
// card, PERF.md section 6): the per-chunk fixed cost (a barrier, a wait, the
// loop) dominated smaller chunks, so two large stages beat four small ones,
// and bulk copies beat 16-byte cp.async at every frame count timed.
//
// Shapes the ring cannot take: rows whose bytes are not a multiple of 16, or
// a frame base off a 16-byte boundary, take a synchronous element copy into
// the same ring; when the slots do not fit in shared memory (large outputs)
// they live in a global workspace per cluster instead.  The host's plan
// (ops/cuda/fused_preprocess.py::preprocess_plan, with preprocess_bands,
// slot_owners, stage_chunks and cluster_frames) is the specification of this
// walk; smem_bytes below is its smem_bytes.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"   // smem_u32, the mbarrier helpers and bulk_copy

#include <algorithm>
#include <atomic>
#include <cfloat>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;  // ring stages: one chunk lands while the other is read
constexpr int kMaxCluster = 8;
constexpr size_t kStaticSmem = 256;  // at least the kernel's static shared memory, kept free beside the dynamic

__device__ __forceinline__ float to_f(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// Running min/max of frame values.  uint8: the even and the odd bytes of each word spread into two 16-bit
// lanes (one byte permute each), folded two at a time by Hopper's three-input 16x2 min/max (DPX), which
// costs a third of the instructions of four-lane byte min/max; floats otherwise.
template <typename T>
struct MinMax;

template <>
struct MinMax<uint8_t> {
  unsigned mn = 0x00ff00ffu, mx = 0u;
  __device__ __forceinline__ void pair(unsigned w) {
    const unsigned even = __byte_perm(w, 0u, 0x4240), odd = __byte_perm(w, 0u, 0x4341);
    mn = __vimin3_u16x2(mn, even, odd);
    mx = __vimax3_u16x2(mx, even, odd);
  }
  __device__ __forceinline__ void word(uint4 q) {
    pair(q.x);
    pair(q.y);
    pair(q.z);
    pair(q.w);
  }
  __device__ __forceinline__ void elem(uint8_t v) {
    mn = __vimin3_u16x2(mn, v * 0x00010001u, v * 0x00010001u);
    mx = __vimax3_u16x2(mx, v * 0x00010001u, v * 0x00010001u);
  }
  __device__ __forceinline__ void result(float& lo, float& hi) const {
    lo = static_cast<float>(min(mn & 0xffffu, mn >> 16));
    hi = static_cast<float>(max(mx & 0xffffu, mx >> 16));
  }
};

template <>
struct MinMax<float> {
  float lo = FLT_MAX, hi = -FLT_MAX;
  __device__ __forceinline__ void word(uint4 q) {
    elem(__uint_as_float(q.x));
    elem(__uint_as_float(q.y));
    elem(__uint_as_float(q.z));
    elem(__uint_as_float(q.w));
  }
  __device__ __forceinline__ void elem(float v) {
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  __device__ __forceinline__ void result(float& l, float& h) const {
    l = lo;
    h = hi;
  }
};

// First row of band s of `extent` rows cut into S bands (preprocess_bands).
__device__ __forceinline__ int band_start(int s, int extent, int S) { return s * extent / S; }

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Dynamic shared memory of one CTA: the ring, the slots (unless in the workspace), then per column
// element x0, x1, w0, w1, per slot its row, owner and weight and an 8-byte entry of the chunks' slot
// lists, and the lists' starts.  The same count as ops/cuda/fused_preprocess.py::smem_bytes.
size_t smem_bytes(int H, int rows_per_stage, size_t row_bytes, int oh, int owc, bool cols_in_smem) {
  const size_t nslots = 2 * static_cast<size_t>(oh);
  return kStages * align16(rows_per_stage * row_bytes) + (cols_in_smem ? 4 * nslots * owc : 0) +
         16 * static_cast<size_t>(owc) + 20 * nslots + 4 * static_cast<size_t>(H / rows_per_stage + 2);
}

struct Args {
  const void* frames;
  float* out;
  const int* ih;     // (2, oh): slot j < oh is (0, j), j >= oh is (1, j - oh)
  const float* wh;   // (2, oh)
  const int* iw;     // (2, ow)
  const float* ww;   // (2, ow)
  float* cols_ws;    // (clusters, 2 oh, ow C) when the slots live in global memory, else null
  long long n;       // frames
  int H, W, C, oh, ow;
  int rows_per_stage;
  int vec16;         // 16-byte copies: row bytes a multiple of 16, frames 16-byte aligned
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) preprocess_cluster_kernel(Args args) {
  extern __shared__ float4 smem4[];
  __shared__ float s_red[2][kThreads / 32];
  __shared__ float s_part[2];   // this CTA's lo/hi of the current frame, read by the whole cluster
  __shared__ float s_lohi[2];   // the frame's lo/hi
  __shared__ __align__(8) uint64_t s_full[kStages];  // a stage's chunk has landed (bulk copies)

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long q = blockIdx.x / S, nclusters = gridDim.x / S;  // this cluster's frames: q, q + nclusters, ...
  const long long nframes = q < args.n ? (args.n - 1 - q) / nclusters + 1 : 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = args.H, oh = args.oh, owc = args.ow * args.C, nslots = 2 * oh;
  const long long row_elems = static_cast<long long>(args.W) * args.C, frame_elems = H * row_elems;
  const int row_bytes = static_cast<int>(row_elems * sizeof(T));
  const int R = args.rows_per_stage;
  // a thread's column element and slot (or output row) group in the tap and combine loops: no division per item
  const int lanes = min(owc, kThreads), groups = kThreads / lanes, grp = tid / lanes, el = tid - grp * lanes;
  const size_t stage_bytes = align16(static_cast<size_t>(R) * row_bytes);

  unsigned char* const ring = reinterpret_cast<unsigned char*>(smem4);
  float* const smem_cols = reinterpret_cast<float*>(ring + kStages * stage_bytes);
  float* const cols = args.cols_ws ? args.cols_ws + q * nslots * owc : smem_cols;  // the cluster's, reused per frame
  int* const s_x0 = reinterpret_cast<int*>(smem_cols + (args.cols_ws ? 0 : nslots * owc));
  int* const s_x1 = s_x0 + owc;
  float* const s_w0 = reinterpret_cast<float*>(s_x1 + owc);
  float* const s_w1 = s_w0 + owc;
  int* const s_row = reinterpret_cast<int*>(s_w1 + owc);
  int* const s_owner = s_row + nslots;
  float* const s_wh = reinterpret_cast<float*>(s_owner + nslots);
  // the slots of each chunk of the band, chunk after chunk: (slot offset j.owc, its row's offset in the stage)
  int2* const s_list = reinterpret_cast<int2*>(s_wh + nslots);
  int* const s_start = reinterpret_cast<int*>(s_list + nslots);  // chunk c's slots: s_list[s_start[c] .. s_start[c+1])

  // This CTA's band of source rows, in chunks of R rows, one chunk per ring stage.  The chunks of all its
  // frames form one stream, so the next frame's first chunks are in flight while a frame's epilogue runs.
  const int r0 = band_start(rank, H, S), r1 = band_start(rank + 1, H, S);
  const int nchunks = (r1 - r0 + R - 1) / R;
  const int last_rows = r1 - r0 - (nchunks - 1) * R;
  // the next chunk to issue: chunk ic of this CTA's frame ik, whose band starts at band_src, into stage is
  const unsigned char* band_src =
      static_cast<const unsigned char*>(args.frames) + (q * frame_elems + r0 * row_elems) * sizeof(T);
  const long long frame_step = nclusters * frame_elems * static_cast<long long>(sizeof(T));
  long long ik = 0;
  int ic = 0, is = 0;
  // The ring holds chunks [consumed, issued) of the stream; every stage is kept busy: one chunk in flight
  // while one is read, both during a frame's epilogue.
  long long issued = 0, consumed = 0;
  const long long total = nframes * nchunks;
  auto issue = [&]() {
    while (issued < total && issued < consumed + kStages) {
      ++issued;
      const int nbytes = (ic + 1 == nchunks ? last_rows : R) * row_bytes;
      const unsigned char* src = band_src + ic * R * row_bytes;
      unsigned char* dst = ring + is * stage_bytes;
      if (args.vec16) {
        if (tid == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the stage's last generic reads
          bulk_copy(dst, src, nbytes, &s_full[is]);
        }
      } else {  // row bytes off 16 or an unaligned base: a synchronous copy, made visible by the next barrier
        for (int i = tid; i < nbytes / static_cast<int>(sizeof(T)); i += kThreads) {
          reinterpret_cast<T*>(dst)[i] = reinterpret_cast<const T*>(src)[i];
        }
      }
      is = is + 1 == kStages ? 0 : is + 1;
      if (++ic == nchunks) {
        ic = 0;
        ++ik;
        band_src += frame_step;
      }
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&s_full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  issue();

  // per column element e = b C + channel (any C) its two source offsets and weights; per slot its row, its
  // owner and its weight
  for (int e = tid; e < owc; e += kThreads) {
    const int b = e / args.C, ch = e - b * args.C;
    s_x0[e] = args.iw[b] * args.C + ch;
    s_x1[e] = args.iw[args.ow + b] * args.C + ch;
    s_w0[e] = args.ww[b];
    s_w1[e] = args.ww[args.ow + b];
  }
  for (int j = tid; j < nslots; j += kThreads) {
    const int r = args.ih[j];
    int s = S - 1;  // the band that holds row r: the last whose first row is <= r (slot_owners)
    while (band_start(s, H, S) > r) --s;
    s_row[j] = r;
    s_owner[j] = s;
    s_wh[j] = args.wh[j];
  }
  __syncthreads();
  if (warp == 0) {  // each chunk's slots, in slot order: the same for every frame of this CTA
    int count = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = r0 + c * R, c1 = min(c0 + R, r1);
      if (lane == 0) s_start[c] = count;
      for (int j0 = 0; j0 < nslots; j0 += 32) {
        const int j = j0 + lane;
        const bool mine = j < nslots && s_row[j] >= c0 && s_row[j] < c1;
        const unsigned ballot = __ballot_sync(0xffffffffu, mine);
        if (mine) {
          s_list[count + __popc(ballot & ((1u << lane) - 1u))] =
              make_int2(j * owc, static_cast<int>((s_row[j] - c0) * row_elems));
        }
        count += __popc(ballot);
      }
    }
    if (lane == 0) s_start[nchunks] = count;
  }
  __syncthreads();

  // this CTA's output rows, and where each slot is read from in the combine
  const int a0 = band_start(rank, oh, S), a1 = band_start(rank + 1, oh, S);
  auto slot = [&](int j, int e) -> float {
    if (args.cols_ws) return cols[j * owc + e];
    const int owner = s_owner[j];
    return owner == rank ? smem_cols[j * owc + e] : cluster.map_shared_rank(smem_cols, owner)[j * owc + e];
  };
  bool own = !args.cols_ws;  // every slot of this CTA's output rows is its own (always so when S = 1)
  for (int j = tid; j < nslots; j += kThreads) {
    const int a = j < oh ? j : j - oh;
    if (a >= a0 && a < a1 && s_owner[j] != rank) own = false;
  }
  own = __syncthreads_and(own);

  // with at most one column element a thread, its taps' offsets and weights stay in registers
  int tx0 = 0, tx1 = 0;
  float tw0 = 0.f, tw1 = 0.f;
  if (owc <= kThreads && grp < groups) {
    tx0 = s_x0[el];
    tx1 = s_x1[el];
    tw0 = s_w0[el];
    tw1 = s_w1[el];
  }
  int cs = 0;  // the stage of the chunk read next
  for (long long k = 0; k < nframes; ++k) {
    MinMax<T> mm;
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = r0 + c * R, c1 = min(c0 + R, r1);
      if (args.vec16) mbar_wait(&s_full[cs], static_cast<unsigned>(consumed / kStages) & 1u);  // it has landed
      // One barrier an iteration: every thread is done with the previous chunk, whose stage takes the next.
      __syncthreads();
      issue();
      ++consumed;

      const unsigned char* stage = ring + cs * stage_bytes;
      cs = cs + 1 == kStages ? 0 : cs + 1;
      const int nbytes = (c1 - c0) * row_bytes;
      if (args.vec16) {
        for (int i = tid; i < nbytes / 16; i += kThreads) mm.word(reinterpret_cast<const uint4*>(stage)[i]);
      } else {
        for (int i = tid; i < nbytes / static_cast<int>(sizeof(T)); i += kThreads) {
          mm.elem(reinterpret_cast<const T*>(stage)[i]);
        }
      }
      const int l0 = s_start[c], l1 = s_start[c + 1];
      const T* st = reinterpret_cast<const T*>(stage);
      auto taps = [&](int e, int x0, int x1, float w0, float w1) {  // column element e of the chunk's slots
        for (int i = l0 + grp; i < l1; i += groups) {
          const int2 sl = s_list[i];
          const T* row = st + sl.y;
          const float v = __fadd_rn(__fmul_rn(w0, to_f(row[x0])), __fmul_rn(w1, to_f(row[x1])));
          if (args.cols_ws) {
            cols[sl.x + e] = v;
          } else {
            smem_cols[sl.x + e] = v;
          }
        }
      };
      if (owc <= kThreads) {
        if (grp < groups) taps(el, tx0, tx1, tw0, tw1);
      } else {
        for (int e = el; e < owc; e += lanes) taps(e, s_x0[e], s_x1[e], s_w0[e], s_w1[e]);
      }
    }

    // the frame's epilogue: lo/hi of this CTA, then of the cluster through distributed shared memory
    float lo, hi;
    mm.result(lo, hi);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      s_red[0][warp] = lo;
      s_red[1][warp] = hi;
    }
    __syncthreads();
    issue();  // the last chunk's stage is free: the next frame's chunks fill every stage during the epilogue
    if (tid == 0) {
      for (int w = 1; w < kThreads / 32; ++w) {
        lo = fminf(lo, s_red[0][w]);
        hi = fmaxf(hi, s_red[1][w]);
      }
      s_part[0] = lo;
      s_part[1] = hi;
    }
    cluster.sync();  // every CTA's slots and lo/hi of this frame are written
    if (warp == 0) {
      lo = FLT_MAX;
      hi = -FLT_MAX;
      if (lane < S) {
        const float* p = cluster.map_shared_rank(&s_part[0], lane);
        lo = p[0];
        hi = p[1];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) {
        s_lohi[0] = lo;
        s_lohi[1] = hi;
      }
    }
    __syncthreads();
    lo = s_lohi[0];
    hi = s_lohi[1];
    const float denom = __fadd_rn(__fsub_rn(hi, lo), args.eps);

    // this CTA's output rows: the two slots of each, from the CTAs that own them
    float* o = args.out + ((q + k * nclusters) * oh + a0) * owc;
    auto combine = [&](auto get) {
      for (int e = grp < groups ? el : owc; e < owc; e += lanes) {
        for (int a = a0 + grp; a < a1; a += groups) {
          const float v = __fadd_rn(__fmul_rn(s_wh[a], get(a, e)), __fmul_rn(s_wh[oh + a], get(oh + a, e)));
          o[(a - a0) * owc + e] = __fdiv_rn(__fsub_rn(v, lo), denom);
        }
      }
    };
    if (own) {
      combine([&](int j, int e) { return smem_cols[j * owc + e]; });
    } else {
      combine(slot);
    }
    // no CTA writes the next frame's slots, or leaves, while a peer may still read this frame's
    cluster.sync();
  }
}

constexpr int kMaxDevices = 64;

// Opt preprocess_cluster_kernel<T> into the most dynamic shared memory a plan may ask for, once per card, so
// no launch pays for the attribute call on the host.  Two threads may both make it the first time; the call
// is idempotent.
template <typename T>
int opt_in_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return 0;
  err = allow_dynamic_smem(preprocess_cluster_kernel<T>, kMaxSmemBytes - kStaticSmem);
  if (!err && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
int launch(const Args& args, int cluster, int nclusters, size_t smem, cudaStream_t stream) {
  auto kernel = preprocess_cluster_kernel<T>;
  int err = opt_in_smem<T>();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nclusters * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int clusters_at_once(size_t smem, int cluster, int* out) {
  auto kernel = preprocess_cluster_kernel<T>;
  const int err = opt_in_smem<T>();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

bool valid_smem(long long smem) { return smem >= 0 && static_cast<size_t>(smem) <= kMaxSmemBytes - kStaticSmem; }

}  // namespace

// frames: (n, H, W, C) uint8 (is_u8 = 1) or float32; out: (n, oh, ow, C) float32.
// ih/wh: (2, oh) int32/float32 row taps; iw/ww: (2, ow) column taps.  The plan: `nclusters` clusters of
// `cluster` CTAs, each looping over frames q, q + nclusters, ...; `rows_per_stage` rows per ring stage.
// cols_ws, when not null, is a (nclusters, 2 oh, ow C) float32 workspace for the slots.  The grid is the
// clusters the card runs at once, so no frame count reaches a grid limit.
extern "C" int fused_preprocess(const void* frames, int is_u8, void* out, long long n, int H, int W, int C,
                                int oh, int ow, const void* ih, const void* wh, const void* iw, const void* ww,
                                float eps, int cluster, int nclusters, int rows_per_stage, void* cols_ws,
                                void* stream) {
  if (n < 1 || H < 1 || W < 1 || C < 1 || oh < 1 || ow < 1 || cluster < 1 || cluster > kMaxCluster ||
      nclusters < 1 || nclusters > 0x7fffffff / cluster || rows_per_stage < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t row_bytes = static_cast<size_t>(W) * C * (is_u8 ? 1 : 4);
  const size_t smem = smem_bytes(H, rows_per_stage, row_bytes, oh, ow * C, cols_ws == nullptr);
  if (!valid_smem(static_cast<long long>(smem))) return static_cast<int>(cudaErrorInvalidValue);
  Args args{frames, static_cast<float*>(out), static_cast<const int*>(ih), static_cast<const float*>(wh),
            static_cast<const int*>(iw), static_cast<const float*>(ww), static_cast<float*>(cols_ws), n,
            H, W, C, oh, ow, rows_per_stage,
            static_cast<int>(reinterpret_cast<uintptr_t>(frames) % 16 == 0 && row_bytes % 16 == 0), eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_u8 ? launch<uint8_t>(args, cluster, nclusters, smem, s) : launch<float>(args, cluster, nclusters, smem, s);
}

// Clusters of `cluster` CTAs with `smem` bytes of dynamic shared memory each that the card runs at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int fused_preprocess_clusters_at_once(int is_u8, long long smem, int cluster, int* out) {
  if (!valid_smem(smem) || cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const size_t b = static_cast<size_t>(smem);
  return is_u8 ? clusters_at_once<uint8_t>(b, cluster, out) : clusters_at_once<float>(b, cluster, out);
}
