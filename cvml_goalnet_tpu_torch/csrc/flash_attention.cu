// Flash attention, float32, for the temporal transformer scorer: the two
// forwards first, the two backwards (training) after them, then the kernels
// on the tensor cores (kernels 6 and 8, the full and the banded backward, one
// template; kernels 5 and 7, the full and the banded forward, another).
//
// The forwards replace two kernels of cvml_goalnet_tpu/ops/pallas/flash_attention.py:
//   * _flash_fwd (body _fwd_kernel): full non-causal attention of (H, Tq, d)
//     queries over (H, Tk, d) keys and values, keys valid below t_valid;
//     writes out and the row log-sum-exp;
//   * _flash_local_fwd (body _local_fwd_kernel, mask _band_mask): banded
//     attention |i + q_offset - j| <= W with keys valid in [lo, hi), visiting
//     only the key tiles that meet each query tile's band, so the work is
//     O(T*W*d) instead of O(T^2*d).
// Head widths up to 128 run on the tensor cores (kernels 5 and 7, the last
// section); 256 and the wide path run the FP32-core templates of this section.
// In both, a row with no valid key gives out 0 and lse 0.
//
// What bounds it on an H100: operations.  Each valid (query, key) pair costs
// 2d FLOP for the score and 2d for the weighted sum of values, against 16d
// bytes per row of q, k, v and out (T = 5400, d = 128: 1.49e10 FLOP against
// 11 MB for full attention, 5.1e9 FLOP for the W = 1024 band).  The work of
// this section is float32 on the FP32 cores (67 TFLOP/s): one TF32 product
// keeps about three digits and breaks the 2e-5 contract the kernels are held
// to.  The design keeps the (Tq, Tk) score matrix out of device memory and
// feeds the FMA units from shared memory:
//   * one block owns BQ = 16*RQ query rows of one head: 256 threads as a
//     16 x 16 grid, a thread owning RQ rows (strided by 16) and, per key
//     tile, 4 keys (strided by 16) of the score tile and d/16 columns of the
//     output; Q, K^T (padded rows, no bank conflicts), V and the tile's
//     weights P sit in shared memory (116 KB at d = 128 and RQ = 4, 91 KB
//     at RQ = 2);
//   * the running max, running sum and unnormalised output stay in registers
//     across the key tiles (attend_tile, the online-softmax step both kernels
//     share); after the last tile one divide gives out, and lse = m + log l;
//   * masked entries get weight 0 instead of a large negative score: a row
//     whose running max is still -inf has seen no valid key;
//   * the banded kernel takes 64-row tiles (RQ = 4) when they give the card
//     at least two blocks per SM, else 32-row tiles, so that short timelines
//     spread over more SMs.  Timing both heights in turns on an H100 chose
//     this: 32-row tiles made short bands faster and everything else slower;
//   * head width 256 is built here (the wrapper zero-pads the widths between
//     128 and 256 up to it).  At D = 256, RQ = 4 takes 210 KB of shared
//     memory and RQ = 2 169 KB: one block per SM either way.
//   * the wide path: past 256 the wrapper zero-pads d to a multiple of kDC
//     and the D = kDC templates run with rows of dw floats (a template flag
//     W and the run-time width dw).  Nothing of width dw sits in shared
//     memory: the contractions over d (S = Q K^T, and dP = dO V^T in the
//     backwards) walk it in kDC-wide chunks through the same buffers, summed
//     in registers, and block z of the grid's third axis writes columns
//     [z*kDC, (z + 1)*kDC) of the outputs (only z = 0 writes lse).  Every
//     slice recomputes the scores over the whole width: at d = 512 four times
//     the score work, for widths no configuration uses.
#include "common.cuh"
#include "tf32_mma.cuh"

#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid: tx picks keys and columns, ty rows
constexpr int kBK = 64;        // keys per tile
constexpr int kLdK = kBK + 1;  // padded row of K^T and P in shared memory
constexpr int kDC = 128;       // the wide path's chunk of d and column slice

template <int D, int RQ>
struct Geom {
  static constexpr int BQ = 16 * RQ;  // query rows per block
  static constexpr int NC = D / 16;   // output columns per thread
  static constexpr int kLdQ = D + 1;
  // shared memory, in floats; V first so that its float4 stores are aligned
  static constexpr int kV = kBK * D;
  static constexpr int kQ = BQ * kLdQ;
  static constexpr int kKt = D * kLdK;
  static constexpr int kP = BQ * kLdK;
  static constexpr size_t kBytes = sizeof(float) * (kV + kQ + kKt + kP);
};

struct AllKeys {
  __device__ bool operator()(int, int) const { return true; }
};

struct Band {
  int q_offset, window;
  __device__ bool operator()(int row, int key) const { return abs(row + q_offset - key) <= window; }
};

// Rows [q0, q0 + 16*RQ) of one head's rows of ld floats, their first D columns, into sq (zeros from row Tq on).
template <int D, int RQ>
__device__ __forceinline__ void load_q(const float* __restrict__ qh, int q0, int Tq, float* sq, int ld = D) {
  using G = Geom<D, RQ>;
  for (int idx = threadIdx.x; idx < G::BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    sq[r * G::kLdQ + c] = (q0 + r < Tq) ? __ldg(qh + static_cast<size_t>(q0 + r) * ld + c) : 0.f;
  }
}

// Keys [k0, k0 + kBK) (zeros from k_lim on), the first D columns of rows of ld floats: K transposed into
// skt, V as it is into sv.
template <int D>
__device__ __forceinline__ void load_kt(const float* __restrict__ kh, int k0, int k_lim, float* skt, int ld = D) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    skt[c * kLdK + r] = (k0 + r < k_lim) ? __ldg(kh + static_cast<size_t>(k0 + r) * ld + c) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_v(const float* __restrict__ vh, int k0, int k_lim, float* sv, int ld = D) {
  for (int idx = threadIdx.x; idx < kBK * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c4 = idx % (D / 4);
    reinterpret_cast<float4*>(sv)[idx] =
        (k0 + r < k_lim) ? __ldg(reinterpret_cast<const float4*>(vh + static_cast<size_t>(k0 + r) * ld) + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// s += the thread's RQ x 4 scores (rows ty + 16i, keys tx + 16j of the tile) over the D columns in shared memory.
template <int D, int RQ>
__device__ __forceinline__ void score_tile(const float* sq, const float* skt, float (&s)[RQ][4]) {
  using G = Geom<D, RQ>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float a[RQ], b[4];
#pragma unroll
    for (int i = 0; i < RQ; ++i) a[i] = sq[(ty + 16 * i) * G::kLdQ + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = skt[kk * kLdK + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// The online-softmax step of one key tile from its scores s: keys [k0, min(k0 + kBK, k_lim)) that pass
// `mask` against the block's rows q0 + ty + 16i.  Updates the running max m, sum l and the rescaling of
// the unnormalised output acc, and leaves the tile's weights in sp.
template <int D, int RQ, typename Mask>
__device__ __forceinline__ void softmax_tile(float (&s)[RQ][4], int k0, int k_lim, int q0, float scale, Mask mask,
                                             float* sp, float (&m)[RQ], float (&l)[RQ],
                                             float (&acc)[RQ][Geom<D, RQ>::NC]) {
  using G = Geom<D, RQ>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      s[i][j] = (key < k_lim && mask(row, key)) ? s[i][j] * scale : -INFINITY;
      mt = fmaxf(mt, s[i][j]);
    }
    // the 16 threads of a row are one half of a warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off, 16));
    const float m_new = fmaxf(m[i], mt);
    // no valid key yet: subtract 0, so every weight and alpha is 0, not NaN
    const float base = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = expf(m[i] - base);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[i][j] - base);
      rs += p;
      sp[(ty + 16 * i) * kLdK + tx + 16 * j] = p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
    l[i] = alpha * l[i] + rs;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) acc[i][c] *= alpha;
  }
}

// acc += P V over the tile's keys, P and V in shared memory.
template <int D, int RQ>
__device__ __forceinline__ void weigh_values(const float* sp, const float* sv, float (&acc)[RQ][Geom<D, RQ>::NC]) {
  using G = Geom<D, RQ>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float p[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) p[i] = sp[(ty + 16 * i) * kLdK + j];
#pragma unroll
    for (int c = 0; c < G::NC; ++c) {
      const float vv = sv[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
    }
  }
}

// One key tile of the online softmax: keys [k0, min(k0 + kBK, k_lim)) that
// pass `mask` against the block's rows q0 + ty + 16i, Q already in sq.
// Updates the running max m, sum l and unnormalised output acc of the
// thread's rows.
template <int D, int RQ, typename Mask>
__device__ __forceinline__ void attend_tile(const float* __restrict__ kh, const float* __restrict__ vh, int k0,
                                            int k_lim, int q0, float scale, Mask mask, const float* sq,
                                            float* skt, float* sv, float* sp, float (&m)[RQ], float (&l)[RQ],
                                            float (&acc)[RQ][Geom<D, RQ>::NC]) {
  __syncthreads();  // every thread is done with the previous tile's K^T, V and P
  load_kt<D>(kh, k0, k_lim, skt);
  load_v<D>(vh, k0, k_lim, sv);
  __syncthreads();
  float s[RQ][4] = {};
  score_tile<D, RQ>(sq, skt, s);
  softmax_tile<D, RQ>(s, k0, k_lim, q0, scale, mask, sp, m, l, acc);
  __syncthreads();
  weigh_values<D, RQ>(sp, sv, acc);
}

// attend_tile on the wide path: rows of dw floats, the scores summed over dw / kDC chunks of Q and K
// (each staged through sq and skt), the values of the block's column slice (grid z) only.
template <int RQ, typename Mask>
__device__ __forceinline__ void attend_tile_wide(const float* __restrict__ qh, const float* __restrict__ kh,
                                                 const float* __restrict__ vh, int k0, int k_lim, int q0, int Tq,
                                                 int dw, float scale, Mask mask, float* sq, float* skt, float* sv,
                                                 float* sp, float (&m)[RQ], float (&l)[RQ],
                                                 float (&acc)[RQ][Geom<kDC, RQ>::NC]) {
  const int slice = blockIdx.z;
  float s[RQ][4] = {};
  for (int ch = 0; ch < dw / kDC; ++ch) {
    __syncthreads();  // every thread is done with the previous chunk's Q and K^T (and the last tile's V, P)
    load_q<kDC, RQ>(qh + ch * kDC, q0, Tq, sq, dw);
    load_kt<kDC>(kh + ch * kDC, k0, k_lim, skt, dw);
    if (ch == slice) load_v<kDC>(vh + slice * kDC, k0, k_lim, sv, dw);
    __syncthreads();
    score_tile<kDC, RQ>(sq, skt, s);
  }
  softmax_tile<kDC, RQ>(s, k0, k_lim, q0, scale, mask, sp, m, l, acc);
  __syncthreads();
  weigh_values<kDC, RQ>(sp, sv, acc);
}

// out (rows of ld floats from oh, the thread's D / 16 columns) and, when write_lse, lse of the block's rows.
template <int D, int RQ>
__device__ __forceinline__ void store_rows(float* __restrict__ oh, float* __restrict__ lh, int q0, int Tq, int ld,
                                           bool write_lse, const float (&m)[RQ], const float (&l)[RQ],
                                           const float (&acc)[RQ][Geom<D, RQ>::NC]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const bool dead = (m[i] == -INFINITY);
#pragma unroll
    for (int c = 0; c < Geom<D, RQ>::NC; ++c)
      oh[static_cast<size_t>(row) * ld + tx + 16 * c] = dead ? 0.f : acc[i][c] / l[i];
    if (write_lse && tx == 0) lh[row] = dead ? 0.f : m[i] + logf(l[i]);
  }
}

// The block's BQ query rows of head blockIdx.y against keys [k_begin, k_end)
// that pass `mask`, tile by tile; writes their out and lse.  W: the wide path
// (rows of dw floats, D = kDC, the column slice blockIdx.z).
template <int D, int RQ, bool W, typename Mask>
__device__ __forceinline__ void attend_rows(const float* __restrict__ q, const float* __restrict__ k,
                                            const float* __restrict__ v, float* __restrict__ out,
                                            float* __restrict__ lse, int Tq, int Tk, int k_begin, int k_end,
                                            float scale, Mask mask, int dw) {
  using G = Geom<D, RQ>;
  extern __shared__ float4 smem4[];
  float* sv = reinterpret_cast<float*>(smem4);
  float* sq = sv + G::kV;
  float* skt = sq + G::kQ;
  float* sp = skt + G::kKt;
  const int ld = W ? dw : D;
  const int h = blockIdx.y, q0 = blockIdx.x * G::BQ, c0 = W ? blockIdx.z * D : 0;
  const float* qh = q + static_cast<size_t>(h) * Tq * ld;
  const float* kh = k + static_cast<size_t>(h) * Tk * ld;
  const float* vh = v + static_cast<size_t>(h) * Tk * ld;
  if constexpr (!W) load_q<D, RQ>(qh, q0, Tq, sq);
  float m[RQ], l[RQ], acc[RQ][G::NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    if constexpr (W)
      attend_tile_wide<RQ>(qh, kh, vh, k0, k_end, q0, Tq, dw, scale, mask, sq, skt, sv, sp, m, l, acc);
    else
      attend_tile<D, RQ>(kh, vh, k0, k_end, q0, scale, mask, sq, skt, sv, sp, m, l, acc);
  }
  store_rows<D, RQ>(out + static_cast<size_t>(h) * Tq * ld + c0, lse + static_cast<size_t>(h) * Tq, q0, Tq, ld,
                    c0 == 0, m, l, acc);
}

template <int D, int RQ, bool W>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int kv_end, float scale,
                     int dw) {
  attend_rows<D, RQ, W>(q, k, v, out, lse, Tq, Tk, 0, kv_end, scale, AllKeys{}, dw);
}

template <int D, int RQ, bool W>
__global__ void __launch_bounds__(kThreads)
    flash_local_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, float scale,
                           int window, int lo, int hi, int q_offset, int dw) {
  // the keys any row of this tile may see: the bands of its first and last
  // row, cut to [lo, hi) and [0, Tk)
  const int q0 = blockIdx.x * Geom<D, RQ>::BQ;
  const int last_row = min(q0 + Geom<D, RQ>::BQ, Tq) - 1;
  const long long begin = max(static_cast<long long>(q0) + q_offset - window, static_cast<long long>(max(lo, 0)));
  const long long end = min(static_cast<long long>(last_row) + q_offset + window + 1,
                            static_cast<long long>(min(hi, Tk)));
  attend_rows<D, RQ, W>(q, k, v, out, lse, Tq, Tk, static_cast<int>(min(begin, end)), static_cast<int>(end), scale,
                        Band{q_offset, window}, dw);
}

// 64-row tiles when they give at least two blocks per SM of the card.
bool wide_tiles(int H, int Tq) { return static_cast<long long>(H) * ((Tq + 63) / 64) >= 2LL * sm_count(); }

// Column slices of the grid: dw / D on the wide path, else 1.
template <int D, bool W>
__host__ __device__ __forceinline__ int slices_of(int dw) {
  return W ? dw / D : 1;
}

template <int D, int RQ, bool W = false>
int launch_full(const float* q, const float* k, const float* v, float* out, float* lse, int H, int Tq, int Tk,
                int kv_end, float scale, int dw, cudaStream_t s) {
  using G = Geom<D, RQ>;
  static_assert(G::kBytes <= kMaxSmemBytes, "the forward's tiles must fit a block's shared memory");
  const int err = allow_dynamic_smem(flash_fwd_kernel<D, RQ, W>, G::kBytes);
  if (err) return err;
  const dim3 grid((Tq + G::BQ - 1) / G::BQ, H, slices_of<D, W>(dw));
  flash_fwd_kernel<D, RQ, W><<<grid, kThreads, G::kBytes, s>>>(q, k, v, out, lse, Tq, Tk, kv_end, scale, dw);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int RQ, bool W = false>
int launch_local(const float* q, const float* k, const float* v, float* out, float* lse, int H, int Tq, int Tk,
                 float scale, int window, int lo, int hi, int q_offset, int dw, cudaStream_t s) {
  using G = Geom<D, RQ>;
  static_assert(G::kBytes <= kMaxSmemBytes, "the forward's tiles must fit a block's shared memory");
  const int err = allow_dynamic_smem(flash_local_fwd_kernel<D, RQ, W>, G::kBytes);
  if (err) return err;
  const dim3 grid((Tq + G::BQ - 1) / G::BQ, H, slices_of<D, W>(dw));
  flash_local_fwd_kernel<D, RQ, W>
      <<<grid, kThreads, G::kBytes, s>>>(q, k, v, out, lse, Tq, Tk, scale, window, lo, hi, q_offset, dw);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int local_for(const float* q, const float* k, const float* v, float* out, float* lse, int H, int Tq, int Tk,
              float scale, int window, int lo, int hi, int q_offset, cudaStream_t s) {
  return wide_tiles(H, Tq)
             ? launch_local<D, 4>(q, k, v, out, lse, H, Tq, Tk, scale, window, lo, hi, q_offset, D, s)
             : launch_local<D, 2>(q, k, v, out, lse, H, Tq, Tk, scale, window, lo, hi, q_offset, D, s);
}

// ---------------------------------------------------------------------------
// Backwards: dq, dk and dv from q, k, v, dO, lse and di = rowsum(dO * O) - g_lse
// (di is computed by the caller, as the JAX package leaves it to XLA).
//
// Replaces two more kernels of cvml_goalnet_tpu/ops/pallas/flash_attention.py:
//   * _flash_bwd (bodies _dkv_kernel and _dq_kernel): the full form, keys
//     valid below t_valid;
//   * _flash_local_bwd (bodies _local_dkv_kernel and _local_dq_kernel): the
//     band |i + q_offset - j| <= W with keys valid in [lo, hi).
// Both run on the tensor cores (kernels 6 and 8, the section after this one)
// at head widths up to 128.  At 256 and on the wide path they run the
// templates of this section, with the full mask or the band, since the
// tensor-core kernel's dK and dV would not fit in registers there (128 a
// thread at 128 already).
// The TPU grid carries dk/dv (or dq) scratch across sequential grid steps;
// Hopper blocks run in no order, so each call is two kernels, no atomics, and
// its results repeat exactly:
//   * dkv: one block per (head, key tile of B keys).  K^T and V^T stay in
//     shared memory; the block walks the query tiles that can reach its keys
//     (all of them for the full form; rows [j - W - q_offset, j + W - q_offset]
//     for the band), recomputing per tile S = Q K^T * scale, P = exp(S - lse)
//     and dS = P * (dO V^T - di), and accumulates dV += P^T dO and
//     dK += dS^T Q in registers; dK is scaled once at the end;
//   * dq: one block per (head, query tile) walking the key tiles the forward
//     walks, dQ += dS K in registers, scaled once at the end.
// Masked entries get P = dS = 0 exactly, so a dead row (forward out 0, lse 0)
// adds nothing and gets dq = 0, and keys outside t_valid or [lo, hi) get
// dk = dv = 0; a key tile no query reaches still writes its zeros.
//
// What bounds it on an H100: operations.  The useful work is 10d FLOP per
// valid (query, key) pair (s, dp, dv, dk, dq at 2d each); the two-kernel split
// does 14d, since both kernels recompute s and dp.  Float32 on the FP32 cores,
// as the forwards (one TF32 product would break the 1e-4 gradient contract;
// the 3xTF32 design follows this section).  Tiles are B x B with B = 16R:
// 256 threads as a 16 x 16 grid, a thread owning R x R entries of the score
// tile and R rows (or keys) x d/16 columns of the accumulators.  R = 2 (at
// d = 256, 139 KB of shared memory; R = 4 would take 292 KB), as on the wide
// path (D = kDC; both operand sides of a tile are reloaded chunk by chunk,
// the block's own column slice last, so that its columns of Q and dO, or of
// K, are in shared memory for the sums into dK and dV, or dQ).

template <int D, int R>
struct BwdGeom {
  static constexpr int B = 16 * R;    // query rows per query tile, keys per key tile
  static constexpr int NC = D / 16;   // accumulator columns per thread
  static constexpr int kLdR = D + 1;  // a row of Q or dO in shared memory (Geom<D, R>'s kLdQ)
  static constexpr int kLdT = B + 1;  // a row of K^T or V^T, and of P or dS
  static constexpr int kRows = B * kLdR;
  static constexpr int kCols = D * kLdT;
  static constexpr int kTile = B * kLdT;
  // Q, dO, K^T, V^T, P, dS, then lse and di of the query tile
  static constexpr size_t kBytes = sizeof(float) * (2 * kRows + 2 * kCols + 2 * kTile + 2 * B);
};

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *di;  // (H, Tq, dw), (H, Tk, dw) x 2, (H, Tq, dw), (H, Tq) x 2
  float *dq, *dk, *dv;                       // (H, Tq, dw), (H, Tk, dw) x 2
  int Tq, Tk, dw;                            // dw: the row width (D but on the wide path)
  float scale;
};

// Rows [k0, k0 + B) of one head's keys or values (the first D columns of rows of ld floats), transposed
// into dst[c * kLdT + r] (zeros from row k_lim on).
template <int D, int R>
__device__ __forceinline__ void load_t(const float* __restrict__ src, int k0, int k_lim, float* dst, int ld = D) {
  using G = BwdGeom<D, R>;
  for (int idx = threadIdx.x; idx < G::B * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[c * G::kLdT + r] = (k0 + r < k_lim) ? __ldg(src + static_cast<size_t>(k0 + r) * ld + c) : 0.f;
  }
}

// s += Q K^T and dp += dO V^T over the D columns in shared memory, for the
// thread's R x R entries (rows ty + 16i, keys tx + 16j of the tiles).
template <int D, int R>
__device__ __forceinline__ void grad_sums(const float* sq, const float* sdo, const float* skt, const float* svt,
                                          float (&s)[R][R], float (&dp)[R][R]) {
  using G = BwdGeom<D, R>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float a[R], g[R], b[R], w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = sq[(ty + 16 * i) * G::kLdR + kk];
      g[i] = sdo[(ty + 16 * i) * G::kLdR + kk];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      b[j] = skt[kk * G::kLdT + tx + 16 * j];
      w[j] = svt[kk * G::kLdT + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// The thread's R x R entries (rows q0 + ty + 16i, keys k0 + tx + 16j) of
// P = exp(s * scale - lse) and dS = P * (dp - di), written to sp and sds as
// [row][key].  Entries whose row is at or past row_lim, whose key lies outside
// [k_lo, k_hi), or that `mask` refuses are exactly 0.
template <int D, int R, typename Mask>
__device__ __forceinline__ void grad_probs(const float (&s)[R][R], const float (&dp)[R][R], int q0, int row_lim,
                                           int k0, int k_lo, int k_hi, float scale, Mask mask, const float (&lse)[R],
                                           const float (&di)[R], float* sp, float* sds) {
  using G = BwdGeom<D, R>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool valid = row < row_lim && key >= k_lo && key < k_hi && mask(row, key);
      const float p = valid ? expf(s[i][j] * scale - lse[i]) : 0.f;
      sp[(ty + 16 * i) * G::kLdT + tx + 16 * j] = p;
      sds[(ty + 16 * i) * G::kLdT + tx + 16 * j] = p * (dp[i][j] - di[i]);
    }
  }
}

// The column of the chunk a tile's j-th pass over d stages: 0 on the built
// widths; on the wide path (n chunks of D) the block's own slice comes last.
template <int D, bool W>
__device__ __forceinline__ int chunk_col(int j, int n) {
  return W ? (static_cast<int>(blockIdx.z) + 1 + j) % n * D : 0;
}

// dK and dV of the block's B keys of head blockIdx.y, from the query rows
// [q_begin, q_end) tile by tile; keys valid in [k_lo, k_hi) that pass `mask`.
// W: the wide path (rows of a.dw floats, D = kDC, the column slice blockIdx.z).
template <int D, int R, bool W, typename Mask>
__device__ __forceinline__ void dkv_keys(const BwdArgs& a, int q_begin, int q_end, int k_lo, int k_hi, Mask mask) {
  using G = BwdGeom<D, R>;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + G::kRows;
  float* skt = sdo + G::kRows;
  float* svt = skt + G::kCols;
  float* sp = svt + G::kCols;
  float* sds = sp + G::kTile;
  float* sl = sds + G::kTile;
  float* sd = sl + G::B;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ld = W ? a.dw : D, chunks = slices_of<D, W>(a.dw);
  const int h = blockIdx.y, k0 = blockIdx.x * G::B;
  const size_t qrow = static_cast<size_t>(h) * a.Tq, krow = static_cast<size_t>(h) * a.Tk;
  const float* qh = a.q + qrow * ld;
  const float* doh = a.dout + qrow * ld;
  const float* kh = a.k + krow * ld;
  const float* vh = a.v + krow * ld;
  if constexpr (!W) {
    load_t<D, R>(kh, k0, a.Tk, skt);
    load_t<D, R>(vh, k0, a.Tk, svt);
  }
  float acc_k[R][G::NC] = {}, acc_v[R][G::NC] = {};
  for (int q0 = q_begin; q0 < q_end; q0 += G::B) {
    float s[R][R] = {}, dp[R][R] = {}, l[R], dd[R];
    for (int j = 0; j < chunks; ++j) {
      const int col = chunk_col<D, W>(j, chunks);
      __syncthreads();  // every thread is done with the previous tile's (or chunk's) Q, dO, P and dS
      load_q<D, R>(qh + col, q0, q_end, sq, ld);
      load_q<D, R>(doh + col, q0, q_end, sdo, ld);
      if constexpr (W) {
        load_t<D, R>(kh + col, k0, a.Tk, skt, ld);
        load_t<D, R>(vh + col, k0, a.Tk, svt, ld);
      }
      if (j == 0) {
        for (int r = threadIdx.x; r < G::B; r += kThreads) {
          const bool in = q0 + r < q_end;
          sl[r] = in ? __ldg(a.lse + qrow + q0 + r) : 0.f;
          sd[r] = in ? __ldg(a.di + qrow + q0 + r) : 0.f;
        }
      }
      __syncthreads();
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          l[i] = sl[ty + 16 * i];
          dd[i] = sd[ty + 16 * i];
        }
      }
      grad_sums<D, R>(sq, sdo, skt, svt, s, dp);
    }
    grad_probs<D, R>(s, dp, q0, q_end, k0, k_lo, k_hi, a.scale, mask, l, dd, sp, sds);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's rows; the thread's keys are ty + 16i
#pragma unroll 2
    for (int r = 0; r < G::B; ++r) {
      float pr[R], dr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pr[i] = sp[r * G::kLdT + ty + 16 * i];
        dr[i] = sds[r * G::kLdT + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        const float gv = sdo[r * G::kLdR + tx + 16 * c], qv = sq[r * G::kLdR + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc_v[i][c] = fmaf(pr[i], gv, acc_v[i][c]);
          acc_k[i][c] = fmaf(dr[i], qv, acc_k[i][c]);
        }
      }
    }
  }
  const int c0 = W ? blockIdx.z * D : 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) {
      a.dk[(krow + key) * ld + c0 + tx + 16 * c] = acc_k[i][c] * a.scale;
      a.dv[(krow + key) * ld + c0 + tx + 16 * c] = acc_v[i][c];
    }
  }
}

// dQ of the block's B query rows of head blockIdx.y, from the keys
// [k_begin, k_end) that pass `mask`, tile by tile.  W: as dkv_keys.
template <int D, int R, bool W, typename Mask>
__device__ __forceinline__ void dq_rows(const BwdArgs& a, int k_begin, int k_end, Mask mask) {
  using G = BwdGeom<D, R>;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + G::kRows;
  float* skt = sdo + G::kRows;
  float* svt = skt + G::kCols;
  float* sp = svt + G::kCols;
  float* sds = sp + G::kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ld = W ? a.dw : D, chunks = slices_of<D, W>(a.dw);
  const int h = blockIdx.y, q0 = blockIdx.x * G::B;
  const size_t qrow = static_cast<size_t>(h) * a.Tq, krow = static_cast<size_t>(h) * a.Tk;
  const float* qh = a.q + qrow * ld;
  const float* doh = a.dout + qrow * ld;
  const float* kh = a.k + krow * ld;
  const float* vh = a.v + krow * ld;
  if constexpr (!W) {
    load_q<D, R>(qh, q0, a.Tq, sq);
    load_q<D, R>(doh, q0, a.Tq, sdo);
  }
  float l[R], dd[R], acc[R][G::NC] = {};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    l[i] = row < a.Tq ? __ldg(a.lse + qrow + row) : 0.f;
    dd[i] = row < a.Tq ? __ldg(a.di + qrow + row) : 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += G::B) {
    float s[R][R] = {}, dp[R][R] = {};
    for (int j = 0; j < chunks; ++j) {
      const int col = chunk_col<D, W>(j, chunks);
      __syncthreads();  // every thread is done with the previous tile's (or chunk's) K^T, V^T and dS
      if constexpr (W) {
        load_q<D, R>(qh + col, q0, a.Tq, sq, ld);
        load_q<D, R>(doh + col, q0, a.Tq, sdo, ld);
      }
      load_t<D, R>(kh + col, k0, k_end, skt, ld);
      load_t<D, R>(vh + col, k0, k_end, svt, ld);
      __syncthreads();
      grad_sums<D, R>(sq, sdo, skt, svt, s, dp);
    }
    grad_probs<D, R>(s, dp, q0, a.Tq, k0, k_begin, k_end, a.scale, mask, l, dd, sp, sds);
    __syncthreads();
    // dQ += dS K: K[j][col] is K^T[col][j], an odd stride apart across the threads
#pragma unroll 4
    for (int j = 0; j < G::B; ++j) {
      float g[R];
#pragma unroll
      for (int i = 0; i < R; ++i) g[i] = sds[(ty + 16 * i) * G::kLdT + j];
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        const float kv = skt[(tx + 16 * c) * G::kLdT + j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(g[i], kv, acc[i][c]);
      }
    }
  }
  const int c0 = W ? blockIdx.z * D : 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) a.dq[(qrow + row) * ld + c0 + tx + 16 * c] = acc[i][c] * a.scale;
  }
}

template <int D, int R, bool W>
__global__ void __launch_bounds__(kThreads) flash_full_dkv_kernel(BwdArgs a, int kv_end) {
  // a key tile wholly past kv_end visits no query and writes zeros
  const bool any_valid = static_cast<int>(blockIdx.x) * BwdGeom<D, R>::B < kv_end;
  dkv_keys<D, R, W>(a, 0, any_valid ? a.Tq : 0, 0, kv_end, AllKeys{});
}

template <int D, int R, bool W>
__global__ void __launch_bounds__(kThreads) flash_full_dq_kernel(BwdArgs a, int kv_end) {
  dq_rows<D, R, W>(a, 0, kv_end, AllKeys{});
}

template <int D, int R, bool W>
__global__ void __launch_bounds__(kThreads)
    flash_local_dkv_kernel(BwdArgs a, int window, int lo, int hi, int q_offset) {
  // the tile's valid keys [kb, ke], then the rows whose band reaches one of them
  const int k0 = blockIdx.x * BwdGeom<D, R>::B;
  const int k_lo = max(lo, 0), k_hi = min(hi, a.Tk);
  const int kb = max(k0, k_lo), ke = min(k0 + BwdGeom<D, R>::B, k_hi) - 1;
  const long long begin = min(max(static_cast<long long>(kb) - window - q_offset, 0LL), static_cast<long long>(a.Tq));
  const long long end = kb > ke ? begin
                                : max(begin, min(static_cast<long long>(ke) + window - q_offset + 1,
                                                 static_cast<long long>(a.Tq)));
  dkv_keys<D, R, W>(a, static_cast<int>(begin), static_cast<int>(end), k_lo, k_hi, Band{q_offset, window});
}

template <int D, int R, bool W>
__global__ void __launch_bounds__(kThreads)
    flash_local_dq_kernel(BwdArgs a, int window, int lo, int hi, int q_offset) {
  // the keys any row of this tile may see, as in flash_local_fwd_kernel
  const int q0 = blockIdx.x * BwdGeom<D, R>::B;
  const int last_row = min(q0 + BwdGeom<D, R>::B, a.Tq) - 1;
  const long long begin = max(static_cast<long long>(q0) + q_offset - window, static_cast<long long>(max(lo, 0)));
  const long long end = min(static_cast<long long>(last_row) + q_offset + window + 1,
                            static_cast<long long>(min(hi, a.Tk)));
  dq_rows<D, R, W>(a, static_cast<int>(min(begin, end)), static_cast<int>(end), Band{q_offset, window});
}

// One backward kernel over `tiles` x H x `slices` blocks (none when tiles or H is 0).
template <typename Kernel, typename... Args>
int launch_bwd(Kernel kernel, size_t bytes, int tiles, int H, int slices, cudaStream_t s, Args... args) {
  if (tiles == 0 || H == 0) return 0;
  const int err = allow_dynamic_smem(kernel, bytes);
  if (err) return err;
  kernel<<<dim3(tiles, H, slices), kThreads, bytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int tiles_of(int T) {
  return (T + 16 * R - 1) / (16 * R);
}

// The banded backward at a head width past the tensor-core kernel's (256, or the wide path with D = kDC):
// R = 2 (the only tiles that fit at 256), no split.
template <int D, bool W>
int local_bwd_f32(const BwdArgs& a, int H, int window, int lo, int hi, int q_offset, cudaStream_t s) {
  using N = BwdGeom<D, 2>;
  static_assert(N::kBytes <= kMaxSmemBytes, "the backward's tiles must fit a block's shared memory");
  const int slices = slices_of<D, W>(a.dw);
  const int err = launch_bwd(flash_local_dkv_kernel<D, 2, W>, N::kBytes, tiles_of<2>(a.Tk), H, slices, s, a,
                             window, lo, hi, q_offset);
  if (err) return err;
  return launch_bwd(flash_local_dq_kernel<D, 2, W>, N::kBytes, tiles_of<2>(a.Tq), H, slices, s, a, window, lo, hi,
                    q_offset);
}

// The full backward at a head width past the tensor-core kernel's (256, or the wide path with D = kDC): the
// FP32-core templates with the full mask, R = 2, no split.
template <int D, bool W>
int full_bwd_f32(const BwdArgs& a, int H, int kv_end, cudaStream_t s) {
  using N = BwdGeom<D, 2>;
  const int slices = slices_of<D, W>(a.dw);
  const int err =
      launch_bwd(flash_full_dkv_kernel<D, 2, W>, N::kBytes, tiles_of<2>(a.Tk), H, slices, s, a, kv_end);
  if (err) return err;
  return launch_bwd(flash_full_dq_kernel<D, 2, W>, N::kBytes, tiles_of<2>(a.Tq), H, slices, s, a, kv_end);
}

BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* di,
                 void* dq, void* dk, void* dv, int Tq, int Tk, int dw, float scale) {
  return BwdArgs{static_cast<const float*>(q),    static_cast<const float*>(k),   static_cast<const float*>(v),
                 static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
                 static_cast<float*>(dq),         static_cast<float*>(dk),        static_cast<float*>(dv),
                 Tq,                              Tk,                             dw,
                 scale};
}


// ---------------------------------------------------------------------------
// Kernels 6 and 8, the full and the banded backward, on the tensor cores in
// 3xTF32.
//
// Same functions as the FP32-core templates above, same contract: float32 in
// and out, masked keys get dk = dv = 0 exactly, dead rows dq = 0 exactly, no
// atomics, equal bits on a repeat.  One template serves both; its mask policy
// says which streamed chunks a stationary tile walks and which of their
// (query, key) pairs are valid:
//   * TcAllKeys (kernel 6): every chunk of the queries (dK/dV) or of the keys
//     below kv_end (dQ); a key tile wholly past kv_end walks none;
//   * TcBand (kernel 8): |query + q_offset - key| <= W with keys in [lo, hi),
//     held as key - query in [d_lo, d_hi] and keys in [k_lo, kv_end).  A tile
//     walks only the chunks that meet its band: for keys [kb, ke] (clipped to
//     the valid ones) the queries [kb - d_hi, ke - d_lo], for rows
//     [q0, last] the keys [q0 + d_lo, last + d_hi], each cut to what exists.
//     At T = 5400 and W = 1024 that is at most 132 chunks of 16 a tile, not 338,
//     and about 97 % of the pairs walked are in the band.  The rest are tested
//     per element in the accumulator layout and get P = dS = 0 exactly.
// The split plans come from the band too (ops/cuda/flash_attention.py::
// local_bwd_plan, the specification of the walk): split i of s walks chunks
// [i n / s, (i + 1) n / s) of its tile's n.
//
// What bounds it on an H100: operations.  The two-kernel split does 14d FLOP
// per (query, key) pair (S and dP in both kernels, then dV, dK; dQ).  One TF32
// product breaks the 1e-4 gradient contract, so every product is 3xTF32
// (csrc/tf32_mma.cuh).  Three products at the 495 TFLOP/s TF32 rate are still
// 2.5x the 67 TFLOP/s of the FP32 cores: 14d*3 per pair bounds
// (1, 5400, 128) at 0.32 ms.
//
// Design (both kernels are one template, `Dkv` picks the side):
//   * a block of 4 warps owns a stationary tile of 64 rows, 16 per warp: keys
//     (K and V) for dK/dV, query rows (Q and dO) for dQ.  It streams the other
//     side in chunks of BS rows (16 at d = 128, 32 below) through a two-stage
//     cp.async ring of 16-byte copies (zero-filled past the end; a copy's
//     address is a shift and an add);
//   * per chunk each warp computes its 16 x BS tiles of S (or S^T) and dP by
//     MMA over d, applies the mask, exp and P * (dP - di) in registers in the
//     MMA accumulator layout, and feeds P and dS as the A operand of the next
//     products straight from those registers: the accumulator holds columns
//     (2t, 2t+1) where the A operand wants (t, t+4), so the k index of those
//     products is permuted and the B operand (dO, Q or K from shared memory)
//     is read in the same permuted row order;
//   * in the products over d the k order within each 8 columns is permuted
//     the same way for both operands, so a thread's two values of a fragment
//     row are adjacent and come in one 8-byte load;
//   * stationary rows are D + 8 floats in shared memory and streamed rows
//     D + 4, so those pair loads of the stationary tile and the (row 2t,
//     col g) loads of the streamed one hit distinct banks (the streamed pair
//     loads take two passes);
//   * at d = 128 a dK/dV warp holds 2 x 16 x 128 accumulators (128 registers
//     a thread); a chunk of 16 queries keeps S and dP at 16 more.  Shared
//     memory is 101 KB, two blocks per SM;
//   * a small grid (one head of T = 5400 is 85 tiles for an H100's 264
//     resident blocks) is filled by splitting each block's walk over the
//     chunks into s parts (the wrapper's plan from the card's occupancy,
//     ops/cuda/flash_attention.py::card_bwd_plan, card_local_bwd_plan); split
//     i writes float32 partials to scratch the wrapper allocates, and a last
//     kernel adds them in split order.  With s = 1 the tile kernels write the
//     outputs directly.

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcTile = 64;      // stationary rows per block, 16 per warp
// The MMA's float32 accumulation rounds toward zero (csrc/tf32_mma.cuh), so S
// and dP are summed over kSumGroup k-steps at a time in a fresh accumulator,
// and each chunk's share of dK, dV and dQ likewise, then added in float32.
constexpr int kSumGroup = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcGeom {
  static constexpr int BS = D == 128 ? 16 : 32;  // streamed rows per chunk
  static constexpr int kLdX = D + 8;             // a stationary row in shared memory
  static constexpr int kLd = D + 4;              // a streamed row
  static constexpr int NT = BS / 8;              // 8-wide MMA tiles across a chunk
  static constexpr int ND = D / 8;               // 8-wide MMA tiles across d
  // stationary X1, X2; the ring of streamed Y1, Y2; lse and di of streamed queries
  static constexpr size_t kBytes = sizeof(float) * (2 * kTcTile * kLdX + 4 * BS * kLd + 4 * BS);
  static_assert(kTcTile * D / 4 % kTcThreads == 0 && BS * D / 4 % kTcThreads == 0, "whole copy rounds");
};

struct TcArgs {
  const float *q, *k, *v, *dout, *lse, *di;  // (H, Tq, D), (H, Tk, D) x 2, (H, Tq, D), (H, Tq) x 2
  float *dq, *dk, *dv;                       // (H, Tq, D), (H, Tk, D) x 2
  float *part_kv, *part_q;                   // (s_dkv, 2, H, Tk, D), (s_dq, H, Tq, D), or null when s = 1
  int H, Tq, Tk, kv_end, s_dkv, s_dq;        // keys valid below kv_end (for the band, below min(hi, Tk))
  float scale;
};

// Kernel 6's (and kernel 5's) mask: every query against the keys below kv_end.
struct TcAllKeys {
  // the streamed chunks [x, y) of BS rows that the stationary tile at r0 walks (Args: TcArgs, or TcFwdArgs with
  // Dkv = false)
  template <bool Dkv, int BS, typename Args>
  __device__ __forceinline__ int2 chunks(const Args& a, int r0) const {
    // a key tile wholly past kv_end sees no query and writes zeros
    if (Dkv) return make_int2(0, r0 >= a.kv_end ? 0 : (a.Tq + BS - 1) / BS);
    return make_int2(0, (a.kv_end + BS - 1) / BS);
  }
  // whether a pair of an existing query and a key below kv_end is valid
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// Kernel 8's (and kernel 7's) band: keys in [k_lo, kv_end), key - query in [d_lo, d_hi] (q_offset -+ W,
// clamped to [-Tq, Tk] so that they fit an int and keep every pair's test).
struct TcBand {
  int k_lo, d_lo, d_hi;
  template <bool Dkv, int BS, typename Args>
  __device__ __forceinline__ int2 chunks(const Args& a, int r0) const {
    long long first, last;  // the streamed rows the tile's band reaches
    if (Dkv) {              // stationary keys [kb, ke], streamed queries
      const long long kb = max(r0, k_lo), ke = min(r0 + kTcTile, a.kv_end) - 1;
      first = max(kb - d_hi, 0LL);
      last = kb > ke ? -1 : min(ke - d_lo, a.Tq - 1LL);
    } else {  // stationary rows [r0, last_row], streamed keys
      const long long last_row = min(r0 + kTcTile, a.Tq) - 1;
      first = max(static_cast<long long>(r0) + d_lo, static_cast<long long>(k_lo));
      last = min(last_row + d_hi, a.kv_end - 1LL);
    }
    if (first > last) return make_int2(0, 0);
    return make_int2(static_cast<int>(first / BS), static_cast<int>(last / BS + 1));
  }
  __device__ __forceinline__ bool operator()(int query, int key) const {
    const int diff = key - query;
    return key >= k_lo && diff >= d_lo && diff <= d_hi;
  }
};

// Rows [r0, r0 + ROWS) of one head's (T, D) matrix into dst (pitch LD),
// zeros from row lim on.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int r0, int lim) {
  constexpr int kPer = D / 4;  // 16-byte copies per row
#pragma unroll
  for (int i = 0; i < ROWS * kPer / kTcThreads; ++i) {
    const int c = threadIdx.x + i * kTcThreads;
    const int r = c / kPer, c4 = c % kPer;
    const bool in = r0 + r < lim;
    cp_async16(dst + r * LD + 4 * c4, src + static_cast<size_t>(in ? r0 + r : 0) * D + 4 * c4, in);
  }
}

// acc += sum over j of A_j * Y[8j .. 8j + 8 in the permuted order][8n .. 8n + 8],
// Y in shared memory with pitch LD and p = &Y[2t][g + 8n]: the chunk's NT
// products in a fresh accumulator, then one float32 add (see kSumGroup).
template <int NT, int LD>
__device__ __forceinline__ void add_chunk_product(float (&acc)[4], const uint32_t (&ab)[NT][4],
                                                  const uint32_t (&as)[NT][4], const float* p) {
  float part[4] = {};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bb[2], bs[2];
    frag_b(p[8 * j * LD], p[(8 * j + 1) * LD], bb, bs);
    mma3(part, ab[j], as[j], bb, bs);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// One block of kernel 6 (Mask = TcAllKeys) or 8 (TcBand): blockIdx = (stationary tile, head, split).
template <int D, bool Dkv, typename Mask>
__global__ void __launch_bounds__(kTcThreads, 2) flash_bwd_tc_kernel(TcArgs a, Mask mask) {
  using G = TcGeom<D>;
  constexpr int BS = G::BS, kLd = G::kLd;
  extern __shared__ float4 smem4[];
  float* sx1 = reinterpret_cast<float*>(smem4);
  float* sx2 = sx1 + kTcTile * G::kLdX;
  float* sy1 = sx2 + kTcTile * G::kLdX;  // [2][BS][kLd]
  float* sy2 = sy1 + 2 * BS * kLd;
  float* sl = sy2 + 2 * BS * kLd;    // [2][BS]
  float* sd = sl + 2 * BS;

  const int h = blockIdx.y, split = blockIdx.z, n_split = Dkv ? a.s_dkv : a.s_dq;
  const int r0 = blockIdx.x * kTcTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t qoff = static_cast<size_t>(h) * a.Tq, koff = static_cast<size_t>(h) * a.Tk;
  // stationary X1, X2 and streamed Y1, Y2: K, V and Q, dO for dK/dV; Q, dO and K, V for dQ
  const float* x1 = Dkv ? a.k + koff * D : a.q + qoff * D;
  const float* x2 = Dkv ? a.v + koff * D : a.dout + qoff * D;
  const float* y1 = Dkv ? a.q + qoff * D : a.k + koff * D;
  const float* y2 = Dkv ? a.dout + qoff * D : a.v + koff * D;
  const float* lse = a.lse + qoff;
  const float* di = a.di + qoff;
  const int x_lim = Dkv ? a.Tk : a.Tq;
  const int y_lim = Dkv ? a.Tq : a.kv_end;  // streamed rows that exist (queries) or are valid (keys)

  // this split's share of the tile's chunks; a tile that walks none writes zeros
  const int2 range = mask.template chunks<Dkv, BS>(a, r0);
  const int chunks = range.y - range.x;
  const int c_begin = range.x + static_cast<int>(static_cast<long long>(split) * chunks / n_split);
  const int c_end = range.x + static_cast<int>(static_cast<long long>(split + 1) * chunks / n_split);

  auto load_chunk = [&](int stage, int c) {
    const int y0 = c * BS;
    copy_rows<D, BS, kLd>(sy1 + stage * BS * kLd, y1, y0, y_lim);
    copy_rows<D, BS, kLd>(sy2 + stage * BS * kLd, y2, y0, y_lim);
    if (Dkv && threadIdx.x < BS) {
      const bool in = y0 + threadIdx.x < a.Tq;
      const int row = in ? y0 + threadIdx.x : 0;
      cp_async4(sl + stage * BS + threadIdx.x, lse + row, in);
      cp_async4(sd + stage * BS + threadIdx.x, di + row, in);
    }
  };
  if (c_begin < c_end) {
    copy_rows<D, kTcTile, G::kLdX>(sx1, x1, r0, x_lim);
    copy_rows<D, kTcTile, G::kLdX>(sx2, x2, r0, x_lim);
    load_chunk(0, c_begin);
  }
  cp_async_commit();

  // the thread's two stationary rows (g and g + 8 of the warp's 16); for dQ their lse and di
  const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
  float l_row[2] = {0.f, 0.f}, d_row[2] = {0.f, 0.f};
  if constexpr (!Dkv) {
    if (row_a < a.Tq) l_row[0] = __ldg(lse + row_a) * kLog2e, d_row[0] = __ldg(di + row_a);
    if (row_b < a.Tq) l_row[1] = __ldg(lse + row_b) * kLog2e, d_row[1] = __ldg(di + row_b);
  }

  const float scale_log2e = a.scale * kLog2e;      // P = 2^(S * scale * log2 e - lse * log2 e)
  float acc1[G::ND][4] = {}, acc2[G::ND][4] = {};  // dK and dV, or dQ (acc2 unused)
  const float* xa = sx1 + (warp * 16 + g) * G::kLdX + 2 * t;
  const float* xb = sx2 + (warp * 16 + g) * G::kLdX + 2 * t;
  for (int c = c_begin; c < c_end; ++c) {
    const int stage = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      load_chunk(stage ^ 1, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ys1 = sy1 + stage * BS * kLd;
    const float* ys2 = sy2 + stage * BS * kLd;
    const int y0 = c * BS;

    // S (or S^T) = X1 Y1^T and dP (or dP^T) = X2 Y2^T over d, kSumGroup k-steps per fresh accumulator
    float s[G::NT][4] = {}, dp[G::NT][4] = {};
#pragma unroll 1
    for (int k0 = 0; k0 < D / 8; k0 += kSumGroup) {
      float ps[G::NT][4] = {}, pdp[G::NT][4] = {};
#pragma unroll
      for (int kk = k0; kk < k0 + kSumGroup; ++kk) {
        uint32_t a1b[4], a1s[4], a2b[4], a2s[4];
        frag_a(xa + 8 * kk, G::kLdX, a1b, a1s);
        frag_a(xb + 8 * kk, G::kLdX, a2b, a2s);
#pragma unroll
        for (int n = 0; n < G::NT; ++n) {
          const float2 y1v = *reinterpret_cast<const float2*>(ys1 + (8 * n + g) * kLd + 8 * kk + 2 * t);
          const float2 y2v = *reinterpret_cast<const float2*>(ys2 + (8 * n + g) * kLd + 8 * kk + 2 * t);
          uint32_t bb[2], bs[2];
          frag_b(y1v.x, y1v.y, bb, bs);
          mma3(ps[n], a1b, a1s, bb, bs);
          frag_b(y2v.x, y2v.y, bb, bs);
          mma3(pdp[n], a2b, a2s, bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] += ps[n][e];
          dp[n][e] += pdp[n][e];
        }
    }

    // P = exp(S * scale - lse) and dS = P * (dP - di), exactly 0 where masked
#pragma unroll
    for (int n = 0; n < G::NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);  // streamed row within the chunk
        const int stat = e < 2 ? row_a : row_b;   // stationary row
        const int query = Dkv ? y0 + col : stat, key = Dkv ? stat : y0 + col;
        float l, dd;
        if constexpr (Dkv) {  // stationary keys, streamed queries
          l = sl[stage * BS + col] * kLog2e;
          dd = sd[stage * BS + col];
        } else {    // stationary queries, streamed keys
          l = l_row[e >> 1];
          dd = d_row[e >> 1];
        }
        const bool valid = key < a.kv_end && query < a.Tq && mask(query, key);
        const float p = valid ? exp2f(fmaf(s[n][e], scale_log2e, -l)) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dd);
      }
    }

    // dK += dS^T Q and dV += P^T dO (dK/dV), or dQ += dS K (dQ), 8 columns at a time
    uint32_t gb[G::NT][4], gs[G::NT][4], pb[G::NT][4], pbs[G::NT][4];
#pragma unroll
    for (int j = 0; j < G::NT; ++j) {
      frag_a_from_acc(dp[j], gb[j], gs[j]);
      if constexpr (Dkv) frag_a_from_acc(s[j], pb[j], pbs[j]);
    }
    const int off = 2 * t * kLd + g;
#pragma unroll
    for (int n = 0; n < G::ND; ++n) {
      add_chunk_product<G::NT, kLd>(acc1[n], gb, gs, ys1 + off + 8 * n);
      if constexpr (Dkv) add_chunk_product<G::NT, kLd>(acc2[n], pb, pbs, ys2 + off + 8 * n);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // rows g and g + 8, columns (2t, 2t + 1) of each 8-wide tile; split i > 1 way writes its partials
  float *out1, *out2 = nullptr;
  if constexpr (Dkv) {
    const size_t n = static_cast<size_t>(a.H) * a.Tk * D;
    out1 = a.s_dkv > 1 ? a.part_kv + 2 * split * n : a.dk;
    out2 = a.s_dkv > 1 ? a.part_kv + (2 * split + 1) * n : a.dv;
    out1 += koff * D;
    out2 += koff * D;
  } else {
    out1 = (a.s_dq > 1 ? a.part_q + split * static_cast<size_t>(a.H) * a.Tq * D : a.dq) + qoff * D;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= x_lim) continue;
#pragma unroll
    for (int n = 0; n < G::ND; ++n) {
      const size_t at = static_cast<size_t>(row) * D + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(out1 + at) =
          make_float2(acc1[n][2 * half] * a.scale, acc1[n][2 * half + 1] * a.scale);
      if constexpr (Dkv) *reinterpret_cast<float2*>(out2 + at) = make_float2(acc2[n][2 * half], acc2[n][2 * half + 1]);
    }
  }
}

// out[i] = part[i] + part[stride + i] + ... over s splits, in split order.
struct SplitSum {
  const float4* part;
  float4* out;
  size_t n4, stride4;
};

__global__ void __launch_bounds__(256) split_sum_kernel(SplitSum j0, SplitSum j1, SplitSum j2, int s) {
  const SplitSum j = blockIdx.y == 0 ? j0 : (blockIdx.y == 1 ? j1 : j2);
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= j.n4) return;
  float4 acc = j.part[i];
  for (int k = 1; k < s; ++k) {
    const float4 p = j.part[k * j.stride4 + i];
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  j.out[i] = acc;
}

int split_sum(SplitSum j0, SplitSum j1, SplitSum j2, int jobs, int s, cudaStream_t st) {
  if (jobs == 0 || j0.n4 == 0) return 0;
  const int blocks = static_cast<int>((j0.n4 + 255) / 256);
  split_sum_kernel<<<dim3(blocks, jobs), 256, 0, st>>>(j0, j1, j2, s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool Dkv, typename Mask>
int launch_tc(const TcArgs& a, Mask mask, int tiles, int splits, cudaStream_t s) {
  if (tiles == 0 || a.H == 0) return 0;
  const int err = allow_dynamic_smem(flash_bwd_tc_kernel<D, Dkv, Mask>, TcGeom<D>::kBytes);
  if (err) return err;
  flash_bwd_tc_kernel<D, Dkv, Mask><<<dim3(tiles, a.H, splits), kTcThreads, TcGeom<D>::kBytes, s>>>(a, mask);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV, then dQ, then (if either was split) the sums of the partials.
template <int D, typename Mask>
int bwd_tc(const TcArgs& a, Mask mask, cudaStream_t s) {
  int err = launch_tc<D, true>(a, mask, (a.Tk + kTcTile - 1) / kTcTile, a.s_dkv, s);
  if (err) return err;
  err = launch_tc<D, false>(a, mask, (a.Tq + kTcTile - 1) / kTcTile, a.s_dq, s);
  if (err) return err;
  const size_t nk4 = static_cast<size_t>(a.H) * a.Tk * D / 4, nq4 = static_cast<size_t>(a.H) * a.Tq * D / 4;
  const SplitSum dk{reinterpret_cast<const float4*>(a.part_kv), reinterpret_cast<float4*>(a.dk), nk4, 2 * nk4};
  const SplitSum dv{reinterpret_cast<const float4*>(a.part_kv) + nk4, reinterpret_cast<float4*>(a.dv), nk4, 2 * nk4};
  const SplitSum dq{reinterpret_cast<const float4*>(a.part_q), reinterpret_cast<float4*>(a.dq), nq4, nq4};
  if (a.s_dkv > 1) {
    err = split_sum(dk, dv, dv, 2, a.s_dkv, s);
    if (err) return err;
  }
  return a.s_dq > 1 ? split_sum(dq, dq, dq, 1, a.s_dq, s) : 0;
}

// which: 0 and 1 kernel 6's dK/dV and dQ, 2 and 3 kernel 8's.
template <int D>
int tc_blocks_per_sm(int which, int* out) {
  const void* kernels[] = {reinterpret_cast<const void*>(flash_bwd_tc_kernel<D, true, TcAllKeys>),
                           reinterpret_cast<const void*>(flash_bwd_tc_kernel<D, false, TcAllKeys>),
                           reinterpret_cast<const void*>(flash_bwd_tc_kernel<D, true, TcBand>),
                           reinterpret_cast<const void*>(flash_bwd_tc_kernel<D, false, TcBand>)};
  if (which < 0 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernels[which];
  const int err = allow_dynamic_smem(kernel, TcGeom<D>::kBytes);
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kTcThreads, TcGeom<D>::kBytes));
}

// ---------------------------------------------------------------------------
// Kernels 5 and 7, the full and the banded forward, on the tensor cores in
// 3xTF32.
//
// Same functions as flash_fwd_kernel and flash_local_fwd_kernel, at head
// widths up to 128 (256 and the wide path keep those FP32-core templates):
// out and the row lse, a dead row out 0 and lse 0; no atomics, equal bits on
// a repeat.  One template serves both, with kernels 6 and 8's mask policies
// on the query side (Dkv = false):
//   * TcAllKeys (kernel 5): every key chunk below kv_end, every pair of an
//     existing key valid: kernel 5's walk and arithmetic;
//   * TcBand (kernel 7): each 64-row tile walks only the key chunks that meet
//     its rows' bands ([q0 + d_lo, last + d_hi] cut to [k_lo, kv_end)), and
//     each pair is tested in the accumulator layout (key >= k_lo, key - query
//     in [d_lo, d_hi]).  At T = 5400, W = 1024 and d = 128 a tile walks at
//     most 67 chunks of 32, where kernel 5 walks 169.
// Where it breaks, and what holds it:
//   1. rows that die inside a live tile: in the band, with [lo, hi) and
//      q_offset, one row of a tile may see no valid key while its neighbour
//      does.  Its running max stays -inf, the base it subtracts is 0, so its
//      weights and alpha are exactly 0 (never NaN), and the store and the
//      merge give it out 0 and lse 0.  A split that walks no chunk of its
//      tile writes m = -inf and l = 0, and the merge weighs it exactly 0;
//   2. summation order: the MMAs sum in another order than the float32 plain
//      version, so at scores near 1e3 both are held to float64;
//   3. offsets of either sign, bounds outside [0, Tk) or crossed, Tq != Tk
//      and windows past T: the host clamps the band's limits in 64 bits
//      (band_of), and the chunk range is computed in 64 bits;
//   4. registers: the band test adds integer compares to the inner loop of a
//      kernel at about 244 registers (chip_smoke.py reports both forms'
//      registers and spills).  At d = 32 it takes the kernel past the 170
//      registers of three blocks an SM, so kernel 7 keeps two there where
//      kernel 5 keeps three; no config runs heads of 32.
//
// What bounds it on an H100: operations.  4d FLOP per valid (query, key)
// pair (S = Q K^T, then P V), each product in 3xTF32 as in kernel 6: 12d per
// pair at 495 TFLOP/s bounds (1, 5400, 128) at 0.090 ms for full attention
// and at 0.031 ms for the W = 1024 band, where the FP32 cores' 67 TFLOP/s
// bound them at 0.223 and 0.077 ms.
//
// Design (kernel 6's pieces, in the shape of its dQ side):
//   * a block of 4 warps owns 64 query rows of one head, 16 per warp.  Q
//     stays in shared memory (rows of D + 8 floats); K and V stream in chunks
//     of BS keys (32 at d = 128, 64 below) through a two-stage ring of
//     16-byte cp.async copies (rows of D + 4; zero-filled past kv_end, where
//     the walk ends);
//   * per chunk each warp computes its 16 x BS scores by mma3 over d,
//     kSumGroup k-steps per fresh accumulator added in float32, and runs the
//     online softmax in the accumulator layout: a thread holds rows g and
//     g + 8, the scores are taken to log2 units once (times scale * log2 e),
//     the row max is reduced over the quad's 4 threads, the weights are
//     exp2f of the scores less the running max, O is rescaled by alpha, and
//     the row sum stays a per-thread partial until the end;
//   * P goes from the accumulators straight into the A operand with kernel
//     6's permuted k index, V is read in the same permuted row order, and
//     O += P V runs per 8-column tile in a fresh accumulator per chunk (O is
//     D / 2 registers a thread, 64 at d = 128);
//   * one head of T = 5400 is 85 tiles for an H100's 264 resident blocks, so
//     the wrapper's plan (ops/cuda/flash_attention.py::card_fwd_plan, and
//     card_local_fwd_plan over the band's chunks, from the card's occupancy)
//     may split each block's walk over its tile's n chunks in s parts (split
//     i walks [i n / s, (i + 1) n / s) of them).  Split i writes its
//     unnormalised out with its row max and sum to float32 scratch the
//     wrapper allocates, and fwd_merge_kernel combines the splits in split
//     order: out = sum_i e^(m_i - m) o_i / sum_i
//     e^(m_i - m) l_i, lse = m + log l.  A split that saw no valid key has
//     weight exactly 0.  With s = 1 the tile kernel writes out and lse.

constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct TcFwdGeom {
  static constexpr int BS = D == 128 ? 32 : 64;  // keys per streamed chunk
  static constexpr int kLdQ = D + 8;             // a row of Q in shared memory
  static constexpr int kLd = D + 4;              // a streamed row of K or V
  static constexpr int NT = BS / 8;              // 8-key MMA tiles across a chunk
  static constexpr int ND = D / 8;               // 8-wide MMA tiles across d
  // Q, then the ring of K and V
  static constexpr size_t kBytes = sizeof(float) * (kTcTile * kLdQ + 4 * BS * kLd);
  static_assert(kTcTile * D / 4 % kTcThreads == 0 && BS * D / 4 % kTcThreads == 0, "whole copy rounds");
};

struct TcFwdArgs {
  const float *q, *k, *v;    // (H, Tq, D), (H, Tk, D) x 2
  float *out, *lse;          // (H, Tq, D), (H, Tq)
  float *part_o, *part_ml;   // (s, H, Tq, D) unnormalised out, (s, H, Tq, 2) row max (log2 units) and sum; s > 1
  int H, Tq, Tk, kv_end, splits;
  float scale;
};

// One block of kernel 5 (Mask = TcAllKeys) or 7 (TcBand): blockIdx = (query tile, head, split).
template <int D, typename Mask>
__global__ void __launch_bounds__(kTcThreads, 2) flash_fwd_tc_kernel(TcFwdArgs a, Mask mask) {
  using G = TcFwdGeom<D>;
  constexpr int BS = G::BS, kLd = G::kLd, NT = G::NT, ND = G::ND;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTcTile * G::kLdQ;  // [2][BS][kLd]
  float* sv = sk + 2 * BS * kLd;       // [2][BS][kLd]

  const int h = blockIdx.y, split = blockIdx.z, r0 = blockIdx.x * kTcTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t qoff = static_cast<size_t>(h) * a.Tq, koff = static_cast<size_t>(h) * a.Tk;
  const float* kh = a.k + koff * D;
  const float* vh = a.v + koff * D;

  // this split's share of the key chunks the tile walks; a split with none writes m = -inf, l = 0
  const int2 range = mask.template chunks<false, BS>(a, r0);
  const int chunks = range.y - range.x;
  const int c_begin = range.x + static_cast<int>(static_cast<long long>(split) * chunks / a.splits);
  const int c_end = range.x + static_cast<int>(static_cast<long long>(split + 1) * chunks / a.splits);

  auto load_chunk = [&](int stage, int c) {
    copy_rows<D, BS, kLd>(sk + stage * BS * kLd, kh, c * BS, a.kv_end);
    copy_rows<D, BS, kLd>(sv + stage * BS * kLd, vh, c * BS, a.kv_end);
  };
  if (c_begin < c_end) {
    copy_rows<D, kTcTile, G::kLdQ>(sq, a.q + qoff * D, r0, a.Tq);
    load_chunk(0, c_begin);
  }
  cp_async_commit();

  const float scale_log2e = a.scale * kLog2e;
  // rows g and g + 8 of the warp's 16: running max (log2 units), the thread's part of the sum, and out
  const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[ND][4] = {};
  const float* xq = sq + (warp * 16 + g) * G::kLdQ + 2 * t;
  for (int c = c_begin; c < c_end; ++c) {
    const int stage = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      load_chunk(stage ^ 1, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = sk + stage * BS * kLd;
    const float* vs = sv + stage * BS * kLd;

    // S = Q K^T over d, kSumGroup k-steps per fresh accumulator (two groups unrolled: timed on an H100
    // against none and all, it was the fastest)
    float s[NT][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < ND; k0 += kSumGroup) {
      float ps[NT][4] = {};
#pragma unroll
      for (int kk = k0; kk < k0 + kSumGroup; ++kk) {
        uint32_t ab[4], as[4];
        frag_a(xq + 8 * kk, G::kLdQ, ab, as);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(ks + (8 * n + g) * kLd + 8 * kk + 2 * t);
          uint32_t bb[2], bs[2];
          frag_b(kv.x, kv.y, bb, bs);
          mma3(ps[n], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += ps[n][e];
    }

    // the online softmax in log2 units; keys at or past kv_end, and pairs the mask refuses, get weight exactly 0
    const int key0 = c * BS + 2 * t;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * n + (e & 1);
        s[n][e] = key < a.kv_end && mask(e < 2 ? row_a : row_b, key) ? s[n][e] * scale_log2e : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    float alpha[2], base[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // a row's 4 threads are one quad of lanes
      mt[half] = fmaxf(mt[half], __shfl_xor_sync(0xffffffffu, mt[half], 1));
      mt[half] = fmaxf(mt[half], __shfl_xor_sync(0xffffffffu, mt[half], 2));
      const float m_new = fmaxf(m[half], mt[half]);
      // no valid key yet (also a row of the band that sees none while its neighbours do): subtract 0, so
      // every weight and alpha is 0, not NaN
      base[half] = m_new == -INFINITY ? 0.f : m_new;
      alpha[half] = exp2f(m[half] - base[half]);
      m[half] = m_new;
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V, P from the accumulators: k index t <- key 2t and t + 4 <- 2t + 1 of each 8
    uint32_t pb[NT][4], psm[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) frag_a_from_acc(s[j], pb[j], psm[j]);
    const float* vp = vs + 2 * t * kLd + g;
#pragma unroll
    for (int n = 0; n < ND; ++n) add_chunk_product<NT, kLd>(o[n], pb, psm, vp + 8 * n);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // the row sums over the quad, then rows g and g + 8, columns (2t, 2t + 1) of each 8-wide tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= a.Tq) continue;
    const bool dead = m[half] == -INFINITY;
    if (a.splits == 1) {
      float* orow = a.out + (qoff + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            dead ? make_float2(0.f, 0.f) : make_float2(o[n][2 * half] / l[half], o[n][2 * half + 1] / l[half]);
      if (t == 0) a.lse[qoff + row] = dead ? 0.f : m[half] * kLn2 + logf(l[half]);
    } else {
      const size_t at = static_cast<size_t>(split) * a.H * a.Tq + qoff + row;
      float* orow = a.part_o + at * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[n][2 * half], o[n][2 * half + 1]);
      if (t == 0) *reinterpret_cast<float2*>(a.part_ml + 2 * at) = make_float2(m[half], l[half]);
    }
  }
}

// out and lse of kernel 5 or 7 from its s splits' partials over `rows` rows of d4 float4s, combined in split
// order; one thread per float4 of out.  A row no split saw a valid key of is dead: out 0, lse 0.
__global__ void __launch_bounds__(256)
    fwd_merge_kernel(const float4* __restrict__ part_o, const float2* __restrict__ part_ml, float4* __restrict__ out,
                     float* __restrict__ lse, int rows, int d4, int s) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t n = static_cast<size_t>(rows) * d4;
  if (i >= n) return;
  const size_t row = i / d4;
  float mx = -INFINITY;
  for (int k = 0; k < s; ++k) mx = fmaxf(mx, part_ml[k * static_cast<size_t>(rows) + row].x);
  if (mx == -INFINITY) {
    out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i % d4 == 0) lse[row] = 0.f;
    return;
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int k = 0; k < s; ++k) {
    const float2 ml = part_ml[k * static_cast<size_t>(rows) + row];
    const float w = ml.x == -INFINITY ? 0.f : exp2f(ml.x - mx);
    const float4 p = part_o[k * n + i];
    acc.x = fmaf(w, p.x, acc.x);
    acc.y = fmaf(w, p.y, acc.y);
    acc.z = fmaf(w, p.z, acc.z);
    acc.w = fmaf(w, p.w, acc.w);
    l = fmaf(w, ml.y, l);
  }
  out[i] = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  if (i % d4 == 0) lse[row] = mx * kLn2 + logf(l);
}

// The tile kernel, then (when split) the merge.
template <int D, typename Mask>
int fwd_tc(const TcFwdArgs& a, Mask mask, cudaStream_t s) {
  const int tiles = (a.Tq + kTcTile - 1) / kTcTile;
  if (tiles == 0 || a.H == 0) return 0;
  int err = allow_dynamic_smem(flash_fwd_tc_kernel<D, Mask>, TcFwdGeom<D>::kBytes);
  if (err) return err;
  flash_fwd_tc_kernel<D, Mask><<<dim3(tiles, a.H, a.splits), kTcThreads, TcFwdGeom<D>::kBytes, s>>>(a, mask);
  err = static_cast<int>(cudaGetLastError());
  if (err || a.splits == 1) return err;
  const int rows = a.H * a.Tq, d4 = D / 4;
  const int blocks = static_cast<int>((static_cast<size_t>(rows) * d4 + 255) / 256);
  fwd_merge_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(a.part_o),
                                          reinterpret_cast<const float2*>(a.part_ml), reinterpret_cast<float4*>(a.out),
                                          a.lse, rows, d4, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// band: 0 kernel 5's tile kernel, 1 kernel 7's.
template <int D>
int tc_fwd_blocks_per_sm(int band, int* out) {
  const void* kernel = band ? reinterpret_cast<const void*>(flash_fwd_tc_kernel<D, TcBand>)
                            : reinterpret_cast<const void*>(flash_fwd_tc_kernel<D, TcAllKeys>);
  const int err = allow_dynamic_smem(kernel, TcFwdGeom<D>::kBytes);
  if (err) return err;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kTcThreads, TcFwdGeom<D>::kBytes));
}

// Kernel 7's band from the band's arguments: keys valid in [max(lo, 0), min(hi, Tk)) (kv_end); key - query
// in q_offset -+ window, in 64 bits, then clamped to [-Tq, Tk], past which no pair's difference lies
// (ops/cuda/flash_attention.py::band_limits).  Kernel 8 takes the same.
TcBand band_of(int Tq, int Tk, int window, int lo, int q_offset) {
  const auto diff = [&](long long x) {
    return static_cast<int>(std::min(std::max(x, -static_cast<long long>(Tq)), static_cast<long long>(Tk)));
  };
  return TcBand{std::max(lo, 0), diff(static_cast<long long>(q_offset) - window),
                diff(static_cast<long long>(q_offset) + window)};
}

}  // namespace

// The full forward (kernel 5).  q: (H, Tq, D); k, v: (H, Tk, D); out: (H, Tq, D); lse: (H, Tq).  Keys at
// j >= t_valid are masked.  D is 32, 64 or 128 (the tensor-core kernel, its walk split in `splits` by the
// wrapper's plan, with part_o (splits, H, Tq, D) and part_ml (splits, H, Tq, 2) float32 scratch when
// splits > 1), 256 (the FP32-core template), or past 256 a multiple of 128 (the wide path); those two
// unsplit.  All rows 16-byte aligned.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int H, int Tq, int Tk,
                         int D, float scale, int t_valid, int splits, void* part_o, void* part_ml, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  const int kv_end = t_valid < 0 ? 0 : (t_valid < Tk ? t_valid : Tk);
  if (splits < 1 || (splits > 1 && (!part_o || !part_ml || D > 128))) return static_cast<int>(cudaErrorInvalidValue);
  const TcFwdArgs a{qf, kf, vf, of, lf, static_cast<float*>(part_o), static_cast<float*>(part_ml), H, Tq, Tk, kv_end,
                    splits, scale};
  switch (D) {
    case 32: return fwd_tc<32>(a, TcAllKeys{}, s);
    case 64: return fwd_tc<64>(a, TcAllKeys{}, s);
    case 128: return fwd_tc<128>(a, TcAllKeys{}, s);
    case 256: return launch_full<256, 4>(qf, kf, vf, of, lf, H, Tq, Tk, kv_end, scale, D, s);
    default:
      if (D <= 256 || D % kDC) return static_cast<int>(cudaErrorInvalidValue);
      return launch_full<kDC, 4, true>(qf, kf, vf, of, lf, H, Tq, Tk, kv_end, scale, D, s);
  }
}

// Blocks of kernel 5's tile kernel (band = 0) or kernel 7's (band = 1) an SM of the current card keeps
// resident, into *out.
extern "C" int flash_fwd_blocks_per_sm(int D, int band, int* out) {
  switch (D) {
    case 32: return tc_fwd_blocks_per_sm<32>(band, out);
    case 64: return tc_fwd_blocks_per_sm<64>(band, out);
    case 128: return tc_fwd_blocks_per_sm<128>(band, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The banded forward (kernel 7): as flash_fwd, with the band |i + q_offset - j| <= window (window >= 0) and
// keys valid in [lo, hi) instead of t_valid.  D is 32, 64 or 128 (the tensor-core kernel, its walk over each
// tile's band split in `splits` by the wrapper's plan, with part_o and part_ml as for flash_fwd), 256 or past
// 256 a multiple of 128 (the FP32-core templates, unsplit).
extern "C" int flash_local_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int H, int Tq,
                               int Tk, int D, float scale, int window, int lo, int hi, int q_offset, int splits,
                               void* part_o, void* part_ml, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  if (window < 0 || splits < 1 || (splits > 1 && (!part_o || !part_ml || D > 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcBand band = band_of(Tq, Tk, window, lo, q_offset);
  const TcFwdArgs a{qf, kf, vf, of, lf, static_cast<float*>(part_o), static_cast<float*>(part_ml), H, Tq, Tk,
                    std::min(std::max(hi, 0), Tk), splits, scale};
  switch (D) {
    case 32: return fwd_tc<32>(a, band, s);
    case 64: return fwd_tc<64>(a, band, s);
    case 128: return fwd_tc<128>(a, band, s);
    case 256: return local_for<256>(qf, kf, vf, of, lf, H, Tq, Tk, scale, window, lo, hi, q_offset, s);
    default:
      if (D <= 256 || D % kDC) return static_cast<int>(cudaErrorInvalidValue);
      return launch_local<kDC, 4, true>(qf, kf, vf, of, lf, H, Tq, Tk, scale, window, lo, hi, q_offset, D, s);
  }
}

// The full backward (kernel 6): dq (H, Tq, D), dk and dv (H, Tk, D) from q,
// k, v, the cotangent dout of out, the forward's lse (H, Tq) and di (H, Tq);
// keys at j >= t_valid are masked.  s_dkv and s_dq split the dK/dV and dQ
// walks (the wrapper's plan); when one is above 1, part_kv (s_dkv, 2, H, Tk, D)
// or part_q (s_dq, H, Tq, D) holds the float32 partials.  Up to three
// launches, each checked.  At D = 256, and past it at a multiple of 128 (the
// wide path), the FP32-core kernels run, unsplit (s_dkv = s_dq = 1).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                         const void* di, void* dq, void* dk, void* dv, int H, int Tq, int Tk, int D, float scale,
                         int t_valid, int s_dkv, int s_dq, void* part_kv, void* part_q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_dkv < 1 || s_dq < 1 || (s_dkv > 1 && !part_kv) || (s_dq > 1 && !part_q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv_end = t_valid < 0 ? 0 : (t_valid < Tk ? t_valid : Tk);
  const TcArgs a{static_cast<const float*>(q),    static_cast<const float*>(k),   static_cast<const float*>(v),
                 static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
                 static_cast<float*>(dq),         static_cast<float*>(dk),        static_cast<float*>(dv),
                 static_cast<float*>(part_kv),    static_cast<float*>(part_q),    H,
                 Tq,                              Tk,                             kv_end,
                 s_dkv,                           s_dq,                           scale};
  if (D > 128 && (s_dkv != 1 || s_dq != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs f = bwd_args(q, k, v, dout, lse, di, dq, dk, dv, Tq, Tk, D, scale);
  switch (D) {
    case 32: return bwd_tc<32>(a, TcAllKeys{}, s);
    case 64: return bwd_tc<64>(a, TcAllKeys{}, s);
    case 128: return bwd_tc<128>(a, TcAllKeys{}, s);
    case 256: return full_bwd_f32<256, false>(f, H, kv_end, s);
    default:
      if (D <= 256 || D % kDC) return static_cast<int>(cudaErrorInvalidValue);
      return full_bwd_f32<kDC, true>(f, H, kv_end, s);
  }
}

// Blocks of kernel 6's dK/dV (which = 0) or dQ (which = 1) kernel, or of
// kernel 8's (2, 3), an SM of the current card keeps resident, into *out.
extern "C" int flash_bwd_blocks_per_sm(int D, int which, int* out) {
  switch (D) {
    case 32: return tc_blocks_per_sm<32>(which, out);
    case 64: return tc_blocks_per_sm<64>(which, out);
    case 128: return tc_blocks_per_sm<128>(which, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The banded backward (kernel 8): as flash_bwd, with the band |i + q_offset - j| <= window (window >= 0) and
// keys valid in [lo, hi) instead of t_valid.  D is 32, 64 or 128 (the tensor-core kernel, its walks split in
// s_dkv and s_dq by the wrapper's plan, with part_kv and part_q as for flash_bwd), 256 or past 256 a multiple
// of 128 (the FP32-core templates, unsplit).
extern "C" int flash_local_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* di, void* dq, void* dk, void* dv, int H, int Tq, int Tk, int D,
                               float scale, int window, int lo, int hi, int q_offset, int s_dkv, int s_dq,
                               void* part_kv, void* part_q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window < 0 || s_dkv < 1 || s_dq < 1 || (s_dkv > 1 && !part_kv) || (s_dq > 1 && !part_q) ||
      (D > 128 && (s_dkv != 1 || s_dq != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcBand band = band_of(Tq, Tk, window, lo, q_offset);
  const int kv_end = std::min(std::max(hi, 0), Tk);
  const TcArgs a{static_cast<const float*>(q),    static_cast<const float*>(k),   static_cast<const float*>(v),
                 static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
                 static_cast<float*>(dq),         static_cast<float*>(dk),        static_cast<float*>(dv),
                 static_cast<float*>(part_kv),    static_cast<float*>(part_q),    H,
                 Tq,                              Tk,                             kv_end,
                 s_dkv,                           s_dq,                           scale};
  const BwdArgs f = bwd_args(q, k, v, dout, lse, di, dq, dk, dv, Tq, Tk, D, scale);
  switch (D) {
    case 32: return bwd_tc<32>(a, band, s);
    case 64: return bwd_tc<64>(a, band, s);
    case 128: return bwd_tc<128>(a, band, s);
    case 256: return local_bwd_f32<256, false>(f, H, window, lo, hi, q_offset, s);
    default:
      if (D <= 256 || D % kDC) return static_cast<int>(cudaErrorInvalidValue);
      return local_bwd_f32<kDC, true>(f, H, window, lo, hi, q_offset, s);
  }
}
