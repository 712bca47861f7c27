// Flash-attention forwards, float32, for the temporal transformer scorer.
//
// Replaces two kernels of cvml_goalnet_tpu/ops/pallas/flash_attention.py:
//   * _flash_fwd (body _fwd_kernel): full non-causal attention of (H, Tq, d)
//     queries over (H, Tk, d) keys and values, keys valid below t_valid;
//     writes out and the row log-sum-exp;
//   * _flash_local_fwd (body _local_fwd_kernel, mask _band_mask): banded
//     attention |i + q_offset - j| <= W with keys valid in [lo, hi), visiting
//     only the key tiles that meet each query tile's band, so the work is
//     O(T*W*d) instead of O(T^2*d).
// In both, a row with no valid key gives out 0 and lse 0.
//
// What bounds it on an H100: operations.  Each valid (query, key) pair costs
// 2d FLOP for the score and 2d for the weighted sum of values, against 16d
// bytes per row of q, k, v and out (T = 5400, d = 128: 1.49e10 FLOP against
// 11 MB for full attention, 5.1e9 FLOP for the W = 1024 band).  The work is
// float32, so the ceiling is the 67 TFLOP/s of the FP32 cores: tensor-core
// products would round the inputs to TF32, which keeps about three digits and
// breaks the 2e-5 contract the kernels are held to.  The design keeps the
// (Tq, Tk) score matrix out of device memory and feeds the FMA units from
// shared memory:
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
//   * the full kernel takes 64-row tiles (RQ = 4); the banded one takes
//     32-row tiles when 64-row tiles would give the card fewer than two
//     blocks per SM (one head of T = 5400 is 85 such tiles on 132 SMs), so
//     that short timelines spread over more SMs.  Timing both heights in
//     turns on an H100 chose this: 32-row tiles made short bands faster and
//     everything else slower.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid: tx picks keys and columns, ty rows
constexpr int kBK = 64;        // keys per tile
constexpr int kLdK = kBK + 1;  // padded row of K^T and P in shared memory

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

template <int D, int RQ>
__device__ __forceinline__ void load_q(const float* __restrict__ qh, int q0, int Tq, float* sq) {
  using G = Geom<D, RQ>;
  for (int idx = threadIdx.x; idx < G::BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    sq[r * G::kLdQ + c] = (q0 + r < Tq) ? __ldg(qh + static_cast<size_t>(q0 + r) * D + c) : 0.f;
  }
}

// One key tile of the online softmax: keys [k0, min(k0 + kBK, k_lim)) that
// pass `mask` against the block's rows q0 + ty + 16i.  Updates the running
// max m, sum l and unnormalised output acc of the thread's rows.
template <int D, int RQ, typename Mask>
__device__ __forceinline__ void attend_tile(const float* __restrict__ kh, const float* __restrict__ vh, int k0,
                                            int k_lim, int q0, float scale, Mask mask, const float* sq,
                                            float* skt, float* sv, float* sp, float (&m)[RQ], float (&l)[RQ],
                                            float (&acc)[RQ][Geom<D, RQ>::NC]) {
  using G = Geom<D, RQ>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __syncthreads();  // every thread is done with the previous tile's K^T, V and P
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    skt[c * kLdK + r] = (k0 + r < k_lim) ? __ldg(kh + static_cast<size_t>(k0 + r) * D + c) : 0.f;
  }
  for (int idx = threadIdx.x; idx < kBK * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c4 = idx % (D / 4);
    reinterpret_cast<float4*>(sv)[idx] =
        (k0 + r < k_lim) ? __ldg(reinterpret_cast<const float4*>(vh + static_cast<size_t>(k0 + r) * D) + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  float s[RQ][4] = {};
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
  __syncthreads();

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

template <int D, int RQ>
__device__ __forceinline__ void store_rows(float* __restrict__ oh, float* __restrict__ lh, int q0, int Tq,
                                           const float (&m)[RQ], const float (&l)[RQ],
                                           const float (&acc)[RQ][Geom<D, RQ>::NC]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const bool dead = (m[i] == -INFINITY);
#pragma unroll
    for (int c = 0; c < Geom<D, RQ>::NC; ++c)
      oh[static_cast<size_t>(row) * D + tx + 16 * c] = dead ? 0.f : acc[i][c] / l[i];
    if (tx == 0) lh[row] = dead ? 0.f : m[i] + logf(l[i]);
  }
}

// The block's BQ query rows of head blockIdx.y against keys [k_begin, k_end)
// that pass `mask`, tile by tile; writes their out and lse.
template <int D, int RQ, typename Mask>
__device__ __forceinline__ void attend_rows(const float* __restrict__ q, const float* __restrict__ k,
                                            const float* __restrict__ v, float* __restrict__ out,
                                            float* __restrict__ lse, int Tq, int Tk, int k_begin, int k_end,
                                            float scale, Mask mask) {
  using G = Geom<D, RQ>;
  extern __shared__ float4 smem4[];
  float* sv = reinterpret_cast<float*>(smem4);
  float* sq = sv + G::kV;
  float* skt = sq + G::kQ;
  float* sp = skt + G::kKt;
  const int h = blockIdx.y, q0 = blockIdx.x * G::BQ;
  const float* kh = k + static_cast<size_t>(h) * Tk * D;
  const float* vh = v + static_cast<size_t>(h) * Tk * D;
  load_q<D, RQ>(q + static_cast<size_t>(h) * Tq * D, q0, Tq, sq);
  float m[RQ], l[RQ], acc[RQ][G::NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::NC; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kBK)
    attend_tile<D, RQ>(kh, vh, k0, k_end, q0, scale, mask, sq, skt, sv, sp, m, l, acc);
  store_rows<D, RQ>(out + static_cast<size_t>(h) * Tq * D, lse + static_cast<size_t>(h) * Tq, q0, Tq, m, l, acc);
}

template <int D, int RQ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int kv_end, float scale) {
  attend_rows<D, RQ>(q, k, v, out, lse, Tq, Tk, 0, kv_end, scale, AllKeys{});
}

template <int D, int RQ>
__global__ void __launch_bounds__(kThreads)
    flash_local_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, float scale,
                           int window, int lo, int hi, int q_offset) {
  // the keys any row of this tile may see: the bands of its first and last
  // row, cut to [lo, hi) and [0, Tk)
  const int q0 = blockIdx.x * Geom<D, RQ>::BQ;
  const int last_row = min(q0 + Geom<D, RQ>::BQ, Tq) - 1;
  const long long begin = max(static_cast<long long>(q0) + q_offset - window, static_cast<long long>(max(lo, 0)));
  const long long end = min(static_cast<long long>(last_row) + q_offset + window + 1,
                            static_cast<long long>(min(hi, Tk)));
  attend_rows<D, RQ>(q, k, v, out, lse, Tq, Tk, static_cast<int>(min(begin, end)), static_cast<int>(end), scale,
                     Band{q_offset, window});
}

// 64-row tiles for the band when they give at least two blocks per SM of the H100.
bool wide_tiles(int H, int Tq) { return static_cast<long long>(H) * ((Tq + 63) / 64) >= 2 * 132; }

template <int D, int RQ>
int launch_full(const float* q, const float* k, const float* v, float* out, float* lse, int H, int Tq, int Tk,
                int kv_end, float scale, cudaStream_t s) {
  using G = Geom<D, RQ>;
  const int err = allow_dynamic_smem(flash_fwd_kernel<D, RQ>, G::kBytes);
  if (err) return err;
  const dim3 grid((Tq + G::BQ - 1) / G::BQ, H);
  flash_fwd_kernel<D, RQ><<<grid, kThreads, G::kBytes, s>>>(q, k, v, out, lse, Tq, Tk, kv_end, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int RQ>
int launch_local(const float* q, const float* k, const float* v, float* out, float* lse, int H, int Tq, int Tk,
                 float scale, int window, int lo, int hi, int q_offset, cudaStream_t s) {
  using G = Geom<D, RQ>;
  const int err = allow_dynamic_smem(flash_local_fwd_kernel<D, RQ>, G::kBytes);
  if (err) return err;
  const dim3 grid((Tq + G::BQ - 1) / G::BQ, H);
  flash_local_fwd_kernel<D, RQ>
      <<<grid, kThreads, G::kBytes, s>>>(q, k, v, out, lse, Tq, Tk, scale, window, lo, hi, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int local_for(const float* q, const float* k, const float* v, float* out, float* lse, int H, int Tq, int Tk,
              float scale, int window, int lo, int hi, int q_offset, cudaStream_t s) {
  return wide_tiles(H, Tq)
             ? launch_local<D, 4>(q, k, v, out, lse, H, Tq, Tk, scale, window, lo, hi, q_offset, s)
             : launch_local<D, 2>(q, k, v, out, lse, H, Tq, Tk, scale, window, lo, hi, q_offset, s);
}

}  // namespace

// q: (H, Tq, D); k, v: (H, Tk, D); out: (H, Tq, D); lse: (H, Tq).  Keys at
// j >= t_valid are masked.  D is 32, 64 or 128; all rows 16-byte aligned.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int H, int Tq, int Tk,
                         int D, float scale, int t_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  const int kv_end = t_valid < 0 ? 0 : (t_valid < Tk ? t_valid : Tk);
  switch (D) {
    case 32: return launch_full<32, 4>(qf, kf, vf, of, lf, H, Tq, Tk, kv_end, scale, s);
    case 64: return launch_full<64, 4>(qf, kf, vf, of, lf, H, Tq, Tk, kv_end, scale, s);
    case 128: return launch_full<128, 4>(qf, kf, vf, of, lf, H, Tq, Tk, kv_end, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As flash_fwd, with the band |i + q_offset - j| <= window (window >= 0) and
// keys valid in [lo, hi) instead of t_valid.
extern "C" int flash_local_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int H, int Tq,
                               int Tk, int D, float scale, int window, int lo, int hi, int q_offset,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return local_for<32>(qf, kf, vf, of, lf, H, Tq, Tk, scale, window, lo, hi, q_offset, s);
    case 64: return local_for<64>(qf, kf, vf, of, lf, H, Tq, Tk, scale, window, lo, hi, q_offset, s);
    case 128: return local_for<128>(qf, kf, vf, of, lf, H, Tq, Tk, scale, window, lo, hi, q_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
