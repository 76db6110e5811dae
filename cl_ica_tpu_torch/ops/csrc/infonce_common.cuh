// What the fused InfoNCE kernels of infonce_lp.cu (Lp distance) and
// infonce_dot.cu (dot product) share: the block shape, the staging of the
// other operand's rows through shared memory, and the row reductions.
//
// A block owns kRows rows of one operand; the kLanes threads of a row split
// the rows of the other operand between them, kTile of which are staged per
// step. Each library is compiled from one .cu file, so everything here is
// in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;                  // own rows per block
constexpr int kLanes = 16;                 // threads that share one own row
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kTile = 128;                 // other rows staged per step
// The running max starts at a finite sentinel, not -INFINITY: with -INFINITY
// the first rescale exp(m_old - m_new) is exp(-inf + inf) = NaN.
constexpr float kNegInf = -1e30f;

constexpr int kNmaxSmall = 16;
constexpr int kNmaxLarge = 64;  // the largest n the kernels take

// One row of n features into registers, zero past n.
template <int NMAX>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int n,
                                         float (&a)[NMAX]) {
#pragma unroll
  for (int k = 0; k < NMAX; ++k) a[k] = (k < n) ? src[k] : 0.f;
}

// Rows [r0, r0 + cnt) of src (row-major, n wide) into tile[k][jj]
// (feature-major), so that the kLanes threads of a row read consecutive
// words of one feature. A row of n = 10 floats is 40 bytes, so rows are not
// 16-byte aligned in device memory: the copy is word by word, coalesced
// over the flat index.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           int r0, int cnt, int n,
                                           float* __restrict__ tile) {
  const float* base = src + (size_t)r0 * n;
  for (int e = threadIdx.x; e < cnt * n; e += kThreads) {
    const int jj = e / n;
    const int k = e - jj * n;
    tile[k * kTile + jj] = base[e];
  }
}

// Sum over the kLanes threads of a row (consecutive lanes of one warp).
__device__ __forceinline__ double lane_sum(double v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Merge the kLanes partial (max, sum) pairs of a row's online log-sum-exp;
// every lane ends with the row's pair.
__device__ __forceinline__ void lane_merge_lse(float& m, double& s) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const double s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, m2);
    s = s * (double)expf(m - mn) + s2 * (double)expf(m2 - mn);
    m = mn;
  }
}

// One more logit x into a thread's running (max, sum): the max is
// subtracted before every exp, so a logit of any sign and size is safe.
__device__ __forceinline__ void online_lse_step(float x, float& m, double& s) {
  if (x > m) {
    s = s * (double)expf(m - x) + 1.0;
    m = x;
  } else {
    s += (double)expf(x - m);
  }
}

inline int blocks_for(int rows) { return (rows + kRows - 1) / kRows; }

inline int width_slot(int n) { return n <= kNmaxSmall ? 0 : 1; }

}  // namespace
