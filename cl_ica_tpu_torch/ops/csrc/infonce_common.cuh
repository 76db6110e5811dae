// What the fused InfoNCE kernels of infonce_lp.cu (Lp distance) and
// infonce_dot.cu (dot product) share: the block shape, the staging of the
// other operand's rows through shared memory, and the row reductions; and
// for the tiled gradients (neg_lse_grad_kernel, dot_lse_grad_kernel) their
// block shape, the width of a staged row, and the reduce over chunks.
//
// A block of the forwards and first-version gradients owns kRows rows of
// one operand; the kLanes threads of a row split the rows of the other
// operand between them, kTile of which are staged per step. Each library
// is compiled from one .cu file, so everything here is in an anonymous
// namespace.

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

// ------------------------------------------------- the tiled gradients
// 256 threads; the kGradCols threads of a row group hold kGradRows own rows
// in registers and take every kGradCols-th row of a staged tile of the
// other operand (see the note at the top of each .cu).
constexpr int kGradThreads = 256;
constexpr int kGradCols = 4;    // threads that share own rows
constexpr int kGradRows = 2;    // own rows per thread
constexpr int kGradBlockRows = kGradThreads / kGradCols * kGradRows;  // 128
constexpr int kGradTile = 128;  // other rows staged per step

// Floats per staged row: NF features, then (dz3) two floats of the row's
// own (its exponent shift and its cotangent), padded to whole float4s. A
// warp reads one float4 of four consecutive rows at once; a row of four
// float4s would put rows 0 and 2 in the same banks, so it gets a fifth.
template <int NF, bool DZ3>
constexpr int kStagedQuads = (NF + (DZ3 ? 2 : 0) + 3) / 4;
template <int NF, bool DZ3>
constexpr int kStagedWidth =
    4 * (kStagedQuads<NF, DZ3> % 4 == 0 ? kStagedQuads<NF, DZ3> + 1
                                         : kStagedQuads<NF, DZ3>);

// out[e] = scale * c_row * sum over s of part[s][e] for part (splits, rows,
// n): the chunks' float partials added in double, s in order, so a run
// repeats bit for bit. ct is null where the gradient has no per-row factor
// (dz3).
__global__ void __launch_bounds__(256)
grad_reduce_kernel(const float* __restrict__ part, const float* __restrict__ ct,
                   float* __restrict__ out, int rows, int n, int splits,
                   double scale) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * n) return;
  double v = 0.0;
  for (int s = 0; s < splits; ++s) v += (double)part[(size_t)s * rows * n + e];
  if (ct != nullptr) scale *= (double)ct[e / n];
  out[e] = (float)(scale * v);
}

inline void launch_grad_reduce(const float* part, const float* ct, float* out,
                               int rows, int n, int splits, double scale,
                               cudaStream_t st) {
  grad_reduce_kernel<<<(rows * n + 255) / 256, 256, 0, st>>>(
      part, ct, out, rows, n, splits, scale);
}

}  // namespace
