// What the fused InfoNCE kernels of infonce_lp.cu (Lp distance) and
// infonce_dot.cu (dot product) share: the block shape, the staging of the
// other operand's rows through shared memory, and the row reductions of
// the first versions; for the tiled kernels (the forwards neg_lse_fwd_tiled
// and dot_lse_fwd_tiled, the gradients neg_lse_grad_kernel and
// dot_lse_grad_kernel) their block shape, the width of a staged row, the
// instances a runtime n is padded into, the quotient, the online
// log-sum-exp of a row group, and the reduces over chunks.
//
// A block of the first versions owns kRows rows of one operand; the kLanes
// threads of a row split the rows of the other operand between them, kTile
// of which are staged per step. Each library is compiled from one .cu
// file, so everything here is in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cmath>

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

// The instance (NF = 4, 8, 10, 12 or 16 features) of a tiled kernel that
// takes a runtime n, zero-padded; -1 for an n past 16.
inline int padded_slot(int n) {
  return n <= 4 ? 0 : n <= 8 ? 1 : n <= 10 ? 2 : n <= 12 ? 3 : n <= 16 ? 4 : -1;
}

// d / tau rounded to nearest, as the division gives it, for rtau = 1.f /
// tau (Markstein's theorem): q = d * rtau is within an ulp of the quotient,
// the remainder d - q * tau is exact in one FMA, and one correction by it
// rounds to the quotient's nearest float. Three instructions in place of
// the division's subroutine; __fmul_rn keeps nvcc from fusing the product.
__device__ __forceinline__ float quotient(float d, float tau, float rtau) {
  const float q = __fmul_rn(d, rtau);
  return fmaf(fmaf(-q, tau, d), rtau, q);
}

// The instance of a tiled kernel that takes n and forms d / tau by
// quotient(), which stands for the division only where 1 / tau is a
// normal float (about 3e-39 < tau < 8e37); -1 where the first version of
// the same function runs: n past 16, or any other tau.
inline int quotient_slot(int n, float tau) {
  return std::isnormal(1.f / tau) ? padded_slot(n) : -1;
}

// ------------------------- the online log-sum-exp of the tiled forwards
// A thread keeps, for each own row, the running max m of its logits, and
// the sum of exp(x - m) over its other terms in two parts: a float t over
// its terms of the current tile (at most kGradTile / kGradCols = 32), and a
// double s of the earlier tiles, taken at the max m_s of the last fold:
//   sum_x exp(x) = exp(m) (1 + t) + exp(m_s) s.
// The max's own term, 1, is never added to a float: where one logit stands
// far above the rest, as at z3 = roll(z1), lse = m + log(1 + s) keeps the
// small terms that 1 + t would round away.

// exp(-|y|) by the SFU's 2^x alone, for the terms of the tiled forwards'
// sums: y = x - m is formed from the exact logits before it is scaled, so
// the one more rounding is relative to |y|, about 1e-6 of a term that is
// more than 1e-7 of the max's (folding log2 e / tau into the logit
// instead would round x itself, 1e-3 at logits of 1e4); accurate expf
// takes six more instructions. Where 2^x falls below float's normal
// range it is 0.
__device__ __forceinline__ float exp_neg_abs(float y) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(y) * -1.4426950408889634f));
  return e;
}

// One more logit x into (m, t): one exponential and no branch.
// exp(-|x - m|) is exp(x - m) for x <= m, and exp(m - x) for a new max,
// which rescales 1 + t; the new max's own term, 1, stays out of t. The
// sentinel start (kNegInf, 0) stands for no term: the first x sets t to
// (1 + 0) exp(kNegInf - x) = 0.
__device__ __forceinline__ void lse_step(float x, float& m, float& t) {
  const float e = exp_neg_abs(x - m);
  t = x > m ? fmaf(t, e, e) : t + e;
  m = fmaxf(m, x);
}

// t into s once per tile, s first brought from m_s to m: one conversion
// and one double add per 32 terms.
__device__ __forceinline__ void lse_fold(float m, float& t, float& m_s,
                                         double& s) {
  s = s * (double)expf(m_s - m) + (double)t;
  m_s = m;
  t = 0.f;
}

// The kGradCols threads of a row group merge their (m, s), each standing
// for exp(m) (1 + s), by two xor-shuffles: the smaller max's 1 + s is
// rescaled into the larger's s. A row is written by one thread of the
// group, so the threads need not end with the same bits.
__device__ __forceinline__ void group_merge_lse(float& m, double& s) {
#pragma unroll
  for (int off = 1; off < kGradCols; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const double s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const double e = (double)expf(-fabsf(m - m2));  // exp(smaller - larger)
    s = m >= m2 ? s + fma(s2, e, e) : s2 + fma(s, e, e);
    m = fmaxf(m, m2);
  }
}

// lse[i] = m + log(sum over c of (1 + s_c) exp(m_c - m)) of the chunks'
// partial (m_c, s_c), part_m and part_s (splits, rows), m the largest m_c,
// taken as m + log1p of the sum less the 1 of the first chunk that holds
// m: the rescale and the sum in double, c in order, so a run repeats bit
// for bit.
__global__ void __launch_bounds__(256)
lse_reduce_kernel(const float* __restrict__ part_m,
                  const double* __restrict__ part_s, float* __restrict__ lse,
                  int rows, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  int top = 0;
  for (int c = 1; c < splits; ++c)
    if (part_m[(size_t)c * rows + i] > part_m[(size_t)top * rows + i]) top = c;
  const float m = part_m[(size_t)top * rows + i];
  double s = 0.0;
  for (int c = 0; c < splits; ++c) {
    const double e = exp((double)part_m[(size_t)c * rows + i] - (double)m);
    s += fma(part_s[(size_t)c * rows + i], e, c == top ? 0.0 : e);
  }
  lse[i] = m + (float)log1p(s);
}

inline void launch_lse_reduce(const float* part_m, const double* part_s,
                              float* lse, int rows, int splits,
                              cudaStream_t st) {
  lse_reduce_kernel<<<(rows + 255) / 256, 256, 0, st>>>(part_m, part_s, lse,
                                                        rows, splits);
}

// The end of a tiled forward's block: merge each own row's (m, s) over its
// row group, then thread q of the group writes own row q (kGradRows <=
// kGradCols): lse itself with one chunk (part_m null), else the chunk's
// partial pair for lse_reduce_kernel.
template <int R>
__device__ __forceinline__ void write_lse_rows(float (&m)[R], double (&s)[R],
                                               int row0, int q, int rows,
                                               int split, float* lse,
                                               float* part_m, double* part_s) {
  static_assert(R <= kGradCols, "one own row per thread of the row group");
#pragma unroll
  for (int r = 0; r < R; ++r) {
    group_merge_lse(m[r], s[r]);
    const int i = row0 + r;
    if (r == q && i < rows) {
      if (part_m != nullptr) {
        part_m[(size_t)split * rows + i] = m[r];
        part_s[(size_t)split * rows + i] = s[r];
      } else {
        lse[i] = m[r] + (float)log1p(s[r]);
      }
    }
  }
}

// The body of both tiled forwards (see the note of infonce_dot.cu): block
// (x, c) owns kGradBlockRows rows of z1 and takes the rows [c * chunk,
// (c + 1) * chunk) of z3, n features each, staged zero-padded to NF;
// logit(a, b) is x of an own row a and a staged row b. With part_m null
// (one chunk) it writes lse; otherwise its rows' partial (m, s) to
// part_m / part_s [c][row], for lse_reduce_kernel.
template <int NF, class Logit>
__device__ __forceinline__ void tiled_lse_forward(
    const float* __restrict__ z1, const float* __restrict__ z3,
    float* __restrict__ lse, float* __restrict__ part_m,
    double* __restrict__ part_s, int M, int N, int n, int chunk,
    const Logit& logit) {
  constexpr int W = kStagedWidth<NF, false>;
  constexpr int R = kGradRows;
  __shared__ __align__(16) float tile[kGradTile * W];
  const int q = threadIdx.x % kGradCols;
  const int row0 = (int)blockIdx.x * kGradBlockRows + (int)threadIdx.x / kGradCols * R;

  float a[R][NF], m[R], t[R], m_s[R];
  double s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + r, M - 1);
#pragma unroll
    for (int k = 0; k < NF; ++k) a[r][k] = k < n ? z1[(size_t)i * n + k] : 0.f;
    m[r] = m_s[r] = kNegInf;
    t[r] = 0.f;
    s[r] = 0.0;
  }

  const int split = blockIdx.y;
  const int j_end = min(N, (split + 1) * chunk);
  for (int j0 = split * chunk; j0 < j_end; j0 += kGradTile) {
    const int cnt = min(kGradTile, j_end - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * NF; e += kGradThreads) {
      const int jj = e / NF;
      const int k = e - jj * NF;
      tile[jj * W + k] = k < n ? z3[(size_t)(j0 + jj) * n + k] : 0.f;
    }
    __syncthreads();
    for (int jj = q; jj < cnt; jj += kGradCols) {
      float b[W];
      const float4* row = reinterpret_cast<const float4*>(tile + jj * W);
#pragma unroll
      for (int v = 0; v < W / 4; ++v) {
        const float4 f = row[v];
        b[4 * v] = f.x;
        b[4 * v + 1] = f.y;
        b[4 * v + 2] = f.z;
        b[4 * v + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) lse_step(logit(a[r], b), m[r], t[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) lse_fold(m[r], t[r], m_s[r], s[r]);
  }
  write_lse_rows<R>(m, s, row0, q, M, split, lse, part_m, part_s);
}

}  // namespace
