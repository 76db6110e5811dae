// Fused Lp-InfoNCE negative log-sum-exp and its two gradients, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (cl_ica_tpu_torch/ops/infonce.py).
//
// Replaces the Pallas TPU kernels of cl_ica_tpu/ops/infonce_pallas.py:
//   forward: neg_lse_fwd_tiled<.., NF> + lse_reduce_kernel for n <= 16;
//        neg_lse_fwd_kernel for 16 < n <= 64
//        <- _fwd_kernel  (:84, pallas_call in _fwd, :232)
//   dz1: neg_lse_grad_kernel<.., false> + grad_reduce_kernel for
//        n = 3, 8, 10; neg_lse_dz1_kernel for any other n
//        <- _dz1_kernel  (pallas_call in _bwd, :262)
//   dz3: neg_lse_grad_kernel<.., true> + grad_reduce_kernel for
//        n = 3, 8, 10; neg_lse_dz3_kernel for any other n
//        <- _dz3_kernel  (pallas_call in _bwd, :280)
//
// For z1 (M, n), z3 (N, n), p >= 1, tau > 0 and a cotangent c (M,):
//   lse_i = log sum_j exp(-d_ij / tau),     d_ij = sum_k |z1_ik - z3_jk|^p
//   w_ij  = exp(-d_ij / tau - lse_i)        (softmax weights, recomputed)
//   dz1_i = -(p/tau) c_i sum_j w_ij g(z1_i - z3_j)
//   dz3_j = +(p/tau) sum_i c_i w_ij g(z1_i - z3_j)
//   g(D)  = sgn(D) |D|^(p-1) per feature, with sgn(0) = 0 (_grad_tile)
//
// The forward. It reads (M + N) * n * 4 bytes and does O(M * N * n)
// arithmetic plus M * N exponentials; at M = N = 6144, n = 10 that is
// 0.5 MB against ~1e9 operations, so the card's CUDA-core rate bounds it,
// never memory. What the design preserves from the TPU kernel is that the
// M x N distance matrix never exists in device memory: each block streams
// tiles of the other operand through shared memory and keeps its running
// max/sum in registers.
//
// How it differs from the TPU kernel, on purpose:
//  * The TPU grid runs in order and carries sums in VMEM scratch across
//    grid steps. Hopper blocks run in no order, so a block owns a tile of
//    rows and one chunk of the other operand, and a second kernel merges
//    the chunks (below).
//  * p == 2 sums (z1_ik - z3_jk)^2 directly. The TPU kernel's dot identity
//    |a|^2 + |b|^2 - 2ab only serves to reach the MXU; with n = 10 there is
//    no tensor-core tile to fill, and the direct sum needs no clamp at 0.
//  * Ragged edges are not padded: loops stop at the valid row/column count,
//    so a missing column contributes nothing (exp(-inf)), never the
//    distance to a zero row.
//  * The running max starts at the finite sentinel -1e30, as the TPU code's
//    NEG_INF: with -INFINITY, exp(m_old - m_new) is NaN on the first step.
//  * fp32 arithmetic with the accurate expf/logf/powf (no fast math, but
//    for the tiled forward's terms, exp_neg_abs in infonce_common.cuh, and
//    the tiled gradients' exp2f, below), as the TPU kernel pins
//    Precision.HIGHEST, but each row's sum of
//    exponentials is a double across tiles. Early in training the
//    encoder's outputs are nearly collapsed, so the terms of one row's sums
//    share a sign, and a float32 running sum over the thousands of terms
//    one thread sees could lose ulps in proportion: no float32 sum runs
//    over more than 32 terms.
//
// The forward for n <= 16 (neg_lse_fwd_tiled + lse_reduce_kernel) is the
// dot library's tiled forward (see the note of infonce_dot.cu) with the
// distance in place of the dot: two own rows a thread, four threads a row
// group reading float4s of four rows of a row-major tile; a runtime n
// zero-padded into NF = 4, 8, 10, 12 or 16 features (|0 - 0|^p = 0 adds
// nothing to d); per pair, x = -quotient(d), the bits of the first
// version's (-d) / tau, and one exponential of -|x - m| (exp_neg_abs) into
// a float sum of the tile's 32 terms, folded into a double once per tile;
// row blocks x S chunks of z3 (split_plan, clica_neg_lse_fwd_blocks_per_sm),
// the S partial
// (m, s) of a row merged in double, in order, by lse_reduce_kernel. What
// the first version (below, for 16 < n <= 64 and for a tau quotient()
// cannot divide by) spent its issue slots on: a shared-memory load per
// term from a feature-major tile, 16 feature slots behind tests of k < n,
// a true division, a branch, a conversion to double and a double add per
// pair, a grid of M / 16 blocks (384 at 6144 rows, 32 at 512), and a
// merge over 16 lanes.
//
// The gradients (neg_lse_grad_kernel + grad_reduce_kernel for
// n = 3, 8 and 10, the widths of main_mlp and main_3dident). Both are
//   out_r = -(p/tau) * c_own_r * sum_o c_oth_o * w_ro * g(own_r - oth_o),
// with own = z1, oth = z3, c_own = c, c_oth = 1 for dz1, and own = z3,
// oth = z1, c_own = 1, c_oth = c for dz3 (g is odd: g(z1 - z3) = -g(z3 - z1)).
// The work is ~4 operations for each of the M * N * n (pair, feature)
// terms and the data 0.5 MB, so issue slots bound it. What the first
// version (still below, for every other n) spent them on, and what this
// design does about it:
//  * A conversion to double and a double add per term. Here a thread adds
//    its terms in float32 registers over one staged tile (kGradTile / 4 =
//    32 terms per sum) and folds each sum into a double once per tile, so
//    a conversion per 32 terms. The double across tiles keeps what the
//    forward's note says of collapsed inputs: no float32 sum runs over more
//    than 32 terms.
//  * A shared-memory load per term. Here a thread holds kGradRows own rows
//    in registers; the four threads of a row group take every fourth
//    column of the staged tile, and the 32 threads of a warp read four
//    columns (distinct banks) as float4s, so one load feeds kGradRows * 4
//    terms. The differences of the distance pass are kept in registers and
//    reused by the gradient pass, so each term is subtracted once.
//  * A grid of M / 16 blocks: 1.45 waves at 6144 rows, 32 blocks on 132
//    SMs at 512. Here the other operand's rows are cut into S chunks
//    (ops/infonce.py:split_plan picks S from the shapes and the blocks the
//    card holds at once), a grid of row blocks x S. Each block writes its
//    rows' partial sums, in float, to a scratch buffer the wrapper
//    allocates, and grad_reduce_kernel (infonce_common.cuh) adds the S
//    partials of each element in double, in the order of s, and scales
//    them. With S = 1 the first kernel writes the result itself. The
//    reduce kernel is part of the gradient: the wrapper counts one launch
//    for the pair.
//  * Per pair: one FMA d * (-log2 e / tau) + (-log2 e * lse) and exp2f,
//    in place of a division, a subtraction and the accurate expf; the
//    staging divides by a compile-time n.
// No atomics anywhere: the four threads of a row group add their doubles
// by two xor-shuffles (the same sum in every lane), the chunks are added
// in a fixed order, so a run repeats bit for bit.

#include "infonce_common.cuh"  // block shapes, staging, quotient, reductions

namespace {

// p selects one of three code paths, as _dist_tile/_grad_tile do.
enum PMode { kPGeneral = 0, kP1 = 1, kP2 = 2 };

template <int PM>
__device__ __forceinline__ float dist_term(float dlt, float p) {
  if (PM == kP1) return fabsf(dlt);
  if (PM == kP2) return dlt * dlt;
  return powf(fabsf(dlt), p);
}

// d|D|^p/dD divided by p. sgn is (D>0)-(D<0): z3 = roll(z1) makes D == 0
// exactly in every feature of one pair per row, and sgn(0) must be 0 there.
template <int PM>
__device__ __forceinline__ float grad_term(float dlt, float p) {
  if (PM == kP2) return dlt;
  const float sgn = (float)(dlt > 0.f) - (float)(dlt < 0.f);
  if (PM == kP1) return sgn;
  return sgn * powf(fabsf(dlt), p - 1.f);
}

template <int PM, int NMAX>
__device__ __forceinline__ float tile_dist(const float (&a)[NMAX],
                                           const float* __restrict__ tile,
                                           int jj, int n, float p) {
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (k < n) d += dist_term<PM>(a[k] - tile[k * kTile + jj], p);
  return d;
}

// ---------------------------------------------------------------- forward
template <int PM, int NMAX>
__global__ void __launch_bounds__(kThreads)
neg_lse_fwd_kernel(const float* __restrict__ z1, const float* __restrict__ z3,
                   float* __restrict__ lse, int M, int N, int n, float p,
                   float tau) {
  __shared__ float tile[NMAX * kTile];
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kRows + r;
  float a[NMAX];
  load_row<NMAX>(z1 + (size_t)min(i, M - 1) * n, n, a);

  // online log-sum-exp over this thread's columns (the sum in double)
  float m = kNegInf;
  double s = 0.0;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int cnt = min(kTile, N - j0);
    __syncthreads();
    stage_tile(z3, j0, cnt, n, tile);
    __syncthreads();
    for (int jj = lane; jj < cnt; jj += kLanes)
      online_lse_step(-tile_dist<PM, NMAX>(a, tile, jj, n, p) / tau, m, s);
  }
  lane_merge_lse(m, s);
  if (lane == 0 && i < M) lse[i] = m + (float)log(s);
}

// ------------------------------------------------- forward for n <= 16
// x of an own row a and a staged row b: the first version's d, its terms in
// its order (a zero feature adds |0 - 0|^p = 0), and -quotient(d), the
// bits of its (-d) / tau.
template <int PM, int NF>
struct LpLogit {
  float p, tau, rtau;
  template <int W>
  __device__ __forceinline__ float operator()(const float (&a)[NF],
                                              const float (&b)[W]) const {
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < NF; ++k) d += dist_term<PM>(a[k] - b[k], p);
    return -quotient(d, tau, rtau);
  }
};

// tiled_lse_forward (infonce_common.cuh) with the Lp logit.
template <int PM, int NF>
__global__ void __launch_bounds__(kGradThreads, 2)
neg_lse_fwd_tiled(const float* __restrict__ z1, const float* __restrict__ z3,
                  float* __restrict__ lse, float* __restrict__ part_m,
                  double* __restrict__ part_s, int M, int N, int n, int chunk,
                  float p, float tau) {
  tiled_lse_forward<NF>(z1, z3, lse, part_m, part_s, M, N, n, chunk,
                        LpLogit<PM, NF>{p, tau, 1.f / tau});
}

// ------------------------------------- dz1 (rows), the first version
// A block owns 16 rows and loops over all of z3, a double add per term; it
// serves every n but 3, 8 and 10. dz3 below is a second pass over z3's
// rows (each block loops over all of z1).
template <int PM, int NMAX>
__global__ void __launch_bounds__(kThreads)
neg_lse_dz1_kernel(const float* __restrict__ z1, const float* __restrict__ z3,
                   const float* __restrict__ lse, const float* __restrict__ ct,
                   float* __restrict__ dz1, int M, int N, int n, float p,
                   float tau) {
  __shared__ float tile[NMAX * kTile];
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kRows + r;
  const int ic = min(i, M - 1);
  float a[NMAX];
  load_row<NMAX>(z1 + (size_t)ic * n, n, a);
  const float lse_i = lse[ic];

  double acc[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) acc[k] = 0.0;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int cnt = min(kTile, N - j0);
    __syncthreads();
    stage_tile(z3, j0, cnt, n, tile);
    __syncthreads();
    for (int jj = lane; jj < cnt; jj += kLanes) {
      const float d = tile_dist<PM, NMAX>(a, tile, jj, n, p);
      const float w = expf(-d / tau - lse_i);
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) acc[k] += (double)(w * grad_term<PM>(a[k] - tile[k * kTile + jj], p));
    }
  }
  const float scale = (-p / tau) * ct[ic];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      const double v = lane_sum(acc[k]);
      if (i < M && (k % kLanes) == lane) dz1[(size_t)i * n + k] = (float)(scale * v);
    }
  }
}

// ------------------------------------ dz3 (columns), the first version
template <int PM, int NMAX>
__global__ void __launch_bounds__(kThreads)
neg_lse_dz3_kernel(const float* __restrict__ z1, const float* __restrict__ z3,
                   const float* __restrict__ lse, const float* __restrict__ ct,
                   float* __restrict__ dz3, int M, int N, int n, float p,
                   float tau) {
  __shared__ float tile[NMAX * kTile];
  __shared__ float tile_lse[kTile];
  __shared__ float tile_ct[kTile];
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int j = blockIdx.x * kRows + r;
  float b[NMAX];
  load_row<NMAX>(z3 + (size_t)min(j, N - 1) * n, n, b);

  double acc[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) acc[k] = 0.0;
  for (int i0 = 0; i0 < M; i0 += kTile) {
    const int cnt = min(kTile, M - i0);
    __syncthreads();
    stage_tile(z1, i0, cnt, n, tile);
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      tile_lse[e] = lse[i0 + e];
      tile_ct[e] = ct[i0 + e];
    }
    __syncthreads();
    for (int ii = lane; ii < cnt; ii += kLanes) {
      // |z3_j - z1_i| == |z1_i - z3_j| exactly, so d is the forward's d_ij
      const float d = tile_dist<PM, NMAX>(b, tile, ii, n, p);
      const float cw = tile_ct[ii] * expf(-d / tau - tile_lse[ii]);
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) acc[k] += (double)(cw * grad_term<PM>(tile[k * kTile + ii] - b[k], p));
    }
  }
  const float scale = p / tau;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      const double v = lane_sum(acc[k]);
      if (j < N && (k % kLanes) == lane) dz3[(size_t)j * n + k] = (float)(scale * v);
    }
  }
}

// ------------------------------------------- dz1 and dz3 for n = 3, 8, 10
// See the note at the top; the block shape is infonce_common.cuh's. A
// staged row holds the n features, then (dz3) the row's exponent shift
// -lse and its cotangent (kStagedWidth).
constexpr float kLog2E = 1.4426950408889634f;  // exponents go to exp2f

// Block (x, s) owns kGradBlockRows rows of `own` and adds over the rows
// [s * chunk, (s + 1) * chunk) of `oth`. With `part` null (one chunk) it
// writes the scaled result to `out`; otherwise its partial sums, unscaled,
// to part[s][row][k].
template <int PM, int NF, bool DZ3>
__global__ void __launch_bounds__(kGradThreads, 2)
neg_lse_grad_kernel(const float* __restrict__ own, const float* __restrict__ oth,
                    const float* __restrict__ lse, const float* __restrict__ ct,
                    float* __restrict__ out, float* __restrict__ part,
                    int n_own, int n_oth, int chunk, float p, float tau) {
  constexpr int W = kStagedWidth<NF, DZ3>;
  constexpr int R = kGradRows;
  __shared__ __align__(16) float tile[kGradTile * W];
  const int q = threadIdx.x % kGradCols;
  const int row0 = (int)blockIdx.x * kGradBlockRows + (int)threadIdx.x / kGradCols * R;
  const float d_scale = -kLog2E / tau;  // exponent = d * d_scale + shift

  float a[R][NF], shift[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + r, n_own - 1);
#pragma unroll
    for (int k = 0; k < NF; ++k) a[r][k] = own[(size_t)i * NF + k];
    shift[r] = DZ3 ? 0.f : -kLog2E * lse[i];
  }
  double acc[R][NF];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NF; ++k) acc[r][k] = 0.0;

  const int split = blockIdx.y;
  const int j_end = min(n_oth, (split + 1) * chunk);
  for (int j0 = split * chunk; j0 < j_end; j0 += kGradTile) {
    const int cnt = min(kGradTile, j_end - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * NF; e += kGradThreads) {
      const int jj = e / NF;
      tile[jj * W + (e - jj * NF)] = oth[(size_t)j0 * NF + e];
    }
    if (DZ3) {
      for (int jj = threadIdx.x; jj < cnt; jj += kGradThreads) {
        tile[jj * W + NF] = -kLog2E * lse[j0 + jj];
        tile[jj * W + NF + 1] = ct[j0 + jj];
      }
    }
    __syncthreads();

    float sum[R][NF];  // this tile's terms, at most kGradTile / kGradCols
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < NF; ++k) sum[r][k] = 0.f;
    for (int jj = q; jj < cnt; jj += kGradCols) {
      float b[W];
      const float4* row = reinterpret_cast<const float4*>(tile + jj * W);
#pragma unroll
      for (int v = 0; v < W / 4; ++v) {
        const float4 t = row[v];
        b[4 * v] = t.x;
        b[4 * v + 1] = t.y;
        b[4 * v + 2] = t.z;
        b[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float g[NF];
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          const float dlt = a[r][k] - b[k];
          d += dist_term<PM>(dlt, p);
          g[k] = grad_term<PM>(dlt, p);
        }
        float w;
        if constexpr (DZ3) {
          w = exp2f(fmaf(d, d_scale, b[NF])) * b[NF + 1];
        } else {
          w = exp2f(fmaf(d, d_scale, shift[r]));
        }
#pragma unroll
        for (int k = 0; k < NF; ++k) sum[r][k] = fmaf(w, g[k], sum[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < NF; ++k) acc[r][k] += (double)sum[r][k];
  }

  // the kGradCols threads of a row group: two xor-shuffles leave the same
  // sum, (v0 + v1) + (v2 + v3), in each of them
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      double v = acc[r][k];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (i < n_own && k % kGradCols == q) {
        if (part != nullptr) {
          part[((size_t)split * n_own + i) * NF + k] = (float)v;
        } else {
          const double scale = -(double)p / (double)tau * (DZ3 ? 1.0 : (double)ct[i]);
          out[(size_t)i * NF + k] = (float)(scale * v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch
bool bad_args(int M, int N, int n, int pmode) {
  return M < 1 || N < 1 || n < 1 || n > kNmaxLarge || pmode < 0 || pmode > 2;
}

// The first version's forward, for 16 < n <= 64 and for a tau whose 1 / tau
// is not a normal float (part_m, part_s and chunk unused).
template <int PM, int NMAX>
cudaError_t fwd_first(const float* z1, const float* z3, float* lse, float*,
                      double*, int, int M, int N, int n, float p, float tau,
                      cudaStream_t st) {
  neg_lse_fwd_kernel<PM, NMAX><<<blocks_for(M), kThreads, 0, st>>>(
      z1, z3, lse, M, N, n, p, tau);
  return cudaGetLastError();
}

// neg_lse_fwd_tiled over (z1 row blocks) x (chunks of z3), then, for more
// than one chunk, lse_reduce_kernel over the partial (m, s) (chunks, M).
template <int PM, int NF>
cudaError_t fwd_tiled(const float* z1, const float* z3, float* lse,
                      float* part_m, double* part_s, int chunk, int M, int N,
                      int n, float p, float tau, cudaStream_t st) {
  const int splits = (N + chunk - 1) / chunk;
  if (splits > 1 && (part_m == nullptr || part_s == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((M + kGradBlockRows - 1) / kGradBlockRows, splits);
  neg_lse_fwd_tiled<PM, NF><<<grid, kGradThreads, 0, st>>>(
      z1, z3, lse, splits > 1 ? part_m : nullptr,
      splits > 1 ? part_s : nullptr, M, N, n, chunk, p, tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  launch_lse_reduce(part_m, part_s, lse, M, splits, st);
  return cudaGetLastError();
}

template <int PM, int NF>
cudaError_t fwd_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, neg_lse_fwd_tiled<PM, NF>, kGradThreads, 0);
}

// The first version's launches, for any n but 3, 8 and 10 (part and chunk
// unused), then the tiled gradients'.
template <int PM, int NMAX>
cudaError_t dz1_impl(const float* z1, const float* z3, const float* lse,
                     const float* ct, float* out, float*, int, int M, int N,
                     int n, float p, float tau, cudaStream_t st) {
  neg_lse_dz1_kernel<PM, NMAX><<<blocks_for(M), kThreads, 0, st>>>(
      z1, z3, lse, ct, out, M, N, n, p, tau);
  return cudaGetLastError();
}

template <int PM, int NMAX>
cudaError_t dz3_impl(const float* z1, const float* z3, const float* lse,
                     const float* ct, float* out, float*, int, int M, int N,
                     int n, float p, float tau, cudaStream_t st) {
  neg_lse_dz3_kernel<PM, NMAX><<<blocks_for(N), kThreads, 0, st>>>(
      z1, z3, lse, ct, out, M, N, n, p, tau);
  return cudaGetLastError();
}

// neg_lse_grad_kernel over (own row blocks) x (chunks of the other rows),
// then, for more than one chunk, grad_reduce_kernel over part (chunks, own
// rows, n), scaled by -(p/tau) (and c_i for dz1).
template <int PM, int NF, bool DZ3>
cudaError_t grad_impl(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* out, float* part, int chunk,
                      int M, int N, int, float p, float tau, cudaStream_t st) {
  const int n_own = DZ3 ? N : M;
  const int n_oth = DZ3 ? M : N;
  const int splits = (n_oth + chunk - 1) / chunk;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((n_own + kGradBlockRows - 1) / kGradBlockRows, splits);
  neg_lse_grad_kernel<PM, NF, DZ3><<<grid, kGradThreads, 0, st>>>(
      DZ3 ? z3 : z1, DZ3 ? z1 : z3, lse, ct, out, splits > 1 ? part : nullptr,
      n_own, n_oth, chunk, p, tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  launch_grad_reduce(part, DZ3 ? nullptr : ct, out, n_own, NF, splits,
                     -(double)p / (double)tau, st);
  return cudaGetLastError();
}

template <int PM, int NF, bool DZ3>
cudaError_t grad_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, neg_lse_grad_kernel<PM, NF, DZ3>, kGradThreads, 0);
}

using FwdFn = cudaError_t (*)(const float*, const float*, float*, float*,
                              double*, int, int, int, int, float, float,
                              cudaStream_t);
using BwdFn = cudaError_t (*)(const float*, const float*, const float*,
                              const float*, float*, float*, int, int, int, int,
                              float, float, cudaStream_t);
using OccFn = cudaError_t (*)(int*);

// [pmode][n <= kNmaxSmall ? 0 : 1]
const FwdFn kFwdFirst[3][2] = {
    {fwd_first<kPGeneral, kNmaxSmall>, fwd_first<kPGeneral, kNmaxLarge>},
    {fwd_first<kP1, kNmaxSmall>, fwd_first<kP1, kNmaxLarge>},
    {fwd_first<kP2, kNmaxSmall>, fwd_first<kP2, kNmaxLarge>}};
// [pmode][padded_slot(n)]
#define CLICA_BY_PADDED_WIDTH(F, PM) \
  {F<PM, 4>, F<PM, 8>, F<PM, 10>, F<PM, 12>, F<PM, 16>}
#define CLICA_BY_P(F)                                                     \
  {CLICA_BY_PADDED_WIDTH(F, kPGeneral), CLICA_BY_PADDED_WIDTH(F, kP1), \
   CLICA_BY_PADDED_WIDTH(F, kP2)}
const FwdFn kFwd[3][5] = CLICA_BY_P(fwd_tiled);
const OccFn kFwdOcc[3][5] = CLICA_BY_P(fwd_occupancy);
#undef CLICA_BY_P
#undef CLICA_BY_PADDED_WIDTH
// [dz3][pmode][n <= kNmaxSmall ? 0 : 1]
const BwdFn kWide[2][3][2] = {
    {{dz1_impl<kPGeneral, kNmaxSmall>, dz1_impl<kPGeneral, kNmaxLarge>},
     {dz1_impl<kP1, kNmaxSmall>, dz1_impl<kP1, kNmaxLarge>},
     {dz1_impl<kP2, kNmaxSmall>, dz1_impl<kP2, kNmaxLarge>}},
    {{dz3_impl<kPGeneral, kNmaxSmall>, dz3_impl<kPGeneral, kNmaxLarge>},
     {dz3_impl<kP1, kNmaxSmall>, dz3_impl<kP1, kNmaxLarge>},
     {dz3_impl<kP2, kNmaxSmall>, dz3_impl<kP2, kNmaxLarge>}}};
// [dz3][pmode][tiled_slot(n)]
#define CLICA_BY_WIDTH(F, PM, DZ3) {F<PM, 3, DZ3>, F<PM, 8, DZ3>, F<PM, 10, DZ3>}
#define CLICA_BY_P(F, DZ3)                                       \
  {CLICA_BY_WIDTH(F, kPGeneral, DZ3), CLICA_BY_WIDTH(F, kP1, DZ3), \
   CLICA_BY_WIDTH(F, kP2, DZ3)}
const BwdFn kGrad[2][3][3] = {CLICA_BY_P(grad_impl, false),
                              CLICA_BY_P(grad_impl, true)};
const OccFn kGradOcc[2][3][3] = {CLICA_BY_P(grad_occupancy, false),
                                 CLICA_BY_P(grad_occupancy, true)};
#undef CLICA_BY_P
#undef CLICA_BY_WIDTH

// The widths neg_lse_grad_kernel is built for: their slot in kGrad, -1 for
// any other n.
int tiled_slot(int n) { return n == 3 ? 0 : n == 8 ? 1 : n == 10 ? 2 : -1; }

int launch_grad(int dz3, const float* z1, const float* z3, const float* lse,
                const float* ct, float* out, float* part, int chunk, int M,
                int N, int n, int pmode, float p, float tau, void* stream) {
  if (bad_args(M, N, n, pmode) || chunk < 1) return (int)cudaErrorInvalidValue;
  const int slot = tiled_slot(n);
  const BwdFn fn = slot >= 0 ? kGrad[dz3][pmode][slot]
                             : kWide[dz3][pmode][width_slot(n)];
  return (int)fn(z1, z3, lse, ct, out, part, chunk, M, N, n, p, tau,
                 (cudaStream_t)stream);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). None synchronizes or allocates.
extern "C" {

// lse (M,). For n <= 16 z3's rows go in chunks of `chunk`, and with more
// than one chunk part_m must hold (chunks, M) floats and part_s (chunks, M)
// doubles; for n > 16, or a tau whose 1 / tau is not a normal float, the
// first version runs and the three are unused.
int clica_neg_lse_fwd(const float* z1, const float* z3, float* lse,
                      float* part_m, double* part_s, int chunk, int M, int N,
                      int n, int pmode, float p, float tau, void* stream) {
  if (bad_args(M, N, n, pmode) || chunk < 1) return (int)cudaErrorInvalidValue;
  const int slot = quotient_slot(n, tau);
  const FwdFn fn = slot >= 0 ? kFwd[pmode][slot] : kFwdFirst[pmode][width_slot(n)];
  return (int)fn(z1, z3, lse, part_m, part_s, chunk, M, N, n, p, tau,
                 (cudaStream_t)stream);
}

// Own rows per block of neg_lse_fwd_tiled.
int clica_neg_lse_fwd_block_rows() { return kGradBlockRows; }

// Blocks of neg_lse_fwd_tiled one SM holds at once; 0 for an n past 16,
// whose forward runs the first version (no chunks).
int clica_neg_lse_fwd_blocks_per_sm(int n, int pmode, int* blocks) {
  if (n < 1 || pmode < 0 || pmode > 2) return (int)cudaErrorInvalidValue;
  if (padded_slot(n) < 0) {
    *blocks = 0;
    return 0;
  }
  return (int)kFwdOcc[pmode][padded_slot(n)](blocks);
}

// dz1 (M, n) and dz3 (N, n). For n = 3, 8, 10 the other operand's rows
// (z3's for dz1, z1's for dz3) go in chunks of `chunk`, and with more than
// one chunk `part` must hold (chunks, own rows, n) floats; for any other n
// both are unused.
int clica_neg_lse_dz1(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz1, float* part, int chunk,
                      int M, int N, int n, int pmode, float p, float tau,
                      void* stream) {
  return launch_grad(0, z1, z3, lse, ct, dz1, part, chunk, M, N, n, pmode, p,
                     tau, stream);
}

int clica_neg_lse_dz3(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz3, float* part, int chunk,
                      int M, int N, int n, int pmode, float p, float tau,
                      void* stream) {
  return launch_grad(1, z1, z3, lse, ct, dz3, part, chunk, M, N, n, pmode, p,
                     tau, stream);
}

// Own rows per block of neg_lse_grad_kernel.
int clica_neg_lse_grad_block_rows() { return kGradBlockRows; }

// Blocks of neg_lse_grad_kernel one SM holds at once; 0 for an n it is not
// built for, whose gradients run the first version (no chunks).
int clica_neg_lse_grad_blocks_per_sm(int dz3, int n, int pmode, int* blocks) {
  if (pmode < 0 || pmode > 2 || dz3 < 0 || dz3 > 1)
    return (int)cudaErrorInvalidValue;
  if (tiled_slot(n) < 0) {
    *blocks = 0;
    return 0;
  }
  return (int)kGradOcc[dz3][pmode][tiled_slot(n)](blocks);
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
