// Fused Lp-InfoNCE negative log-sum-exp and its two gradients, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (cl_ica_tpu_torch/ops/infonce.py).
//
// Replaces the Pallas TPU kernels of cl_ica_tpu/ops/infonce_pallas.py:
//   neg_lse_fwd_kernel <- _fwd_kernel  (pallas_call in _fwd, :232)
//   neg_lse_dz1_kernel <- _dz1_kernel  (pallas_call in _bwd, :262)
//   neg_lse_dz3_kernel <- _dz3_kernel  (pallas_call in _bwd, :280)
//
// For z1 (M, n), z3 (N, n), p >= 1, tau > 0 and a cotangent c (M,):
//   lse_i = log sum_j exp(-d_ij / tau),     d_ij = sum_k |z1_ik - z3_jk|^p
//   w_ij  = exp(-d_ij / tau - lse_i)        (softmax weights, recomputed)
//   dz1_i = -(p/tau) c_i sum_j w_ij g(z1_i - z3_j)
//   dz3_j = +(p/tau) sum_i c_i w_ij g(z1_i - z3_j)
//   g(D)  = sgn(D) |D|^(p-1) per feature, with sgn(0) = 0 (_grad_tile)
//
// What bounds it. The forward reads (M + N) * n * 4 bytes and does
// O(M * N * n) arithmetic plus M * N exponentials; at M = N = 6144,
// n = 10 that is 0.5 MB against ~1e9 operations, so the card's CUDA-core
// rate bounds it, never memory. What the design preserves from the TPU
// kernel is that the M x N distance matrix never exists in device memory:
// each block streams tiles of the other operand through shared memory and
// keeps its running max/sum (forward) or gradient (backward) in registers.
//
// How it differs from the TPU kernel, on purpose:
//  * The TPU grid runs in order and carries sums in VMEM scratch across
//    grid steps. Hopper blocks run in no order, so a block owns a tile of
//    rows and loops over ALL tiles of the other operand itself. dz3 is a
//    second pass over z3's rows (each block loops over all of z1), which
//    keeps the result deterministic without atomics.
//  * p == 2 sums (z1_ik - z3_jk)^2 directly. The TPU kernel's dot identity
//    |a|^2 + |b|^2 - 2ab only serves to reach the MXU; with n = 10 there is
//    no tensor-core tile to fill, and the direct sum needs no clamp at 0.
//  * Ragged edges are not padded: loops stop at the valid row/column count,
//    so a missing column contributes nothing (exp(-inf)), never the
//    distance to a zero row.
//  * The running max starts at the finite sentinel -1e30, as the TPU code's
//    NEG_INF: with -INFINITY, exp(m_old - m_new) is NaN on the first step.
//  * fp32 arithmetic with the accurate expf/logf/powf (no fast math), as
//    the TPU kernel pins Precision.HIGHEST, but each thread's running sums
//    (the forward's sum of exponentials, the gradients' accumulators) are
//    double. Early in training the encoder's outputs are nearly collapsed,
//    so the terms of one row's sums share a sign, and a float32 running sum
//    over the N/16 terms one thread sees could lose up to ~N/32 ulps.
// Making it fast (register tiles, wgmma, TMA, atomics for dz3) is later work.

#include "infonce_common.cuh"  // block shape, stage_tile, lane reductions

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

// -------------------------------------------------------------- dz1 (rows)
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

// ----------------------------------------------------------- dz3 (columns)
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

// ---------------------------------------------------------------- launch
bool bad_args(int M, int N, int n, int pmode) {
  return M < 1 || N < 1 || n < 1 || n > kNmaxLarge || pmode < 0 || pmode > 2;
}

template <int PM, int NMAX>
void fwd_impl(const float* z1, const float* z3, float* lse, int M, int N,
              int n, float p, float tau, cudaStream_t st) {
  neg_lse_fwd_kernel<PM, NMAX><<<blocks_for(M), kThreads, 0, st>>>(
      z1, z3, lse, M, N, n, p, tau);
}

template <int PM, int NMAX>
void dz1_impl(const float* z1, const float* z3, const float* lse,
              const float* ct, float* out, int M, int N, int n, float p,
              float tau, cudaStream_t st) {
  neg_lse_dz1_kernel<PM, NMAX><<<blocks_for(M), kThreads, 0, st>>>(
      z1, z3, lse, ct, out, M, N, n, p, tau);
}

template <int PM, int NMAX>
void dz3_impl(const float* z1, const float* z3, const float* lse,
              const float* ct, float* out, int M, int N, int n, float p,
              float tau, cudaStream_t st) {
  neg_lse_dz3_kernel<PM, NMAX><<<blocks_for(N), kThreads, 0, st>>>(
      z1, z3, lse, ct, out, M, N, n, p, tau);
}

using FwdFn = void (*)(const float*, const float*, float*, int, int, int,
                       float, float, cudaStream_t);
using BwdFn = void (*)(const float*, const float*, const float*,
                       const float*, float*, int, int, int, float, float,
                       cudaStream_t);

// [pmode][n <= kNmaxSmall ? 0 : 1]
const FwdFn kFwd[3][2] = {
    {fwd_impl<kPGeneral, kNmaxSmall>, fwd_impl<kPGeneral, kNmaxLarge>},
    {fwd_impl<kP1, kNmaxSmall>, fwd_impl<kP1, kNmaxLarge>},
    {fwd_impl<kP2, kNmaxSmall>, fwd_impl<kP2, kNmaxLarge>}};
const BwdFn kDz1[3][2] = {
    {dz1_impl<kPGeneral, kNmaxSmall>, dz1_impl<kPGeneral, kNmaxLarge>},
    {dz1_impl<kP1, kNmaxSmall>, dz1_impl<kP1, kNmaxLarge>},
    {dz1_impl<kP2, kNmaxSmall>, dz1_impl<kP2, kNmaxLarge>}};
const BwdFn kDz3[3][2] = {
    {dz3_impl<kPGeneral, kNmaxSmall>, dz3_impl<kPGeneral, kNmaxLarge>},
    {dz3_impl<kP1, kNmaxSmall>, dz3_impl<kP1, kNmaxLarge>},
    {dz3_impl<kP2, kNmaxSmall>, dz3_impl<kP2, kNmaxLarge>}};

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched). None synchronizes or allocates.
extern "C" {

int clica_neg_lse_fwd(const float* z1, const float* z3, float* lse, int M,
                      int N, int n, int pmode, float p, float tau,
                      void* stream) {
  if (bad_args(M, N, n, pmode)) return (int)cudaErrorInvalidValue;
  kFwd[pmode][width_slot(n)](z1, z3, lse, M, N, n, p, tau,
                             (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int clica_neg_lse_dz1(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz1, int M, int N, int n,
                      int pmode, float p, float tau, void* stream) {
  if (bad_args(M, N, n, pmode)) return (int)cudaErrorInvalidValue;
  kDz1[pmode][width_slot(n)](z1, z3, lse, ct, dz1, M, N, n, p, tau,
                             (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int clica_neg_lse_dz3(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz3, int M, int N, int n,
                      int pmode, float p, float tau, void* stream) {
  if (bad_args(M, N, n, pmode)) return (int)cudaErrorInvalidValue;
  kDz3[pmode][width_slot(n)](z1, z3, lse, ct, dz3, M, N, n, p, tau,
                             (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
