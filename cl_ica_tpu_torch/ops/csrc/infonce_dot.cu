// Fused dot-product (SimCLR) InfoNCE log-sum-exp and its two gradients, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (cl_ica_tpu_torch/ops/infonce_dot.py).
//
// Replaces the Pallas TPU kernels of cl_ica_tpu/ops/infonce_pallas.py:
//   dot_lse_fwd_kernel <- _dot_fwd_kernel  (:319, pallas_call in _dot_fwd, :411)
//   dot_lse_dz1_kernel <- _dot_dz1_kernel  (:345, pallas_call in _dot_bwd, :448)
//   dot_lse_dz3_kernel <- _dot_dz3_kernel  (:369, pallas_call in _dot_bwd, :466)
//
// For z1 (M, n), z3 (N, n), tau > 0 and a cotangent c (M,):
//   x_ij  = (sum_k z1_ik z3_jk) / tau
//   lse_i = log sum_j exp(x_ij)
//   w_ij  = exp(x_ij - lse_i)               (softmax weights, recomputed)
//   dz1_i = (c_i / tau) sum_j w_ij z3_j     ((c/tau . W) @ z3)
//   dz3_j = (1 / tau) sum_i c_i w_ij z1_i   ((c/tau . W)^T @ z1)
// The three products z1 z3^T, W z3 and W^T z1 are computed here, in the
// kernel bodies, as they are inside the Pallas bodies: fp32 FMAs on the CUDA
// cores (the Pallas tiles pin Precision.HIGHEST, so no TF32).
//
// What bounds it. Each kernel reads (M + N) * n * 4 bytes (plus lse and c in
// the backward) and writes one vector or one (rows, n) matrix: 0.5-0.8 MB
// at M = N = 6144, n = 10, a fraction of a microsecond of memory traffic.
// The forward does 2 M N n flops and M N exponentials, each gradient
// 4 M N n flops (the logits again, then the second product) and M N
// exponentials: operations bound it, on the CUDA cores, never memory. The
// M x N matrix of logits never exists in device memory: a block streams
// tiles of the other operand through shared memory and keeps its running
// max/sum (forward) or its gradient rows (backward) in registers.
//
// How it differs from the TPU kernels, on purpose:
//  * The TPU grid runs in order and carries (max, sum) or the accumulator in
//    VMEM scratch across the column steps. Hopper blocks run in no order, so
//    a block owns kRows rows and loops over ALL tiles of the other operand
//    itself. dz3 is a second pass that owns rows of z3 and loops over all of
//    z1: no atomics, so the result is the same on every run.
//  * Logits have either sign and no bound (the inputs need not be
//    normalised). The forward subtracts the running max before every exp;
//    the backward forms exp(x - lse) as ONE subtraction, never
//    exp(x) * exp(-lse), either factor of which overflows alone.
//  * The running max starts at the finite sentinel -1e30, as the TPU code's
//    NEG_INF (see infonce_common.cuh).
//  * Ragged and rectangular shapes are not padded and masked by a count:
//    the loops stop at the valid row/column count. M and N are independent.
//  * x is dot / tau, a true division, as the plain version and the Pallas
//    body compute it; the gradients' 1 / tau is applied once per output.
//  * Accurate expf/logf (no fast math). The forward's sum of exponentials is
//    a double per thread: its terms are all positive, so a float32 running
//    sum over the N/16 terms a thread sees could lose ~N/32 ulps. It costs
//    one float-to-double conversion and one double add per pair, on a card
//    whose double rate is half its float rate. The gradients sum each staged
//    tile (8 terms a thread) in float32 and add the tile's partial sum to a
//    double accumulator, so the conversion is paid once per tile and feature.
// Making it fast (register tiles that reuse a staged value, wgmma on an
// n padded to 16, TMA staging) is later work.

#include "infonce_common.cuh"  // block shape, stage_tile, lane reductions

namespace {

template <int NMAX>
__device__ __forceinline__ float tile_dot(const float (&a)[NMAX],
                                          const float* __restrict__ tile,
                                          int jj, int n) {
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (k < n) d = fmaf(a[k], tile[k * kTile + jj], d);
  return d;
}

// ---------------------------------------------------------------- forward
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
dot_lse_fwd_kernel(const float* __restrict__ z1, const float* __restrict__ z3,
                   float* __restrict__ lse, int M, int N, int n, float tau) {
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
      online_lse_step(tile_dot<NMAX>(a, tile, jj, n) / tau, m, s);
  }
  lane_merge_lse(m, s);
  if (lane == 0 && i < M) lse[i] = m + (float)log(s);
}

// -------------------------------------------------------------- dz1 (rows)
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
dot_lse_dz1_kernel(const float* __restrict__ z1, const float* __restrict__ z3,
                   const float* __restrict__ lse, const float* __restrict__ ct,
                   float* __restrict__ dz1, int M, int N, int n, float tau) {
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
    float part[NMAX];
#pragma unroll
    for (int k = 0; k < NMAX; ++k) part[k] = 0.f;
    for (int jj = lane; jj < cnt; jj += kLanes) {
      const float w = expf(tile_dot<NMAX>(a, tile, jj, n) / tau - lse_i);
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) part[k] = fmaf(w, tile[k * kTile + jj], part[k]);
    }
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n) acc[k] += (double)part[k];
  }
  const float scale = ct[ic] / tau;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      const double v = lane_sum(acc[k]);
      if (i < M && (k % kLanes) == lane) dz1[(size_t)i * n + k] = (float)(scale * v);
    }
  }
}

// ----------------------------------------------------------- dz3 (columns)
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
dot_lse_dz3_kernel(const float* __restrict__ z1, const float* __restrict__ z3,
                   const float* __restrict__ lse, const float* __restrict__ ct,
                   float* __restrict__ dz3, int M, int N, int n, float tau) {
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
    float part[NMAX];
#pragma unroll
    for (int k = 0; k < NMAX; ++k) part[k] = 0.f;
    for (int ii = lane; ii < cnt; ii += kLanes) {
      // b . z1_i sums the same products in the same order as the forward's
      // z1_i . z3_j, so x is the forward's x_ij bit for bit
      const float x = tile_dot<NMAX>(b, tile, ii, n) / tau;
      const float cw = tile_ct[ii] * expf(x - tile_lse[ii]);
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) part[k] = fmaf(cw, tile[k * kTile + ii], part[k]);
    }
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n) acc[k] += (double)part[k];
  }
  const float scale = 1.f / tau;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      const double v = lane_sum(acc[k]);
      if (j < N && (k % kLanes) == lane) dz3[(size_t)j * n + k] = (float)(scale * v);
    }
  }
}

// ---------------------------------------------------------------- launch
bool bad_args(int M, int N, int n) {
  return M < 1 || N < 1 || n < 1 || n > kNmaxLarge;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched). None synchronizes or allocates.
extern "C" {

int clica_dot_lse_fwd(const float* z1, const float* z3, float* lse, int M,
                      int N, int n, float tau, void* stream) {
  if (bad_args(M, N, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (width_slot(n) == 0)
    dot_lse_fwd_kernel<kNmaxSmall><<<blocks_for(M), kThreads, 0, st>>>(
        z1, z3, lse, M, N, n, tau);
  else
    dot_lse_fwd_kernel<kNmaxLarge><<<blocks_for(M), kThreads, 0, st>>>(
        z1, z3, lse, M, N, n, tau);
  return (int)cudaGetLastError();
}

int clica_dot_lse_dz1(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz1, int M, int N, int n,
                      float tau, void* stream) {
  if (bad_args(M, N, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (width_slot(n) == 0)
    dot_lse_dz1_kernel<kNmaxSmall><<<blocks_for(M), kThreads, 0, st>>>(
        z1, z3, lse, ct, dz1, M, N, n, tau);
  else
    dot_lse_dz1_kernel<kNmaxLarge><<<blocks_for(M), kThreads, 0, st>>>(
        z1, z3, lse, ct, dz1, M, N, n, tau);
  return (int)cudaGetLastError();
}

int clica_dot_lse_dz3(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz3, int M, int N, int n,
                      float tau, void* stream) {
  if (bad_args(M, N, n)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (width_slot(n) == 0)
    dot_lse_dz3_kernel<kNmaxSmall><<<blocks_for(N), kThreads, 0, st>>>(
        z1, z3, lse, ct, dz3, M, N, n, tau);
  else
    dot_lse_dz3_kernel<kNmaxLarge><<<blocks_for(N), kThreads, 0, st>>>(
        z1, z3, lse, ct, dz3, M, N, n, tau);
  return (int)cudaGetLastError();
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
