// Fused dot-product (SimCLR) InfoNCE log-sum-exp and its two gradients, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (cl_ica_tpu_torch/ops/infonce_dot.py).
//
// Replaces the Pallas TPU kernels of cl_ica_tpu/ops/infonce_pallas.py:
//   forward: dot_lse_fwd_tiled<NF> + lse_reduce_kernel for n <= 16;
//        dot_lse_fwd_kernel for 16 < n <= 64
//        <- _dot_fwd_kernel  (:319, pallas_call in _dot_fwd, :411)
//   dz1: dot_lse_grad_kernel<NF, false> + grad_reduce_kernel for n <= 16;
//        dot_lse_dz1_kernel for 16 < n <= 64
//        <- _dot_dz1_kernel  (:345, pallas_call in _dot_bwd, :448)
//   dz3: dot_lse_grad_kernel<NF, true> + grad_reduce_kernel for n <= 16;
//        dot_lse_dz3_kernel for 16 < n <= 64
//        <- _dot_dz3_kernel  (:369, pallas_call in _dot_bwd, :466)
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
// exponentials: operations bound it, issue slots on the CUDA cores, never
// memory. The M x N matrix of logits never exists in device memory: a
// block streams tiles of the other operand through shared memory and keeps
// its running max/sum (forward) or its gradient rows (backward) in
// registers.
//
// How it differs from the TPU kernels, on purpose:
//  * The TPU grid runs in order and carries (max, sum) or the accumulator in
//    VMEM scratch across the column steps. Hopper blocks run in no order, so
//    a block owns rows of one operand and one chunk of the other, and a
//    second kernel merges the chunks (below). dz3 is a pass of its own over
//    z3's rows: no atomics, so the result is the same on every run.
//  * Logits have either sign and no bound (the inputs need not be
//    normalised). The forward subtracts the running max before every exp;
//    the backward forms exp(x - lse) as ONE subtraction, never
//    exp(x) * exp(-lse), either factor of which overflows alone.
//  * The running max starts at the finite sentinel -1e30, as the TPU code's
//    NEG_INF (see infonce_common.cuh).
//  * Ragged and rectangular shapes are not padded and masked by a count:
//    the loops stop at the valid row/column count. M and N are independent.
//  * x is dot / tau, rounded as a true division rounds it, as the plain
//    version and the Pallas body compute it, and the backward sums the
//    dot's products in the forward's order: its x is the forward's x bit
//    for bit, so at logits of 1e4, where one ulp of x is 1e-3, w =
//    exp(x - lse) is as exact as the forward's lse. The gradients' 1 / tau
//    is applied once per output.
//  * Accurate expf/logf (no fast math), but for the tiled forwards' terms
//    (exp_neg_abs, below). The forward's sum of exponentials
//    is a double across tiles: its terms are all positive, so a float32
//    running sum over the thousands of terms a thread sees could lose
//    ulps in proportion; no float32 sum runs over more than 32 terms.
//
// The forward for n <= 16 (dot_lse_fwd_tiled + lse_reduce_kernel). The work
// is one multiply-add for each of the M * N * n (pair, feature) terms, plus
// a division and an exponential per pair, against 0.5 MB of data: issue
// slots on the CUDA cores bound it. The first version (still below, for
// 16 < n <= 64 and for a tau quotient() cannot divide by) mirrored the
// first-version gradients, and spent them so; this design is the tiled
// gradients' (below), with a (max, sum) in place of their sums:
//  * A shared-memory load per term, from a feature-major tile that
//    stage_tile fills with an integer division per word. Here two own rows
//    a thread in registers, four threads a row group, float4 reads of four
//    rows of a row-major tile (kStagedWidth floats a row, four-float4 rows
//    padded to five against bank conflicts): one load feeds 2 x 4 terms,
//    and the staging divides by a compile-time NF.
//  * 16 feature slots behind tests of k < n. Here a runtime n is staged,
//    zero-padded, into the narrowest of NF = 4, 8, 10, 12, 16 that holds
//    it; fmaf(0, 0, d) == d, so x keeps its bits.
//  * A true division per pair. Here quotient(), its bits in three
//    instructions, so x is the x the gradients recompute bit for bit, and
//    the max m is that x exactly: at logits of 1e4, where an ulp of x is
//    1e-3, the gradients' w = exp(x - lse) rests on it.
//  * Per pair, a data-dependent branch, an accurate expf, a float-to-
//    double conversion and a double add (online_lse_step). Here lse_step:
//    one exponential of -|x - m|, which is exp(x - m), or exp(m - x) to
//    rescale the sum at a new max, and predicated adds in place of the
//    branch; the max's own term 1 stays out of the float sum, which runs
//    over a tile's 32 terms and is folded into the double once per tile.
//    The exponential is the SFU's 2^x of (x - m) log2 e (exp_neg_abs):
//    x and m keep their bits, and only the difference is scaled.
//  * A grid of M / 16 blocks, each over all of z3: 384 blocks at 6144
//    rows, 32 on 132 SMs at 512. Here row blocks x S chunks of z3
//    (split_plan, with clica_dot_lse_fwd_blocks_per_sm: three blocks an
//    SM at n = 10, so 48 x 16 in two waves, and 4 x 8 at 512). With S > 1
//    each block writes its rows' partial (m, s), float and double, and
//    lse_reduce_kernel merges the S partials of a row in double, in the
//    order of the chunks; the wrapper counts one launch for the pair.
//  * A merge over the 16 lanes of a row, four shuffle rounds of (float,
//    double) with two expf each. Here two rounds over a row group of four.
//
// The gradients for n <= 16 (dot_lse_grad_kernel + grad_reduce_kernel), the
// widths of main_mlp (10) and main_3dident (8). Both are
//   out_r = s_r * sum_o c_oth_o * w_ro * oth_o
// with own = z1, oth = z3, s = c / tau, c_oth = 1 for dz1, and own = z3,
// oth = z1, s = 1 / tau, c_oth = c for dz3. The work is 2 multiply-adds
// for each of the M * N * n (pair, feature) terms, plus a division and an
// exponential per pair, against 0.5 MB of data: issue slots on the CUDA
// cores bound it. What the first version (still below, for 16 < n <= 64)
// spent them on, and what this design does about it:
//  * A shared-memory load per term, feature-major (tile[k][jj]), read once
//    for the logit and again for the sum. Here a thread holds kGradRows = 2
//    own rows in registers; the four threads of a row group take every
//    fourth row of a staged tile of 128 rows, stored row-major with
//    kStagedWidth floats a row, and the 32 threads of a warp read four
//    rows' float4s (distinct banks, the other row groups' reads broadcast),
//    so one load feeds 2 x 4 terms, kept in registers for both the logit
//    and the sum.
//  * A conversion to double and a double add per term and feature in
//    the sums. Here a thread adds its terms in float32 registers over one
//    staged tile (kGradTile / 4 = 32 terms per sum) and folds each sum into
//    a double once per tile, a conversion per 32 terms. The double across
//    tiles keeps what the forward's note says of collapsed inputs: no
//    float32 sum runs over more than 32 terms.
//  * A grid of M / 16 blocks: 1.45 waves at 6144 rows, 32 blocks on 132
//    SMs at 512. Here the other operand's rows are cut into S chunks
//    (ops/infonce.py:split_plan picks S from the shapes and the blocks the
//    card holds at once, clica_dot_lse_grad_blocks_per_sm), a grid of row
//    blocks x S: 48 x 11 at 6144 rows, 4 x 8 at 512. Each block writes its
//    rows' partial sums, in float, to a scratch buffer the wrapper
//    allocates, and grad_reduce_kernel (infonce_common.cuh) adds the S
//    partials of each element in double, in the order of s, and scales
//    them. With S = 1 the first kernel writes the result itself. The
//    reduce kernel is part of the gradient: the wrapper counts one launch
//    for the pair. No atomics: the four threads of a row group add their
//    doubles by two xor-shuffles, the chunks are added in a fixed order, so
//    a run repeats bit for bit.
//  * Feature loops over 16 (or 64) slots, each behind a test of k < n.
//    Here a runtime n is staged into the narrowest instance of NF = 4, 8,
//    10, 12 or 16 features that holds it, zero past n: a zero feature adds exactly 0 to z1_i . z3_j (fmaf(0, 0, d) == d,
//    so x keeps the forward's bits) and to every sum, and its column is
//    never written. Issue slots follow NF, so main_mlp's n = 10 has an
//    instance of its own (NF = 12 took 1.2x its time).
//  * A division and an exponential per pair. The exponent stays
//    expf(dot / tau - lse) with the forward's x (see above), but the
//    quotient is formed as Markstein's corrected product (quotient(),
//    infonce_common.cuh): the same bits in three instructions. A tau whose
//    1 / tau is not a normal float goes to the first version, which
//    divides. exp2f with log2 e / tau folded into one FMA rounds the
//    exponent twice more, ~2e-3 at logits of 1.8e4, twenty times the
//    gradient bar.
// Left for later: one pass for both gradients, and 3xTF32 mma.sync on an n
// padded to a K of 16 (HIGHEST precision rules out plain TF32).

#include "infonce_common.cuh"  // block shapes, staging, quotient, reductions

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

// ------------------------------------------------- forward for n <= 16
// x of an own row a and a staged row b: the gradients' logit, the same
// products in the same order, d / tau by quotient().
template <int NF>
struct DotLogit {
  float tau, rtau;
  template <int W>
  __device__ __forceinline__ float operator()(const float (&a)[NF],
                                              const float (&b)[W]) const {
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < NF; ++k) d = fmaf(a[k], b[k], d);
    return quotient(d, tau, rtau);
  }
};

// tiled_lse_forward (infonce_common.cuh) with the dot's logit.
template <int NF>
__global__ void __launch_bounds__(kGradThreads, 2)
dot_lse_fwd_tiled(const float* __restrict__ z1, const float* __restrict__ z3,
                  float* __restrict__ lse, float* __restrict__ part_m,
                  double* __restrict__ part_s, int M, int N, int n, int chunk,
                  float tau) {
  tiled_lse_forward<NF>(z1, z3, lse, part_m, part_s, M, N, n, chunk,
                        DotLogit<NF>{tau, 1.f / tau});
}

// ------------------------------------- dz1 (rows), the first version
// A block owns 16 rows and loops over all of z3, feature-major tiles and
// float sums per tile; it serves 16 < n <= 64. dz3 below is a pass over
// z3's rows (each block loops over all of z1).
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

// ---------------------------------- dz3 (columns), the first version
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

// ------------------------------------------------ dz1 and dz3 for n <= 16
// See the note at the top; the block shape is infonce_common.cuh's. Block
// (x, s) owns kGradBlockRows rows of `own` and adds over the rows
// [s * chunk, (s + 1) * chunk) of `oth`. With `part` null (one chunk) it
// writes the scaled result to `out`; otherwise its partial sums, unscaled,
// to part[s][row][k]. At NF = 16 the two rows' registers pass the 128 that
// two blocks an SM allow, so that instance asks for one.
template <int NF, bool DZ3>
__global__ void __launch_bounds__(kGradThreads, NF <= 12 ? 2 : 1)
dot_lse_grad_kernel(const float* __restrict__ own, const float* __restrict__ oth,
                    const float* __restrict__ lse, const float* __restrict__ ct,
                    float* __restrict__ out, float* __restrict__ part,
                    int n_own, int n_oth, int n, int chunk, float tau) {
  constexpr int W = kStagedWidth<NF, DZ3>;
  constexpr int R = kGradRows;
  __shared__ __align__(16) float tile[kGradTile * W];
  const int q = threadIdx.x % kGradCols;
  const int row0 = (int)blockIdx.x * kGradBlockRows + (int)threadIdx.x / kGradCols * R;
  const float rtau = 1.f / tau;  // RN(1 / tau), for quotient() below

  float a[R][NF], lse_own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + r, n_own - 1);
#pragma unroll
    for (int k = 0; k < NF; ++k) a[r][k] = k < n ? own[(size_t)i * n + k] : 0.f;
    lse_own[r] = DZ3 ? 0.f : lse[i];
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
      const int k = e - jj * NF;
      tile[jj * W + k] = k < n ? oth[(size_t)(j0 + jj) * n + k] : 0.f;
    }
    if (DZ3) {
      for (int jj = threadIdx.x; jj < cnt; jj += kGradThreads) {
        tile[jj * W + NF] = lse[j0 + jj];
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
        // the forward's tile_dot: the same products in the same order
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < NF; ++k) d = fmaf(a[r][k], b[k], d);
        const float x = quotient(d, tau, rtau);  // d / tau, its bits
        float w;
        if constexpr (DZ3) {
          w = expf(x - b[NF]) * b[NF + 1];
        } else {
          w = expf(x - lse_own[r]);
        }
#pragma unroll
        for (int k = 0; k < NF; ++k) sum[r][k] = fmaf(w, b[k], sum[r][k]);
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
      if (i < n_own && k < n && k % kGradCols == q) {
        if (part != nullptr) {
          part[((size_t)split * n_own + i) * n + k] = (float)v;
        } else {
          // grad_reduce_kernel's scale, in its order
          const double scale = (1.0 / (double)tau) * (DZ3 ? 1.0 : (double)ct[i]);
          out[(size_t)i * n + k] = (float)(scale * v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch
bool bad_args(int M, int N, int n) {
  return M < 1 || N < 1 || n < 1 || n > kNmaxLarge;
}

// The first version's forward, for 16 < n <= 64 and for a tau whose 1 / tau
// is not a normal float (part_m, part_s and chunk unused).
cudaError_t fwd_first(const float* z1, const float* z3, float* lse, float*,
                      double*, int, int M, int N, int n, float tau,
                      cudaStream_t st) {
  if (width_slot(n) == 0)
    dot_lse_fwd_kernel<kNmaxSmall><<<blocks_for(M), kThreads, 0, st>>>(
        z1, z3, lse, M, N, n, tau);
  else
    dot_lse_fwd_kernel<kNmaxLarge><<<blocks_for(M), kThreads, 0, st>>>(
        z1, z3, lse, M, N, n, tau);
  return cudaGetLastError();
}

// dot_lse_fwd_tiled over (z1 row blocks) x (chunks of z3), then, for more
// than one chunk, lse_reduce_kernel over the partial (m, s) (chunks, M).
template <int NF>
cudaError_t fwd_tiled(const float* z1, const float* z3, float* lse,
                      float* part_m, double* part_s, int chunk, int M, int N,
                      int n, float tau, cudaStream_t st) {
  const int splits = (N + chunk - 1) / chunk;
  if (splits > 1 && (part_m == nullptr || part_s == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((M + kGradBlockRows - 1) / kGradBlockRows, splits);
  dot_lse_fwd_tiled<NF><<<grid, kGradThreads, 0, st>>>(
      z1, z3, lse, splits > 1 ? part_m : nullptr,
      splits > 1 ? part_s : nullptr, M, N, n, chunk, tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  launch_lse_reduce(part_m, part_s, lse, M, splits, st);
  return cudaGetLastError();
}

template <int NF>
cudaError_t fwd_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, dot_lse_fwd_tiled<NF>, kGradThreads, 0);
}

// The first version's launches, for 16 < n <= 64 (part and chunk unused),
// then the tiled gradients'.
cudaError_t dz1_wide(const float* z1, const float* z3, const float* lse,
                     const float* ct, float* out, float*, int, int M, int N,
                     int n, float tau, cudaStream_t st) {
  dot_lse_dz1_kernel<kNmaxLarge><<<blocks_for(M), kThreads, 0, st>>>(
      z1, z3, lse, ct, out, M, N, n, tau);
  return cudaGetLastError();
}

cudaError_t dz3_wide(const float* z1, const float* z3, const float* lse,
                     const float* ct, float* out, float*, int, int M, int N,
                     int n, float tau, cudaStream_t st) {
  dot_lse_dz3_kernel<kNmaxLarge><<<blocks_for(N), kThreads, 0, st>>>(
      z1, z3, lse, ct, out, M, N, n, tau);
  return cudaGetLastError();
}

// dot_lse_grad_kernel over (own row blocks) x (chunks of the other rows),
// then, for more than one chunk, grad_reduce_kernel over part (chunks, own
// rows, n), scaled by 1 / tau (and c_i for dz1).
template <int NF, bool DZ3>
cudaError_t grad_impl(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* out, float* part, int chunk,
                      int M, int N, int n, float tau, cudaStream_t st) {
  const int n_own = DZ3 ? N : M;
  const int n_oth = DZ3 ? M : N;
  const int splits = (n_oth + chunk - 1) / chunk;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((n_own + kGradBlockRows - 1) / kGradBlockRows, splits);
  dot_lse_grad_kernel<NF, DZ3><<<grid, kGradThreads, 0, st>>>(
      DZ3 ? z3 : z1, DZ3 ? z1 : z3, lse, ct, out, splits > 1 ? part : nullptr,
      n_own, n_oth, n, chunk, tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  launch_grad_reduce(part, DZ3 ? nullptr : ct, out, n_own, n, splits,
                     1.0 / (double)tau, st);
  return cudaGetLastError();
}

template <int NF, bool DZ3>
cudaError_t grad_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, dot_lse_grad_kernel<NF, DZ3>, kGradThreads, 0);
}

using FwdFn = cudaError_t (*)(const float*, const float*, float*, float*,
                              double*, int, int, int, int, float, cudaStream_t);
using BwdFn = cudaError_t (*)(const float*, const float*, const float*,
                              const float*, float*, float*, int, int, int, int,
                              float, cudaStream_t);
using OccFn = cudaError_t (*)(int*);

// [padded_slot(n)]
const FwdFn kFwd[5] = {fwd_tiled<4>, fwd_tiled<8>, fwd_tiled<10>,
                       fwd_tiled<12>, fwd_tiled<16>};
const OccFn kFwdOcc[5] = {fwd_occupancy<4>, fwd_occupancy<8>,
                          fwd_occupancy<10>, fwd_occupancy<12>,
                          fwd_occupancy<16>};
// [dz3][padded_slot(n)]
#define CLICA_BY_WIDTH(F, DZ3) \
  {F<4, DZ3>, F<8, DZ3>, F<10, DZ3>, F<12, DZ3>, F<16, DZ3>}
const BwdFn kGrad[2][5] = {CLICA_BY_WIDTH(grad_impl, false),
                           CLICA_BY_WIDTH(grad_impl, true)};
const OccFn kGradOcc[2][5] = {CLICA_BY_WIDTH(grad_occupancy, false),
                              CLICA_BY_WIDTH(grad_occupancy, true)};
#undef CLICA_BY_WIDTH
const BwdFn kWide[2] = {dz1_wide, dz3_wide};

int launch_grad(int dz3, const float* z1, const float* z3, const float* lse,
                const float* ct, float* out, float* part, int chunk, int M,
                int N, int n, float tau, void* stream) {
  if (bad_args(M, N, n) || chunk < 1) return (int)cudaErrorInvalidValue;
  const int slot = quotient_slot(n, tau);
  const BwdFn fn = slot >= 0 ? kGrad[dz3][slot] : kWide[dz3];
  return (int)fn(z1, z3, lse, ct, out, part, chunk, M, N, n, tau,
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
int clica_dot_lse_fwd(const float* z1, const float* z3, float* lse,
                      float* part_m, double* part_s, int chunk, int M, int N,
                      int n, float tau, void* stream) {
  if (bad_args(M, N, n) || chunk < 1) return (int)cudaErrorInvalidValue;
  const int slot = quotient_slot(n, tau);
  const FwdFn fn = slot >= 0 ? kFwd[slot] : fwd_first;
  return (int)fn(z1, z3, lse, part_m, part_s, chunk, M, N, n, tau,
                 (cudaStream_t)stream);
}

// Own rows per block of dot_lse_fwd_tiled.
int clica_dot_lse_fwd_block_rows() { return kGradBlockRows; }

// Blocks of dot_lse_fwd_tiled one SM holds at once; 0 for an n past 16,
// whose forward runs the first version (no chunks).
int clica_dot_lse_fwd_blocks_per_sm(int n, int* blocks) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (padded_slot(n) < 0) {
    *blocks = 0;
    return 0;
  }
  return (int)kFwdOcc[padded_slot(n)](blocks);
}

// dz1 (M, n) and dz3 (N, n). For n <= 16 the other operand's rows (z3's
// for dz1, z1's for dz3) go in chunks of `chunk`, and with more than one
// chunk `part` must hold (chunks, own rows, n) floats; for n > 16, or a
// tau whose 1 / tau is not a normal float, the first version runs and both
// are unused.
int clica_dot_lse_dz1(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz1, float* part, int chunk,
                      int M, int N, int n, float tau, void* stream) {
  return launch_grad(0, z1, z3, lse, ct, dz1, part, chunk, M, N, n, tau,
                     stream);
}

int clica_dot_lse_dz3(const float* z1, const float* z3, const float* lse,
                      const float* ct, float* dz3, float* part, int chunk,
                      int M, int N, int n, float tau, void* stream) {
  return launch_grad(1, z1, z3, lse, ct, dz3, part, chunk, M, N, n, tau,
                     stream);
}

// Own rows per block of dot_lse_grad_kernel.
int clica_dot_lse_grad_block_rows() { return kGradBlockRows; }

// Blocks of dot_lse_grad_kernel one SM holds at once; 0 for an n past 16,
// whose gradients run the first version (no chunks).
int clica_dot_lse_grad_blocks_per_sm(int dz3, int n, int* blocks) {
  if (dz3 < 0 || dz3 > 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (padded_slot(n) < 0) {
    *blocks = 0;
    return 0;
  }
  return (int)kGradOcc[dz3][padded_slot(n)](blocks);
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
