// The minimal-residual batch norm of the ResNet blocks, training mode, for
// sm_90a: four kernels for the three functions of ops/bn_minres.py,
//
//   bn_relu      y = relu(x*a + b)
//   bn_add_relu  y = relu(x*a + b + res)
//   bn_only      y = x*a + b
//
// with a = scale*rstd and b = bias - mean*a per channel from the batch's own
// statistics, and the backward that keeps only x (and, for bn_add_relu,
// the output y, which the next layer keeps anyway).
//
// Not a TPU kernel: the JAX package computes these functions as fused XLA
// passes (cl_ica_tpu/ops/bn_minres.py: _channel_stats :56, the forward's
// affine and relu, _bn_bwd_core :83 and _mask_grad :114). The port's own,
// as stem_dx_kernel (stem_pool.cu) is.
//
//   stats     bn_stats_kernel: one pass over x, per channel the float sums
//             of x and of x*x (x*x rounded to x's type first, as
//             jnp.square(x) is), a block's sums into one row of a
//             (2, rows, C) buffer; bn_reduce_kernel adds the rows in double
//             in a fixed order and forms mean, var = max(E[x^2] - mean^2, 0)
//             and rstd = 1/sqrt(var + eps). Under a data-parallel mesh
//             the same pass writes the moments, mean and E[x^2]
//             (clica_bn_moments); the wrapper averages them over the ranks
//             and hands them back to bn_reduce_kernel as one row of count 1
//             (clica_bn_finish), which forms var and rstd from them in the
//             same arithmetic.
//   apply     bn_apply_kernel<T, M>: y = x*a + b (+ res) (relu), one pass.
//   bwd sums  bn_bwd_kernel<T, M, Q, A>: per channel the sums of g and of
//             g*x (g*x rounded to x's type, as the JAX line's product is),
//             where g = dy * 1[x*a + b > 0] is recomputed in registers for
//             bn_relu, g = dy for bn_only; rows and bn_reduce_kernel as for
//             stats. For bn_add_relu g = dy * 1[y > 0] (the same mask as
//             1[x*a + b + res > 0], read from the output so that res need
//             not be kept), and the same pass writes g, the residual's
//             gradient and dx's input. There dy may come as two addends
//             (A = 2): a block's output feeds the next block's first
//             convolution and its shortcut, whose gradients autograd would
//             otherwise add in a pass of its own (3 passes) before this one
//             read the sum. The kernel adds them in float and rounds once
//             to T, as PyTorch's add does, so g is that sum's g bit for bit;
//             a junction's backward makes 5 + 3 passes where it made 3 + 3
//             + 5.
//   dx        bn_dx_kernel<T, M>: dx = A*g - B*x + C with the per-channel
//             A, B, C of _bn_bwd_core in x's type, g recomputed as above
//             for bn_relu and bn_only; bn_add_relu's dx is bn_only's mode
//             on the g that its sums pass wrote.
//
// The float8 modes (ops/bn_minres8.py, the JAX package's
// cl_ica_tpu/ops/bn_minres8.py) are the same three kernels with Q = true,
// where the backward keeps xq = e4m3fn((x - mean)*rstd), one byte a value,
// in place of x:
//
//   apply     writes xq beside y in the same pass over x: xhat in float
//             ((x - mean) rounded, then *rstd rounded), rounded once to
//             e4m3fn to nearest even; past 464 (the midpoint of 448, the
//             largest value, and the next step) and for infinities and NaN
//             the byte is NaN with xhat's sign, as the JAX package's
//             conversion gives (PyTorch's saturates instead; C9).
//   bwd sums  reads xq (as the value xh it stands for) and dy, and res for
//             bn_add_relu: g = dy * 1[xh*s + t (+ res) > 0], s and t the
//             norm's scale and bias in T (the JAX _mask8), and per channel
//             the sums of g and g*xh.
//   dx        dx = A*g - B*xh + C' with C' = -C of _bwd_core8 (the host
//             negates it), g as above; for bn_add_relu the same pass
//             writes g.
//
// Every value is computed in float and, in bfloat16, rounded to bfloat16
// after each operation, as the plain PyTorch versions beside the wrappers
// do in the tensor's type: products and sums are __fmul_rn/__fadd_rn, never
// contracted into a fused multiply-add, so y, the recomputed relu mask and
// dx equal the plain versions' given the same a, b, A, B, C.
//
// Bound on this card: bytes. Per element, stats reads x once; apply reads x
// (and res) and writes y; the sums read x and dy (and bn_add_relu's second
// addend and y, and write g); dx reads x and dy (or g) and writes dx. The
// operations, under ten per element and value, are far below the bytes at 67
// TFLOP/s. So every kernel is one streaming pass: a thread owns one 16-byte
// vector of channels (4 float32 or 8 bfloat16 values) of a row of C, keeps that
// vector's per-channel factors (and sums) in registers, and walks the positions
// p, p + stride, ..., issuing kUnroll positions' 16-byte loads before it uses
// any. A block's 256 threads take 256 / vectors positions a pass; C of more
// than 256 vectors is cut into evened slices, one per blockIdx.y. The grid is
// the wrapper's (ops/bn_minres.py grid_rows). Sums: a thread adds a pass's
// values in float and folds them into double accumulators; a block adds its
// threads' in a fixed order. No atomics: a run repeats bit for bit.
//
// Shapes: x (P, C) dense, P >= 1 positions, C a multiple of the vector width
// with at most 256 vectors a slice. Index arithmetic is 64-bit (the stem's x
// is 3.3 GB in float32).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // positions a thread loads before it computes

enum Mode { kOnly = 0, kRelu = 1, kAddRelu = 2 };

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
  // a float rounded to the nearest bfloat16 (ties to even), as a float
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// The value of an e4m3fn byte: 2^(e-7) * (1 + m/8), subnormals m * 2^-9,
// S.1111.111 NaN. Exact in float (and in bfloat16).
__device__ __forceinline__ float e4m3_value(unsigned int byte) {
  const unsigned int e = (byte >> 3) & 0xfu, m = byte & 7u;
  float v;
  if (e == 0xfu && m == 7u)
    v = __int_as_float(0x7fc00000);
  else if (e == 0u)
    v = (float)m * 0.001953125f;
  else
    v = __int_as_float((int)(((e + 120u) << 23) | (m << 20)));
  return (byte & 0x80u) ? -v : v;
}

// A float rounded to the nearest e4m3fn byte (ties to even); NaN, with the
// value's sign, past 464, for infinities and for NaN.
__device__ __forceinline__ unsigned int e4m3_byte(float v) {
  if (!(fabsf(v) <= 464.f)) return signbit(v) ? 0xffu : 0x7fu;
  return (unsigned int)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

// V e4m3fn bytes, a vector of xq, as V / 4 32-bit words.
template <int V>
struct QPack {
  static constexpr int W = V / 4;
  struct Raw {
    unsigned int w[W];
  };
  static __device__ __forceinline__ Raw load_raw(const unsigned char* p) {
    Raw r;
    if constexpr (W == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      r.w[0] = u.x;
      r.w[1] = u.y;
    } else {
      r.w[0] = *reinterpret_cast<const unsigned int*>(p);
    }
    return r;
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[V]) {
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * i + k] = e4m3_value((r.w[i] >> (8 * k)) & 0xffu);
  }
  static __device__ __forceinline__ void store(unsigned char* p, const float (&v)[V]) {
    unsigned int w[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = e4m3_byte(v[4 * i]) | (e4m3_byte(v[4 * i + 1]) << 8) |
             (e4m3_byte(v[4 * i + 2]) << 16) | (e4m3_byte(v[4 * i + 3]) << 24);
    if constexpr (W == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<unsigned int*>(p) = w[0];
  }
};

// One operation in T: the float result rounded to T.
template <typename T>
__device__ __forceinline__ float mul(float x, float y) {
  return Pack<T>::round(__fmul_rn(x, y));
}
template <typename T>
__device__ __forceinline__ float add(float x, float y) {
  return Pack<T>::round(__fadd_rn(x, y));
}
template <typename T>
__device__ __forceinline__ float sub(float x, float y) {
  return Pack<T>::round(__fsub_rn(x, y));
}

// The pre-activation x*a + b (+ res) in T, one rounding an operation.
template <typename T, int M>
__device__ __forceinline__ float pre(float x, float a, float b, float r) {
  const float z = add<T>(mul<T>(x, a), b);
  return M == kAddRelu ? add<T>(z, r) : z;
}

// g = dy where the relu passed its input, else 0: for bn_relu from the
// recomputed x*a + b, for bn_add_relu from its output y (r), or with Q from
// xh*a + b + res (r; a, b the scale and bias); dy for bn_only.
template <typename T, int M, bool Q>
__device__ __forceinline__ float masked(float x, float a, float b, float r,
                                        float dy) {
  if (M == kOnly) return dy;
  if (M == kAddRelu && !Q) return r > 0.f ? dy : 0.f;
  return pre<T, M>(x, a, b, r) > 0.f ? dy : 0.f;
}

// Which vector of which positions a thread owns. blockIdx.y is the slice of
// C: gridDim.y slices of cvb vectors (the last may be shorter).
struct Geom {
  int cvb, per, pl, v0, nv, vi, c0;
  bool active;
  __device__ Geom(int cvs, int V) {
    cvb = (cvs + gridDim.y - 1) / gridDim.y;
    v0 = blockIdx.y * cvb;
    nv = min(cvb, cvs - v0);
    per = kThreads / cvb;
    pl = threadIdx.x / cvb;
    vi = threadIdx.x % cvb;
    active = pl < per && vi < nv;
    c0 = (v0 + vi) * V;
  }
};

// Calls f(q, v) for each position q the thread owns, v[i] the V values of
// the first N inputs in[i] at (q, c0..c0+V-1) (with Q, v[0] those of the
// e4m3fn bytes xq, and in[0] unused), then done() after each pass of
// kUnroll positions. The pass's loads are issued before any value is used.
template <typename T, int N, bool Q, typename F, typename D>
__device__ __forceinline__ void walk(const Geom& g, long long P, int C,
                                     const T* const* in, const unsigned char* xq,
                                     F&& f, D&& done) {
  constexpr int V = Pack<T>::V;
  const long long stride = (long long)gridDim.x * g.per;
  for (long long p = (long long)blockIdx.x * g.per + g.pl; p < P;
       p += kUnroll * stride) {
    typename Pack<T>::Raw raw[kUnroll][N];
    typename QPack<V>::Raw qraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * stride;
      if (q < P) {
#pragma unroll
        for (int i = Q ? 1 : 0; i < N; ++i)
          raw[u][i] = Pack<T>::load_raw(in[i] + q * C + g.c0);
        if (Q) qraw[u] = QPack<V>::load_raw(xq + q * C + g.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * stride;
      if (q < P) {
        float v[N][V];
#pragma unroll
        for (int i = Q ? 1 : 0; i < N; ++i) Pack<T>::unpack(raw[u][i], v[i]);
        if (Q) QPack<V>::unpack(qraw[u], v[0]);
        f(q, v);
      }
    }
    done();
  }
}

template <typename T>
__device__ __forceinline__ void load_factor(const T* p, float (&v)[Pack<T>::V]) {
  Pack<T>::unpack(Pack<T>::load_raw(p), v);
}

// V float32 factors (16-byte aligned) into registers.
template <int V>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}

// A block's two sums per channel of its slice into row blockIdx.x of
// partial (2, gridDim.x, C): the threads' double sums added in the order
// of their position lanes.
template <int V>
__device__ __forceinline__ void block_sums(const Geom& g, const double (&s0)[V],
                                           const double (&s1)[V],
                                           float* __restrict__ partial, int C) {
  __shared__ double sh[2][kThreads * V];
  if (g.active) {
#pragma unroll
    for (int l = 0; l < V; ++l) {
      sh[0][(g.pl * g.cvb + g.vi) * V + l] = s0[l];
      sh[1][(g.pl * g.cvb + g.vi) * V + l] = s1[l];
    }
  }
  __syncthreads();
  const int width = g.nv * V;
  for (int t = threadIdx.x; t < width; t += kThreads) {
    double a0 = 0.0, a1 = 0.0;
    for (int r = 0; r < g.per; ++r) {
      a0 += sh[0][r * g.cvb * V + t];
      a1 += sh[1][r * g.cvb * V + t];
    }
    const long long ch = (long long)g.v0 * V + t;
    partial[(long long)blockIdx.x * C + ch] = (float)a0;
    partial[((long long)gridDim.x + blockIdx.x) * C + ch] = (float)a1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                long long P, int C) {
  constexpr int V = Pack<T>::V;
  const Geom g(C / V, V);
  double s0[V], s1[V];
  float f0[V], f1[V];
#pragma unroll
  for (int l = 0; l < V; ++l) s0[l] = s1[l] = 0.0, f0[l] = f1[l] = 0.f;
  if (g.active) {
    const T* const in[1] = {x};
    walk<T, 1, false>(g, P, C, in, nullptr,
        [&](long long, const float (&v)[1][V]) {
#pragma unroll
          for (int l = 0; l < V; ++l) {
            f0[l] = __fadd_rn(f0[l], v[0][l]);
            f1[l] = __fadd_rn(f1[l], mul<T>(v[0][l], v[0][l]));
          }
        },
        [&]() {
#pragma unroll
          for (int l = 0; l < V; ++l) {
            s0[l] += (double)f0[l];
            s1[l] += (double)f1[l];
            f0[l] = f1[l] = 0.f;
          }
        });
  }
  block_sums<V>(g, s0, s1, partial, C);
}

// out[s][c] = the rows of partial[s] added in double in a fixed order
// (eight threads a channel take every eighth row, then their eight totals
// are added in order). With stats kStats, out is (3, C): mean, var, rstd
// of count positions; with kMoments (2, C): mean and E[x^2]; with kSums
// (2, C): the two sums. Rows of count 1 that hold moments turn back into
// the same mean and E[x^2] (t / 1.0 is exact), so kStats over them forms
// var and rstd exactly as it does from the partial sums.
enum { kSums = 0, kStats = 1, kMoments = 2 };

__global__ void bn_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int rows, int C,
                                 long long count, float eps, int stats) {
  __shared__ double part[2][8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  double acc0 = 0.0, acc1 = 0.0;
  if (c < C)
    for (int r = threadIdx.y; r < rows; r += 8) {
      acc0 += (double)partial[(long long)r * C + c];
      acc1 += (double)partial[((long long)rows + r) * C + c];
    }
  part[0][threadIdx.y][threadIdx.x] = acc0;
  part[1][threadIdx.y][threadIdx.x] = acc1;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  double t0 = 0.0, t1 = 0.0;
  for (int r = 0; r < 8; ++r) {
    t0 += part[0][r][threadIdx.x];
    t1 += part[1][r][threadIdx.x];
  }
  if (stats == kSums) {
    out[c] = (float)t0;
    out[C + c] = (float)t1;
    return;
  }
  const float mean = (float)(t0 / (double)count);
  const float mean2 = (float)(t1 / (double)count);
  if (stats == kMoments) {
    out[c] = mean;
    out[C + c] = mean2;
    return;
  }
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  out[c] = mean;
  out[C + c] = var;
  out[2 * C + c] = 1.f / sqrtf(__fadd_rn(var, eps));
}

// With Q, xq = e4m3fn((x - mean)*rstd) is written too; mean and rstd are
// (C,) float.
template <typename T, int M, bool Q>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ y, const float* __restrict__ mean,
                const float* __restrict__ rstd, unsigned char* __restrict__ xq,
                long long P, int C) {
  constexpr int V = Pack<T>::V;
  const Geom g(C / V, V);
  if (!g.active) return;
  float av[V], bv[V], mv[V], rv[V];
  load_factor(a + g.c0, av);
  load_factor(b + g.c0, bv);
  if (Q) {
    load_floats(mean + g.c0, mv);
    load_floats(rstd + g.c0, rv);
  }
  constexpr int N = M == kAddRelu ? 2 : 1;  // x (and res)
  const T* const in[2] = {x, res};
  walk<T, N, false>(g, P, C, in, nullptr,
      [&](long long q, const float (&v)[N][V]) {
        float out[V];
#pragma unroll
        for (int l = 0; l < V; ++l) {
          const float z = pre<T, M>(v[0][l], av[l], bv[l], v[N - 1][l]);
          out[l] = (M == kOnly || z > 0.f) ? z : 0.f;
        }
        Pack<T>::store(y + q * C + g.c0, out);
        if (Q) {
          float xh[V];
#pragma unroll
          for (int l = 0; l < V; ++l)
            xh[l] = __fmul_rn(__fsub_rn(v[0][l], mv[l]), rv[l]);
          QPack<V>::store(xq + q * C + g.c0, xh);
        }
      },
      [] {});
}

// y is the forward's output, read for bn_add_relu only, where g is
// written to gout and, with A = 2, dy is dy + dyr rounded to T; with Q, x
// is not read but xq, y is bn_add_relu's res, a and b the scale and bias,
// and g is not written (bn_dx8 writes it).
template <typename T, int M, bool Q, int A = 1>
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const T* __restrict__ dyr, const T* __restrict__ y,
              const T* __restrict__ a, const T* __restrict__ b,
              float* __restrict__ partial, T* __restrict__ gout,
              const unsigned char* __restrict__ xq, long long P, int C) {
  constexpr int V = Pack<T>::V;
  constexpr bool kWritesG = M == kAddRelu && !Q;
  const Geom g(C / V, V);
  double s0[V], s1[V];
  float f0[V], f1[V], av[V], bv[V];
#pragma unroll
  for (int l = 0; l < V; ++l) s0[l] = s1[l] = 0.0, f0[l] = f1[l] = 0.f;
  if (g.active) {
    load_factor(a + g.c0, av);
    load_factor(b + g.c0, bv);
    // x, dy (, dyr) (and y or res)
    constexpr int N = (M == kAddRelu ? 3 : 2) + A - 1;
    const T* const in[4] = {x, dy, A == 2 ? dyr : y, y};
    walk<T, N, Q>(g, P, C, in, xq,
        [&](long long q, const float (&v)[N][V]) {
          float gw[V];
#pragma unroll
          for (int l = 0; l < V; ++l) {
            const float d = A == 2 ? add<T>(v[1][l], v[2][l]) : v[1][l];
            gw[l] = masked<T, M, Q>(v[0][l], av[l], bv[l], v[N - 1][l], d);
            f0[l] = __fadd_rn(f0[l], gw[l]);
            f1[l] = __fadd_rn(f1[l], mul<T>(gw[l], v[0][l]));
          }
          if (kWritesG) Pack<T>::store(gout + q * C + g.c0, gw);
        },
        [&]() {
#pragma unroll
          for (int l = 0; l < V; ++l) {
            s0[l] += (double)f0[l];
            s1[l] += (double)f1[l];
            f0[l] = f1[l] = 0.f;
          }
        });
  }
  block_sums<V>(g, s0, s1, partial, C);
}

// k is (3, C) in T: the rows A, B and C of dx = A*g - B*x + C. The add
// mode is Q's alone: y is then bn_add_relu's res, x is xq's value (C the
// negated C of _bwd_core8), and g is written too.
template <typename T, int M, bool Q>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             const T* __restrict__ y, const T* __restrict__ a,
             const T* __restrict__ b, const T* __restrict__ k,
             T* __restrict__ dx, T* __restrict__ gout,
             const unsigned char* __restrict__ xq, long long P, int C) {
  constexpr int V = Pack<T>::V;
  const Geom g(C / V, V);
  if (!g.active) return;
  float av[V], bv[V], kA[V], kB[V], kC[V];
  load_factor(a + g.c0, av);
  load_factor(b + g.c0, bv);
  load_factor(k + g.c0, kA);
  load_factor(k + C + g.c0, kB);
  load_factor(k + 2 * C + g.c0, kC);
  constexpr int N = M == kAddRelu ? 3 : 2;  // x, dy (and, with Q, res)
  const T* const in[3] = {x, dy, y};
  walk<T, N, Q>(g, P, C, in, xq,
      [&](long long q, const float (&v)[N][V]) {
        float out[V], gv[V];
#pragma unroll
        for (int l = 0; l < V; ++l) {
          gv[l] = masked<T, M, Q>(v[0][l], av[l], bv[l], v[N - 1][l], v[1][l]);
          out[l] = add<T>(sub<T>(mul<T>(kA[l], gv[l]), mul<T>(kB[l], v[0][l])),
                          kC[l]);
        }
        Pack<T>::store(dx + q * C + g.c0, out);
        if (M == kAddRelu) Pack<T>::store(gout + q * C + g.c0, gv);
      },
      [] {});
}

// Slices of C: vectors in the fewest slices of at most kThreads, evened.
inline int slices_of(int cvs) { return (cvs + kThreads - 1) / kThreads; }

inline bool bad_shape(long long P, int C, int V, int grid) {
  return P < 1 || C < V || (C % V) || grid < 1 || grid > 0x7fffffff / 2;
}

template <typename T>
int launch_stats(const void* x, float* partial, float* out, long long P, int C,
                 int grid, float eps, int moments, cudaStream_t st) {
  const dim3 blocks(grid, slices_of(C / Pack<T>::V));
  bn_stats_kernel<T><<<blocks, kThreads, 0, st>>>((const T*)x, partial, P, C);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  bn_reduce_kernel<<<(C + 31) / 32, dim3(32, 8), 0, st>>>(
      partial, out, grid, C, P, eps, moments ? kMoments : kStats);
  return (int)cudaGetLastError();
}

template <typename T, int M, bool Q>
int launch_apply(const void* x, const void* res, const void* a, const void* b,
                 void* y, const float* mean, const float* rstd, void* xq,
                 long long P, int C, int grid, cudaStream_t st) {
  const dim3 blocks(grid, slices_of(C / Pack<T>::V));
  bn_apply_kernel<T, M, Q><<<blocks, kThreads, 0, st>>>(
      (const T*)x, (const T*)res, (const T*)a, (const T*)b, (T*)y, mean, rstd,
      (unsigned char*)xq, P, C);
  return (int)cudaGetLastError();
}

template <typename T, int M, bool Q, int A = 1>
int launch_bwd(const void* x, const void* dy, const void* dyr, const void* y,
               const void* a, const void* b, float* partial, float* sums,
               void* g, const void* xq, long long P, int C, int grid,
               cudaStream_t st) {
  const dim3 blocks(grid, slices_of(C / Pack<T>::V));
  bn_bwd_kernel<T, M, Q, A><<<blocks, kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, (const T*)dyr, (const T*)y, (const T*)a,
      (const T*)b, partial, (T*)g, (const unsigned char*)xq, P, C);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  bn_reduce_kernel<<<(C + 31) / 32, dim3(32, 8), 0, st>>>(partial, sums, grid,
                                                          C, P, 0.f, kSums);
  return (int)cudaGetLastError();
}

template <typename T, int M, bool Q>
int launch_dx(const void* x, const void* dy, const void* y, const void* a,
              const void* b, const void* k, void* dx, void* g, const void* xq,
              long long P, int C, int grid, cudaStream_t st) {
  const dim3 blocks(grid, slices_of(C / Pack<T>::V));
  bn_dx_kernel<T, M, Q><<<blocks, kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, (const T*)y, (const T*)a, (const T*)b,
      (const T*)k, (T*)dx, (T*)g, (const unsigned char*)xq, P, C);
  return (int)cudaGetLastError();
}

// Each entry point below takes the mode (0 bn_only, 1 bn_relu,
// 2 bn_add_relu) and the type, and calls one of six instances: those of Q
// false, or (the ..8 entry points) of Q true. clica_bn_dx has no add mode
// (CLICA_BN_CASES alone): bn_add_relu's dx is bn_only's on g.
#define CLICA_BN_CASES(fn, Q, ...)                                          \
    case 0: return fn<float, kOnly, Q>(__VA_ARGS__);                        \
    case 1: return fn<__nv_bfloat16, kOnly, Q>(__VA_ARGS__);                \
    case 2: return fn<float, kRelu, Q>(__VA_ARGS__);                        \
    case 3: return fn<__nv_bfloat16, kRelu, Q>(__VA_ARGS__);
#define CLICA_BN_DISPATCH(fn, Q, ...)                                       \
  switch (mode * 2 + (is_bf16 ? 1 : 0)) {                                   \
    CLICA_BN_CASES(fn, Q, __VA_ARGS__)                                      \
    case 4: return fn<float, kAddRelu, Q>(__VA_ARGS__);                     \
    case 5: return fn<__nv_bfloat16, kAddRelu, Q>(__VA_ARGS__);             \
    default: return (int)cudaErrorInvalidValue;                             \
  }

inline int vec_of(int is_bf16) { return is_bf16 ? 8 : 4; }

}  // namespace

extern "C" {

// mean, var and rstd of x (P, C) into out (3, C) float; partial is a
// (2, grid, C) float buffer.
int clica_bn_stats(const void* x, float* partial, float* out, long long P,
                   int C, int is_bf16, int grid, float eps, void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_stats<__nv_bfloat16>(x, partial, out, P, C, grid,
                                               eps, 0, st)
                 : launch_stats<float>(x, partial, out, P, C, grid, eps, 0, st);
}

// The same pass with the moments, mean and E[x^2] of x (P, C), into out
// (2, C) float: what a data-parallel mesh averages over its ranks.
int clica_bn_moments(const void* x, float* partial, float* out, long long P,
                     int C, int is_bf16, int grid, void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_stats<__nv_bfloat16>(x, partial, out, P, C, grid,
                                               0.f, 1, st)
                 : launch_stats<float>(x, partial, out, P, C, grid, 0.f, 1, st);
}

// mean, var and rstd into out (3, C) float from moments (2, C): mean and
// E[x^2], as clica_bn_moments writes them (averaged over the ranks of a
// mesh in between).
int clica_bn_finish(const float* moments, float* out, int C, float eps,
                    void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  bn_reduce_kernel<<<(C + 31) / 32, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      moments, out, 1, C, 1, eps, kStats);
  return (int)cudaGetLastError();
}

// y = x*a + b (mode 0), relu of it (1), relu(x*a + b + res) (2); a and b
// (C,) in x's type, res read in mode 2 only.
int clica_bn_apply(const void* x, const void* res, const void* a,
                   const void* b, void* y, long long P, int C, int is_bf16,
                   int mode, int grid, void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CLICA_BN_DISPATCH(launch_apply, false, x, res, a, b, y, nullptr, nullptr,
                    nullptr, P, C, grid, st)
}

// The sums of g and of g*x into sums (2, C) float; partial is a (2, grid, C)
// float buffer. In mode 2 only: y, the forward's output, is read, g (P, C)
// is written, and dyr, where not null, is dy's second addend.
int clica_bn_bwd(const void* x, const void* dy, const void* dyr, const void* y,
                 const void* a, const void* b, float* partial, float* sums,
                 void* g, long long P, int C, int is_bf16, int mode, int grid,
                 void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dyr != nullptr) {
    if (mode != kAddRelu) return (int)cudaErrorInvalidValue;
    return is_bf16 ? launch_bwd<__nv_bfloat16, kAddRelu, false, 2>(
                         x, dy, dyr, y, a, b, partial, sums, g, nullptr, P, C,
                         grid, st)
                   : launch_bwd<float, kAddRelu, false, 2>(
                         x, dy, dyr, y, a, b, partial, sums, g, nullptr, P, C,
                         grid, st);
  }
  CLICA_BN_DISPATCH(launch_bwd, false, x, dy, nullptr, y, a, b, partial, sums,
                    g, nullptr, P, C, grid, st)
}

// dx = A*g - B*x + C with k = (A, B, C) (3, C) in x's type, g = dy (mode 0)
// or dy masked by the recomputed relu (mode 1).
int clica_bn_dx(const void* x, const void* dy, const void* a, const void* b,
                const void* k, void* dx, long long P, int C, int is_bf16,
                int mode, int grid, void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode * 2 + (is_bf16 ? 1 : 0)) {
    CLICA_BN_CASES(launch_dx, false, x, dy, nullptr, a, b, k, dx, nullptr,
                   nullptr, P, C, grid, st)
    default: return (int)cudaErrorInvalidValue;
  }
}

// The float8 modes (minres8). clica_bn_apply's y, and xq (P, C) bytes of
// e4m3fn((x - mean)*rstd); mean and rstd (C,) float.
int clica_bn_apply8(const void* x, const void* res, const void* a,
                    const void* b, const float* mean, const float* rstd,
                    void* y, void* xq, long long P, int C, int is_bf16,
                    int mode, int grid, void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CLICA_BN_DISPATCH(launch_apply, true, x, res, a, b, y, mean, rstd, xq, P, C,
                    grid, st)
}

// The sums of g and of g*xh into sums (2, C) float, xh the value of xq's
// bytes; s and t (C,) the scale and bias in dy's type; res is read in mode 2
// only.
int clica_bn_bwd8(const void* xq, const void* dy, const void* res,
                  const void* s, const void* t, float* partial, float* sums,
                  long long P, int C, int is_bf16, int mode, int grid,
                  void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CLICA_BN_DISPATCH(launch_bwd, true, nullptr, dy, nullptr, res, s, t,
                    partial, sums, nullptr, xq, P, C, grid, st)
}

// dx = A*g - B*xh + C' with k = (A, B, C') (3, C) in dy's type; in mode 2 g
// is written too, and res read as for clica_bn_bwd8.
int clica_bn_dx8(const void* xq, const void* dy, const void* res,
                 const void* s, const void* t, const void* k, void* dx,
                 void* g, long long P, int C, int is_bf16, int mode, int grid,
                 void* stream) {
  if (bad_shape(P, C, vec_of(is_bf16), grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CLICA_BN_DISPATCH(launch_dx, true, nullptr, dy, res, s, t, k, dx, g, xq, P,
                    C, grid, st)
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
