// The ResNet stem tail, fused: per-channel affine (the folded batch norm),
// relu and the 3x3 stride-2 max pool with padding 1, forward and backward,
// for sm_90a.
//
// Replaces the two TPU kernels of cl_ica_tpu/ops/stem_pallas.py: _fwd_kernel
// (:223) and _bwd_kernel (:235). They compute the same function; nothing of
// their shape is kept. The TPU version views x as (H, W/2, 2C), shifts with
// roll-and-mask and factorises the argmax into a W stage and an H stage
// because of the TPU's tiling; its grid runs in order and carries the
// channel sums from image to image. Here C is the fastest axis of dense
// NHWC memory, a thread owns a vector of 16 bytes of channels, and blocks
// run in no order.
//
//   forward   out[n,i,j,c] = max over the window rows 2i-1..2i+1, columns
//             2j-1..2j+1 inside the image of relu(x*a[c] + b[c]); one thread
//             per output position and channel vector, nine loads of x, the
//             overlap of neighbouring windows served by the caches. The
//             maximum starts at 0: the relu'd values are >= 0, so zero
//             padding is exact.
//   backward  a gather, not a scatter: two windows share an input position
//             on odd rows and on odd columns, so a thread per window that
//             wrote its winner's position would race. A block owns a tile
//             of 8x8 quads of one image, a quad being the 2x2 input
//             positions (2k..2k+1, 2j..2j+1), which only the four windows
//             (k..k+1, j..j+1) reach. First the block recomputes the winner
//             of each of the tile's 9x9 windows once (first wins: strict >,
//             row-major over the window) and keeps it as one byte a channel
//             in shared memory. Then a thread per quad and channel vector
//             adds to each of its four positions the g of the windows it
//             won, the windows taken in one fixed order; then the relu mask
//             y > 0; dy is written in g's type. Each block also sums dy and
//             dy*xhat per channel over its positions in a fixed order into
//             one row of a (rows, C) buffer, and stem_reduce_kernel adds
//             the rows in a fixed order. No atomics: a run repeats bit for
//             bit. Channels beyond 256 go to further blocks (blockIdx.y).
//
// All arithmetic is float32 whatever x's type: y = x*a + b as a rounded
// product and a rounded sum (no fused multiply-add), so that the plain
// PyTorch version beside the wrapper (ops/stem.py) repeats it bit for bit.
//
// Bound on this card: bytes. The forward must read x and write a quarter of
// it; the backward must read x and g and write dy; a few tens of operations
// per element set nothing. The forward reads each x about once from device
// memory (2.25 loads per element, the rest from L1/L2). The backward's
// first phase issues 2.25 * (9/8)^2 loads per element for the winners and
// its second phase one more for the mask and xhat; a first version that
// recomputed four windows per quad issued nine and ran at a quarter of its
// bound.
//
// Shapes: any N; H and W even; C a multiple of the vector width (4 float32,
// 8 bfloat16) with at most 256 vectors. Index arithmetic is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;          // the widest vector (bfloat16)
constexpr int kMaxSumRows = 2048;   // rows of the partial-sum buffer, at most
constexpr int kTile = 8;            // quads along each side of a block's tile
constexpr int kWin = kTile + 1;     // windows along each side of it
constexpr int kChunk = 256;         // channels of one block (blockIdx.y picks)

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
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
};

// x*a + b with both roundings, never contracted into a fused multiply-add.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// V winners, one byte each, to and from shared memory as 32-bit words.
template <int V>
__device__ __forceinline__ void store_winners(unsigned char* dst,
                                              const unsigned char (&arg)[V]) {
  unsigned int* words = reinterpret_cast<unsigned int*>(dst);
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    words[i] = arg[4 * i] | (arg[4 * i + 1] << 8) | (arg[4 * i + 2] << 16) |
               (arg[4 * i + 3] << 24);
}

template <int V>
__device__ __forceinline__ void load_winners(const unsigned char* src,
                                             unsigned char (&arg)[V]) {
  const unsigned int* words = reinterpret_cast<const unsigned int*>(src);
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const unsigned int word = words[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) arg[4 * i + k] = (word >> (8 * k)) & 0xffu;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                const T* __restrict__ b, T* __restrict__ out, long long total,
                int H, int W, int C) {
  constexpr int V = Pack<T>::V;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int cvs = C / V, Ho = H / 2, Wo = W / 2;
  const int c0 = (int)(idx % cvs) * V;
  long long rest = idx / cvs;
  const int wo = (int)(rest % Wo);
  rest /= Wo;
  const int ho = (int)(rest % Ho);
  const long long n = rest / Ho;

  float av[V], bv[V], m[V];
  Pack<T>::load(a + c0, av);
  Pack<T>::load(b + c0, bv);
#pragma unroll
  for (int l = 0; l < V; ++l) m[l] = 0.f;
  const T* xn = x + n * H * W * C;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int h = 2 * ho - 1 + dh;
    if (h < 0 || h >= H) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int w = 2 * wo - 1 + dw;
      if (w < 0 || w >= W) continue;
      float xv[V];
      Pack<T>::load(xn + ((long long)h * W + w) * C + c0, xv);
#pragma unroll
      for (int l = 0; l < V; ++l)
        m[l] = fmaxf(m[l], affine(xv[l], av[l], bv[l]));
    }
  }
  Pack<T>::store(out + ((n * Ho + ho) * Wo + wo) * C + c0, m);
}

// The winner of window (ho, wo) per channel: its row-major index dh*3+dw,
// the first position to reach the maximum. Positions outside the image do
// not take part.
template <typename T>
__device__ __forceinline__ void window_winner(
    const T* __restrict__ xn, int ho, int wo, int H, int W, int C, int c0,
    const float (&av)[Pack<T>::V], const float (&bv)[Pack<T>::V],
    unsigned char (&arg)[Pack<T>::V]) {
  constexpr int V = Pack<T>::V;
  float m[V];
#pragma unroll
  for (int l = 0; l < V; ++l) {
    m[l] = -1.f;  // below every relu'd value: the first position is taken
    arg[l] = 0;
  }
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int h = 2 * ho - 1 + dh;
    if (h < 0 || h >= H) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int w = 2 * wo - 1 + dw;
      if (w < 0 || w >= W) continue;
      float xv[V];
      Pack<T>::load(xn + ((long long)h * W + w) * C + c0, xv);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const float z = fmaxf(affine(xv[l], av[l], bv[l]), 0.f);
        if (z > m[l]) {  // strict: a tie keeps the earlier position
          m[l] = z;
          arg[l] = (unsigned char)(dh * 3 + dw);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                T* __restrict__ dy, float* __restrict__ partial,
                long long tiles, int H, int W, int C, int rows) {
  constexpr int V = Pack<T>::V;
  __shared__ float red[2][kThreads * kMaxVec];
  __shared__ __align__(16) unsigned char win[kWin * kWin][kChunk];
  const int Ho = H / 2, Wo = W / 2;
  const int th = (Ho + kTile - 1) / kTile, tw = (Wo + kTile - 1) / kTile;
  const int cbeg = blockIdx.y * kChunk;           // this block's channels
  const int cn = min(kChunk, C - cbeg);
  const int cvs = cn / V;
  const int qpb = kThreads / cvs;  // windows or quads of one pass of the block
  const int cv = threadIdx.x % cvs;
  const int ql = threadIdx.x / cvs;
  const int cl = cv * V;           // first channel of this thread in the chunk
  const int c0 = cbeg + cl;        // and in the tensor
  const bool active = ql < qpb;

  float av[V], bv[V], mu[V], rs[V], sb[V], sg[V];
#pragma unroll
  for (int l = 0; l < V; ++l) sb[l] = sg[l] = 0.f;
  if (active) {
    Pack<T>::load(a + c0, av);
    Pack<T>::load(b + c0, bv);
#pragma unroll
    for (int l = 0; l < V; ++l) {
      mu[l] = mean[c0 + l];
      rs[l] = rstd[c0 + l];
    }
  }
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (int)(tile % tw) * kTile;
    const int k0 = (int)((tile / tw) % th) * kTile;
    const long long n = tile / ((long long)tw * th);
    const T* xn = x + n * H * W * C;
    const T* gn = g + n * Ho * Wo * C;
    T* dyn = dy + n * H * W * C;

    // the winners of the tile's windows (k0..k0+8, j0..j0+8), once each
    if (active) {
      for (int wi = ql; wi < kWin * kWin; wi += qpb) {
        const int k = k0 + wi / kWin, j = j0 + wi % kWin;
        if (k >= Ho || j >= Wo) continue;
        unsigned char arg[V];
        window_winner<T>(xn, k, j, H, W, C, c0, av, bv, arg);
        store_winners<V>(win[wi] + cl, arg);
      }
    }
    __syncthreads();

    if (active) {
      for (int qi = ql; qi < kTile * kTile; qi += qpb) {
        const int kl = qi / kTile, jl = qi % kTile;
        const int k = k0 + kl, j = j0 + jl;
        if (k >= Ho || j >= Wo) continue;
        // dz of the four positions (2k,2j) (2k,2j+1) (2k+1,2j) (2k+1,2j+1).
        // The windows come in the order (k+1,j+1), (k+1,j), (k,j+1), (k,j):
        // the order of the terms of the specification's sums.
        float dz[4][V], gv[V];
        unsigned char arg[V];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int l = 0; l < V; ++l) dz[p][l] = 0.f;

        if (k + 1 < Ho && j + 1 < Wo) {
          load_winners<V>(win[(kl + 1) * kWin + jl + 1] + cl, arg);
          Pack<T>::load(gn + ((long long)(k + 1) * Wo + (j + 1)) * C + c0, gv);
#pragma unroll
          for (int l = 0; l < V; ++l)
            if (arg[l] == 0) dz[3][l] += gv[l];
        }
        if (k + 1 < Ho) {
          load_winners<V>(win[(kl + 1) * kWin + jl] + cl, arg);
          Pack<T>::load(gn + ((long long)(k + 1) * Wo + j) * C + c0, gv);
#pragma unroll
          for (int l = 0; l < V; ++l) {
            if (arg[l] == 1) dz[2][l] += gv[l];
            if (arg[l] == 2) dz[3][l] += gv[l];
          }
        }
        if (j + 1 < Wo) {
          load_winners<V>(win[kl * kWin + jl + 1] + cl, arg);
          Pack<T>::load(gn + ((long long)k * Wo + (j + 1)) * C + c0, gv);
#pragma unroll
          for (int l = 0; l < V; ++l) {
            if (arg[l] == 3) dz[1][l] += gv[l];
            if (arg[l] == 6) dz[3][l] += gv[l];
          }
        }
        {
          load_winners<V>(win[kl * kWin + jl] + cl, arg);
          Pack<T>::load(gn + ((long long)k * Wo + j) * C + c0, gv);
#pragma unroll
          for (int l = 0; l < V; ++l) {
            if (arg[l] == 4) dz[0][l] += gv[l];
            if (arg[l] == 5) dz[1][l] += gv[l];
            if (arg[l] == 7) dz[2][l] += gv[l];
            if (arg[l] == 8) dz[3][l] += gv[l];
          }
        }

#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int h = 2 * k + p / 2, w = 2 * j + p % 2;
          const long long at = ((long long)h * W + w) * C + c0;
          float xv[V], out[V];
          Pack<T>::load(xn + at, xv);
#pragma unroll
          for (int l = 0; l < V; ++l) {
            const float y = affine(xv[l], av[l], bv[l]);
            out[l] = y > 0.f ? dz[p][l] : 0.f;
            sb[l] += out[l];
            sg[l] += out[l] * ((xv[l] - mu[l]) * rs[l]);
          }
          Pack<T>::store(dyn + at, out);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the winners
  }

  // The block's sums per channel: thread rows ql = 0.. in order.
  if (active) {
#pragma unroll
    for (int l = 0; l < V; ++l) {
      red[0][ql * cn + cl + l] = sb[l];
      red[1][ql * cn + cl + l] = sg[l];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cn; c += kThreads) {
    float tb = 0.f, tg = 0.f;
    for (int r = 0; r < qpb; ++r) {
      tb += red[0][r * cn + c];
      tg += red[1][r * cn + c];
    }
    partial[(long long)blockIdx.x * C + cbeg + c] = tb;
    partial[((long long)rows + blockIdx.x) * C + cbeg + c] = tg;
  }
}

// sums[s][c] = the rows of partial[s] added in a fixed order (in double):
// eight threads per channel take every eighth row, then their eight totals
// are added in order.
__global__ void stem_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ sums, int rows, int C) {
  __shared__ double part[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int s = blockIdx.y;
  double acc = 0.0;
  if (c < C)
    for (int r = threadIdx.y; r < rows; r += 8)
      acc += (double)partial[((long long)s * rows + r) * C + c];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    double total = 0.0;
    for (int r = 0; r < 8; ++r) total += part[r][threadIdx.x];
    sums[s * C + c] = (float)total;
  }
}

inline bool bad_shape(long long n, int h, int w, int c, int vec) {
  return n < 1 || h < 2 || w < 2 || (h % 2) || (w % 2) || c < vec ||
         (c % vec) || c / vec > kThreads;
}

inline long long tile_count(long long n, int h, int w) {
  return n * ((h / 2 + kTile - 1) / kTile) * ((w / 2 + kTile - 1) / kTile);
}

inline int sum_rows(long long n, int h, int w) {
  const long long need = tile_count(n, h, w);
  return (int)(need < kMaxSumRows ? need : kMaxSumRows);
}

template <typename T>
int launch_fwd(const void* x, const void* a, const void* b, void* out,
               long long n, int h, int w, int c, cudaStream_t st) {
  const long long total = n * (h / 2) * (w / 2) * (c / Pack<T>::V);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stem_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const T*)x, (const T*)a, (const T*)b, (T*)out, total, h, w, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* a, const void* b,
               const float* mean, const float* rstd, void* dy, float* partial,
               float* sums, long long n, int h, int w, int c,
               cudaStream_t st) {
  const int rows = sum_rows(n, h, w);
  const dim3 grid(rows, (c + kChunk - 1) / kChunk);
  stem_bwd_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)g, (const T*)a, (const T*)b, mean, rstd, (T*)dy,
      partial, tile_count(n, h, w), h, w, c, rows);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  stem_reduce_kernel<<<dim3((c + 31) / 32, 2), dim3(32, 8), 0, st>>>(
      partial, sums, rows, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the (2, rows, C) float32 partial-sum buffer that clica_stem_bwd
// needs for this shape, or -1 for a shape the kernels do not take.
int clica_stem_sum_rows(long long n, int h, int w, int c, int is_bf16) {
  const int vec = is_bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (bad_shape(n, h, w, c, vec)) return -1;
  return sum_rows(n, h, w);
}

int clica_stem_fwd(const void* x, const void* a, const void* b, void* out,
                   long long n, int h, int w, int c, int is_bf16,
                   void* stream) {
  const int vec = is_bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (bad_shape(n, h, w, c, vec)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, a, b, out, n, h, w, c, st)
                 : launch_fwd<float>(x, a, b, out, n, h, w, c, st);
}

int clica_stem_bwd(const void* x, const void* g, const void* a, const void* b,
                   const float* mean, const float* rstd, void* dy,
                   float* partial, float* sums, long long n, int h, int w,
                   int c, int is_bf16, void* stream) {
  const int vec = is_bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (bad_shape(n, h, w, c, vec)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, g, a, b, mean, rstd, dy,
                                             partial, sums, n, h, w, c, st)
                 : launch_bwd<float>(x, g, a, b, mean, rstd, dy, partial,
                                     sums, n, h, w, c, st);
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
