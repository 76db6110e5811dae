// The ResNet stem tail, fused: per-channel affine (the folded batch norm),
// relu and the 3x3 stride-2 max pool with padding 1, forward and backward,
// for sm_90a.
//
// Replaces the two TPU kernels of cl_ica_tpu/ops/stem_pallas.py: _fwd_kernel
// (:223) and _bwd_kernel (:235), and the XLA pass that finishes the
// backward there (:429-434, dx). They compute the same functions; nothing of
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
//   backward  stem_bwd_kernel: dy, the pooled gradient g routed to each
//             window's winner (first wins: strict >, row-major over the
//             window; positions outside the image never win) under the relu
//             mask, and per channel the sums of dy and dy*xhat. A gather,
//             not a scatter: a thread owns a window column j and a channel
//             vector, computes the winner of window (k+1, j) and then dy of
//             the quad (k, j), the input positions (2k..2k+1, 2j..2j+1),
//             which only the four windows (k..k+1, j..j+1) reach. The g of
//             those windows is added in one fixed order, the order of the
//             terms of the specification's sums (ops/stem.py), so dy equals
//             the plain version bit for bit. The winner is found row by row:
//             each row's first maximum, then the first row whose maximum is
//             the window's, which is the row-major scan's first maximum. A
//             window's bottom row is the next window's top row, so a thread
//             carries it from step to step and reads two rows, not three;
//             those two rows are quad (k+1, j)'s, and their relu mask is
//             carried too, as bits.
//   dx        stem_dx_kernel: dx = k1*dy + (-k2) + (x - mean)*(-k3*rstd),
//             one pass over x and dy with the per-channel factors in
//             registers, each product and sum rounded (no fused multiply-add),
//             rounded once to x's type: stem_dx_reference repeats it.
//
// Two more for ResNet(stem_pool='argmax') (ops/pool_minres.py, the JAX
// package's cl_ica_tpu/ops/pool_minres.py, an XLA custom VJP there):
//
//   code      pool_code_kernel: the forward's function with z = relu(x*a +
//             b) rounded to T after each operation (the minres norm's
//             arithmetic, bn_minres.cu), which also writes a byte a value:
//             the row-major position 0..8 in the padded 3x3 window of the
//             first maximum (positions outside the image never win; a 0
//             after the relu is a value, so an all-zero window's code is
//             its first position inside the image). Staged and walked as
//             the backward is (below): z is computed once an input element.
//   scatter   pool_scatter_kernel: dz (N, H, W, C) from the pooled gradient
//             and the codes, a gather: a thread owns a quad (2m..2m+1,
//             2j..2j+1) and a channel vector and reads the four windows
//             (m..m+1, j..j+1) that reach it, adding for each position the
//             gradients of the windows whose code names it, in the order
//             of the JAX stencil's terms (_dz_stencil: the window above
//             before the one below, the left before the right), each sum
//             rounded to T: pool_scatter_reference repeats it bit for bit.
//
// All arithmetic is float32 whatever x's type: y = x*a + b as a rounded
// product and a rounded sum (no fused multiply-add), so that the plain
// PyTorch versions beside the wrappers (ops/stem.py) repeat it bit for bit.
//
// Bound on this card: bytes. The forward must read x and write a quarter of
// it; the backward must read x and g and write dy, 2.25 * elements * size;
// dx reads x and dy and writes dx, 3 * elements * size. The operations, a
// few tens per element, are below the bytes at 67 TFLOP/s, but not by much
// in bfloat16: the backward's code has to stay lean, and a thread works on
// its vector four lanes at a time, so that bfloat16's eight lanes do not
// hold twice float32's registers (at 128 a thread, two blocks an SM). The
// code must read x and write a quarter of it and a byte a pooled value. In
// bfloat16 the forward's shape, a thread a window with nine z's a value
// each rounded twice, is bound by its instruction rate, not by bytes
// (about 90 instructions an output value, 1.47 ms against 0.675 at the
// main path's shape): so the code kernel computes each z once (below).
//
// The backward's design. A block owns a tile, one strip of ws window
// columns of one image, a slice of cv channel vectors and a segment of ks
// quad rows, and walks down it a quad row at a time. A stage of its ring
// in shared memory holds x rows 2s, 2s+1 across the strip (with the one
// column of halo on the left and two on the right that its windows reach)
// and g row s; a step k uses stages k and k+1: the winners of window row
// k+1 (x rows 2k+1..2k+3), then dy of quad row k. The stages come in by
// bulk copies (cp.async.bulk, async_copy.cuh) that complete on one mbarrier
// a slot, issued by one warp kStages - 2 steps ahead of their use, across
// the end of a tile into the next, so the copy engine streams the next rows
// while the threads compute; every x element and every g is fetched from
// device memory once (the halo columns and a segment's first row aside)
// and read from shared memory after. The winners of a window row are
// computed once, kept as one byte a channel in shared memory and read by
// the two quad rows and two quad columns that share them. The grid is
// persistent, (the card's resident blocks / slices) x slices, and block b
// takes tiles b, b + grid, ... in that fixed order, neighbouring strips on
// neighbouring blocks, so their halo columns meet in L2. Each thread adds
// its dy and dy*(x - mean) in float, per tile in registers and then across
// tiles in shared memory, a block its threads' sums in a fixed order into
// one row of a (2, rows, C) buffer, and stem_reduce_kernel adds the rows
// in double in a fixed order.
// No atomics: a run repeats bit for bit. The plan (slices, strips,
// segments, tiles and the grid) is the wrapper's (ops/stem.py bwd_plan),
// which the kernel walks as given after a check that it covers the map once;
// the dx grid is the wrapper's too. The edges of the image are masked by
// index, never by what a slot holds.
//
// The code kernel's design. It walks the backward's kind of tiles on the
// backward's kind of persistent grid (the wrapper's pool_code_plan, checked
// the same way), one stage a step: a stage holds x rows 2s and 2s+1
// across the strip, with the one halo column on the left that its windows
// reach, and step k takes stage k, the two rows of window row k below its
// top row; a tile's first step takes only row 2 k0 - 1 of stage k0 - 1. A
// thread owns a window column j and a channel vector: it turns its columns
// 2j and 2j+1 of each row into z once (in bfloat16 one cvt.rn.bf16x2.f32
// rounds two lanes) and hands column 2j+1 to the thread of window j+1
// through shared memory (one more row of threads turns the halo column);
// then each row's first maximum over columns 2j-1..2j+1 and its column,
// and the window's from its rows, as the backward finds its winner. The
// window's bottom row is the next window's top row: a thread carries its
// maximum and column from step to step. Values are compared in T, two
// bfloat16 lanes a compare (set.gt.u32.bf16x2), and values and codes are
// selected by the compare's mask, so that a word of two bfloat16 lanes
// costs what one float lane does. One barrier a step: the hand-over
// buffer alternates between two halves. x is read from device memory once
// (the halo columns and a segment's row above aside).
//
// Shapes: any N; H and W even; C a multiple of the vector width (4 float32,
// 8 bfloat16) with at most 256 vectors. Index arithmetic is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using clica::bulk_load;
using clica::fence_proxy_async;
using clica::mbar_expect;
using clica::mbar_init;
using clica::mbar_init_fence;
using clica::mbar_wait;

constexpr int kThreads = 256;
// slots of a ring: the backward's 2 in use and 2 in flight, the code
// kernel's 1 in use and 3 in flight (4 once its barrier has passed)
constexpr int kStages = 4;
constexpr int kUnroll = 8;   // positions a dx thread loads before it computes
// A step waits for its two loads before the barrier after which the slot
// the step before it read may be refilled. After a tile's last step the
// next step's loads are two further on, so they must have been issued
// during the step before, at most kStages - 1 loads past its first: with
// three slots the second of them would wait for itself (a deadlock).
static_assert(kStages >= 4, "the ring needs four slots");

template <typename T>
struct Pack;

// V values of T in 16 bytes: loaded into floats at once, or kept Raw and
// unpacked later (what is in flight then holds 16 bytes, not V floats).
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
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    unpack(load_raw(p), v);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  // four values (here all of a vector)
  static __device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    load(p, v);
  }
  static __device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
    store(p, v);
  }
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
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    unpack(load_raw(p), v);
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
  // four values, 8 bytes (8-byte aligned)
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float (&v)[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    v[0] = f0.x; v[1] = f0.y; v[2] = f1.x; v[3] = f1.y;
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p,
                                                const float (&v)[4]) {
    uint2 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = r;
  }
};

// x*a + b with both roundings, never contracted into a fused multiply-add.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// A float rounded to T (nearest, ties to even), as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V bytes (the codes of a vector) from memory as 32-bit words.
template <int V>
__device__ __forceinline__ void load_codes(const unsigned char* p,
                                           unsigned char (&k)[V]) {
  unsigned int w[V / 4];
  if constexpr (V == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned int*>(p);
  }
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) k[4 * i + b] = (w[i] >> (8 * b)) & 0xffu;
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
  for (int l = 0; l < V; ++l) m[l] = 0.f;  // the zero padding, exact after the relu
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
      for (int l = 0; l < V; ++l) m[l] = fmaxf(m[l], affine(xv[l], av[l], bv[l]));
    }
  }
  Pack<T>::store(out + ((n * Ho + ho) * Wo + wo) * C + c0, m);
}

// dz of the argmax pool from the pooled gradient dp and the codes (both
// (N, H/2, W/2, C)): one thread a quad of positions and a channel vector.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_scatter_kernel(const T* __restrict__ dp,
                    const unsigned char* __restrict__ codes,
                    T* __restrict__ dz, long long total, int H, int W, int C) {
  constexpr int V = Pack<T>::V;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int cvs = C / V, Ho = H / 2, Wo = W / 2;
  const int c0 = (int)(idx % cvs) * V;
  long long rest = idx / cvs;
  const int j = (int)(rest % Wo);
  rest /= Wo;
  const int m = (int)(rest % Ho);
  const long long n = rest / Ho;

  // the windows (m + r, j + c), r, c in {0, 1}, that lie in the pooled map;
  // a missing one's code 9 names no position
  float d[2][2][V];
  unsigned char k[2][2][V];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (m + r < Ho && j + c < Wo) {
        const long long o = ((n * Ho + m + r) * Wo + j + c) * C + c0;
        Pack<T>::load(dp + o, d[r][c]);
        load_codes<V>(codes + o, k[r][c]);
      } else {
#pragma unroll
        for (int l = 0; l < V; ++l) d[r][c][l] = 0.f, k[r][c][l] = 9;
      }
    }
  float q00[V], q01[V], q10[V], q11[V];
#pragma unroll
  for (int l = 0; l < V; ++l) {
    const auto term = [&](int r, int c, int code) {
      return k[r][c][l] == code ? d[r][c][l] : 0.f;
    };
    const auto sum = [](float acc, float t) { return round_to<T>(__fadd_rn(acc, t)); };
    q00[l] = term(0, 0, 4);
    q01[l] = sum(term(0, 0, 5), term(0, 1, 3));
    q10[l] = sum(term(0, 0, 7), term(1, 0, 1));
    q11[l] = sum(sum(sum(term(0, 0, 8), term(0, 1, 6)), term(1, 0, 2)),
                 term(1, 1, 0));
  }
  T* base = dz + ((n * H + 2 * m) * W + 2 * j) * C + c0;
  Pack<T>::store(base, q00);
  Pack<T>::store(base + C, q01);
  Pack<T>::store(base + (long long)W * C, q10);
  Pack<T>::store(base + (long long)W * C + C, q11);
}

// The geometry of the backward's or the code kernel's walk, the same for
// every block (see the notes above).
struct TileShape {
  int H, W, C, Ho, Wo;
  int cv;           // channel vectors of a block's slice
  int ws;           // window columns of a strip whose quads it owns
  int ks;           // quad (window) rows of a segment
  int strips, segs;
  long long tiles;  // N * segs * strips, strip fastest
  int col_bytes;    // one column of a slot: cv 16-byte vectors
  int row_bytes;    // one x row of a slot: 2 ws + 3 columns (code: 2 ws + 1)
  int slot_bytes;   // a slot: two x rows, then g's row of ws + 1 columns
};

struct Tile {
  long long n;
  int k0, k1;  // quad rows [k0, k1)
  int j0;      // first window column
};

__device__ __forceinline__ Tile tile_at(const TileShape& s, long long t) {
  Tile r;
  r.j0 = (int)(t % s.strips) * s.ws;
  const long long rest = t / s.strips;
  r.k0 = (int)(rest % s.segs) * s.ks;
  r.k1 = min(r.k0 + s.ks, s.Ho);
  r.n = rest / s.segs;
  return r;
}

// Stage st of a tile into a slot, by the lanes of warp 0: x rows 2st and
// 2st+1, columns 2 j0 - 1 .. 2 j0 + 2 ws + 1, and g row st, columns j0 ..
// j0 + ws, whatever of them lies inside the image. The first stage of a
// tile (st = k0 - 1) serves only window row k0: its x row 2st+1 alone.
// Without kGrad (the code kernel) no g, and x's columns stop at 2 j0 +
// 2 ws - 1, the last that the strip's windows reach.
template <typename T, bool kGrad>
__device__ void issue_stage(const TileShape& s, const T* __restrict__ x,
                            const T* __restrict__ g, const Tile& tl, int st,
                            bool first, int v0, int nvec, bool dense,
                            unsigned char* slot, uint64_t* bar, int lane) {
  constexpr int V = Pack<T>::V;
  const int wbeg = 2 * tl.j0 - 1;  // the image column of the slot's column 0
  const int wlo = max(0, wbeg);
  const int whi = min(s.W, wbeg + 2 * s.ws + (kGrad ? 3 : 1));
  const int jhi = min(s.Wo, tl.j0 + s.ws + 1);
  const int nx = whi - wlo, ng = kGrad ? jhi - tl.j0 : 0;
  const bool r0 = !first && st >= 0 && st < s.Ho;
  const bool r1 = st >= 0 && st < s.Ho;
  const bool rg = kGrad && !first && st >= 0 && st < s.Ho;
  const uint32_t vbytes = nvec * 16;
  if (lane == 0) mbar_expect(bar, ((r0 + r1) * nx + rg * ng) * vbytes);
  __syncwarp();
  const long long xrow = (tl.n * s.H + 2 * st) * s.W;  // x row 2st, column 0
  const long long grow = (tl.n * s.Ho + st) * s.Wo;
  unsigned char* xdst = slot + (wlo - wbeg) * s.col_bytes;
  unsigned char* gdst = slot + 2 * s.row_bytes;
  if (dense) {  // the slice is all of C: a row's columns are contiguous
    if (lane == 0 && r0)
      bulk_load(xdst, x + (xrow + wlo) * s.C, nx * vbytes, bar);
    if (lane == 1 && r1)
      bulk_load(xdst + s.row_bytes, x + (xrow + s.W + wlo) * s.C, nx * vbytes,
                bar);
    if (lane == 2 && rg)
      bulk_load(gdst, g + (grow + tl.j0) * s.C, ng * vbytes, bar);
    return;
  }
  const int off = v0 * V;  // the slice's first channel
  for (int i = lane; i < 2 * nx + ng; i += 32) {
    if (i < nx) {
      if (r0)
        bulk_load(xdst + i * s.col_bytes, x + (xrow + wlo + i) * s.C + off,
                  vbytes, bar);
    } else if (i < 2 * nx) {
      if (r1)
        bulk_load(xdst + s.row_bytes + (i - nx) * s.col_bytes,
                  x + (xrow + s.W + wlo + i - nx) * s.C + off, vbytes, bar);
    } else if (rg) {
      const int jj = i - 2 * nx;
      bulk_load(gdst + jj * s.col_bytes, g + (grow + tl.j0 + jj) * s.C + off,
                vbytes, bar);
    }
  }
}

// The first-wins maximum of relu(x*a + b) over one x row of a window,
// columns 2j-1 .. 2j+1 (the first outside the image when j = 0), and the
// column that reaches it, for the lanes 4h .. 4h+3 of the thread's vector.
// ``bits`` gains, at bit (base + dw - 1) * V + lane, whether y > 0 at
// column 2j + dw - 1, dw = 1, 2: the relu mask of the quad's two
// positions in this row.
template <typename T>
__device__ __forceinline__ void row_max(const unsigned char* row, int jl, int j,
                                        int col_bytes, int tv, int h,
                                        const float (&av)[Pack<T>::V],
                                        const float (&bv)[Pack<T>::V],
                                        float (&m)[4], unsigned char (&d)[4],
                                        unsigned int& bits, int base) {
  constexpr int V = Pack<T>::V;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    m[l] = -1.f;  // below every relu'd value: the first position is taken
    d[l] = 0;
  }
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    if (dw == 0 && j == 0) continue;
    float xv[4];
    Pack<T>::load4(
        reinterpret_cast<const T*>(row + (2 * jl + dw) * col_bytes + tv) + 4 * h,
        xv);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float z = fmaxf(affine(xv[l], av[4 * h + l], bv[4 * h + l]), 0.f);
      if (dw > 0 && z > 0.f) bits |= 1u << ((base + dw - 1) * V + 4 * h + l);
      if (z > m[l]) {  // strict: a tie keeps the earlier column
        m[l] = z;
        d[l] = (unsigned char)dw;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                T* __restrict__ dy, float* __restrict__ partial, TileShape s) {
  constexpr int V = Pack<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  // the winners of two window rows: [2][ws + 1][cv] vectors of V bytes
  unsigned char* win = smem + kStages * s.slot_bytes;
  const int win_row = (s.ws + 1) * s.cv * V;
  // each thread's sums of dy and dy*(x - mean): [2][kThreads][V]
  float* sums = reinterpret_cast<float*>(win + ((2 * win_row + 15) & ~15));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums + 2 * kThreads * V);

  const int cvs = s.C / V;
  const int v0 = blockIdx.y * s.cv;  // this block's slice of vectors
  const int nvec = min(s.cv, cvs - v0);
  const int cvi = threadIdx.x % s.cv, jl = threadIdx.x / s.cv;
  const bool active = jl <= s.ws && cvi < nvec;
  const int c0 = (v0 + cvi) * V;  // this thread's first channel
  const int lane = threadIdx.x % 32;
  const bool dense = gridDim.y == 1;
  float* my_sb = sums + threadIdx.x * V;
  float* my_sg = sums + (kThreads + threadIdx.x) * V;

  float av[V], bv[V], mu[V];
#pragma unroll
  for (int l = 0; l < V; ++l) my_sb[l] = my_sg[l] = 0.f;
  if (active) {
    Pack<T>::load(a + c0, av);
    Pack<T>::load(b + c0, bv);
#pragma unroll
    for (int l = 0; l < V; ++l) mu[l] = mean[c0 + l];
  }
  if (threadIdx.x == 0) {
    for (int r = 0; r < kStages; ++r) mbar_init(&bars[r]);
    mbar_init_fence();
  }
  __syncthreads();

  // The producer, warp 0: the loads of the block's tiles in order, a tile
  // of k1 - k0 + 1 steps taking its stages k0 - 1 .. k1, each load into
  // slot (its index mod kStages) once the step that last read that slot is
  // over.
  long long issued = 0, pt = blockIdx.x;
  int ps = 0;
  Tile pl;
  if (pt < s.tiles) pl = tile_at(s, pt);
  auto produce = [&](long long upto) {
    if (threadIdx.x >= 32) return;
    while (issued < upto && pt < s.tiles) {
      const int slot = (int)(issued % kStages);
      issue_stage<T, true>(s, x, g, pl, pl.k0 - 1 + ps, ps == 0, v0, nvec, dense,
                     ring + slot * s.slot_bytes, &bars[slot], lane);
      ++issued;
      if (++ps == pl.k1 - pl.k0 + 2) {
        ps = 0;
        pt += gridDim.x;
        if (pt < s.tiles) pl = tile_at(s, pt);
      }
    }
  };
  produce(kStages);

  long long c = 0;  // step k uses loads c (stage k) and c + 1 (stage k + 1)
  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tl = tile_at(s, t);
    const int j = tl.j0 + jl;
    T* dyn = dy + tl.n * s.H * s.W * s.C;
    // carried from step to step: the row maximum of x row 2k+1 (the top
    // row of window row k+1) and the relu mask of quad (k, j)
    float top_m[V];
    unsigned char top_d[V];
    unsigned int mask = 0;
    float tb[V], tg[V];
#pragma unroll
    for (int l = 0; l < V; ++l) tb[l] = tg[l] = 0.f;
    for (int k = tl.k0 - 1; k < tl.k1; ++k, ++c) {
      mbar_wait(&bars[c % kStages], (uint32_t)((c / kStages) & 1));
      mbar_wait(&bars[(c + 1) % kStages], (uint32_t)(((c + 1) / kStages) & 1));
      __syncthreads();  // every thread is done with the step before
      if (threadIdx.x < 32) fence_proxy_async();
      produce(c + kStages);
      const unsigned char* A = ring + (c % kStages) * s.slot_bytes;
      const unsigned char* B = ring + ((c + 1) % kStages) * s.slot_bytes;
      const int tv = cvi * 16;  // this thread's bytes in a column

      // The winner of window (k + 1, j), its rows' maxima taken in order:
      // the first row that reaches the window's maximum, and in it the
      // first column, is the first position of the row-major scan to do
      // so. Rows 2k+2 and 2k+3 are quad (k + 1, j)'s: their relu mask
      // comes with them.
      const int kw = k + 1;
      unsigned int next = 0;
      if (active && kw < s.Ho && j < s.Wo) {
        unsigned char arg[V];
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {  // four lanes at a time
          if (k < tl.k0) {  // the tile's first step: the top row from A
            float m[4];
            unsigned char d[4];
            unsigned int none = 0;
            if (kw > 0)
              row_max<T>(A + s.row_bytes, jl, j, s.col_bytes, tv, h, av, bv, m,
                         d, none, 0);
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              top_m[4 * h + l] = kw > 0 ? m[l] : -1.f;
              top_d[4 * h + l] = kw > 0 ? d[l] : 0;
            }
          }
          float mid_m[4], bot_m[4];
          unsigned char mid_d[4], bot_d[4];
          row_max<T>(B, jl, j, s.col_bytes, tv, h, av, bv, mid_m, mid_d, next, 0);
          row_max<T>(B + s.row_bytes, jl, j, s.col_bytes, tv, h, av, bv, bot_m,
                     bot_d, next, 2);
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int q = 4 * h + l;
            float m = top_m[q];
            arg[q] = top_d[q];
            if (mid_m[l] > m) {
              m = mid_m[l];
              arg[q] = 3 + mid_d[l];
            }
            if (bot_m[l] > m) arg[q] = 6 + bot_d[l];
            top_m[q] = bot_m[l];
            top_d[q] = bot_d[l];
          }
        }
        store_winners<V>(win + (kw & 1) * win_row + threadIdx.x * V, arg);
      }
      __syncthreads();  // the winners of row k + 1 are in

      if (k >= tl.k0 && active && jl < s.ws && j < s.Wo) {
        // dz of the positions (2k,2j) (2k,2j+1) (2k+1,2j) (2k+1,2j+1). The
        // windows come in the order (k+1,j+1), (k+1,j), (k,j+1), (k,j): the
        // order of the terms of the specification's sums.
        const unsigned char* wk = win + (k & 1) * win_row + threadIdx.x * V;
        const unsigned char* wk1 = win + (kw & 1) * win_row + threadIdx.x * V;
        const T* ga =
            reinterpret_cast<const T*>(A + 2 * s.row_bytes + jl * s.col_bytes + tv);
        const T* gb =
            reinterpret_cast<const T*>(B + 2 * s.row_bytes + jl * s.col_bytes + tv);
        const int right = s.cv * V;           // the winners of column j + 1
        const int gright = s.col_bytes / sizeof(T);  // g of column j + 1
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {  // four lanes at a time
          float dz[4][4], gv[4];
          unsigned char arg[4];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int l = 0; l < 4; ++l) dz[p][l] = 0.f;
          if (kw < s.Ho && j + 1 < s.Wo) {
            load_winners<4>(wk1 + right + 4 * h, arg);
            Pack<T>::load4(gb + gright + 4 * h, gv);
#pragma unroll
            for (int l = 0; l < 4; ++l)
              if (arg[l] == 0) dz[3][l] += gv[l];
          }
          if (kw < s.Ho) {
            load_winners<4>(wk1 + 4 * h, arg);
            Pack<T>::load4(gb + 4 * h, gv);
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              if (arg[l] == 1) dz[2][l] += gv[l];
              if (arg[l] == 2) dz[3][l] += gv[l];
            }
          }
          if (j + 1 < s.Wo) {
            load_winners<4>(wk + right + 4 * h, arg);
            Pack<T>::load4(ga + gright + 4 * h, gv);
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              if (arg[l] == 3) dz[1][l] += gv[l];
              if (arg[l] == 6) dz[3][l] += gv[l];
            }
          }
          {
            load_winners<4>(wk + 4 * h, arg);
            Pack<T>::load4(ga + 4 * h, gv);
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              if (arg[l] == 4) dz[0][l] += gv[l];
              if (arg[l] == 5) dz[1][l] += gv[l];
              if (arg[l] == 7) dz[2][l] += gv[l];
              if (arg[l] == 8) dz[3][l] += gv[l];
            }
          }

#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float xv[4], out[4];
            Pack<T>::load4(reinterpret_cast<const T*>(
                               A + (p / 2) * s.row_bytes +
                               (2 * jl + 1 + p % 2) * s.col_bytes + tv) +
                               4 * h,
                           xv);
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              const int q = 4 * h + l;
              out[l] = (mask >> (p * V + q)) & 1u ? dz[p][l] : 0.f;
              tb[q] += out[l];
              tg[q] += out[l] * (xv[l] - mu[q]);
            }
            const int hh = 2 * k + p / 2, w = 2 * j + p % 2;
            Pack<T>::store4(dyn + ((long long)hh * s.W + w) * s.C + c0 + 4 * h, out);
          }
        }
      }
      mask = next;
    }
    ++c;  // the tile's last load (stage k1) is not the next tile's first
#pragma unroll
    for (int l = 0; l < V; ++l) {
      my_sb[l] += tb[l];
      my_sg[l] += tg[l];
    }
  }

  // The block's sums per channel: threads jl = 0..ws in order.
  __syncthreads();
  for (int q = threadIdx.x; q < nvec * V; q += kThreads) {
    const int vi = q / V, l = q % V;
    float rb = 0.f, rg = 0.f;
    for (int r = 0; r <= s.ws; ++r) {
      rb += sums[(r * s.cv + vi) * V + l];
      rg += sums[(kThreads + r * s.cv + vi) * V + l];
    }
    const int ch = v0 * V + q;
    partial[(long long)blockIdx.x * s.C + ch] = rb;
    partial[((long long)gridDim.x + blockIdx.x) * s.C + ch] = rg * rstd[ch];
  }
}

// The code kernel's lanes. A channel vector is four 32-bit words: four
// float lanes, one a word, or eight bfloat16 lanes, two a word, the low half
// the lower channel. z, the maxima and the codes are kept word by word; a
// lane's code is its lane's bits of the code word (a float lane's word, a
// bfloat16 lane's half). sel(mask, u, v) takes u where the mask is set.
__device__ __forceinline__ uint32_t sel(uint32_t mask, uint32_t u, uint32_t v) {
  return (u & mask) | (v & ~mask);
}

template <typename T>
struct Words;

template <>
struct Words<float> {
  static constexpr int L = 1;                      // lanes a word
  static constexpr uint32_t kBelow = 0xbf800000u;  // -1: below every relu'd value
  static constexpr uint32_t kCode1 = 1u;           // code 1 in every lane of a word
  // z = relu(x*a + b) of the word's lane; a, b its factors
  static __device__ __forceinline__ uint32_t z(uint32_t x, const float* a,
                                               const float* b) {
    return __float_as_uint(fmaxf(affine(__uint_as_float(x), a[0], b[0]), 0.f));
  }
  // all ones in each lane where u > v (strict: a tie keeps v)
  static __device__ __forceinline__ uint32_t gt(uint32_t u, uint32_t v) {
    return __uint_as_float(u) > __uint_as_float(v) ? ~0u : 0u;
  }
  // the four lanes' codes, a byte each, to memory
  static __device__ __forceinline__ void store_codes(unsigned char* p,
                                                     const uint32_t (&d)[4]) {
    *reinterpret_cast<uint32_t*>(p) = __byte_perm(
        __byte_perm(d[0], d[1], 0x40), __byte_perm(d[2], d[3], 0x40), 0x5410);
  }
};

template <>
struct Words<__nv_bfloat16> {
  static constexpr int L = 2;
  static constexpr uint32_t kBelow = 0xbf80bf80u;
  static constexpr uint32_t kCode1 = 0x00010001u;
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat162 pair(uint32_t w) {
    return *reinterpret_cast<const __nv_bfloat162*>(&w);
  }
  // z of both lanes, each product and sum rounded to bfloat16, the two
  // lanes by one conversion
  static __device__ __forceinline__ uint32_t z(uint32_t x, const float* a,
                                               const float* b) {
    const uint32_t p = bits(__floats2bfloat162_rn(
        __fmul_rn(__uint_as_float(x << 16), a[0]),
        __fmul_rn(__uint_as_float(x & 0xffff0000u), a[1])));
    const __nv_bfloat162 y = __floats2bfloat162_rn(
        __fadd_rn(__uint_as_float(p << 16), b[0]),
        __fadd_rn(__uint_as_float(p & 0xffff0000u), b[1]));
    return bits(__hmax2(y, pair(0u)));
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t u, uint32_t v) {
    return __hgt2_mask(pair(u), pair(v));  // set.gt.u32.bf16x2
  }
  static __device__ __forceinline__ void store_codes(unsigned char* p,
                                                     const uint32_t (&d)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(__byte_perm(d[0], d[1], 0x6420),
                                              __byte_perm(d[2], d[3], 0x6420));
  }
};

// z of the four words of the vector at p.
template <typename T>
__device__ __forceinline__ void z_vector(const unsigned char* p,
                                         const float (&av)[Pack<T>::V],
                                         const float (&bv)[Pack<T>::V],
                                         uint32_t (&z)[4]) {
  constexpr int L = Words<T>::L;
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  z[0] = Words<T>::z(q.x, av, bv);
  z[1] = Words<T>::z(q.y, av + L, bv + L);
  z[2] = Words<T>::z(q.z, av + 2 * L, bv + 2 * L);
  z[3] = Words<T>::z(q.w, av + 3 * L, bv + 3 * L);
}

__device__ __forceinline__ void store_words(unsigned char* p,
                                            const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One row's first maximum over the window's columns 2j-1 (left: kBelow
// when j = 0, outside the image), 2j and 2j+1 (mid, right), and the
// column 0..2 that reaches it.
template <typename T>
__device__ __forceinline__ void row_code(const uint32_t (&left)[4],
                                         const uint32_t (&mid)[4],
                                         const uint32_t (&right)[4],
                                         uint32_t (&m)[4], uint32_t (&d)[4]) {
  using W = Words<T>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t mask = W::gt(mid[i], left[i]);
    m[i] = sel(mask, mid[i], left[i]);
    d[i] = mask & W::kCode1;
    mask = W::gt(right[i], m[i]);
    m[i] = sel(mask, right[i], m[i]);
    d[i] = sel(mask, 2 * W::kCode1, d[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pool_code_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ b, T* __restrict__ out,
                 unsigned char* __restrict__ codes, TileShape s) {
  using W = Words<T>;
  constexpr int V = Pack<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  // the hand-over of z at column 2j+1 from the thread of window j to that
  // of window j+1: [2 halves][2 rows][ws + 1][cv] vectors, index 0 the
  // halo column's, index jl + 1 thread jl's
  unsigned char* hand = smem + kStages * s.slot_bytes;
  const int hand_row = (s.ws + 1) * s.col_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(hand + 4 * hand_row);

  const int cvs = s.C / V;
  const int v0 = blockIdx.y * s.cv;  // this block's slice of vectors
  const int nvec = min(s.cv, cvs - v0);
  const int cvi = threadIdx.x % s.cv, jl = threadIdx.x / s.cv;
  const bool active = jl <= s.ws && cvi < nvec;
  const int c0 = (v0 + cvi) * V;  // this thread's first channel
  const int tv = cvi * 16;        // this thread's bytes in a column
  const int lane = threadIdx.x % 32;
  const bool dense = gridDim.y == 1;

  float av[V], bv[V];
  if (active) {
    Pack<T>::load(a + c0, av);
    Pack<T>::load(b + c0, bv);
  }
  if (threadIdx.x == 0) {
    for (int r = 0; r < kStages; ++r) mbar_init(&bars[r]);
    mbar_init_fence();
  }
  __syncthreads();

  // The producer, warp 0: the loads of the block's tiles in order, a tile
  // of k1 - k0 + 1 steps taking its stages k0 - 1 .. k1 - 1, each load into
  // slot (its index mod kStages) once the step that read that slot is over.
  long long issued = 0, pt = blockIdx.x;
  int ps = 0;
  Tile pl;
  if (pt < s.tiles) pl = tile_at(s, pt);
  auto produce = [&](long long upto) {
    if (threadIdx.x >= 32) return;
    while (issued < upto && pt < s.tiles) {
      const int slot = (int)(issued % kStages);
      issue_stage<T, false>(s, x, nullptr, pl, pl.k0 - 1 + ps, ps == 0, v0,
                            nvec, dense, ring + slot * s.slot_bytes, &bars[slot],
                            lane);
      ++issued;
      if (++ps == pl.k1 - pl.k0 + 1) {
        ps = 0;
        pt += gridDim.x;
        if (pt < s.tiles) pl = tile_at(s, pt);
      }
    }
  };
  produce(kStages);

  long long c = 0;  // step c uses load c
  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tl = tile_at(s, t);
    const int j = tl.j0 + jl;
    const bool owner = active && jl < s.ws && j < s.Wo;  // of window column j
    const bool halo = active && jl == s.ws && tl.j0 > 0;  // turns column 2 j0 - 1
    const long long orow = tl.n * s.Ho;  // the image's first pooled row
    // carried from step to step: x row 2k-1's maximum and column, the top
    // row of window row k
    uint32_t top_m[4], top_d[4];
    for (int k = tl.k0 - 1; k < tl.k1; ++k, ++c) {
      mbar_wait(&bars[c % kStages], (uint32_t)((c / kStages) & 1));
      const unsigned char* slot = ring + (c % kStages) * s.slot_bytes;
      unsigned char* h = hand + (c & 1) * 2 * hand_row;
      const int r0 = k < tl.k0 ? 1 : 0;  // the first step has row 2 k0 - 1 alone
      uint32_t zm[2][4], zr[2][4];  // z at columns 2j, 2j+1 of rows 2k, 2k+1
      if (k >= 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r < r0) continue;
          const unsigned char* row = slot + r * s.row_bytes + tv;
          if (owner) {
            z_vector<T>(row + (2 * jl + 1) * s.col_bytes, av, bv, zm[r]);
            z_vector<T>(row + (2 * jl + 2) * s.col_bytes, av, bv, zr[r]);
            store_words(h + r * hand_row + (jl + 1) * s.col_bytes + tv, zr[r]);
          } else if (halo) {
            uint32_t zh[4];
            z_vector<T>(row, av, bv, zh);
            store_words(h + r * hand_row + tv, zh);
          }
        }
      }
      __syncthreads();  // the slot is read and the hand-over is in
      if (threadIdx.x < 32) fence_proxy_async();
      produce(c + kStages + 1);
      if (!owner) continue;
      if (k < 0) {  // the image's first window row has no top row
#pragma unroll
        for (int i = 0; i < 4; ++i) top_m[i] = W::kBelow, top_d[i] = 0;
        continue;
      }
      uint32_t rm[2][4], rd[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r < r0) continue;
        uint32_t left[4];
        if (j > 0) {
          const uint4 q = *reinterpret_cast<const uint4*>(
              h + r * hand_row + jl * s.col_bytes + tv);
          left[0] = q.x, left[1] = q.y, left[2] = q.z, left[3] = q.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) left[i] = W::kBelow;
        }
        row_code<T>(left, zm[r], zr[r], rm[r], rd[r]);
      }
      if (k >= tl.k0) {
        // the window's maximum from its rows in order: the first row that
        // reaches it, the row-major scan's first maximum
        uint32_t m[4], d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t mask = W::gt(rm[0][i], top_m[i]);
          m[i] = sel(mask, rm[0][i], top_m[i]);
          d[i] = sel(mask, rd[0][i] + 3 * W::kCode1, top_d[i]);
          mask = W::gt(rm[1][i], m[i]);
          m[i] = sel(mask, rm[1][i], m[i]);
          d[i] = sel(mask, rd[1][i] + 6 * W::kCode1, d[i]);
        }
        const long long o = ((orow + k) * s.Wo + j) * s.C + c0;
        store_words(reinterpret_cast<unsigned char*>(out + o), m);
        W::store_codes(codes + o, d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) top_m[i] = rm[1][i], top_d[i] = rd[1][i];
    }
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

// dx = ((dy*k1 + nk2) + (x - mean)*nk3), every operation rounded, the
// result rounded to T once. A thread keeps one channel vector's factors
// and walks the positions p = its first, + stride, ...; kUnroll of them
// are loaded, as raw 16 bytes, before any is computed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ k1, const float* __restrict__ nk2,
               const float* __restrict__ nk3, const float* __restrict__ mean,
               T* __restrict__ dx, long long positions, int C) {
  constexpr int V = Pack<T>::V;
  const int cvs = C / V, per = kThreads / cvs;  // positions of a block's pass
  const int pl = threadIdx.x / cvs;
  if (pl >= per) return;
  const int c0 = (threadIdx.x % cvs) * V;
  float f1[V], f2[V], f3[V], fm[V];
#pragma unroll
  for (int l = 0; l < V; ++l) {
    f1[l] = k1[c0 + l];
    f2[l] = nk2[c0 + l];
    f3[l] = nk3[c0 + l];
    fm[l] = mean[c0 + l];
  }
  const long long stride = (long long)gridDim.x * per;
  for (long long p = (long long)blockIdx.x * per + pl; p < positions;
       p += kUnroll * stride) {
    typename Pack<T>::Raw xr[kUnroll], dr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * stride;
      if (q < positions) {
        xr[u] = Pack<T>::load_raw(x + q * C + c0);
        dr[u] = Pack<T>::load_raw(dy + q * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * stride;
      if (q < positions) {
        float xv[V], dv[V], out[V];
        Pack<T>::unpack(xr[u], xv);
        Pack<T>::unpack(dr[u], dv);
#pragma unroll
        for (int l = 0; l < V; ++l)
          out[l] = __fadd_rn(__fadd_rn(__fmul_rn(dv[l], f1[l]), f2[l]),
                             __fmul_rn(__fsub_rn(xv[l], fm[l]), f3[l]));
        Pack<T>::store(dx + q * C + c0, out);
      }
    }
  }
}

inline bool bad_shape(long long n, int h, int w, int c, int vec) {
  return n < 1 || h < 2 || w < 2 || (h % 2) || (w % 2) || c < vec ||
         (c % vec) || c / vec > kThreads;
}

template <typename T>
size_t bwd_smem(int cv, int ws) {
  const size_t slot = (size_t)(5 * ws + 7) * cv * 16;  // 2 (2 ws + 3) + ws + 1
  const size_t win = ((size_t)2 * (ws + 1) * cv * Pack<T>::V + 15) & ~(size_t)15;
  const size_t sums = (size_t)2 * kThreads * Pack<T>::V * sizeof(float);
  return kStages * slot + win + sums + kStages * sizeof(uint64_t);
}

inline bool bad_slice(int cv, int ws) {
  return cv < 1 || ws < 1 || (ws + 1) * cv > kThreads;
}

// A plan the backward can walk: its slices, strips and segments cover the
// channel vectors, window columns and quad rows once (the last of each may
// be short, none is empty), and its tiles are the images' segments' strips.
inline bool bad_plan(long long n, int h, int w, int cvs, int cv, int slices,
                     int ws, int strips, int ks, int segs, long long tiles,
                     int grid) {
  const auto covers = [](int size, int part, int parts) {
    return parts >= 1 && (long long)(parts - 1) * part < size &&
           (long long)parts * part >= size;
  };
  return bad_slice(cv, ws) || ks < 1 || grid < 1 || !covers(cvs, cv, slices) ||
         !covers(w / 2, ws, strips) || !covers(h / 2, ks, segs) ||
         tiles != n * segs * strips;
}

template <typename T>
int bwd_blocks_per_sm(int cv, int ws, int* out) {
  const size_t smem = bwd_smem<T>(cv, ws);
  int rc = (int)cudaFuncSetAttribute(
      stem_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, stem_bwd_kernel<T>, kThreads, smem);
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

// The code kernel's ring of two-row slots, its two halves of hand-over
// vectors and its barriers.
inline size_t code_smem(int cv, int ws) {
  const size_t slot = (size_t)2 * (2 * ws + 1) * cv * 16;
  const size_t hand = (size_t)4 * (ws + 1) * cv * 16;
  return kStages * slot + hand + kStages * sizeof(uint64_t);
}

template <typename T>
int code_blocks_per_sm(int cv, int ws, int* out) {
  const size_t smem = code_smem(cv, ws);
  int rc = (int)cudaFuncSetAttribute(
      pool_code_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, pool_code_kernel<T>, kThreads, smem);
}

template <typename T>
int launch_code(const void* x, const void* a, const void* b, void* out,
                void* codes, int h, int w, int c, int cv, int slices, int ws,
                int strips, int ks, int segs, long long tiles, int grid,
                cudaStream_t st) {
  TileShape s;
  s.H = h; s.W = w; s.C = c; s.Ho = h / 2; s.Wo = w / 2;
  s.cv = cv; s.ws = ws; s.ks = ks;
  s.strips = strips;
  s.segs = segs;
  s.tiles = tiles;
  s.col_bytes = cv * 16;
  s.row_bytes = (2 * ws + 1) * s.col_bytes;
  s.slot_bytes = 2 * s.row_bytes;
  const size_t smem = code_smem(cv, ws);
  int rc = (int)cudaFuncSetAttribute(
      pool_code_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  pool_code_kernel<T><<<dim3(grid, slices), kThreads, smem, st>>>(
      (const T*)x, (const T*)a, (const T*)b, (T*)out, (unsigned char*)codes, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter(const void* dp, const void* codes, void* dz, long long n,
                   int h, int w, int c, cudaStream_t st) {
  const long long total = n * (h / 2) * (w / 2) * (c / Pack<T>::V);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pool_scatter_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const T*)dp, (const unsigned char*)codes, (T*)dz, total, h, w, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* a, const void* b,
               const float* mean, const float* rstd, void* dy, float* partial,
               float* sums, int h, int w, int c, int cv, int slices, int ws,
               int strips, int ks, int segs, long long tiles, int grid,
               cudaStream_t st) {
  TileShape s;
  s.H = h; s.W = w; s.C = c; s.Ho = h / 2; s.Wo = w / 2;
  s.cv = cv; s.ws = ws; s.ks = ks;
  s.strips = strips;
  s.segs = segs;
  s.tiles = tiles;
  s.col_bytes = cv * 16;
  s.row_bytes = (2 * ws + 3) * s.col_bytes;
  s.slot_bytes = 2 * s.row_bytes + (ws + 1) * s.col_bytes;
  const size_t smem = bwd_smem<T>(cv, ws);
  int rc = (int)cudaFuncSetAttribute(
      stem_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  stem_bwd_kernel<T><<<dim3(grid, slices), kThreads, smem, st>>>(
      (const T*)x, (const T*)g, (const T*)a, (const T*)b, mean, rstd, (T*)dy,
      partial, s);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  stem_reduce_kernel<<<dim3((c + 31) / 32, 2), dim3(32, 8), 0, st>>>(
      partial, sums, grid, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* x, const void* dy, const float* k1, const float* nk2,
              const float* nk3, const float* mean, void* dx, long long n, int h,
              int w, int c, int grid, cudaStream_t st) {
  stem_dx_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, k1, nk2, nk3, mean, (T*)dx, n * h * w, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Resident blocks of stem_bwd_kernel on one SM for a plan's slice of cv
// vectors and strip of ws columns (its shared memory), into *out.
int clica_stem_bwd_blocks_per_sm(int cv, int ws, int is_bf16, int* out) {
  if (bad_slice(cv, ws)) return (int)cudaErrorInvalidValue;
  return is_bf16 ? bwd_blocks_per_sm<__nv_bfloat16>(cv, ws, out)
                 : bwd_blocks_per_sm<float>(cv, ws, out);
}

// Resident blocks of stem_dx_kernel on one SM, into *out.
int clica_stem_dx_blocks_per_sm(int is_bf16, int* out) {
  return (int)(is_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             out, stem_dx_kernel<__nv_bfloat16>, kThreads, 0)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             out, stem_dx_kernel<float>, kThreads, 0));
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

// Resident blocks of pool_code_kernel on one SM for a plan's slice of cv
// vectors and strip of ws columns (its shared memory), into *out.
int clica_pool_code_blocks_per_sm(int cv, int ws, int is_bf16, int* out) {
  if (bad_slice(cv, ws)) return (int)cudaErrorInvalidValue;
  return is_bf16 ? code_blocks_per_sm<__nv_bfloat16>(cv, ws, out)
                 : code_blocks_per_sm<float>(cv, ws, out);
}

// The dynamic shared memory of a pool_code_kernel block, in bytes.
long long clica_pool_code_smem(int cv, int ws) {
  return (long long)code_smem(cv, ws);
}

// The argmax pool's forward: out as clica_stem_fwd's with z rounded to x's
// type after each operation, and codes (n, h/2, w/2, c) bytes, each the
// window position 0..8 of its value's first maximum, for the plan (cv,
// slices, ws, strips, ks, segs, tiles, grid) of ops/pool_minres.py
// pool_code_plan.
int clica_pool_code(const void* x, const void* a, const void* b, void* out,
                    void* codes, long long n, int h, int w, int c, int is_bf16,
                    int cv, int slices, int ws, int strips, int ks, int segs,
                    long long tiles, int grid, void* stream) {
  const int vec = is_bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (bad_shape(n, h, w, c, vec) ||
      bad_plan(n, h, w, c / vec, cv, slices, ws, strips, ks, segs, tiles, grid))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_code<__nv_bfloat16>(x, a, b, out, codes, h, w, c, cv,
                                              slices, ws, strips, ks, segs,
                                              tiles, grid, st)
                 : launch_code<float>(x, a, b, out, codes, h, w, c, cv, slices,
                                      ws, strips, ks, segs, tiles, grid, st);
}

// dz (n, h, w, c) of the argmax pool from dp and codes (n, h/2, w/2, c).
int clica_pool_scatter(const void* dp, const void* codes, void* dz, long long n,
                       int h, int w, int c, int is_bf16, void* stream) {
  const int vec = is_bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (bad_shape(n, h, w, c, vec)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_scatter<__nv_bfloat16>(dp, codes, dz, n, h, w, c, st)
                 : launch_scatter<float>(dp, codes, dz, n, h, w, c, st);
}

// dy and the channel sums for the plan (cv, slices, ws, strips, ks, segs,
// tiles, grid) of ops/stem.py bwd_plan: partial is a (2, grid, C) float
// buffer, sums (2, C).
int clica_stem_bwd(const void* x, const void* g, const void* a, const void* b,
                   const float* mean, const float* rstd, void* dy,
                   float* partial, float* sums, long long n, int h, int w,
                   int c, int is_bf16, int cv, int slices, int ws, int strips,
                   int ks, int segs, long long tiles, int grid, void* stream) {
  const int vec = is_bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (bad_shape(n, h, w, c, vec) ||
      bad_plan(n, h, w, c / vec, cv, slices, ws, strips, ks, segs, tiles, grid))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, g, a, b, mean, rstd, dy,
                                             partial, sums, h, w, c, cv, slices,
                                             ws, strips, ks, segs, tiles, grid,
                                             st)
                 : launch_bwd<float>(x, g, a, b, mean, rstd, dy, partial, sums,
                                     h, w, c, cv, slices, ws, strips, ks, segs,
                                     tiles, grid, st);
}

// dx of the backward on grid blocks: k1, nk2 = -k2, nk3 = -k3*rstd and
// mean, (C,) float.
int clica_stem_dx(const void* x, const void* dy, const float* k1,
                  const float* nk2, const float* nk3, const float* mean,
                  void* dx, long long n, int h, int w, int c, int is_bf16,
                  int grid, void* stream) {
  const int vec = is_bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (bad_shape(n, h, w, c, vec) || grid < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_dx<__nv_bfloat16>(x, dy, k1, nk2, nk3, mean, dx, n,
                                            h, w, c, grid, st)
                 : launch_dx<float>(x, dy, k1, nk2, nk3, mean, dx, n, h, w, c,
                                    grid, st);
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
