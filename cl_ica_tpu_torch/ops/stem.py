"""The ResNet stem tail, fused: batch norm → relu → 3×3/2 max pool with a
minimal-residual backward. Hopper kernels and their plain PyTorch version.

Port of cl_ica_tpu/ops/stem_pallas.py (``bn_relu_pool_train``):

    pooled = maxpool3×3/2,pad 1(relu(x·a + b)),   a, b per channel

with a = rstd·scale and b = bias − mean·rstd·scale from the batch's own
float32 statistics. The backward keeps only x and the statistics; it
recomputes the relu mask and each window's winner (ties go to the first
position in row-major window order), routes the pooled gradient back to
the input positions, and sums Σdy and Σdy·x̂ per channel for the
through-the-statistics batch-norm gradient. The post-norm activation, four
times the pooled output, never reaches device memory.

The three kernels are CUDA C++ in csrc/stem_pool.cu (see the note there):
``stem_fwd`` (affine, relu, pool), ``stem_bwd`` (winner recompute,
routing, mask, channel sums) and ``stem_dx`` (dx = k1·dy − k2 − k3·x̂ in
one pass over x and dy, where the JAX package leaves one fused XLA pass).
As in the JAX package, the batch statistics and the parameter gradients
stay plain tensor operations around them. This module builds and binds
the kernels, plans the backward's persistent grid (``bwd_plan``), wraps
them in a ``torch.autograd.Function``, and launches them through
ops/runtime.py, which counts them (``ops.launch_counts``: ``stem_fwd``,
``stem_bwd``, ``stem_dx``).

Layout: (N, H, W, C), dense, as in the JAX package. H and W even; C a
multiple of the kernels' 16-byte vector (4 float32, 8 bfloat16 values),
at most 256 vectors. float32 and bfloat16.

Under a data-parallel mesh (``group``: the ranks of parallel/, each with
its rows of the batch) the statistics are the whole batch's: each rank's
mean and E[x²] are averaged over the ranks; and the backward's channel
sums are summed over the ranks and divided by the global count for dx,
while the sums returned as dscale and dbias stay the rank's own (the
parameters' gradients are averaged over the ranks afterwards). With no
group nothing communicates.

On CPU tensors ``bn_relu_pool_train`` runs the plain versions
(``stem_fwd_reference``, ``stem_bwd_reference``, ``stem_dx_reference``),
because there is no kernel to launch there. On CUDA tensors it launches
the kernels or raises; it never falls back, and it never copies x to make
it dense.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import runtime
from .collectives import all_reduce_mean_, all_reduce_sum_, world_of
from .runtime import INT, LONG, PTR, vector_width

THREADS = 256  # a backward block's threads: (ws + 1) * cv of them compute
MAX_SLICE = 16  # the most channel vectors a backward block takes

LIBRARY = "stem_pool"

# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _affine(x, a, b):
    """x·a + b in float32, the product and the sum each rounded (two
    operations, as in the kernels; not ``addcmul``)."""
    y = x.float() * a.float()
    return y.add_(b.float())


def pool_views(zp):
    """Nine shifted (N, Ho, Wo, C) views of a padded (N, H+2, W+2, C) map
    in row-major (dh, dw) window order, which defines the tie-break."""
    h, w = zp.shape[1] - 2, zp.shape[2] - 2
    return [zp[:, dh:dh + h:2, dw:dw + w:2] for dh in range(3) for dw in range(3)]


def _shift_up(t):
    """t[:, i+1] with zero fill on the last row."""
    return F.pad(t[:, 1:], (0, 0, 0, 0, 0, 1))


def _shift_left(t):
    """t[:, :, j+1] with zero fill on the last column."""
    return F.pad(t[:, :, 1:], (0, 0, 0, 1))


def stem_fwd_reference(x: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """The plain version of the forward kernel: relu(x·a + b) in float32,
    the maximum of the nine window views over zero padding (exact, since
    the values are ≥ 0), written in x's dtype."""
    z = _affine(x, a, b).clamp_(min=0)
    views = pool_views(F.pad(z, (0, 0, 1, 1, 1, 1)))
    m = views[0].clone()
    for v in views[1:]:
        torch.maximum(m, v, out=m)
    return m.to(x.dtype)


def stem_bwd_reference(x, g, a, b, mean, rstd
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernel, from the specification
    (stem_pallas.py ``_recompute_dy``, ``_scatter_pool_grad``): the
    first-wins winner over the nine views (strict ``>``), g routed to the
    winners' input positions

        dz[2m,   2n  ] = C4[m, n]
        dz[2m,   2n+1] = C3[m, n+1] + C5[m, n]
        dz[2m+1, 2n  ] = C1[m+1, n] + C7[m, n]
        dz[2m+1, 2n+1] = C0[m+1, n+1] + C2[m+1, n] + C6[m, n+1] + C8[m, n]

    (C_k = g where the winner is k, zero outside the image), the relu mask,
    and the two channel sums of the float32 dy. Returns (dy in g's dtype,
    Σdy, Σdy·x̂)."""
    n, h, w, c = x.shape
    y = _affine(x, a, b)
    z = y.clamp(min=0)
    views = pool_views(
        F.pad(z, (0, 0, 1, 1, 1, 1), value=torch.finfo(torch.float32).min))
    m = views[0].clone()
    arg = torch.zeros(m.shape, dtype=torch.int8, device=x.device)
    for k in range(1, 9):
        take = views[k] > m  # strict: a tie keeps the earlier index
        m = torch.where(take, views[k], m)
        arg.masked_fill_(take, k)
    del z, views, m
    gf = g.float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def ck(k):
        return torch.where(arg == k, gf, zero)

    dz = torch.empty((n, h, w, c), dtype=torch.float32, device=x.device)
    dz[:, 0::2, 0::2] = ck(4)
    dz[:, 0::2, 1::2] = _shift_left(ck(3)) + ck(5)
    dz[:, 1::2, 0::2] = _shift_up(ck(1)) + ck(7)
    dz[:, 1::2, 1::2] = (_shift_up(_shift_left(ck(0))) + _shift_up(ck(2))
                         + _shift_left(ck(6)) + ck(8))
    dyf = torch.where(y > 0, dz, zero)
    del dz, y
    xhat = (x.float() - mean) * rstd
    sb = dyf.sum(dim=(0, 1, 2))
    sg = xhat.mul_(dyf).sum(dim=(0, 1, 2))
    return dyf.to(g.dtype), sb, sg


def stem_dx_reference(x, dy, k1, nk2, nk3, mean) -> torch.Tensor:
    """The plain version of the dx kernel: dx = (dy·k1 + nk2) + (x − mean)·nk3
    per channel (nk2 = −k2, nk3 = −k3·rstd), each operation one rounded
    float32 tensor operation in the kernel's order, rounded once to x's
    dtype."""
    t = dy.float() * k1
    t += nk2
    d = x.float() - mean
    d *= nk3
    t += d
    return t.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return runtime.library(LIBRARY, declare)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of a library built
    from csrc/stem_pool.cu."""
    lib.clica_stem_bwd_blocks_per_sm.argtypes = [INT, INT, INT, ctypes.POINTER(INT)]
    lib.clica_stem_bwd_blocks_per_sm.restype = INT
    lib.clica_stem_dx_blocks_per_sm.argtypes = [INT, ctypes.POINTER(INT)]
    lib.clica_stem_dx_blocks_per_sm.restype = INT
    lib.clica_stem_fwd.argtypes = [PTR, PTR, PTR, PTR, LONG, INT, INT, INT, INT, PTR]
    lib.clica_stem_fwd.restype = INT
    lib.clica_stem_bwd.argtypes = [PTR] * 9 + [LONG] + [INT] * 10 + [LONG, INT, PTR]
    lib.clica_stem_bwd.restype = INT
    lib.clica_stem_dx.argtypes = [PTR] * 7 + [LONG, INT, INT, INT, INT, INT, PTR]
    lib.clica_stem_dx.restype = INT
    # the argmax pool's two kernels (ops/pool_minres.py)
    lib.clica_pool_code_blocks_per_sm.argtypes = [INT, INT, INT, ctypes.POINTER(INT)]
    lib.clica_pool_code_blocks_per_sm.restype = INT
    lib.clica_pool_code_smem.argtypes = [INT, INT]
    lib.clica_pool_code_smem.restype = LONG
    lib.clica_pool_code.argtypes = [PTR] * 5 + [LONG] + [INT] * 10 + [LONG, INT, PTR]
    lib.clica_pool_code.restype = INT
    lib.clica_pool_scatter.argtypes = [PTR] * 3 + [LONG, INT, INT, INT, INT, PTR]
    lib.clica_pool_scatter.restype = INT
    return lib


class TilePlan(NamedTuple):
    """A persistent grid over tiles (csrc/stem_pool.cu), the backward's
    (``bwd_plan``) and the argmax pool's code kernel's
    (``pool_minres.pool_code_plan``): a block takes a slice of ``cv``
    channel vectors (``slices`` of them cover C), and walks tiles of one
    image, a strip of ``ws`` window columns (``strips`` of them) and a
    segment of ``ks`` quad (window) rows (``segs``); ``tiles`` = N · segs ·
    strips, strip fastest. ``grid`` blocks a slice: block b takes tiles b, b
    + grid, ... The kernel takes the plan whole, in this order."""
    cv: int
    slices: int
    ws: int
    strips: int
    ks: int
    segs: int
    tiles: int
    grid: int


def tile_geometry(w: int, c: int, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(cv, slices, ws, strips): C's vectors in the fewest slices of at most
    MAX_SLICE, evened out; then the widest strip that a block's threads
    cover, a thread per window column and vector and one more row of them
    (the backward's last window column, the code kernel's halo column),
    evened out over W/2."""
    cvs = c // vector_width(dtype)
    slices = -(-cvs // MAX_SLICE)
    cv = -(-cvs // slices)
    wo = w // 2
    strips = -(-wo // min(wo, THREADS // cv - 1))
    return cv, slices, -(-wo // strips), strips


def tile_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype, slots: int,
              tile_cost) -> TilePlan:
    """The plan for x = (n, h, w, c) on a card that holds ``slots`` blocks
    at once: the geometry, then the segment length that finishes soonest,
    each block taking ceil(tiles / grid) tiles of ``tile_cost(ks, segs)``;
    ties go to the longer segment."""
    cv, slices, ws, strips = tile_geometry(w, c, dtype)
    ho = h // 2
    grid = max(1, slots // slices)
    best = None
    for want in range(1, ho + 1):
        ks = -(-ho // want)
        segs = -(-ho // ks)
        cost = -(-(n * segs * strips) // grid) * tile_cost(ks, segs)
        if best is None or cost < best[0]:
            best = (cost, ks, segs)
    _, ks, segs = best
    tiles = n * segs * strips
    return TilePlan(cv, slices, ws, strips, ks, segs, tiles, min(grid, tiles))


def bwd_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
             slots: int) -> TilePlan:
    """The backward's plan: a tile of ks quad rows takes ks + 2 steps (a
    segment's first step recomputes one window row, and its stages reach
    one row past it)."""
    return tile_plan(n, h, w, c, dtype, slots, lambda ks, segs: ks + 2)


def check_shape(x: torch.Tensor) -> None:
    """What the stem kernels ask of x's shape: (N, H, W, C), H and W even,
    C at most 256 vectors."""
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            "bn_relu_pool_train requires even H and W (3x3/2 pool with "
            f"padding 1 over an even grid); got H={h}, W={w}")
    vec = vector_width(x.dtype)
    if n < 1 or h < 2 or w < 2 or c % vec or c // vec > 256:
        raise ValueError(
            f"the stem kernels take N >= 1 and C a multiple of {vec} "
            f"({x.dtype}) up to {256 * vec}; got {tuple(x.shape)}")


def launch_stem_fwd(x, a, b) -> torch.Tensor:
    """The forward kernel on dense NHWC x; a, b (C,) in x's dtype."""
    runtime.check_map("x", x)
    check_shape(x)
    n, h, w, c = x.shape
    runtime.check_vec("a", a, (c,), x.dtype, x.device)
    runtime.check_vec("b", b, (c,), x.dtype, x.device)
    out = torch.empty((n, h // 2, w // 2, c), device=x.device, dtype=x.dtype)
    runtime.launch(load_kernels(), "stem_fwd", x.device, x.data_ptr(),
                   a.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
                   int(x.dtype == torch.bfloat16), count="stem_fwd")
    return out


def launch_stem_bwd(x, g, a, b, mean, rstd):
    """The backward kernel (and the reduction of its partial sums):
    (dy in g's dtype, Σdy, Σdy·x̂)."""
    runtime.check_map("x", x)
    check_shape(x)
    n, h, w, c = x.shape
    runtime.check_map("g", g, like=x, shape=(n, h // 2, w // 2, c))
    runtime.check_vec("a", a, (c,), x.dtype, x.device)
    runtime.check_vec("b", b, (c,), x.dtype, x.device)
    runtime.check_vec("mean", mean, (c,), torch.float32, x.device)
    runtime.check_vec("rstd", rstd, (c,), torch.float32, x.device)
    lib = load_kernels()
    bf16 = int(x.dtype == torch.bfloat16)
    cv, _, ws, _ = tile_geometry(w, c, x.dtype)
    plan = bwd_plan(n, h, w, c, x.dtype, runtime.resident_blocks(
        lib, "stem_bwd", x.device.index, cv, ws, bf16))
    dy = torch.empty_like(x)
    partial = torch.empty((2, plan.grid, c), device=x.device, dtype=torch.float32)
    sums = torch.empty((2, c), device=x.device, dtype=torch.float32)
    runtime.launch(lib, "stem_bwd", x.device, x.data_ptr(), g.data_ptr(),
                   a.data_ptr(), b.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                   dy.data_ptr(), partial.data_ptr(), sums.data_ptr(), n, h, w,
                   c, bf16, *plan, count="stem_bwd")
    return dy, sums[0], sums[1]


def launch_stem_dx(x, dy, k1, nk2, nk3, mean) -> torch.Tensor:
    """The dx kernel on dense NHWC x and dy (x's dtype); k1, nk2 = −k2,
    nk3 = −k3·rstd and mean (C,) float32: dx in x's dtype."""
    runtime.check_map("x", x)
    check_shape(x)
    runtime.check_map("dy", dy, like=x)
    n, h, w, c = x.shape
    for name, t in (("k1", k1), ("nk2", nk2), ("nk3", nk3), ("mean", mean)):
        runtime.check_vec(name, t, (c,), torch.float32, x.device)
    lib = load_kernels()
    bf16 = int(x.dtype == torch.bfloat16)
    # a block takes THREADS // vectors positions a pass: no more blocks than
    # the positions need, nor than the card holds at once
    per = THREADS // (c // vector_width(x.dtype))
    grid = min(-(-n * h * w // per),
               runtime.resident_blocks(lib, "stem_dx", x.device.index, bf16))
    dx = torch.empty_like(x)
    runtime.launch(lib, "stem_dx", x.device, x.data_ptr(), dy.data_ptr(),
                   k1.data_ptr(), nk2.data_ptr(), nk3.data_ptr(),
                   mean.data_ptr(), dx.data_ptr(), n, h, w, c, bf16, grid,
                   count="stem_dx")
    return dx


# ---------------------------------------------------------------------------
# the public function
# ---------------------------------------------------------------------------


def batch_statistics(x: torch.Tensor, eps: float, group=None):
    """(mean, biased var, rstd) per channel of (N, H, W, C) x: float32 sums
    straight from the input (the square is taken in x's dtype, as
    ``jnp.square(x)`` is), var = max(E[x²] − E[x]², 0)."""
    mean = x.mean(dim=(0, 1, 2), dtype=torch.float32)
    mean2 = x.square().mean(dim=(0, 1, 2), dtype=torch.float32)
    if group is not None:  # the ranks' average of each rank's moments
        mean, mean2 = all_reduce_mean_(torch.stack([mean, mean2]), group)
    var = (mean2 - mean * mean).clamp_(min=0)
    return mean, var, torch.rsqrt(var + eps)


class _BnReluPool(torch.autograd.Function):
    """(pooled, mean, var) = f(x, scale, bias); eps and the route are not
    differentiable, and neither are the mean and var outputs: they feed
    running-statistics buffers (the JAX custom_vjp drops their cotangents).
    Neither is the group."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, use_kernels, group):
        mean, var, rstd = batch_statistics(x, eps, group)
        a = (rstd * scale).to(x.dtype)
        b = (bias - mean * rstd * scale).to(x.dtype)
        if use_kernels:
            pooled = launch_stem_fwd(x, a, b)
        else:
            pooled = stem_fwd_reference(x, a, b)
        ctx.save_for_backward(x, scale, mean, rstd, a, b)
        ctx.use_kernels, ctx.group = use_kernels, group
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, scale, mean, rstd, a, b = ctx.saved_tensors
        # the pooled gradient is a quarter of x: made dense here, x never is
        g = g.to(x.dtype).contiguous()
        if ctx.use_kernels:
            dy, sb, sg = launch_stem_bwd(x, g, a, b, mean, rstd)
        else:
            dy, sb, sg = stem_bwd_reference(x, g, a, b, mean, rstd)
        m_count = x.shape[0] * x.shape[1] * x.shape[2]
        total_b, total_g = sb, sg
        if ctx.group is not None:  # the whole batch's sums and count
            total_b, total_g = all_reduce_sum_(torch.stack([sb, sg]), ctx.group)
            m_count *= world_of(ctx.group)
        k1 = scale * rstd
        k2 = k1 * total_b / m_count
        k3 = k1 * total_g / m_count
        # dx = k1·dy − k2 − k3·x̂ in one pass, x̂'s factor rstd folded into k3
        dx_fn = launch_stem_dx if ctx.use_kernels else stem_dx_reference
        dx = dx_fn(x, dy, k1, -k2, -(k3 * rstd), mean)
        return dx, sg, sb, None, None, None


def _bn_relu_pool(x, scale, bias, eps, use_kernels, group=None):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            "bn_relu_pool_train requires even H and W (3x3/2 pool with "
            f"padding 1 over an even grid); got H={x.shape[1]}, "
            f"W={x.shape[2]}")
    return _BnReluPool.apply(x, scale, bias, float(eps), use_kernels, group)


def bn_relu_pool_train(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5, group=None):
    """maxpool3×3/2(relu(batchnorm_train(x))) with the minimal-residual
    backward.

    x (N, H, W, C), dense, H and W even, float32 or bfloat16; scale, bias
    (C,) float32. Returns (pooled, mean, var): pooled (N, H/2, W/2, C) in
    x's dtype; mean and var the float32 batch statistics (biased variance,
    what the normalisation used), which carry NO gradient: they exist to
    update running-statistics buffers. ``group``: the data-parallel ranks
    whose rows make up the batch (see the module docstring), None for this
    tensor alone.

    CUDA tensors run the Hopper kernels (``stem_fwd`` here, ``stem_bwd`` and
    ``stem_dx`` in backward) or raise; CPU tensors run the plain versions.
    """
    return _bn_relu_pool(x, scale, bias, eps, x.device.type != "cpu", group)


def bn_relu_pool_reference(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5):
    """The same function through the plain versions on any device: what
    the kernels are held against. Nothing on the main path calls it when a
    card is present."""
    return _bn_relu_pool(x, scale, bias, eps, False)
