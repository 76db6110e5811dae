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

The two kernels are CUDA C++ in csrc/stem_pool.cu (see the note there):
``stem_fwd`` (affine, relu, pool) and ``stem_bwd`` (winner recompute,
routing, mask, channel sums). As in the JAX package, the batch statistics,
dx = k1·dy − k2 − k3·x̂ and the parameter gradients stay plain tensor
operations around them. This module builds and binds the kernels, wraps
them in a ``torch.autograd.Function``, and counts their launches beside
the InfoNCE kernels' (``ops.launch_counts``: ``stem_fwd``, ``stem_bwd``).

Layout: (N, H, W, C), dense, as in the JAX package. H and W even; C a
multiple of the kernels' 16-byte vector (4 float32, 8 bfloat16 values),
at most 256 vectors. float32 and bfloat16.

On CPU tensors ``bn_relu_pool_train`` runs the plain versions
(``stem_fwd_reference``, ``stem_bwd_reference``), because there is no
kernel to launch there. On CUDA tensors it launches the kernels or raises;
it never falls back, and it never copies x to make it dense.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .build import load_library
from .infonce import _check_launch, _launches, _stream

LIBRARY = "stem_pool"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)


def vector_width(dtype: torch.dtype) -> int:
    """Channels per 16-byte vector of the kernels."""
    return 8 if dtype == torch.bfloat16 else 4


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _affine(x, a, b):
    """x·a + b in float32, the product and the sum each rounded (two
    operations, as in the kernels; not ``addcmul``)."""
    y = x.float() * a.float()
    return y.add_(b.float())


def _pool_views(zp):
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
    views = _pool_views(F.pad(z, (0, 0, 1, 1, 1, 1)))
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
    views = _pool_views(
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


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library, with every
    entry point's C signature declared."""
    lib = load_library(LIBRARY)
    lib.clica_stem_sum_rows.argtypes = [_LL, _I, _I, _I, _I]
    lib.clica_stem_sum_rows.restype = _I
    lib.clica_stem_fwd.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
    lib.clica_stem_fwd.restype = _I
    lib.clica_stem_bwd.argtypes = [_P] * 9 + [_LL, _I, _I, _I, _I, _P]
    lib.clica_stem_bwd.restype = _I
    lib.clica_error_string.argtypes = [_I]
    lib.clica_error_string.restype = ctypes.c_char_p
    return lib


def _check_map(name: str, t: torch.Tensor, like: torch.Tensor = None) -> None:
    """What the kernels ask of x, g: a dense (N, H, W, C) CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{name} must be (N, H, W, C), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(
            f"{name} must be dense (N, H, W, C) memory, got strides "
            f"{t.stride()} for shape {tuple(t.shape)}; the wrapper does not "
            "copy it (for a channels_last NCHW tensor pass "
            "t.permute(0, 2, 3, 1))")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if like is not None and (t.dtype != like.dtype or t.device != like.device):
        raise ValueError(f"{name} is {t.dtype} on {t.device}, x is "
                         f"{like.dtype} on {like.device}")


def _check_shape(x: torch.Tensor) -> None:
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


def _check_vec(name: str, t: torch.Tensor, c: int, dtype, device) -> None:
    if (t.shape != (c,) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({c},) {dtype} tensor "
                         f"on {device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def launch_stem_fwd(x, a, b) -> torch.Tensor:
    """The forward kernel on dense NHWC x; a, b (C,) in x's dtype."""
    _check_map("x", x)
    _check_shape(x)
    n, h, w, c = x.shape
    _check_vec("a", a, c, x.dtype, x.device)
    _check_vec("b", b, c, x.dtype, x.device)
    lib = load_kernels()
    out = torch.empty((n, h // 2, w // 2, c), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = lib.clica_stem_fwd(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                out.data_ptr(), n, h, w, c,
                                int(x.dtype == torch.bfloat16), _stream(x))
    _check_launch(lib, rc, "stem fwd")
    _launches["stem_fwd"] += 1
    return out


def launch_stem_bwd(x, g, a, b, mean, rstd):
    """The backward kernel (and the reduction of its partial sums):
    (dy in g's dtype, Σdy, Σdy·x̂)."""
    _check_map("x", x)
    _check_shape(x)
    n, h, w, c = x.shape
    _check_map("g", g, like=x)
    if g.shape != (n, h // 2, w // 2, c):
        raise ValueError(f"g must be {(n, h // 2, w // 2, c)}, got {tuple(g.shape)}")
    _check_vec("a", a, c, x.dtype, x.device)
    _check_vec("b", b, c, x.dtype, x.device)
    _check_vec("mean", mean, c, torch.float32, x.device)
    _check_vec("rstd", rstd, c, torch.float32, x.device)
    lib = load_kernels()
    bf16 = int(x.dtype == torch.bfloat16)
    rows = lib.clica_stem_sum_rows(n, h, w, c, bf16)
    if rows < 1:
        raise ValueError(f"the stem kernels do not take shape {tuple(x.shape)}")
    dy = torch.empty_like(x)
    partial = torch.empty((2, rows, c), device=x.device, dtype=torch.float32)
    sums = torch.empty((2, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = lib.clica_stem_bwd(x.data_ptr(), g.data_ptr(), a.data_ptr(),
                                b.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                dy.data_ptr(), partial.data_ptr(),
                                sums.data_ptr(), n, h, w, c, bf16, _stream(x))
    _check_launch(lib, rc, "stem bwd")
    _launches["stem_bwd"] += 1
    return dy, sums[0], sums[1]


# ---------------------------------------------------------------------------
# the public function
# ---------------------------------------------------------------------------


def batch_statistics(x: torch.Tensor, eps: float):
    """(mean, biased var, rstd) per channel of (N, H, W, C) x: float32 sums
    straight from the input (the square is taken in x's dtype, as
    ``jnp.square(x)`` is), var = max(E[x²] − E[x]², 0)."""
    mean = x.mean(dim=(0, 1, 2), dtype=torch.float32)
    mean2 = x.square().mean(dim=(0, 1, 2), dtype=torch.float32)
    var = (mean2 - mean * mean).clamp_(min=0)
    return mean, var, torch.rsqrt(var + eps)


class _BnReluPool(torch.autograd.Function):
    """(pooled, mean, var) = f(x, scale, bias); eps and the route are not
    differentiable, and neither are the mean and var outputs: they feed
    running-statistics buffers (the JAX custom_vjp drops their cotangents)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, use_kernels):
        mean, var, rstd = batch_statistics(x, eps)
        a = (rstd * scale).to(x.dtype)
        b = (bias - mean * rstd * scale).to(x.dtype)
        if use_kernels:
            pooled = launch_stem_fwd(x, a, b)
        else:
            pooled = stem_fwd_reference(x, a, b)
        ctx.save_for_backward(x, scale, mean, rstd, a, b)
        ctx.use_kernels = use_kernels
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
        k1 = scale * rstd
        k2 = k1 * sb / m_count
        k3 = k1 * sg / m_count
        # dx = k1·dy − k2 − k3·x̂ in three passes: (k1·dy − k2), (x − mean),
        # and their sum with x̂'s factor rstd folded into k3
        dx = torch.addcmul(-k2, dy, k1)
        dx.addcmul_(x.float() - mean, -(k3 * rstd))
        return dx.to(x.dtype), sg, sb, None, None


def _bn_relu_pool(x, scale, bias, eps, use_kernels):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            "bn_relu_pool_train requires even H and W (3x3/2 pool with "
            f"padding 1 over an even grid); got H={x.shape[1]}, "
            f"W={x.shape[2]}")
    return _BnReluPool.apply(x, scale, bias, float(eps), use_kernels)


def bn_relu_pool_train(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5):
    """maxpool3×3/2(relu(batchnorm_train(x))) with the minimal-residual
    backward.

    x (N, H, W, C), dense, H and W even, float32 or bfloat16; scale, bias
    (C,) float32. Returns (pooled, mean, var): pooled (N, H/2, W/2, C) in
    x's dtype; mean and var the float32 batch statistics (biased variance,
    what the normalisation used), which carry NO gradient: they exist to
    update running-statistics buffers.

    CUDA tensors run the Hopper kernels (``stem_fwd`` here, ``stem_bwd`` in
    backward) or raise; CPU tensors run the plain versions.
    """
    return _bn_relu_pool(x, scale, bias, eps, x.device.type != "cpu")


def bn_relu_pool_reference(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5):
    """The same function through the plain versions on any device: what
    the kernels are held against. Nothing on the main path calls it when a
    card is present."""
    return _bn_relu_pool(x, scale, bias, eps, False)
