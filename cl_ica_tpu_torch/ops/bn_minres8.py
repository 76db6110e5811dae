"""The minimal-residual batch norm with a float8 residual: ResNet(
norm_kind='minres8'). Hopper kernels and their plain PyTorch versions.

Port of cl_ica_tpu/ops/bn_minres8.py (``bn_relu8``, ``bn_add_relu8``,
``bn_only8``). The forward is ops/bn_minres.py's, bit for bit: the same
statistics kernel, y from the full-precision x. What the backward keeps is
not x but its normalised value rounded once to float8_e4m3fn,

    xq = e4m3fn((x − mean)·rstd)     (float32 arithmetic, one rounding)

beside scale, rstd, bias (the relu modes) and res (the residual add); the
mean is not kept. With xh = xq's value in dy's dtype, N the positions of a
channel and g = dy·1[xh·scale + bias (+ res) > 0] (dy for ``bn_only8``),

    dscale = Σg·xh,  dbias = Σg,  dx = A·g − B·xh − C,
    A = scale·rstd,  B = A·(Σg·xh)/N,  C = A·(Σg)/N

with A, B and C folded in float32 and rounded to dy's dtype, each product
and sum of dx rounded in it (the JAX ``_bwd_core8``). The relu gate is
read from the quantized xh (the JAX ``_mask8``): an element whose
pre-activation lies within xh's rounding of the kink takes the other
branch, so the gradients are those of a network whose gates read xq. The
add mode keeps res, as the JAX VJP does, and gates on xh·scale + bias +
res, where ops/bn_minres.py keeps its output y.

The conversion follows the JAX package's: nearest e4m3fn value, ties to
even; past 464 (the midpoint of 448, the largest value, and the next step
of the format), infinities and NaN give NaN with the value's sign (JAX on
the CPU; ROADMAP C9). PyTorch's own cast saturates to ±448 instead, so
``quantize_reference`` makes those bytes itself.

Three modes of the ops/bn_minres.py kernels do the work on the card
(csrc/bn_minres.cu, Q = true): ``bn_apply8`` writes xq beside y in the
apply pass, ``bn_bwd8`` and ``bn_dx8`` read xq (1 byte an element, where
minres reads x's 4 or 2). Their launches are counted beside the others'
(``ops.launch_counts``); the statistics are ``bn_stats``'s. Under a
data-parallel mesh (``group``) the statistics are the whole batch's
(ops/bn_minres.py) and so is xq's normalisation; the two backward sums are
summed over the ranks for dx, while dscale and dbias stay the rank's own.

On CPU tensors the functions run the plain versions (``apply8_reference``,
``bwd8_reference``, ``dx8_reference``); on CUDA tensors they launch the
kernels or raise, and never fall back.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import runtime
from .bn_minres import (
    affine,
    channel_stats,
    dense,
    kernel_mode,
    launch_stats,
    position_dims,
    pre_activation,
    prepare,
)
from .collectives import all_reduce_sum_, world_of

QDTYPE = torch.float8_e4m3fn
# |xhat| past this is NaN in the JAX package's conversion: the midpoint of
# 448, e4m3fn's largest value, and 480, the next step the format lacks
E4M3_OVERFLOW = 464.0
_NAN_BYTE, _NEG_NAN_BYTE = 0x7F, 0xFF


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def quantize_reference(x, mean, rstd) -> torch.Tensor:
    """xq = e4m3fn((x − mean)·rstd) of (..., C) x, the arithmetic in float32
    (the JAX ``_quantize``); NaN bytes (with the sign) past 464, for
    infinities and for NaN, as the JAX package's conversion gives them."""
    xh = (x.float() - mean) * rstd
    ok = xh.abs() <= E4M3_OVERFLOW
    # in range PyTorch's cast rounds as JAX's does (448 < |xh| ≤ 464 round
    # down to 448 in both); out of range the bytes are made here
    q = torch.where(ok, xh.clamp(-448.0, 448.0), 0.0).to(QDTYPE).view(torch.uint8)
    nan = torch.where(torch.signbit(xh), _NEG_NAN_BYTE, _NAN_BYTE).to(torch.uint8)
    return torch.where(ok, q, nan).view(QDTYPE)


def apply8_reference(x, a, b, mean, rstd, res: Optional[torch.Tensor] = None,
                     relu: bool = True):
    """The plain version of the apply kernel's float8 mode: (y, xq), y as
    ops/bn_minres.py ``bn_apply_reference`` makes it."""
    z = pre_activation(x, a, b, res)
    return (torch.relu(z) if relu else z), quantize_reference(x, mean, rstd)


def _masked8(xh, dy, s, t, res, relu):
    """g = dy·1[xh·s + t (+ res) > 0] in dy's dtype (the JAX ``_mask8``), dy
    itself without the relu."""
    if not relu:
        return dy
    z = pre_activation(xh, s, t, res)
    return torch.where(z > 0, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))


def bwd8_reference(xq, dy, s, t, res: Optional[torch.Tensor] = None,
                   relu: bool = True):
    """The plain version of the backward sums' float8 mode: (Σg, Σg·xh) per
    channel, float32 sums, g·xh in dy's dtype; s, t the scale and bias in
    dy's dtype."""
    xh = xq.to(dy.dtype)
    g = _masked8(xh, dy, s, t, res, relu)
    return (g.sum(dim=position_dims(g), dtype=torch.float32),
            (g * xh).sum(dim=position_dims(g), dtype=torch.float32))


def dx8_factors(scale, rstd, sum_g, sum_gxh, count: int, dtype: torch.dtype):
    """k = (A, B, −C) (3, C) in ``dtype`` for dx = A·g − B·xh + (−C), folded
    in float32 as the JAX ``_bwd_core8``."""
    inv = scale * rstd
    return torch.stack([inv, inv * (sum_gxh / count),
                        -(inv * (sum_g / count))]).to(dtype)


def dx8_reference(xq, dy, k, s, t, res: Optional[torch.Tensor] = None,
                  relu: bool = True):
    """The plain version of the dx kernel's float8 mode: (dx, g) with
    dx = A·g − B·xh + (−C), each operation rounded in dy's dtype."""
    xh = xq.to(dy.dtype)
    g = _masked8(xh, dy, s, t, res, relu)
    return k[0] * g - k[1] * xh + k[2], g


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_xq(xq, like) -> None:
    """xq: a dense CUDA float8_e4m3fn tensor of like's shape, 16-byte
    aligned."""
    if (xq.device != like.device or xq.dtype != QDTYPE or xq.shape != like.shape
            or not xq.is_contiguous() or xq.data_ptr() % 16):
        raise ValueError(f"xq must be a dense, 16-byte aligned "
                         f"{tuple(like.shape)} {QDTYPE} tensor on {like.device}, "
                         f"got {tuple(xq.shape)} {xq.dtype} on {xq.device}")


def launch_apply8(x, a, b, mean, rstd, res=None, relu: bool = True):
    """The apply kernel's float8 mode: (y, xq), y = relu(x·a + b (+ res)) or
    x·a + b; a, b (C,) in x's dtype, mean, rstd (C,) float32."""
    mode = kernel_mode(res, relu)
    lib, positions, c, bf16, grid = prepare(x, res, (("a", a), ("b", b)))
    for name, v in (("mean", mean), ("rstd", rstd)):
        runtime.check_vec(name, v, (c,), torch.float32, x.device)
    y = torch.empty_like(x)
    xq = torch.empty(x.shape, device=x.device, dtype=QDTYPE)
    runtime.launch(lib, "bn_apply8", x.device, x.data_ptr(),
                   (x if res is None else res).data_ptr(), a.data_ptr(),
                   b.data_ptr(), mean.data_ptr(), rstd.data_ptr(), y.data_ptr(),
                   xq.data_ptr(), positions, c, bf16, mode, grid,
                   count="bn_apply8")
    return y, xq


def launch_bwd8(xq, dy, s, t, res=None, relu: bool = True):
    """The backward sums kernel's float8 mode and its reduction: (Σg, Σg·xh),
    float32 (C,) views of one (2, C) tensor; s, t (C,) in dy's dtype."""
    mode = kernel_mode(res, relu)
    lib, positions, c, bf16, grid = prepare(dy, res, (("s", s), ("t", t)))
    _check_xq(xq, dy)
    partial = torch.empty((2, grid, c), device=dy.device, dtype=torch.float32)
    sums = torch.empty((2, c), device=dy.device, dtype=torch.float32)
    runtime.launch(lib, "bn_bwd8", dy.device, xq.data_ptr(), dy.data_ptr(),
                   (dy if res is None else res).data_ptr(), s.data_ptr(),
                   t.data_ptr(), partial.data_ptr(), sums.data_ptr(), positions,
                   c, bf16, mode, grid, count="bn_bwd8")
    return sums[0], sums[1]


def launch_dx8(xq, dy, k, s, t, res=None, relu: bool = True):
    """The dx kernel's float8 mode: (dx, g), dx = A·g − B·xh + (−C) with
    k = (A, B, −C) (3, C) in dy's dtype; given res, g is written too (the
    residual's gradient), else None."""
    mode = kernel_mode(res, relu)
    lib, positions, c, bf16, grid = prepare(dy, res, (("s", s), ("t", t),
                                                      ("k", k)))
    _check_xq(xq, dy)
    dx = torch.empty_like(dy)
    g = torch.empty_like(dy) if res is not None else None
    runtime.launch(lib, "bn_dx8", dy.device, xq.data_ptr(), dy.data_ptr(),
                   (dy if res is None else res).data_ptr(), s.data_ptr(),
                   t.data_ptr(), k.data_ptr(), dx.data_ptr(),
                   (dx if g is None else g).data_ptr(), positions, c, bf16,
                   mode, grid, count="bn_dx8")
    return dx, g


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------


class _MinRes8BN(torch.autograd.Function):
    """(y, mean, var) = f(x, res, scale, bias) for the three functions, as
    ops/bn_minres.py's ``_MinResBN`` with the float8 residual. Saved: xq,
    res (the add mode), and (C,) vectors."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, eps, relu, use_kernels, group):
        stats = launch_stats if use_kernels else channel_stats
        mean, var, rstd = stats(x, eps, group)
        a, b = affine(scale, bias, mean, rstd, x.dtype)
        apply = launch_apply8 if use_kernels else apply8_reference
        y, xq = apply(x, a, b, mean, rstd, res, relu)
        ctx.save_for_backward(xq, res, scale, bias, rstd)
        ctx.relu, ctx.use_kernels, ctx.group = relu, use_kernels, group
        ctx.dtype = x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        xq, res, scale, bias, rstd = ctx.saved_tensors
        dy = dense(dy, ctx.dtype)
        s, t = scale.to(ctx.dtype), bias.to(ctx.dtype)
        sums = launch_bwd8 if ctx.use_kernels else bwd8_reference
        sum_g, sum_gxh = sums(xq, dy, s, t, res, ctx.relu)
        # dscale and dbias are this rank's; dx takes the whole batch's sums
        count, totals = xq.numel() // xq.shape[-1], (sum_g, sum_gxh)
        if ctx.group is not None:
            totals = all_reduce_sum_(torch.stack(totals), ctx.group)
            count *= world_of(ctx.group)
        k = dx8_factors(scale, rstd, *totals, count, ctx.dtype)
        dx_fn = launch_dx8 if ctx.use_kernels else dx8_reference
        dx, g = dx_fn(xq, dy, k, s, t, res, ctx.relu)
        return (dx, g if res is not None else None, sum_gxh, sum_g, None, None,
                None, None)


def _minres8(x, res, scale, bias, eps, relu, use_kernels, group=None):
    if x.ndim < 2:
        raise ValueError(f"x must be (..., C), got {tuple(x.shape)}")
    return _MinRes8BN.apply(x, res, scale, bias, float(eps), relu, use_kernels,
                            group)


def bn_relu8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5, group=None):
    """Training-mode batch norm → relu keeping the float8 xq for the
    backward. As ops/bn_minres.py ``bn_relu`` otherwise: (y, mean, var), y
    bit for bit its y; mean and var carry no gradient."""
    return _minres8(x, None, scale, bias, eps, True, x.device.type != "cpu",
                    group)


def bn_add_relu8(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, eps: float = 1e-5, group=None):
    """Training-mode batch norm of x, + res, → relu, keeping xq and res;
    res's gradient is g. As ``bn_relu8`` otherwise."""
    return _minres8(x, res, scale, bias, eps, True, x.device.type != "cpu",
                    group)


def bn_only8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5, group=None):
    """Training-mode batch norm with no activation, keeping xq. As
    ``bn_relu8`` otherwise."""
    return _minres8(x, None, scale, bias, eps, False, x.device.type != "cpu",
                    group)
