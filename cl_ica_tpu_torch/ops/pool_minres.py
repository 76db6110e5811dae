"""The argmax-code stem tail: batch norm → relu → 3×3/2 max pool with the
minimal-residual backward of ResNet(stem_pool='argmax'). Hopper kernels
and their plain PyTorch versions.

Port of cl_ica_tpu/ops/pool_minres.py (``bn_relu_pool``):

    pooled = maxpool3×3/2,pad 1(relu(x·a + b)),   a, b per channel

with the minres norm's statistics and arithmetic (ops/bn_minres.py: a, b
and relu(x·a + b) in x's dtype), so pooled equals
``F.max_pool2d(bn_relu(x))`` bit for bit. Beside pooled the forward keeps a
byte a pooled value, the code: the row-major position 0..8, in the padded
3×3 window, of the window's first maximum (positions outside the image
never win; a zero after the relu is a value, so an all-zero window names
its first position in the image, as ``F.max_pool2d`` and XLA's
SelectAndScatter do). The backward keeps x, the code and (C,) vectors, not
relu(x·a + b) and not int64 indices: it scatters the pooled gradient to
the positions the codes name (the JAX nine-offset stencil ``_dz_stencil``:
each position gathers from the at most four windows that reach it), then
takes bn_relu's backward on (x, dz): the relu mask from x·a + b > 0, the
two channel sums and dx.

The kernels: the statistics are ops/bn_minres.py's ``bn_stats``; the
forward is ``pool_code`` (csrc/stem_pool.cu ``pool_code_kernel``: x staged
by bulk copies, z once an input element, on the persistent grid that
``pool_code_plan`` plans); the scatter is ``pool_scatter`` (same file);
the backward sums and dx are ``bn_bwd`` and ``bn_dx`` in bn_relu's mode.
Launches are counted (``ops.launch_counts``). Under a data-parallel mesh
(``group``) the statistics and the backward sums are the whole batch's, as
in ops/bn_minres.py.

Layout: (N, H, W, C) dense, H and W even (otherwise it raises, as the JAX
function does), C a multiple of the 16-byte vector, at most 256 vectors;
``takes(x)`` says whether the kernels take x. On CPU tensors the plain
versions run (``pool_code_reference``, ``pool_scatter_reference`` and
ops/bn_minres.py's); on CUDA tensors the kernels, or it raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import runtime
from .bn_minres import (
    affine,
    bn_apply_reference,
    bn_bwd_reference,
    bn_dx_reference,
    channel_stats,
    dense,
    dx_factors,
    launch_bwd,
    launch_dx,
    launch_stats,
    param_grads,
)
from .collectives import all_reduce_sum_, world_of
from .stem import (
    TilePlan,
    check_shape,
    load_kernels,
    pool_views,
    tile_geometry,
    tile_plan,
)

NO_WINDOW = 9  # a code that names no position (outside the pooled map)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def pool_code_reference(x, a, b):
    """The plain version of the code kernel: (pooled, code), pooled in x's
    dtype, code uint8 (N, H/2, W/2, C): the first maximum of relu(x·a + b)
    (in x's dtype, as ``bn_apply_reference``) over the row-major window
    views, the padding −inf (the JAX ``_pool_fwd_core``)."""
    z = bn_apply_reference(x, a, b, None, True)
    views = pool_views(F.pad(z, (0, 0, 1, 1, 1, 1), value=float("-inf")))
    m = views[0].clone()
    code = torch.zeros(m.shape, dtype=torch.uint8, device=x.device)
    for k in range(1, 9):
        take = views[k] > m  # strict: a tie keeps the earlier position
        m = torch.where(take, views[k], m)
        code.masked_fill_(take, k)
    return m, code


def pool_scatter_reference(dp, code, h: int, w: int):
    """The plain version of the scatter kernel, the JAX ``_dz_stencil``: the
    pooled gradient and the codes placed at the window centres of the
    padded (h + 2, w + 2) grid, then nine shifted reads, each adding the
    gradient of the window whose code names the position, in dp's dtype, in
    the stencil's order."""
    n, _, _, c = dp.shape
    dpd = torch.zeros((n, h + 2, w + 2, c), dtype=dp.dtype, device=dp.device)
    coded = torch.full((n, h + 2, w + 2, c), NO_WINDOW, dtype=torch.uint8,
                       device=dp.device)
    dpd[:, 1:h:2, 1:w:2] = dp
    coded[:, 1:h:2, 1:w:2] = code
    zero = torch.zeros((), dtype=dp.dtype, device=dp.device)
    dz = None
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            # the window centred at (i + dr, j + dc) credits position (i, j)
            # where its winner sits at (1 − dr, 1 − dc)
            req = (1 - dr) * 3 + (1 - dc)
            rows, cols = slice(1 + dr, 1 + dr + h), slice(1 + dc, 1 + dc + w)
            term = torch.where(coded[:, rows, cols] == req, dpd[:, rows, cols], zero)
            dz = term if dz is None else dz + term
    return dz


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def pool_code_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
                   slots: int) -> TilePlan:
    """The code kernel's plan for x = (n, h, w, c) on a card that holds
    ``slots`` of its blocks at once (stem.tile_plan): a tile of ks window
    rows reads 2·ks rows of x, and one more, the row above, unless its
    segment is its image's only one."""
    return tile_plan(n, h, w, c, dtype, slots, lambda ks, segs: 2 * ks + (segs > 1))


def launch_pool_code(x, a, b):
    """The code kernel on dense NHWC x; a, b (C,) in x's dtype: (pooled,
    code)."""
    runtime.check_map("x", x)
    check_shape(x)
    n, h, w, c = x.shape
    runtime.check_vec("a", a, (c,), x.dtype, x.device)
    runtime.check_vec("b", b, (c,), x.dtype, x.device)
    lib = load_kernels()
    bf16 = int(x.dtype == torch.bfloat16)
    cv, _, ws, _ = tile_geometry(w, c, x.dtype)
    plan = pool_code_plan(n, h, w, c, x.dtype, runtime.resident_blocks(
        lib, "pool_code", x.device.index, cv, ws, bf16))
    out = torch.empty((n, h // 2, w // 2, c), device=x.device, dtype=x.dtype)
    code = torch.empty(out.shape, device=x.device, dtype=torch.uint8)
    runtime.launch(lib, "pool_code", x.device, x.data_ptr(), a.data_ptr(),
                   b.data_ptr(), out.data_ptr(), code.data_ptr(), n, h, w, c,
                   bf16, *plan, count="pool_code")
    return out, code


def launch_pool_scatter(dp, code, h: int, w: int):
    """The scatter kernel: dz (N, h, w, C) in dp's dtype from the dense
    pooled gradient dp and the codes (N, h/2, w/2, C)."""
    runtime.check_map("dp", dp)
    n, ho, wo, c = dp.shape
    if (h, w) != (2 * ho, 2 * wo):
        raise ValueError(f"dp {tuple(dp.shape)} is not the pooled map of {h}x{w}")
    if (code.device != dp.device or code.dtype != torch.uint8
            or code.shape != dp.shape or not code.is_contiguous()
            or code.data_ptr() % 16):
        raise ValueError(f"code must be a dense, 16-byte aligned "
                         f"{tuple(dp.shape)} uint8 tensor on {dp.device}, got "
                         f"{tuple(code.shape)} {code.dtype} on {code.device}")
    dz = torch.empty((n, h, w, c), device=dp.device, dtype=dp.dtype)
    check_shape(dz)
    runtime.launch(load_kernels(), "pool_scatter", dp.device, dp.data_ptr(),
                   code.data_ptr(), dz.data_ptr(), n, h, w, c,
                   int(dp.dtype == torch.bfloat16), count="pool_scatter")
    return dz


# ---------------------------------------------------------------------------
# the public function
# ---------------------------------------------------------------------------


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take x (N, H, W, C): float32 or bfloat16, and the
    shapes ``stem.check_shape`` admits (H and W even, C a multiple of the
    16-byte vector, at most 256 vectors)."""
    if x.ndim != 4 or x.dtype not in runtime.DTYPES:
        return False
    try:
        check_shape(x)
    except ValueError:
        return False
    return True


class _BnReluPoolCode(torch.autograd.Function):
    """(pooled, mean, var) = f(x, scale, bias); eps, the route and the group
    are not differentiable, and neither are mean and var (they feed the
    running statistics). Saved: x, the code, (C,) vectors."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, use_kernels, group):
        stats = launch_stats if use_kernels else channel_stats
        mean, var, rstd = stats(x, eps, group)
        a, b = affine(scale, bias, mean, rstd, x.dtype)
        pool = launch_pool_code if use_kernels else pool_code_reference
        pooled, code = pool(x, a, b)
        ctx.save_for_backward(x, code, scale, bias, mean, rstd)
        ctx.use_kernels, ctx.group = use_kernels, group
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, dp, _d_mean, _d_var):
        x, code, scale, bias, mean, rstd = ctx.saved_tensors
        dp = dense(dp, x.dtype)
        scatter = launch_pool_scatter if ctx.use_kernels else pool_scatter_reference
        dz = scatter(dp, code, x.shape[1], x.shape[2])
        a, b = affine(scale, bias, mean, rstd, x.dtype)
        sums = launch_bwd if ctx.use_kernels else bn_bwd_reference
        sum_g, sum_gx, _ = sums(x, dz, a, b, None, True)
        # dscale and dbias are this rank's; dx takes the whole batch's sums
        dscale, dbias = param_grads(mean, rstd, sum_g, sum_gx)
        count, totals = x.numel() // x.shape[-1], (sum_g, sum_gx)
        if ctx.group is not None:
            totals = all_reduce_sum_(torch.stack(totals), ctx.group)
            count *= world_of(ctx.group)
        k = dx_factors(scale, mean, rstd, *totals, count, x.dtype)[2]
        dx_fn = launch_dx if ctx.use_kernels else bn_dx_reference
        dx = dx_fn(x, dz, k, a, b, True)
        return dx, dscale, dbias, None, None, None


def bn_relu_pool(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5, group=None):
    """maxpool3×3/2(relu(batchnorm_train(x))) keeping the argmax code.

    x (N, H, W, C) dense, H and W even, float32 or bfloat16; scale, bias
    (C,) float32. Returns (pooled, mean, var): pooled (N, H/2, W/2, C) in
    x's dtype; mean and the biased var, float32, carry no gradient.
    ``group``: the data-parallel ranks (ops/bn_minres.py). CUDA tensors run
    the kernels or raise; CPU tensors the plain versions."""
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"bn_relu_pool requires even H, W; got "
                         f"{(x.shape[1], x.shape[2])}")
    return _BnReluPoolCode.apply(x, scale, bias, float(eps),
                                 x.device.type != "cpu", group)
