"""The minimal-residual batch norm (+ residual add) (+ relu) of the ResNet
blocks, training mode: Hopper kernels and their plain PyTorch versions.

Port of cl_ica_tpu/ops/bn_minres.py (``bn_relu``, ``bn_add_relu``,
``bn_only``):

    y = relu(x·a + b),  relu(x·a + b + res),  x·a + b

with a = scale·rstd and b = bias − mean·a per channel, in x's dtype, from
the batch's own float32 statistics (the square taken in x's dtype, var =
max(E[x²] − E[x]², 0)). Each function is a ``torch.autograd.Function``
that saves only x and the per-channel vectors (and, for ``bn_add_relu``,
its own output y); its backward takes the relu mask g = dy·1[x·a + b > 0]
(recomputed from x) or, for ``bn_add_relu``, g = dy·1[y > 0], and makes
two passes, the channel sums Σg and Σg·x, then

    dx = A·g − B·x + C   (A, B, C per channel, folded in float32,
                          applied in x's dtype)

and, for ``bn_add_relu``, g itself as the residual's gradient, written by
the sums' pass and read by dx's. The batch mean and var returned beside y
feed running statistics and carry no gradient, as in the JAX custom VJPs.

``bn_add_relu`` returns its output twice, y and y_res, one tensor as two
autograd edges: a ResNet block's output feeds the next block's first
convolution and its shortcut, and with one edge each their gradients reach
the backward apart, as dy and dy_res, where autograd would add them in a
pass of its own. The sums' pass adds them, rounded once to x's dtype as
that add rounds them, so every gradient is the sum's bit for bit, and a
block junction's backward reads and writes 8 passes of the block's output
size where the add and the backward made 11. An edge left unused brings no
gradient (None), and one addend is the plain backward.

Where the JAX ``bn_add_relu`` keeps res and recomputes the mask from
x·a + b + res, this one keeps y: y > 0 exactly where x·a + b + res > 0,
and y is kept by the next layer anyway (the next block's convolution, or
the mean pool's relu in the plain composition), where res of a projection
shortcut is kept for this norm alone. Keeping res raised the step's peak
memory above the plain norm's under autograd (0.57 GiB at ResNet18, 512
pairs, float32: PERF.md); both read one tensor more in the backward.

The JAX package leaves these passes to XLA; here they are four CUDA
kernels in csrc/bn_minres.cu (see the note there): ``bn_stats`` (the
statistics, with the reduction of its per-block sums), ``bn_apply``,
``bn_bwd`` (the two sums, with their reduction) and ``bn_dx``. Their
launches are counted beside the other kernels' (``ops.launch_counts``).
The per-channel folds (a, b; dscale, dbias, A, B, C) stay plain tensor
operations on (C,) vectors.

Layout: x, res, y and dy are dense (..., C) memory, which is what the
permuted NHWC view of a ``channels_last`` NCHW tensor is; C a multiple
of the kernels' 16-byte vector (4 float32, 8 bfloat16 values). An
upstream gradient that is not dense (the global mean pool's backward
hands the last block a broadcast one) is copied dense first, and such
copies are counted (``dy_copies``).

Under a data-parallel mesh (``group``: the ranks of parallel/, each with
its rows of the batch) the statistics and the backward sums are the whole
batch's. The forward averages each rank's moments, mean and E[x²], over
the ranks (equal row counts) before var and rstd are formed from them;
the backward sums Σg and Σg·x over the ranks and folds dx with the global
count, while dscale and dbias stay the rank's own, since the parameters'
gradients are averaged over the ranks afterwards (parallel/sharded.py).
With no group nothing communicates and every value is what it was.

On CPU tensors the functions run the plain versions (``channel_stats``,
``bn_apply_reference``, ``bn_bwd_reference``, ``bn_dx_reference``),
because there is no kernel to launch there. On CUDA tensors they launch
the kernels or raise; they never fall back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .build import load_library
from .collectives import all_reduce_mean_, all_reduce_sum_, world_of
from .infonce import _check_launch, _launches, _stream

LIBRARY = "bn_minres"
THREADS = 256  # a block's threads
BLOCKS_PER_SM = 4  # the grid: at most this many blocks an SM, one wave
ONLY, RELU, ADD_RELU = 0, 1, 2  # the kernels' modes

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)

# Upstream gradients made dense by a copy since the last reset (under a
# CUDA graph's capture, the capture's copies only).
_copies: Dict[str, int] = {"dy": 0}


def dy_copies() -> int:
    return _copies["dy"]


def reset_dy_copies() -> None:
    _copies["dy"] = 0


def vector_width(dtype: torch.dtype) -> int:
    """Channels per 16-byte vector of the kernels."""
    return 8 if dtype == torch.bfloat16 else 4


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _dims(x: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(x.ndim - 1))


def channel_stats(x: torch.Tensor, eps: float, group=None):
    """(mean, var, rstd), float32 per channel of (..., C) x: float32 means
    straight from the input, the square taken in x's dtype (as
    ``jnp.square(x)``), var = max(E[x²] − E[x]², 0), rstd = 1/√(var + eps).
    With a group, mean and E[x²] are first averaged over the ranks."""
    mean = x.mean(dim=_dims(x), dtype=torch.float32)
    mean2 = x.square().mean(dim=_dims(x), dtype=torch.float32)
    if group is not None:
        mean, mean2 = all_reduce_mean_(torch.stack([mean, mean2]), group)
    var = (mean2 - mean * mean).clamp_(min=0)
    return mean, var, torch.rsqrt(var + eps)


def affine(scale, bias, mean, rstd, dtype: torch.dtype):
    """(a, b) in ``dtype``: a = scale·rstd, b = bias − mean·a, folded in
    float32 (the JAX ``_affine``)."""
    inv = scale * rstd
    return inv.to(dtype), (bias - mean * inv).to(dtype)


def _pre(x, a, b, res):
    """x·a + b (+ res) in x's dtype, each operation rounded."""
    z = x * a + b
    return z if res is None else z + res


def bn_apply_reference(x, a, b, res: Optional[torch.Tensor] = None,
                       relu: bool = True) -> torch.Tensor:
    """The plain version of the apply kernel: relu(x·a + b (+ res)), or
    x·a + b without the relu, in x's dtype."""
    z = _pre(x, a, b, res)
    return torch.relu(z) if relu else z


def _masked(x, dy, a, b, y, relu):
    """g = dy·1[x·a + b > 0] (the JAX ``_mask_grad``), or dy·1[y > 0] given
    bn_add_relu's output y; dy itself without the relu."""
    if not relu:
        return dy
    z = y if y is not None else _pre(x, a, b, None)
    return torch.where(z > 0, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))


def bn_bwd_reference(x, dy, a, b, y: Optional[torch.Tensor] = None,
                     relu: bool = True, dy_res: Optional[torch.Tensor] = None):
    """The plain version of the backward sums: (Σg, Σg·x, g), float32 sums
    per channel, g·x taken in x's dtype (the JAX ``_bn_bwd_core``). y is
    bn_add_relu's output, whose sign is the mask; then g is returned (else
    None), and dy_res, where given, is added to dy first in x's dtype."""
    if dy_res is not None:
        dy = dy + dy_res
    g = _masked(x, dy, a, b, y, relu)
    return (g.sum(dim=_dims(x), dtype=torch.float32),
            (g * x).sum(dim=_dims(x), dtype=torch.float32),
            g if y is not None else None)


def param_grads(mean, rstd, sum_g, sum_gx):
    """(dscale, dbias) from the backward sums, in float32."""
    return (sum_gx - mean * sum_g) * rstd, sum_g


def dx_factors(scale, mean, rstd, sum_g, sum_gx, count: int,
               dtype: torch.dtype):
    """(dscale, dbias, k) from the backward sums, as the JAX
    ``_bn_bwd_core`` folds them in float32: dscale = (Σg·x − mean·Σg)·rstd,
    dbias = Σg, and k = (A, B, C) (3, C) in ``dtype`` for
    dx = A·g − B·x + C."""
    dscale, dbias = param_grads(mean, rstd, sum_g, sum_gx)
    inv = scale * rstd
    big_b = inv * rstd * (dscale / count)
    big_c = inv * (rstd * (dscale / count) * mean - sum_g / count)
    return dscale, dbias, torch.stack([inv, big_b, big_c]).to(dtype)


def bn_dx_reference(x, dy, k, a, b, relu: bool = True):
    """The plain version of the dx kernel: dx = A·g − B·x + C in x's dtype,
    each operation rounded, g = dy·1[x·a + b > 0], or dy without the relu
    (bn_only, and bn_add_relu on its g)."""
    g = _masked(x, dy, a, b, None, relu)
    return k[0] * g - k[1] * x + k[2]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return declare(load_library(LIBRARY))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of a library built
    from csrc/bn_minres.cu."""
    lib.clica_bn_stats.argtypes = [_P, _P, _P, _LL, _I, _I, _I,
                                   ctypes.c_float, _P]
    lib.clica_bn_stats.restype = _I
    lib.clica_bn_moments.argtypes = [_P, _P, _P, _LL, _I, _I, _I, _P]
    lib.clica_bn_moments.restype = _I
    lib.clica_bn_finish.argtypes = [_P, _P, _I, ctypes.c_float, _P]
    lib.clica_bn_finish.restype = _I
    lib.clica_bn_apply.argtypes = [_P] * 5 + [_LL, _I, _I, _I, _I, _P]
    lib.clica_bn_apply.restype = _I
    lib.clica_bn_bwd.argtypes = [_P] * 9 + [_LL, _I, _I, _I, _I, _P]
    lib.clica_bn_bwd.restype = _I
    lib.clica_bn_dx.argtypes = [_P] * 6 + [_LL, _I, _I, _I, _I, _P]
    lib.clica_bn_dx.restype = _I
    # the float8 modes (ops/bn_minres8.py)
    lib.clica_bn_apply8.argtypes = [_P] * 8 + [_LL, _I, _I, _I, _I, _P]
    lib.clica_bn_apply8.restype = _I
    lib.clica_bn_bwd8.argtypes = [_P] * 7 + [_LL, _I, _I, _I, _I, _P]
    lib.clica_bn_bwd8.restype = _I
    lib.clica_bn_dx8.argtypes = [_P] * 8 + [_LL, _I, _I, _I, _I, _P]
    lib.clica_bn_dx8.restype = _I
    lib.clica_error_string.argtypes = [_I]
    lib.clica_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def grid_rows(positions: int, c: int, dtype: torch.dtype, sms: int) -> int:
    """The kernels' grid for ``positions`` rows of ``c`` channels: a block's
    threads take THREADS // (vectors of its slice) positions a pass (C in
    the fewest slices of at most THREADS vectors); as many blocks as the
    positions need, at most BLOCKS_PER_SM an SM. The sums kernels write
    one row of partial sums a block."""
    cvs = c // vector_width(dtype)
    slices = -(-cvs // THREADS)
    per = THREADS // -(-cvs // slices)
    return max(1, min(-(-positions // per), BLOCKS_PER_SM * sms))


def _check_map(name: str, t: torch.Tensor, like: torch.Tensor = None) -> None:
    """What the kernels ask of x, res, y, dy: a dense (..., C) CUDA tensor,
    float32 or bfloat16, C a multiple of the vector width."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.ndim < 2 or t.numel() == 0:
        raise ValueError(f"{name} must be (..., C) and not empty, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(
            f"{name} must be dense (..., C) memory, got strides {t.stride()} "
            f"for shape {tuple(t.shape)}; the wrapper does not copy it (for a "
            "channels_last NCHW tensor pass t.permute(0, 2, 3, 1))")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    vec = vector_width(t.dtype)
    if t.shape[-1] % vec:
        raise ValueError(f"{name}: C = {t.shape[-1]} is not a multiple of "
                         f"{vec} ({t.dtype})")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"x is {tuple(like.shape)} {like.dtype} on {like.device}")


def _check_vec(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if (t.shape != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"{shape} {dtype} tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _prepare(x, other, vectors):
    """Check x (and res or y) and the (C,) or (3, C) vectors in x's dtype;
    the library, the mode-independent launch arguments and the grid."""
    _check_map("x", x)
    if other is not None:
        _check_map("res or y", other, like=x)
    c = x.shape[-1]
    for name, t in vectors:
        _check_vec(name, t, (c,) if name != "k" else (3, c), x.dtype, x.device)
    positions = x.numel() // c
    grid = grid_rows(positions, c, x.dtype, _sms(x.device.index))
    return load_kernels(), positions, c, int(x.dtype == torch.bfloat16), grid


def _mode(other, relu: bool) -> int:
    """The kernels' mode: bn_add_relu's with res (forward) or y (backward)."""
    if other is not None and not relu:
        raise ValueError("the residual add is followed by the relu")
    return ADD_RELU if other is not None else RELU if relu else ONLY


def launch_stats(x: torch.Tensor, eps: float, group=None):
    """The statistics kernel and its reduction: (mean, var, rstd), float32
    (C,) views of one (3, C) tensor. With a group the same pass writes the
    moments (mean, E[x²]), they are averaged over the ranks, and the
    reduction kernel forms (mean, var, rstd) from the average."""
    lib, positions, c, bf16, grid = _prepare(x, None, ())
    partial = torch.empty((2, grid, c), device=x.device, dtype=torch.float32)
    out = torch.empty((3, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        if group is None:
            rc = lib.clica_bn_stats(x.data_ptr(), partial.data_ptr(),
                                    out.data_ptr(), positions, c, bf16, grid,
                                    float(eps), _stream(x))
        else:
            moments = torch.empty((2, c), device=x.device, dtype=torch.float32)
            rc = lib.clica_bn_moments(x.data_ptr(), partial.data_ptr(),
                                      moments.data_ptr(), positions, c, bf16,
                                      grid, _stream(x))
            _check_launch(lib, rc, "bn moments")
            all_reduce_mean_(moments, group)
            rc = lib.clica_bn_finish(moments.data_ptr(), out.data_ptr(), c,
                                     float(eps), _stream(x))
    _check_launch(lib, rc, "bn stats")
    _launches["bn_stats"] += 1
    return out[0], out[1], out[2]


def launch_apply(x, a, b, res=None, relu: bool = True) -> torch.Tensor:
    """The apply kernel: relu(x·a + b (+ res)), or x·a + b; a, b (C,) in
    x's dtype."""
    mode = _mode(res, relu)
    lib, positions, c, bf16, grid = _prepare(x, res, (("a", a), ("b", b)))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.clica_bn_apply(x.data_ptr(), (x if res is None else res).data_ptr(),
                                a.data_ptr(), b.data_ptr(), y.data_ptr(),
                                positions, c, bf16, mode, grid, _stream(x))
    _check_launch(lib, rc, "bn apply")
    _launches["bn_apply"] += 1
    return y


def launch_bwd(x, dy, a, b, y=None, relu: bool = True, dy_res=None):
    """The backward sums kernel and its reduction: (Σg, Σg·x, g), the sums
    float32 (C,) views of one (2, C) tensor. Given bn_add_relu's output y,
    g is written too (the residual's gradient, and dx's input), else None;
    dy_res, bn_add_relu's only, is dy's second addend (a block junction's,
    counted in ``bn_junctions``)."""
    mode = _mode(y, relu)
    lib, positions, c, bf16, grid = _prepare(x, y, (("a", a), ("b", b)))
    _check_map("dy", dy, like=x)
    if dy_res is not None:
        _check_map("dy_res", dy_res, like=x)
    partial = torch.empty((2, grid, c), device=x.device, dtype=torch.float32)
    sums = torch.empty((2, c), device=x.device, dtype=torch.float32)
    g = torch.empty_like(x) if y is not None else None
    with torch.cuda.device(x.device):
        rc = lib.clica_bn_bwd(x.data_ptr(), dy.data_ptr(),
                              None if dy_res is None else dy_res.data_ptr(),
                              (x if y is None else y).data_ptr(),
                              a.data_ptr(), b.data_ptr(), partial.data_ptr(),
                              sums.data_ptr(), None if g is None else g.data_ptr(),
                              positions, c, bf16, mode, grid, _stream(x))
    _check_launch(lib, rc, "bn bwd")
    _launches["bn_bwd"] += 1
    if dy_res is not None:
        _launches["bn_junctions"] += 1
    return sums[0], sums[1], g


def launch_dx(x, dy, k, a, b, relu: bool = True):
    """The dx kernel: dx = A·g − B·x + C with k = (A, B, C) (3, C) in x's
    dtype, g = dy·1[x·a + b > 0], or dy without the relu (bn_only, and
    bn_add_relu on the g its sums wrote)."""
    lib, positions, c, bf16, grid = _prepare(x, None, (("a", a), ("b", b),
                                                       ("k", k)))
    _check_map("dy", dy, like=x)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.clica_bn_dx(x.data_ptr(), dy.data_ptr(), a.data_ptr(),
                             b.data_ptr(), k.data_ptr(), dx.data_ptr(),
                             positions, c, bf16, _mode(None, relu), grid,
                             _stream(x))
    _check_launch(lib, rc, "bn dx")
    _launches["bn_dx"] += 1
    return dx


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------


def _dense(dy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dy in ``dtype`` (x's) and dense memory; a copy, where one is needed,
    is counted."""
    dy = dy.to(dtype)
    if not dy.is_contiguous():
        _copies["dy"] += 1
        dy = dy.contiguous()
    return dy


class _MinResBN(torch.autograd.Function):
    """(y, y_res, mean, var) = f(x, res, scale, bias) for the three
    functions (res None without the residual add; relu False only without
    it). y_res is y a second time, as its own autograd edge, with res (see
    the module docstring), else None. eps, the relu, the route and the
    group are not differentiable, and neither are the mean and var
    outputs: they feed running-statistics buffers (the JAX custom VJPs
    drop their cotangents). Saved: x, (C,) vectors and, with res, the
    output y (the relu mask's sign; see the module docstring)."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, eps, relu, use_kernels, group):
        if use_kernels:
            mean, var, rstd = launch_stats(x, eps, group)
        else:
            mean, var, rstd = channel_stats(x, eps, group)
        a, b = affine(scale, bias, mean, rstd, x.dtype)
        apply = launch_apply if use_kernels else bn_apply_reference
        y = apply(x, a, b, res, relu)
        ctx.save_for_backward(x, y if res is not None else None, scale, bias,
                              mean, rstd)
        ctx.relu, ctx.use_kernels, ctx.group = relu, use_kernels, group
        ctx.mark_non_differentiable(mean, var)
        # an unused edge's gradient comes as None, not as zeros
        ctx.set_materialize_grads(False)
        return y, None if res is None else y.view_as(y), mean, var

    @staticmethod
    def backward(ctx, dy, dy_res, _d_mean, _d_var):
        x, y, scale, bias, mean, rstd = ctx.saved_tensors
        if dy is None:  # only y_res was used
            dy, dy_res = dy_res, None
        a, b = affine(scale, bias, mean, rstd, x.dtype)
        dy = _dense(dy, x.dtype)
        if dy_res is not None:
            dy_res = _dense(dy_res, x.dtype)
        sums = launch_bwd if ctx.use_kernels else bn_bwd_reference
        sum_g, sum_gx, g = sums(x, dy, a, b, y, ctx.relu, dy_res)
        # dscale and dbias are this rank's (the ranks' gradients are
        # averaged later); dx takes the whole batch's sums and count
        dscale, dbias = param_grads(mean, rstd, sum_g, sum_gx)
        count, totals = x.numel() // x.shape[-1], (sum_g, sum_gx)
        if ctx.group is not None:
            totals = all_reduce_sum_(torch.stack(totals), ctx.group)
            count *= world_of(ctx.group)
        k = dx_factors(scale, mean, rstd, *totals, count, x.dtype)[2]
        dx_fn = launch_dx if ctx.use_kernels else bn_dx_reference
        # bn_add_relu's g is masked already: its dx is bn_only's on g
        dx = (dx_fn(x, dy, k, a, b, ctx.relu) if g is None
              else dx_fn(x, g, k, a, b, False))
        return dx, g, dscale, dbias, None, None, None, None


def _minres(x, res, scale, bias, eps, relu, use_kernels, group=None):
    if x.ndim < 2:
        raise ValueError(f"x must be (..., C), got {tuple(x.shape)}")
    return _MinResBN.apply(x, res, scale, bias, float(eps), relu, use_kernels,
                           group)


def bn_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5, group=None):
    """Training-mode batch norm → relu with the minimal-residual backward.

    x (..., C) dense, float32 or bfloat16; scale, bias (C,) float32.
    Returns (y, mean, var): y in x's dtype; mean and the biased var, the
    float32 batch statistics the normalisation used, carry NO gradient.
    ``group``: the data-parallel ranks whose rows make up the batch (see
    the module docstring), None for this tensor alone. CUDA tensors run
    the Hopper kernels or raise; CPU tensors the plain versions."""
    y, _, mean, var = _minres(x, None, scale, bias, eps, True,
                              x.device.type != "cpu", group)
    return y, mean, var


def bn_add_relu(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, eps: float = 1e-5, group=None):
    """Training-mode batch norm of x, + res, → relu (a ResNet block's
    tail); res's gradient is the masked upstream gradient g. It keeps y,
    not res, for the backward. Returns (y, y_res, mean, var): y_res is y,
    the same memory, as a second autograd edge (for the next block's
    shortcut, y for its first convolution), whose gradient the backward
    adds to y's itself (see the module docstring). As ``bn_relu``
    otherwise."""
    return _minres(x, res, scale, bias, eps, True, x.device.type != "cpu",
                   group)


def bn_only(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5, group=None):
    """Training-mode batch norm with no activation (a projection
    shortcut). As ``bn_relu`` otherwise."""
    y, _, mean, var = _minres(x, None, scale, bias, eps, False,
                              x.device.type != "cpu", group)
    return y, mean, var
