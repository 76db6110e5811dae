"""Constraint heads, activations, and the ResNet's batch norm.

Port of cl_ica_tpu/models/layers.py:14-60 (heads), :63-93 (the two
positional encodings), :96-152
(``FastBatchNorm``), :155-232 (``MinResBN``), :235-280 (``MinResBNPool``)
and :283-335 (``StemBNReLUPool``), and the MLP's ``BatchNorm1d``. Parameter names and
shapes follow the Flax modules so that models/convert.py maps them by
name: ``RescaleLayer.r`` is (1,), ``SoftclipLayer.max_abs_bound`` is (n,),
a norm's ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` are
``weight``/``bias`` and ``running_mean``/``running_var``.

Every norm here, in training mode under a data-parallel step
(``ops.collectives.current_group()`` set by parallel/), takes its
statistics over the whole batch, all ranks' rows, and updates its running
buffers with them (the unbiased correction from the global count), as the
JAX package's norms do under GSPMD. Outside such a step each is the
single-device module, bit for bit.

Under ``recomputing()`` (a rematerialised block's second forward, in the
backward: models/resnet.py ``remat``) the norms compute as before but leave
their running buffers alone, so that a step updates them once, as Flax's
``nn.remat`` does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_minres import bn_add_relu, bn_only, bn_relu
from ..ops.bn_minres8 import bn_add_relu8, bn_only8, bn_relu8
from ..ops.collectives import all_reduce_mean, current_group, world_of
from ..ops.pool_minres import bn_relu_pool, takes
from ..ops.stem import bn_relu_pool_train

_RECOMPUTING = [False]


@contextlib.contextmanager
def recomputing():
    """Within: the norms' running buffers are not updated (the forward runs
    a second time, for a rematerialised block's backward)."""
    was, _RECOMPUTING[0] = _RECOMPUTING[0], True
    try:
        yield
    finally:
        _RECOMPUTING[0] = was


def _group_kw() -> dict:
    """The norm functions' ``group`` argument: none outside a data-parallel
    step, so that their call is the single-device one."""
    group = current_group()
    return {} if group is None else {"group": group}


def _global_count(x) -> int:
    """Positions a channel's statistics are taken over, all ranks' rows."""
    return x.numel() // x.shape[1] * world_of(current_group())


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype,
    as the JAX package's Dense layers under a compute dtype: float32 in,
    the plain layer; bfloat16 in, a bfloat16 product of float32
    parameters."""

    def forward(self, x):
        if isinstance(x, torch.Tensor) and x.dtype != self.weight.dtype:
            bias = None if self.bias is None else self.bias.to(x.dtype)
            return F.linear(x, self.weight.to(x.dtype), bias)
        return super().forward(x)


def smooth_leaky_relu(x, alpha: float = 0.2):
    """alpha*x + (1-alpha)*log(1+exp(x)) — a C∞ leaky ReLU."""
    return alpha * x + (1 - alpha) * F.softplus(x)


class RescaleLayer(nn.Module):
    """Normalize outputs onto a hypersphere of fixed or learnable radius.
    mode='eq' projects onto the sphere; 'leq' only rescales points
    outside it."""

    def __init__(self, init_r: float = 1.0, fixed_r: bool = False,
                 mode: str = "eq"):
        super().__init__()
        if mode not in ("eq", "leq"):
            raise ValueError(f"mode must be 'eq' or 'leq', got {mode!r}")
        self.mode = mode
        self.init_r = float(init_r)
        self.fixed_r = fixed_r
        if not fixed_r:
            self.r = nn.Parameter(torch.ones(1) * init_r)

    def forward(self, x):
        r = self.init_r if self.fixed_r else self.r
        norm = torch.linalg.norm(x, dim=-1, keepdim=True)
        if self.mode == "eq":
            return x / norm * r
        return x * torch.where(norm > r, r / norm, torch.ones_like(norm))


class SoftclipLayer(nn.Module):
    """Squash outputs into a hyperrectangle: sigmoid(x) * bound, with a
    fixed or learnable per-dim bound vector."""

    def __init__(self, n: int, init_abs_bound: float = 1.0,
                 fixed_abs_bound: bool = True):
        super().__init__()
        self.n = n
        self.init_abs_bound = float(init_abs_bound)
        self.fixed_abs_bound = fixed_abs_bound
        if not fixed_abs_bound:
            self.max_abs_bound = nn.Parameter(torch.ones(n) * init_abs_bound)

    def forward(self, x):
        if self.fixed_abs_bound:
            return torch.sigmoid(x) * self.init_abs_bound
        return torch.sigmoid(x) * self.max_abs_bound[None, :]


def _coordinates(h: int, w: int, dtype, device) -> torch.Tensor:
    """(2, h, w): the row and column indices, divided by their largest
    (plus 1e-12, so that a 1×1 map gives zeros), as the JAX package does."""
    rows = torch.arange(h, dtype=dtype, device=device)[:, None] * torch.ones(
        (1, w), dtype=dtype, device=device)
    cols = torch.ones((h, 1), dtype=dtype, device=device) * torch.arange(
        w, dtype=dtype, device=device)[None, :]
    pos = torch.stack([rows, cols], dim=0)
    return pos / (torch.max(pos) + 1e-12)


class PositionalEncoding(nn.Module):
    """The reference's PositionalEncoding, channel-first as the JAX
    package's (cl_ica_tpu/models/layers.py:63): (B, C, H, W) → (B, 2 + C,
    H, W), the two normalised coordinate channels (row, column) first."""

    def forward(self, x):
        h, w = x.shape[-2], x.shape[-1]
        pos = _coordinates(h, w, x.dtype, x.device)
        return torch.cat([pos[None].expand(x.shape[0], 2, h, w), x], dim=1)


class PositionalEncoding2D(nn.Module):
    """Port of cl_ica_tpu/models/layers.py:81 on the port's image layout:
    logical (B, C, H, W) images (the JAX module takes NHWC) gain the two
    normalised coordinate channels (row, column) first on the channel axis,
    dim 1: (B, 2 + C, H, W). The output keeps the input's memory format
    (channels_last for normalize_3dident's images), so it is the JAX
    module's NHWC array in memory."""

    def forward(self, x):
        h, w = x.shape[-2], x.shape[-1]
        pos = _coordinates(h, w, x.dtype, x.device)
        fmt = (torch.channels_last
               if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        out = torch.empty((x.shape[0], 2 + x.shape[1], h, w), dtype=x.dtype,
                          device=x.device, memory_format=fmt)
        out[:, :2] = pos
        out[:, 2:] = x
        return out


class FastBatchNorm2d(nn.Module):
    """Batch norm over (N, C, H, W) with ``FastBatchNorm``'s contract.

    The statistics are float32 sums taken straight from the (possibly
    bfloat16) input; the batch is normalised with the biased variance
    max(E[x²] − E[x]², 0); the running variance gets the unbiased
    correction n/(n−1); ``momentum`` is torch's (0.1 is Flax's 0.9); the
    per-channel affine a = rstd·weight, b = bias − mean·a is applied in
    the input's dtype. The gradient runs through the statistics (autograd;
    under a data-parallel step through their mean over the ranks).
    ``norm_kind`` 'fast' and 'batch' of the JAX package are this one
    mathematics; 'minres' is too, with another backward (``MinResBN2d``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, zero_init: bool = False):
        super().__init__()
        self.num_features, self.eps, self.momentum = num_features, eps, momentum
        self.weight = nn.Parameter(
            torch.zeros(num_features) if zero_init else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def update_running(self, mean, var, n: int) -> None:
        """running ← (1 − momentum)·running + momentum·batch, the variance
        with the unbiased correction n / max(n − 1, 1); nothing under
        ``recomputing()``."""
        if _RECOMPUTING[0]:
            return
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.mul_(1 - m).add_(var, alpha=m * (n / max(n - 1, 1)))

    def forward(self, x):
        if self.training:
            dims = (0, 2, 3)
            mean = x.mean(dim=dims, dtype=torch.float32)
            mean2 = x.square().mean(dim=dims, dtype=torch.float32)
            group = current_group()
            if group is not None:
                mean, mean2 = all_reduce_mean(torch.stack([mean, mean2]), group)
            var = (mean2 - mean * mean).clamp(min=0)
            self.update_running(mean.detach(), var.detach(), _global_count(x))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        a = inv.to(x.dtype)
        b = (self.bias - mean * inv).to(x.dtype)
        return x * a[None, :, None, None] + b[None, :, None, None]


class MinResBN2d(FastBatchNorm2d):
    """Batch norm (+ residual add) (+ relu) with the minimal-residual
    backward: the JAX package's ``MinResBN``.

    Same parameters and buffers as ``FastBatchNorm2d`` (checkpoints
    interchange) and the same training mathematics, but in training mode
    the norm, the relu (``act='relu'``; ``'none'`` for a projection
    shortcut) and, with ``forward(x, res=...)``, the residual add before
    the relu are one function of ``ops.bn_minres`` (the Hopper kernels on
    CUDA tensors) that saves only x (and, with the add, its output) for its
    backward and takes the relu mask from them there; the running buffers
    are updated from the batch mean and biased variance it returns, which
    carry no gradient. Eval mode is the plain composition on the running
    statistics.

    ``residuals_f8=True`` (``ResNet(norm_kind='minres8')``) takes the
    functions of ``ops.bn_minres8``: the same forward, bit for bit, and a
    backward that keeps the normalised x as float8_e4m3fn (and, with the
    add, res) in place of x.

    The input is logical (N, C, H, W); the kernels take dense (N, H, W, C)
    memory, which is what a ``channels_last`` tensor is. The layout is
    made explicit here (a no-op when it already is) and the output comes
    back as a channels_last view, as ``StemBNReLUPool``'s does."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, zero_init: bool = False,
                 act: str = "relu", residuals_f8: bool = False):
        super().__init__(num_features, eps, momentum, zero_init)
        if act not in ("relu", "none"):
            raise ValueError(f"act must be 'relu' or 'none', got {act!r}")
        self.act = act
        self.residuals_f8 = residuals_f8

    def forward(self, x, res=None):
        if res is not None and self.act != "relu":
            raise ValueError("the residual add is followed by the relu: "
                             "act='relu'")
        if not self.training:
            y = super().forward(x)
            if res is not None:
                y = y + res
            return F.relu(y) if self.act == "relu" else y
        x = x.contiguous(memory_format=torch.channels_last)
        nhwc = x.permute(0, 2, 3, 1)
        f8 = self.residuals_f8
        if res is not None:
            res = res.contiguous(memory_format=torch.channels_last)
            y, mean, var = (bn_add_relu8 if f8 else bn_add_relu)(
                nhwc, res.permute(0, 2, 3, 1), self.weight, self.bias, self.eps,
                **_group_kw())
        elif self.act == "relu":
            y, mean, var = (bn_relu8 if f8 else bn_relu)(
                nhwc, self.weight, self.bias, self.eps, **_group_kw())
        else:
            y, mean, var = (bn_only8 if f8 else bn_only)(
                nhwc, self.weight, self.bias, self.eps, **_group_kw())
        self.update_running(mean, var, _global_count(x))
        return y.permute(0, 3, 1, 2)


def _max_pool(z):
    """The stem's 3×3/2 max pool with padding 1."""
    return F.max_pool2d(z, kernel_size=3, stride=2, padding=1)


def _train_pool(norm: FastBatchNorm2d, x, train_fn):
    """A stem tail's training mode: ``train_fn`` (norm, relu and pool in
    one) on x's dense (N, H, W, C) view, ``norm``'s running buffers updated
    from the mean and biased variance it returns, the pooled map back as a
    channels_last view. A convolution's output is not promised to be
    channels_last, so the layout is made explicit here (a no-op when it
    already is)."""
    x = x.contiguous(memory_format=torch.channels_last)
    pooled, mean, var = train_fn(x.permute(0, 2, 3, 1), norm.weight, norm.bias,
                                 norm.eps, **_group_kw())
    norm.update_running(mean, var, _global_count(x))
    return pooled.permute(0, 3, 1, 2)


class StemBNReLUPool(FastBatchNorm2d):
    """Fused batch norm → relu → 3×3/2 max pool, the ResNet stem tail.

    Same parameters and buffers as ``FastBatchNorm2d``, so checkpoints
    interchange with the unfused norm → relu → max_pool stem. Training
    mode goes through ``ops.stem.bn_relu_pool_train`` (the Hopper kernels
    on CUDA tensors) and updates the running buffers from the mean and
    biased variance it returns; eval mode is the plain composition on the
    running statistics. The input is logical (N, C, H, W); the pooled
    output comes back as a channels_last view."""

    def forward(self, x):
        if not self.training:
            return _max_pool(F.relu(super().forward(x)))
        return _train_pool(self, x, bn_relu_pool_train)


class MinResBNPool(MinResBN2d):
    """The minres norm and relu, then the 3×3/2 max pool: the stem of
    ``ResNet(norm_kind='minres')``, and the JAX package's ``MinResBNPool``
    (its ``stem_pool='argmax'``).

    In training mode, where the kernels take the input
    (``ops.pool_minres.takes``: float32 or bfloat16, H and W even, C a
    multiple of the 16-byte vector up to 256 vectors), it goes through
    ``ops.pool_minres.bn_relu_pool``: the minres norm's statistics and
    arithmetic, so its output is ``MinResBN2d``'s followed by
    ``F.max_pool2d``, bit for bit, and a backward that keeps x and an
    argmax code a pooled value in place of the pool's input and int64
    indices. Any other input, and eval mode, takes that composition itself.
    Parameters, buffers and layout as ``MinResBN2d``'s."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps, momentum)

    def forward(self, x):
        if self.training and takes(x.permute(0, 2, 3, 1)):
            return _train_pool(self, x, bn_relu_pool)
        return _max_pool(super().forward(x))


class BatchNorm1d(nn.BatchNorm1d):
    """The MLP's --layer-normalization bn: ``nn.BatchNorm1d`` (Flax's
    BatchNorm as the JAX package's MLP uses it), which under a
    data-parallel step normalises (B, C) rows with the whole batch's mean
    and biased variance, each the ranks' average (a mean over the ranks of
    the rows' mean, then of their squared deviations from it), through
    autograd, and updates its running buffers with them, the variance with
    the global count's unbiased correction. Outside such a step it is
    ``nn.BatchNorm1d``. (``nn.SyncBatchNorm`` takes CUDA tensors only.)"""

    def forward(self, x):
        group = current_group()
        if group is None or not self.training:
            return super().forward(x)
        if x.ndim != 2:
            raise ValueError(f"x must be (B, C) rows, got {tuple(x.shape)}")
        mean = all_reduce_mean(x.mean(dim=0), group)
        var = all_reduce_mean((x - mean).square().mean(dim=0), group)
        n = x.shape[0] * world_of(group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m * n / max(n - 1, 1))
            self.num_batches_tracked.add_(1)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias
