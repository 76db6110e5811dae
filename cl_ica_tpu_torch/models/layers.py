"""Constraint heads, activations, and the ResNet's batch norm.

Port of cl_ica_tpu/models/layers.py:14-60 (heads), :96-152
(``FastBatchNorm``) and :283-335 (``StemBNReLUPool``). Parameter names and
shapes follow the Flax modules so that models/convert.py maps them by
name: ``RescaleLayer.r`` is (1,), ``SoftclipLayer.max_abs_bound`` is (n,),
a norm's ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` are
``weight``/``bias`` and ``running_mean``/``running_var``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stem import bn_relu_pool_train


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


class FastBatchNorm2d(nn.Module):
    """Batch norm over (N, C, H, W) with ``FastBatchNorm``'s contract.

    The statistics are float32 sums taken straight from the (possibly
    bfloat16) input; the batch is normalised with the biased variance
    max(E[x²] − E[x]², 0); the running variance gets the unbiased
    correction n/(n−1); ``momentum`` is torch's (0.1 is Flax's 0.9); the
    per-channel affine a = rstd·weight, b = bias − mean·a is applied in
    the input's dtype. The gradient runs through the statistics (autograd).
    ``norm_kind`` 'fast', 'minres' and 'batch' of the JAX package are this
    one mathematics."""

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
        with the unbiased correction n / max(n − 1, 1)."""
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.mul_(1 - m).add_(var, alpha=m * (n / max(n - 1, 1)))

    def forward(self, x):
        if self.training:
            dims = (0, 2, 3)
            mean = x.mean(dim=dims, dtype=torch.float32)
            mean2 = x.square().mean(dim=dims, dtype=torch.float32)
            var = (mean2 - mean * mean).clamp(min=0)
            self.update_running(mean.detach(), var.detach(),
                                x.numel() // x.shape[1])
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        a = inv.to(x.dtype)
        b = (self.bias - mean * inv).to(x.dtype)
        return x * a[None, :, None, None] + b[None, :, None, None]


class StemBNReLUPool(FastBatchNorm2d):
    """Fused batch norm → relu → 3×3/2 max pool, the ResNet stem tail.

    Same parameters and buffers as ``FastBatchNorm2d``, so checkpoints
    interchange with the unfused norm → relu → max_pool stem. Training
    mode goes through ``ops.stem.bn_relu_pool_train`` (the Hopper kernels
    on CUDA tensors) and updates the running buffers from the mean and
    biased variance it returns; eval mode is the plain composition on the
    running statistics.

    The input is logical (N, C, H, W); the kernels take dense (N, H, W, C)
    memory, which is what a ``channels_last`` tensor is. A convolution's
    output is not promised to be channels_last, so the layout is made
    explicit here (a no-op when it already is) and the permuted view is
    handed on; the pooled output comes back as a channels_last view."""

    def forward(self, x):
        if not self.training:
            z = F.relu(super().forward(x))
            return F.max_pool2d(z, kernel_size=3, stride=2, padding=1)
        x = x.contiguous(memory_format=torch.channels_last)
        pooled, mean, var = bn_relu_pool_train(
            x.permute(0, 2, 3, 1), self.weight, self.bias, self.eps)
        self.update_running(mean, var, x.numel() // x.shape[1])
        return pooled.permute(0, 3, 1, 2)
