"""Constraint heads and activations.

Port of cl_ica_tpu/models/layers.py:14-60. Parameter names and shapes
follow the Flax modules so that models/convert.py maps them by name:
``RescaleLayer.r`` is (1,), ``SoftclipLayer.max_abs_bound`` is (n,).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
