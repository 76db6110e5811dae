"""Coupling-flow networks (GIN / GLOW).

Port of cl_ica_tpu/models/flows.py. Each block applies two affine
half-couplings (transform x1 conditioned on x2, then x2 conditioned on the
new x1) with the soft-clamped log-scale CLAMP·0.636·atan(s / CLAMP); GIN
also centres the log-scales of each sample, so that its blocks preserve
volume (log-det 0). The subnet is Linear-ReLU-Linear-ReLU-Linear, its last
layer zero under ``init_identity`` (the identity flow). Both directions are
exact inverses.

Where the Flax module's ``__call__`` returns y and its ``forward`` method
(y, log-det), the port's ``CouplingFlow.forward`` (its call) returns y and
``forward_with_logdet`` the pair. Parameters are initialised as Flax's
Dense is (lecun_normal kernels, zero biases); models/convert.py
``flow_params_from_flax`` maps the Flax variables onto them
(``blocks.i.subnet{1,2}.denses.k``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resnet import lecun_normal_

CLAMP = 2.0
COUPLINGS = ("gin", "glow")


def _soft_scale(s):
    """The soft clamp of the log-scale, with the JAX package's 0.636 (not
    2/π): CLAMP·0.636·atan(s / CLAMP)."""
    return CLAMP * 0.636 * torch.atan(s / CLAMP)


class _Subnet(nn.Module):
    def __init__(self, c_in: int, c_out: int, width: int, init_identity: bool):
        super().__init__()
        self.init_identity = init_identity
        self.denses = nn.ModuleList([nn.Linear(c_in, width),
                                     nn.Linear(width, width),
                                     nn.Linear(width, c_out)])

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.denses:
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()
        if self.init_identity:
            self.denses[-1].weight.zero_()

    def forward(self, x):
        for layer in self.denses[:-1]:
            x = F.relu(layer(x))
        return self.denses[-1](x)


class CouplingBlock(nn.Module):
    """One GIN/GLOW block: two conditional affine half-couplings.
    ``forward(x)`` -> (y, log-det), as the Flax block's call."""

    def __init__(self, n: int, coupling: str, width: int, init_identity: bool):
        super().__init__()
        self.n, self.coupling = n, coupling
        self.split = n // 2
        half2 = n - self.split
        self.subnet1 = _Subnet(half2, 2 * self.split, width, init_identity)
        self.subnet2 = _Subnet(self.split, 2 * half2, width, init_identity)

    def _affine_params(self, subnet, cond, out_dim):
        st = subnet(cond)
        s, t = st[..., :out_dim], st[..., out_dim:]
        log_scale = _soft_scale(s)
        if self.coupling == "gin":
            # volume preserving: per-sample zero-mean log-scales
            log_scale = log_scale - torch.mean(log_scale, dim=-1, keepdim=True)
        return log_scale, t

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x1, x2 = x[..., :self.split], x[..., self.split:]
        ls1, t1 = self._affine_params(self.subnet1, x2, self.split)
        y1 = x1 * torch.exp(ls1) + t1
        ls2, t2 = self._affine_params(self.subnet2, y1, self.n - self.split)
        y2 = x2 * torch.exp(ls2) + t2
        logdet = torch.sum(ls1, -1) + torch.sum(ls2, -1)
        return torch.cat([y1, y2], -1), logdet

    def inverse(self, y):
        y1, y2 = y[..., :self.split], y[..., self.split:]
        ls2, t2 = self._affine_params(self.subnet2, y1, self.n - self.split)
        x2 = (y2 - t2) * torch.exp(-ls2)
        ls1, t1 = self._affine_params(self.subnet1, x2, self.split)
        x1 = (y1 - t1) * torch.exp(-ls1)
        return torch.cat([x1, x2], -1)


class CouplingFlow(nn.Module):
    """A stack of ``num_nodes`` coupling blocks; the subnets are
    max(n · node_size_factor, 2) wide."""

    def __init__(self, n: int, coupling_block: str = "gin", num_nodes: int = 8,
                 node_size_factor: int = 1, init_identity: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if coupling_block not in COUPLINGS:
            raise ValueError(f"coupling_block must be one of {COUPLINGS}, "
                             f"got {coupling_block!r}")
        self.n, self.coupling_block = n, coupling_block
        width = max(n * node_size_factor, 2)
        self.blocks = nn.ModuleList([
            CouplingBlock(n, coupling_block, width, init_identity)
            for _ in range(num_nodes)])
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            blk.subnet1.reset_parameters(generator)
            blk.subnet2.reset_parameters(generator)

    def forward_with_logdet(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(y, log|det ∂y/∂x|): the Flax module's ``forward`` method."""
        logdet = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for blk in self.blocks:
            x, ld = blk(x)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, y):
        for blk in reversed(self.blocks):
            y = blk.inverse(y)
        return y

    def forward(self, x):
        return self.forward_with_logdet(x)[0]


def get_flow(
    n_in: int,
    n_out: int,
    init_identity: bool = False,
    coupling_block: str = "gin",
    num_nodes: int = 8,
    node_size_factor: int = 1,
    generator: Optional[torch.Generator] = None,
) -> CouplingFlow:
    """The JAX package's get_flow; a flow maps n to n, so n_in != n_out
    raises ValueError (an assertion there)."""
    if n_in != n_out:
        raise ValueError(f"a flow maps n to n: n_in {n_in} != n_out {n_out}")
    return CouplingFlow(n_in, coupling_block, num_nodes, node_size_factor,
                        init_identity, generator)


class FrozenFlow(nn.Module):
    """A frozen flow used as the mixing g: its parameters take no gradient
    (the input still does). ``inverse`` undoes it."""

    def __init__(self, flow: CouplingFlow):
        super().__init__()
        self.flow = flow.requires_grad_(False)

    def forward(self, x):
        return self.flow(x)

    def inverse(self, y):
        return self.flow.inverse(y)


def construct_invertible_flow(
    n: int,
    coupling_block: str = "gin",
    num_nodes: int = 8,
    node_size_factor: int = 1,
    generator: Optional[torch.Generator] = None,
) -> FrozenFlow:
    """A frozen invertible flow mixing. Without a ``generator`` the seed is
    drawn from numpy's global generator, as the JAX package draws its key."""
    if generator is None:
        generator = torch.Generator().manual_seed(int(np.random.randint(2**31)))
    return FrozenFlow(get_flow(n, n, False, coupling_block, num_nodes,
                               node_size_factor, generator))
