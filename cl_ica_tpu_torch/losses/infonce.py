"""Lp-distance InfoNCE.

Port of cl_ica_tpu/losses/infonce.py: ``logmeanexp``,
``pairwise_lp_distance`` and ``LpSimCLRLoss`` with its compat mode,
``pow`` and the p<1 eps-and-transpose branch. For p ≥ 1 with ``pow`` on
CUDA tensors the negatives term goes through the fused Hopper kernel
(ops.fused_neg_lse) instead of materializing the B×B matrix.
"""

from __future__ import annotations

import dataclasses
import math
from abc import ABC, abstractmethod
from typing import Optional

import torch

from ..ops import fused_neg_lse


def logmeanexp(x, dim):
    """log(mean(exp(x)))."""
    return torch.logsumexp(x, dim=dim) - math.log(x.shape[dim])


def pairwise_lp_distance(z1, z3, p: float, pow_: bool = True, eps: float = 0.0,
                         block_size: Optional[int] = 1024):
    """All-pairs Lp distances D[i, j] = ||z1_i - z3_j||_p (optionally ^p).

    p == 2 with pow_ is one matmul (|a|² + |b|² - 2a·b, clamped at 0);
    other p go over row blocks of z1 so the broadcast intermediate is
    block×B×n. ``eps`` is added inside the abs (the p<1 guard).
    """
    if p == 2.0 and eps == 0.0:
        sq1 = torch.sum(z1 * z1, dim=-1)
        sq3 = torch.sum(z3 * z3, dim=-1)
        cross = z1 @ z3.T
        d2 = torch.clamp(sq1[:, None] + sq3[None, :] - 2.0 * cross, min=0.0)
        return d2 if pow_ else torch.sqrt(d2)

    def block_fn(z1_blk):
        diff = torch.abs(z1_blk[:, None, :] - z3[None, :, :] + eps)
        if p == 1.0:
            return torch.sum(diff, dim=-1)  # |.|^1 == |.|, pow_ irrelevant
        dp = torch.sum(diff**p, dim=-1)
        return dp if pow_ else dp ** (1.0 / p)

    if block_size is None or z1.shape[0] <= block_size:
        return block_fn(z1)
    return torch.cat([block_fn(b) for b in z1.split(block_size)], dim=0)


class CLLoss(ABC):
    """Pos+neg pair loss protocol. Ground-truth latents z1, z2_con_z1, z3
    are accepted for interface parity; the loss uses only the
    reconstructions."""

    @abstractmethod
    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        ...

    def __call__(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        return self.loss(z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec)


@dataclasses.dataclass
class LpSimCLRLoss(CLLoss):
    """Extended InfoNCE for non-normalized representations, Lp distance.

    For p<1 the negatives matrix is built transposed (row i holds
    |z1_j - z3_i|), as in the JAX package, so per-item losses match.

    use_fused: None routes through the fused kernel exactly when the
    tensors are on CUDA, p ≥ 1 and ``pow``; True forces it (and raises on
    CPU tensors, where there is no kernel); False never uses it.
    """

    p: float
    tau: float = 1.0
    alpha: float = 0.5
    simclr_compatibility_mode: bool = False
    pow: bool = True
    block_size: Optional[int] = 1024
    use_fused: Optional[bool] = None

    def _fused_ok(self, z: torch.Tensor) -> bool:
        eligible = float(self.p) >= 1.0 and self.pow
        if self.use_fused is None:
            return eligible and z.is_cuda
        if self.use_fused and eligible and not z.is_cuda:
            raise ValueError(
                "LpSimCLRLoss(use_fused=True) needs CUDA tensors: the fused "
                f"kernel does not run on {z.device}. Use use_fused=None or False."
            )
        return bool(self.use_fused) and eligible

    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        del z1, z2_con_z1, z3
        p = float(self.p)

        if self._fused_ok(z1_rec):
            # pos folded in via logaddexp == appending the pos column
            # before the logsumexp
            pos = torch.sum(torch.abs(z1_rec - z2_con_z1_rec) ** p, dim=-1)
            lse = fused_neg_lse(z1_rec, z3_rec, p, self.tau)
            loss_pos = pos / self.tau
            if self.simclr_compatibility_mode:
                loss_neg = torch.logaddexp(lse, -pos / self.tau)
            else:
                loss_neg = lse - math.log(z3_rec.shape[0])
            loss = 2 * (self.alpha * loss_pos + (1.0 - self.alpha) * loss_neg)
            return loss.mean(), loss, [loss_pos.mean(), loss_neg.mean()]

        if p < 1.0:
            neg = pairwise_lp_distance(z3_rec, z1_rec, p, pow_=self.pow,
                                       eps=1e-12, block_size=self.block_size)
            pos_d = torch.abs(z1_rec - z2_con_z1_rec) + 1e-12
            pos = torch.sum(pos_d**p, dim=-1)
        else:
            neg = pairwise_lp_distance(z1_rec, z3_rec, p, pow_=self.pow,
                                       block_size=self.block_size)
            pos = torch.sum(torch.abs(z1_rec - z2_con_z1_rec) ** p, dim=-1)
        if not self.pow:
            pos = pos ** (1.0 / p)

        loss_pos = pos / self.tau
        if self.simclr_compatibility_mode:
            neg_and_pos = torch.cat([neg, pos[:, None]], dim=1)
            loss_neg = torch.logsumexp(-neg_and_pos / self.tau, dim=1)
        else:
            loss_neg = logmeanexp(-neg / self.tau, dim=1)

        loss = 2 * (self.alpha * loss_pos + (1.0 - self.alpha) * loss_neg)
        return loss.mean(), loss, [loss_pos.mean(), loss_neg.mean()]
