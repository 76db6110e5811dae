"""InfoNCE-family contrastive losses.

Port of cl_ica_tpu/losses/infonce.py: ``SimCLRLoss`` (dot-product
InfoNCE), ``LpSimCLRLoss`` with its compat mode, ``pow`` and the p<1
eps-and-transpose branch, Alignment/Uniformity, the Split/Combined
combinators, ``JacobianDeterminantLoss`` and ``R2Loss``. On CUDA tensors
the negatives term of ``SimCLRLoss`` and of ``LpSimCLRLoss`` (p ≥ 1 with
``pow``) goes through the fused Hopper kernels (ops.fused_dot_lse,
ops.fused_neg_lse) instead of materializing the B×B matrix. The kernels
take contiguous operands only, so both losses hand them ``.contiguous()``
copies (a column slice from ``SplitCombinedCLLoss`` is not contiguous).
"""

from __future__ import annotations

import dataclasses
import math
from abc import ABC, abstractmethod
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import fused_dot_lse, fused_neg_lse


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


def _needs_cuda(loss_name: str, z: torch.Tensor) -> ValueError:
    return ValueError(
        f"{loss_name}(use_fused=True) needs CUDA tensors: the fused "
        f"kernel does not run on {z.device}. Use use_fused=None or False.")


@dataclasses.dataclass
class SimCLRLoss(CLLoss):
    """Dot-product InfoNCE: the positive is appended to the negatives row
    before the logsumexp.

    use_fused: None routes the negatives through the fused kernel
    (ops.fused_dot_lse) exactly when the tensors are on CUDA; True forces
    it (and raises on CPU tensors, where there is no kernel); False takes
    the materialized path, ``z1 @ z3.T`` and a logsumexp over B+1 columns.
    """

    normalize: bool = False
    tau: float = 1.0
    alpha: float = 0.5
    use_fused: Optional[bool] = None

    def _fused_ok(self, z: torch.Tensor) -> bool:
        if self.use_fused is None:
            return z.is_cuda
        if self.use_fused and not z.is_cuda:
            raise _needs_cuda("SimCLRLoss", z)
        return bool(self.use_fused)

    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        del z1, z2_con_z1, z3
        if self.normalize:
            unit = lambda z: z / torch.linalg.norm(z, dim=-1, keepdim=True)
            z1_rec, z2_con_z1_rec, z3_rec = (
                unit(z1_rec), unit(z2_con_z1_rec), unit(z3_rec))

        pos = torch.sum(z1_rec * z2_con_z1_rec, dim=-1)
        loss_pos = -pos / self.tau
        if self._fused_ok(z1_rec):
            lse = fused_dot_lse(z1_rec.contiguous(), z3_rec.contiguous(),
                                self.tau)
            # pos column folded in (== appending it before the logsumexp)
            loss_neg = torch.logaddexp(lse, pos / self.tau)
        else:
            neg = z1_rec @ z3_rec.T
            neg_and_pos = torch.cat([neg, pos[:, None]], dim=1)
            loss_neg = torch.logsumexp(neg_and_pos / self.tau, dim=1)
        loss = 2 * (self.alpha * loss_pos + (1.0 - self.alpha) * loss_neg)
        return loss.mean(), loss, [loss_pos.mean(), loss_neg.mean()]


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
            raise _needs_cuda("LpSimCLRLoss", z)
        return bool(self.use_fused) and eligible

    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        del z1, z2_con_z1, z3
        p = float(self.p)

        if self._fused_ok(z1_rec):
            # pos folded in via logaddexp == appending the pos column
            # before the logsumexp
            pos = torch.sum(torch.abs(z1_rec - z2_con_z1_rec) ** p, dim=-1)
            lse = fused_neg_lse(z1_rec.contiguous(), z3_rec.contiguous(), p,
                                self.tau)
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


class MarginalPairCLLoss(ABC):
    """Negative-pair-only loss protocol."""

    @abstractmethod
    def loss(self, z1_rec, z3_rec):
        ...

    def __call__(self, z1_rec, z3_rec):
        return self.loss(z1_rec, z3_rec)


class ConditionalPairCLLoss(ABC):
    """Positive-pair-only loss protocol."""

    @abstractmethod
    def loss(self, z1_rec, z2_con_z1_rec):
        ...

    def __call__(self, z1_rec, z2_con_z1_rec):
        return self.loss(z1_rec, z2_con_z1_rec)


class MarginalSingleCLLoss(ABC):
    """Single-input loss protocol."""

    @abstractmethod
    def loss(self, z1_rec):
        ...

    def __call__(self, z1_rec):
        return self.loss(z1_rec)


@dataclasses.dataclass
class UniformityLoss(MarginalPairCLLoss):
    """Negative-pair term of L2-normalized InfoNCE."""

    p: float = 2.0

    def loss(self, z1_rec, z3_rec):
        # deltas[i, j] = z1_j - z3_i (the JAX package's broadcast order)
        deltas = torch.abs(z1_rec[None, :, :] - z3_rec[:, None, :])
        lp = torch.sum(deltas**self.p, dim=-1)
        loss_per_item = logmeanexp(-lp, dim=-1)
        loss = loss_per_item.mean(dim=0)
        return loss, loss_per_item, [loss]


@dataclasses.dataclass
class AlignmentLoss(ConditionalPairCLLoss):
    """Positive-pair term of L2-normalized InfoNCE."""

    p: float = 2.0

    def loss(self, z1_rec, z2_rec):
        lp = torch.sum(torch.abs(z1_rec - z2_rec) ** self.p, dim=-1)
        return lp.mean(), lp, [lp.mean()]


class SplitCombinedCLLoss(CLLoss):
    """Apply different losses to dim-chunks of the data and combine.
    losses_and_indices: [(loss, start, end), ...]; end None = full width."""

    def __init__(
        self,
        losses_and_indices: List[Tuple[object, int, Optional[int]]],
        weights: Optional[Sequence[float]] = None,
    ):
        if weights is None:
            weights = [1.0] * len(losses_and_indices)
        if len(weights) != len(losses_and_indices):
            raise ValueError("one weight per loss")
        for entry in losses_and_indices:
            if not (isinstance(entry, (tuple, list)) and len(entry) == 3
                    and isinstance(entry[1], int)
                    and (entry[2] is None or isinstance(entry[2], int))):
                raise ValueError(
                    f"expected (loss, start:int, end:int|None), got {entry!r}")
        self.weights = list(weights)
        self.losses_and_indices = losses_and_indices

    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        loss_values, per_item_values, individual = [], [], []
        for l, s, e in self.losses_and_indices:
            c = lambda a: None if a is None else a[:, s:e]
            if isinstance(l, MarginalPairCLLoss):
                tl, lpi, ils = l(c(z1_rec), c(z3_rec))
            elif isinstance(l, ConditionalPairCLLoss):
                tl, lpi, ils = l(c(z1_rec), c(z2_con_z1_rec))
            elif isinstance(l, CLLoss):
                tl, lpi, ils = l(c(z1), c(z2_con_z1), c(z3), c(z1_rec),
                                 c(z2_con_z1_rec), c(z3_rec))
            elif isinstance(l, MarginalSingleCLLoss):
                tl, lpi, ils = l(c(z1))
            else:
                raise ValueError(f"Invalid loss type: {type(l)}")
            loss_values.append(tl)
            per_item_values.append(lpi)
            individual.append(ils)

        total = sum(w * l for l, w in zip(loss_values, self.weights))
        per_item = sum(w * lpi for lpi, w in zip(per_item_values, self.weights))
        return total, per_item, list(zip(loss_values, individual, individual))


class CombinedCLLoss(SplitCombinedCLLoss):
    """Apply several losses to the full data: the (0, None) chunk is the
    full width, so the parent's dispatch applies unchanged."""

    def __init__(self, losses, weights=None):
        super().__init__([(l, 0, None) for l in losses], weights=weights)


@dataclasses.dataclass
class AlignmentUniformityLoss(CLLoss):
    """Convex combination of Alignment and Uniformity."""

    alpha: float = 0.5
    p: float = 2.0

    def __post_init__(self):
        if not 0 <= self.alpha <= 1:
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        self._combined = CombinedCLLoss(
            [AlignmentLoss(p=self.p), UniformityLoss(p=self.p)],
            [1.0 - self.alpha, self.alpha],
        )

    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        return self._combined.loss(z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec,
                                   z3_rec)


class JacobianDeterminantLoss(MarginalSingleCLLoss):
    """Mean |det J_h(z)| objective, with a vmapped forward-mode Jacobian
    of h at each row of z."""

    def __init__(self, h):
        self.h = h

    def loss(self, z1):
        if z1.ndim != 2:
            raise ValueError(f"z1 must be (B, n), got {tuple(z1.shape)}")
        jac = torch.func.vmap(
            torch.func.jacfwd(lambda z: self.h(z[None, :])[0]))(z1)
        loss = torch.abs(torch.linalg.det(jac)).mean()
        nan = torch.full((z1.shape[0],), float("nan"), device=z1.device)
        return loss, nan, [loss]


@dataclasses.dataclass
class R2Loss:
    """(Negative) R² score per output dimension, with the biased variance."""

    reduction: str = "none"
    mode: str = "negative_r2"

    def __post_init__(self):
        if self.mode not in ("negative_r2", "r2"):
            raise ValueError(f"mode must be 'negative_r2' or 'r2', got {self.mode!r}")

    def __call__(self, y_pred, y):
        var_y = torch.var(y, dim=0, unbiased=False)
        r2 = 1.0 - torch.mean((y_pred - y) ** 2, dim=0) / var_y
        if self.reduction == "mean":
            r2 = r2.mean()
        elif self.reduction == "sum":
            r2 = r2.sum()
        return r2 if self.mode == "r2" else -r2
