"""InfoNCE, plain, in row blocks (Zimmermann et al., ICML 2021, eq. 2 and
its Lp form; brendel-group/cl-ica ``losses.py`` in SimCLR-compatibility
mode, α = 0.5).

Lp (p ≥ 1, ``pow``): d_ij = Σ_k |a_ik − b_jk|^p, pos_i = Σ_k |a_ik − c_ik|^p,
loss_i = pos_i/τ + logsumexp_j([−d_i·/τ, −pos_i/τ]).
Dot: s_ij = a_i·b_j, pos_i = a_i·c_i,
loss_i = −pos_i/τ + logsumexp_j([s_i·/τ, pos_i/τ]).
(2·(α·pos-term + (1 − α)·neg-term) with α = 0.5.) Each returns the
per-item losses.

The B × B matrix is never held whole: each block of rows is a checkpointed
function of (rows, all of b), so a 65536-row batch fits.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

BLOCK = 2048


def _lp_dist(a, b, p: float):
    if p == 2.0:
        d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
        return d.clamp_min(0.0)
    out = torch.zeros(a.shape[0], b.shape[0], dtype=a.dtype, device=a.device)
    for k in range(a.shape[1]):  # one column at a time: a block × N matrix
        diff = (a[:, k:k + 1] - b[None, :, k]).abs()
        out = out + (diff if p == 1.0 else diff ** p)
    return out


def _lp_lse(a, pos, b, p: float, tau: float):
    neg = -_lp_dist(a, b, p) / tau
    return torch.logsumexp(torch.cat([neg, (-pos / tau)[:, None]], 1), 1)


def _dot_lse(a, pos, b, tau: float):
    return torch.logsumexp(torch.cat([a @ b.T / tau, (pos / tau)[:, None]], 1), 1)


def _blocks(fn, a, pos, b, *args, block: int):
    return torch.cat([checkpoint(fn, a[s:s + block], pos[s:s + block], b, *args,
                                 use_reentrant=False)
                      for s in range(0, a.shape[0], block)])


def lp_infonce(z1, z2, z3, p: float, tau: float = 1.0, block: int = BLOCK):
    """Per-item Lp-InfoNCE of anchors z1, positives z2 and negatives z3."""
    pos = ((z1 - z2).abs() ** p).sum(1)
    return pos / tau + _blocks(_lp_lse, z1, pos, z3, p, tau, block=block)


def dot_infonce(z1, z2, z3, tau: float = 1.0, block: int = BLOCK):
    """Per-item dot-product InfoNCE, without normalisation."""
    pos = (z1 * z2).sum(1)
    return -pos / tau + _blocks(_dot_lse, z1, pos, z3, tau, block=block)
