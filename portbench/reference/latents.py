"""The drawn latents held to their distribution, from closed forms.

A training pair is z1 from the space's marginal and z2 from its
conditional around z1. The configuration states both: a box [lo, hi]^n
with a uniform marginal and an elementwise truncated conditional of
density ∝ exp(−(|t|/λ)^p) (``laplace``: p = 1, λ its scale; ``normal``:
p = 2, λ = σ√2), or a unit sphere with a uniform marginal and a von
Mises-Fisher conditional of concentration κ. For each statistic below the
run's mean over a batch is set against its expectation, as a z-score with
the batch's own standard deviation:

- box: the mean of z1's elements ((lo + hi)/2), the mean of their squared
  distance from the centre ((hi − lo)²/12), and the mean of |z2 − z1|
  over the elements (a one-dimensional integral over z1's position);
- sphere: the mean over rows of Σ_i z1_i (0) and of (Σ_i z1_i)² (1), and
  the mean of cos(z1, z2) (A_d(κ) = I_{d/2}(κ) / I_{d/2−1}(κ)).

Sound draws read |z| of a few at most; a marginal or a conditional off by
a tenth of its scale reads tens at the cells' batches.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _p_lam(space: dict) -> tuple:
    if space["conditional"] == "laplace":
        return 1.0, float(space["scale"])
    if space["conditional"] == "normal":
        return 2.0, float(space["scale"]) * math.sqrt(2.0)
    raise ValueError(f"no closed form for the conditional {space['conditional']!r}")


def box_gap_mean(lo: float, hi: float, p: float, lam: float, k: int = 400_000) -> float:
    """E|z2 − z1| for z1 ~ U(lo, hi) and z2 | z1 of density
    ∝ exp(−(|z2 − z1|/λ)^p) on [lo, hi]. With F(L) = ∫_0^L w and
    G(L) = ∫_0^L t·w, w(t) = exp(−(t/λ)^p), a position a in the box gives
    (G(a − lo) + G(hi − a)) / (F(a − lo) + F(hi − a)); averaged over a by
    the midpoint rule on the same grid (float64)."""
    width = hi - lo
    dt = width / k
    t = (np.arange(k) + 0.5) * dt
    w = np.exp(-((t / lam) ** p))
    f = np.concatenate([[0.0], np.cumsum(w) * dt])   # F at i·dt
    g = np.concatenate([[0.0], np.cumsum(t * w) * dt])
    i = np.arange(k)
    # a = lo + (i + ½)dt: a − lo and hi − a as the average of the grid's
    # neighbouring points
    fl, gl = 0.5 * (f[i] + f[i + 1]), 0.5 * (g[i] + g[i + 1])
    fr, gr = 0.5 * (f[k - i] + f[k - i - 1]), 0.5 * (g[k - i] + g[k - i - 1])
    return float(np.mean((gl + gr) / (fl + fr)))


def _log_bessel_i(v: float, x: float, terms: int = 400) -> float:
    """log I_v(x) by its power series (float64, x of tens)."""
    logs = [(2 * j + v) * math.log(x / 2) - math.lgamma(j + 1) - math.lgamma(j + v + 1)
            for j in range(terms)]
    top = max(logs)
    return top + math.log(sum(math.exp(s - top) for s in logs))


def vmf_mean_cos(d: int, kappa: float) -> float:
    """E cos(z1, z2) under a von Mises-Fisher conditional on the unit
    sphere in R^d: A_d(κ) = I_{d/2}(κ) / I_{d/2−1}(κ)."""
    return math.exp(_log_bessel_i(d / 2, kappa) - _log_bessel_i(d / 2 - 1, kappa))


def zscore(x: torch.Tensor, mu: float) -> float:
    """(mean(x) − mu) / (std(x)/√N) over every entry of x, in float64."""
    x = x.double().flatten()
    sd = float(x.std())
    return (float(x.mean()) - mu) / (sd / math.sqrt(x.numel())) if sd > 0 else (
        0.0 if float(x.mean()) == mu else float("inf"))


def statistics(z1: torch.Tensor, z2: torch.Tensor, spaces: list) -> dict:
    """{statistic: z-score} of one batch; ``spaces`` cover z's columns in
    order, each with its ``dim`` (or all columns when alone)."""
    out, at = {}, 0
    for i, sp in enumerate(spaces):
        d = int(sp.get("dim", z1.shape[1] - at))
        a, b = z1[:, at:at + d].double(), z2[:, at:at + d].double()
        at += d
        key = f"{i}.{sp['kind']}"
        if sp["kind"] == "box":
            lo, hi = float(sp["min"]), float(sp["max"])
            mid = 0.5 * (lo + hi)
            out[key + ".mean"] = zscore(a, mid)
            out[key + ".spread"] = zscore((a - mid) ** 2, (hi - lo) ** 2 / 12)
            out[key + ".gap"] = zscore((b - a).abs(), box_gap_mean(lo, hi, *_p_lam(sp)))
        elif sp["kind"] == "sphere":
            if sp["conditional"] != "vmf":
                raise ValueError(f"no closed form for {sp['conditional']!r} on a sphere")
            r = float(sp["r"])
            s = a.sum(1) / r
            out[key + ".sum"] = zscore(s, 0.0)
            out[key + ".sum2"] = zscore(s * s, 1.0)
            cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
            out[key + ".cos"] = zscore(cos, vmf_mean_cos(d, float(sp["kappa"])))
        else:
            raise ValueError(f"no closed form for the space {sp['kind']!r}")
    if at != z1.shape[1]:
        raise ValueError(f"the spaces cover {at} of {z1.shape[1]} columns")
    return out


def sample_z(pairs, spaces: list) -> float:
    """The largest |z-score| over the statistics of every (z1, z2) pair."""
    return max(abs(v) for z1, z2 in pairs for v in statistics(z1, z2, spaces).values())
