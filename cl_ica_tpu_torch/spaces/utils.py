"""Sampling and coordinate primitives on torch tensors.

Port of cl_ica_tpu/spaces/utils.py. Every sampler draws from an explicit
``torch.Generator`` and returns tensors on that generator's device;
nothing reads the global RNG. ``torch.distributions.Gamma``/``Beta``
take no generator, so Gamma variates come from Marsaglia–Tsang here.

Rejection samplers draw a fixed number of rounds at once, as one
(rounds, ...) tensor, and keep each element's first accepted proposal:
the first accepted of i.i.d. proposals has the law of the JAX
``lax.while_loop``s they replace, and nothing waits on the host, so a
step that samples can be captured in a CUDA graph. The rounds are sized
from each sampler's acceptance rate (``rounds_for``) so that an element
falls back (to the value the JAX loop keeps after ``max_iters``) with a
chance below FALLBACK_BUDGET over a RUN_STEPS-step run. Each device keeps
a count of the elements that fell back (``fallback_count``); nothing on
the training path reads it.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import numpy as np
import torch

# An element of one draw site falls back with a chance below
# FALLBACK_BUDGET over a run of RUN_STEPS steps that each draw it once.
FALLBACK_BUDGET = 1e-7
RUN_STEPS = 300_000

# Elements that fell back since the last reset, one int64 counter per
# device, added to on the device.
_fallbacks: Dict[str, torch.Tensor] = {}


def spherical_to_cartesian(r, phi):
    """Convert spherical coordinates to cartesian coordinates.

    ``phi`` holds (..., n-1) angles; returns (..., n) cartesian points
    with radius ``r`` (cumprod-of-sines construction, as in the JAX
    package).
    """
    phi = torch.as_tensor(phi)
    flat = phi.ndim == 1
    if flat:
        phi = phi[None, :]
    r = torch.as_tensor(r, dtype=phi.dtype, device=phi.device)
    if r.ndim == 0:
        r = r.expand(phi.shape[0])

    # a = [2π, φ_1, ..., φ_{n-1}]; si = cumprod(sin(a)) with si[0]=1;
    # co = cos(a) rolled left so the last entry pairs with sin of all angles.
    a = torch.cat(
        [torch.full((phi.shape[0], 1), 2 * math.pi, dtype=phi.dtype,
                    device=phi.device), phi],
        dim=1,
    )
    si = torch.sin(a)
    si[:, 0] = 1.0
    si = torch.cumprod(si, dim=1)
    co = torch.roll(torch.cos(a), -1, dims=1)
    result = si * co * r[:, None]
    return result[0] if flat else result


def cartesian_to_spherical(x):
    """Convert cartesian to spherical coordinates; returns (r, phi),
    including the 2π wrap of the last angle when x[..., -1] <= 0."""
    x = torch.as_tensor(x)
    flat = x.ndim == 1
    if flat:
        x = x[None, :]

    # rs[:, i] = sqrt(sum_{j>=i} x_j^2): suffix L2 norms.
    rs = torch.sqrt(torch.flip(torch.cumsum(torch.flip(x**2, [1]), dim=1), [1]))
    rs_safe = torch.where(rs == 0, torch.ones_like(rs), rs)
    phi = torch.arccos(torch.clamp(x / rs_safe, -1.0, 1.0))[:, :-1]
    wrap = (x[:, -1] <= 0).to(phi.dtype)
    last = phi[:, -1] + (2 * math.pi - 2 * phi[:, -1]) * wrap
    phi = torch.cat([phi[:, :-1], last[:, None]], dim=1)
    r = rs[:, 0]
    if flat:
        return r[0], phi[0]
    return r, phi


def rademacher(generator: torch.Generator, shape) -> torch.Tensor:
    """±1 with equal probability, float32."""
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(torch.float32)


def sample_laplace(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Laplace(0, 1): a signed Exp(1) variate. 1 - U lies in
    (0, 1], so the log is finite."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return rademacher(generator, shape) * -torch.log1p(-u)


def rounds_for(acceptance: float, elements: int) -> int:
    """The fewest rounds R with elements·RUN_STEPS·(1 - acceptance)^R below
    FALLBACK_BUDGET: the rounds of a draw of ``elements`` elements whose
    proposals are each accepted with at least ``acceptance``."""
    if acceptance >= 1.0:
        return 1
    need = math.log(FALLBACK_BUDGET / (elements * RUN_STEPS))
    return max(1, math.ceil(need / math.log1p(-acceptance)))


def fallback_count(device) -> torch.Tensor:
    """The device's int64 count of elements that fell back since the
    last ``reset_fallback_counts``. Reading its value waits for the device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in _fallbacks:
        _fallbacks[key] = torch.zeros((), dtype=torch.int64, device=device)
    return _fallbacks[key]


def reset_fallback_counts() -> None:
    """Zero every device's count in place (a captured step keeps adding
    to the same tensor)."""
    for count in _fallbacks.values():
        count.zero_()


def first_accepted(ok: torch.Tensor, proposals: torch.Tensor, fallback):
    """Each element's first proposal along dim 0 with ``ok`` set, or
    ``fallback`` where no round accepted it (counted in fallback_count)."""
    idx = ok.to(torch.uint8).argmax(0, keepdim=True)  # the first maximum
    got = ok.any(0)
    fallback_count(ok.device).add_((~got).sum())
    return torch.where(got, proposals.gather(0, idx).squeeze(0), fallback)


@functools.cache
def gamma_acceptance(a: float) -> float:
    """Marsaglia–Tsang's acceptance rate at shape a >= 1: E over x ~ N(0, 1)
    of exp(min(0, x²/2 + d - d·v + d·log v)) where v = (1 + c·x)³ > 0,
    by the midpoint rule on x in (-1/c, 12)."""
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    lo, hi, k = -1.0 / c, 12.0, 200_000
    x = lo + (np.arange(k) + 0.5) * (hi - lo) / k
    v = (1.0 + c * x) ** 3
    log_ratio = np.minimum(0.5 * x * x + d - d * v + d * np.log(v), 0.0)
    pdf = np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
    return float(np.sum(pdf * np.exp(log_ratio)) * (hi - lo) / k)


def sample_gamma(generator: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia–Tsang, drawn from ``generator``.

    For alpha < 1 it samples Gamma(alpha + 1) and multiplies by
    U^(1/alpha). All rounds (``rounds_for`` of the boosted shape's
    acceptance rate, above 0.95) are drawn at once; an element no round
    accepted keeps d (the mode).
    """
    device = generator.device
    shape = tuple(shape)
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    rounds = rounds_for(gamma_acceptance(a), math.prod(shape))
    x = torch.randn((rounds,) + shape, generator=generator, device=device)
    u = torch.rand((rounds,) + shape, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (
        torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(1e-30)))
    out = first_accepted(ok, d * v, d)
    if alpha < 1.0:
        u = torch.rand(shape, generator=generator, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def sample_beta(generator: torch.Generator, a: float, b: float, shape):
    """Beta(a, b) as X / (X + Y) with X ~ Gamma(a), Y ~ Gamma(b)."""
    x = sample_gamma(generator, a, shape)
    y = sample_gamma(generator, b, shape)
    return x / (x + y)


def sample_generalized_normal(generator: torch.Generator, mean, lbd: float,
                              p: float, shape):
    """Sample from a generalized Normal (Lp-exponential) distribution.

    density ∝ exp(-(|x-mean|/lbd)^p); sampled as sign * Gamma(1/p)^{1/p}
    scaled by lbd, the construction of the JAX package.
    """
    ipower = 1.0 / p
    gamma_sample = sample_gamma(generator, ipower, shape)
    sign = rademacher(generator, shape)
    sampled = sign * torch.abs(gamma_sample) ** ipower
    return mean + lbd * sampled


@functools.cache
def box_acceptance(p: float, lbd: float, width: float) -> float:
    """The least chance that mean + noise lands in a box interval of
    ``width`` for a mean inside it, with noise of density ∝
    exp(-(|x|/lbd)^p): the mean on a wall, half the mass of |x| <= width,
    0.5·∫_0^T exp(-t^p) dt / Γ(1 + 1/p) with T = width/lbd, by the
    midpoint rule (Laplace: p = 1, lbd its scale; Normal: p = 2,
    lbd = σ·√2)."""
    top = min(width / lbd, 60.0 ** (1.0 / p))  # exp(-60): the tail is nothing
    k = 200_000
    t = (np.arange(k) + 0.5) * top / k
    mass = np.sum(np.exp(-t ** p)) * top / k / math.gamma(1.0 + 1.0 / p)
    return 0.5 * min(float(mass), 1.0)


def truncated_rejection_resampling(
    sampler_fn: Callable,
    generator: torch.Generator,
    min_: float,
    max_: float,
    size: int,
    n: int,
    acceptance: float,
    buffer_size_factor: int = 1,
):
    """Elementwise rejection resampling onto the box [min_, max_]^n.

    ``sampler_fn(generator, s) -> (s, n)`` draws untruncated proposals.
    Each *element* keeps its first proposal inside the box.
    ``acceptance`` is the least chance that a proposal of an element lands
    inside; ``rounds_for`` of it, rounded up to whole rounds of
    ``buffer_size_factor`` (``--rej-mult``) candidates, are drawn at once
    in the order the JAX loop folds them. An element no proposal accepted
    is 0 clipped into the box, as the JAX loop leaves it after
    ``max_iters``.
    """
    k = rounds_for(acceptance, size * n)
    k = -(-k // buffer_size_factor) * buffer_size_factor
    buf = sampler_fn(generator, size * k).reshape(k, size, n)
    ok = (buf >= min_) & (buf <= max_)
    return torch.clamp(first_accepted(ok, buf, 0.0), min_, max_)
