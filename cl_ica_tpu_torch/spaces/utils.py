"""Sampling and coordinate primitives on torch tensors.

Port of cl_ica_tpu/spaces/utils.py. Every sampler draws from an explicit
``torch.Generator`` and returns tensors on that generator's device;
nothing reads the global RNG. ``torch.distributions.Gamma``/``Beta``
take no generator, so Gamma variates come from Marsaglia–Tsang here.

Rejection loops are bounded like the JAX ``lax.while_loop``s they
replace; each iteration ends with one host check of "all accepted",
which is the loop's only device synchronisation.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


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


def sample_gamma(generator: torch.Generator, alpha: float, shape,
                 max_iters: int = 64) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia–Tsang, drawn from ``generator``.

    For alpha < 1 it samples Gamma(alpha + 1) and multiplies by
    U^(1/alpha). The acceptance rate is above 0.95 for the boosted
    shape, so the bound of ``max_iters`` rounds is never reached in
    practice; an element still unaccepted then keeps d (the mode).
    """
    device = generator.device
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.full(shape, d, dtype=torch.float32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for _ in range(max_iters):
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (
            torch.log(u)
            < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(1e-30))
        )
        take = ok & ~done
        out = torch.where(take, d * v, out)
        done |= take
        if bool(done.all()):
            break
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


def truncated_rejection_resampling(
    sampler_fn: Callable,
    generator: torch.Generator,
    min_: float,
    max_: float,
    size: int,
    n: int,
    max_iters: int = 128,
    buffer_size_factor: int = 1,
):
    """Elementwise rejection resampling onto the box [min_, max_]^n.

    ``sampler_fn(generator, size) -> (size, n)`` draws untruncated
    proposals. Each *element* is kept once it lands inside the box.
    ``buffer_size_factor`` (``--rej-mult``) draws factor×size candidates
    per iteration and folds them in order. After ``max_iters`` rounds any
    element still unaccepted is clipped into the box.
    """
    device = generator.device
    result = torch.zeros((size, n), dtype=torch.float32, device=device)
    done = torch.zeros((size, n), dtype=torch.bool, device=device)
    for _ in range(max_iters):
        buf = sampler_fn(generator, size * buffer_size_factor)
        buf = buf.reshape(buffer_size_factor, size, n)
        ok = (buf >= min_) & (buf <= max_)
        for i in range(buffer_size_factor):
            take = ok[i] & ~done
            result = torch.where(take, buf[i], result)
            done |= take
        if bool(done.all()):
            break
    return torch.clamp(result, min_, max_) if max_iters else result
