"""Von Mises-Fisher sampling on torch tensors.

Port of cl_ica_tpu/spaces/vmf.py: Wood's (1994) rejection sampler over
the whole batch. Its rounds are drawn at once, (R, B) proposals, each a
Beta from (R_g, R, B) Gamma proposals, with R sized from the acceptance
rate at (kappa, dim) (``wood_acceptance``, ``utils.rounds_for``); a
sample no round accepted keeps the JAX loop's fallback, w = x.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .utils import first_accepted, rounds_for, sample_beta


def _wood_constants(kappa: float, d: int):
    b = d / (math.sqrt(4.0 * kappa**2 + d**2) + 2.0 * kappa)
    x = (1.0 - b) / (1.0 + b)
    return b, x, kappa * x + d * math.log(1.0 - x**2)


@functools.cache
def wood_acceptance(kappa: float, dim: int) -> float:
    """Wood's acceptance rate on S^{dim-1}: E over z ~ Beta(d/2, d/2) of
    exp(kappa·w + d·log(1 - x·w) - c), d = dim - 1, by the midpoint rule on
    θ with z = sin²θ (the Beta density's end points become bounded)."""
    d = dim - 1
    b, x, c = _wood_constants(float(kappa), d)
    a = d / 2.0
    k = 200_000
    theta = (np.arange(k) + 0.5) * (math.pi / 2) / k
    z = np.sin(theta) ** 2
    log_beta = 2.0 * math.lgamma(a) - math.lgamma(2.0 * a)
    dens = 2.0 * (np.sin(theta) * np.cos(theta)) ** (2.0 * a - 1.0) / math.exp(log_beta)
    w = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
    ratio = np.exp(np.minimum(kappa * w + d * np.log1p(-x * w) - c, 0.0))
    return float(np.sum(dens * ratio) * (math.pi / 2) / k)


def _sample_weights(generator: torch.Generator, kappa, dim: int,
                    num_samples: int):
    """Rejection-sample the cosine w of the angle to mu on S^{dim-1}.

    Propose z ~ Beta(a, a) with a = (dim-1)/2, map through
    w = (1-(1+b)z)/(1-(1-b)z), accept when
    kappa*w + (dim-1)*log(1-x*w) - c >= log(u).
    """
    device = generator.device
    d = dim - 1  # S^{n-1}
    kappa = float(kappa)
    b, x, c = _wood_constants(kappa, d)
    shape = (rounds_for(wood_acceptance(kappa, dim), num_samples), num_samples)
    z = sample_beta(generator, d / 2.0, d / 2.0, shape)
    w_prop = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
    u = torch.rand(shape, generator=generator, device=device)
    acc = kappa * w_prop + d * torch.log(1.0 - x * w_prop) - c >= torch.log(u)
    return first_accepted(acc, w_prop, x)


def _sample_orthonormal_to(generator: torch.Generator, mu):
    """Sample unit vectors orthogonal to each row of mu."""
    v = torch.randn(mu.shape, generator=generator, device=generator.device)
    proj = (
        mu
        * torch.sum(mu * v, dim=-1, keepdim=True)
        / torch.linalg.norm(mu, dim=-1, keepdim=True)
    )
    ortho = v - proj
    return ortho / torch.linalg.norm(ortho, dim=-1, keepdim=True)


def sample_vmf(generator: torch.Generator, mu, kappa, num_samples: int):
    """Draw vMF samples around per-row means mu with concentration kappa.

    mu: (num_samples, n) or (n,) unit vectors.
    result = v * sqrt(1-w²) + w * mu with v ⟂ mu.
    """
    mu = torch.as_tensor(mu, dtype=torch.float32, device=generator.device)
    if mu.ndim == 1:
        mu = mu[None, :].expand(num_samples, mu.shape[0])
    dim = mu.shape[1]
    w = _sample_weights(generator, kappa, dim, num_samples)
    v = _sample_orthonormal_to(generator, mu)
    return v * torch.sqrt(torch.clamp(1.0 - w**2, min=0.0))[:, None] + w[:, None] * mu
