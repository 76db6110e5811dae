"""Von Mises-Fisher sampling on torch tensors.

Port of cl_ica_tpu/spaces/vmf.py: Wood's (1994) rejection sampler over
the whole batch with acceptance masks, bounded at ``max_iters`` rounds,
with the mode as the value of any sample still unaccepted.
"""

from __future__ import annotations

import math

import torch

from .utils import sample_beta


def _sample_weights(generator: torch.Generator, kappa, dim: int,
                    num_samples: int, max_iters: int = 256):
    """Rejection-sample the cosine w of the angle to mu on S^{dim-1}.

    Propose z ~ Beta(a, a) with a = (dim-1)/2, map through
    w = (1-(1+b)z)/(1-(1-b)z), accept when
    kappa*w + (dim-1)*log(1-x*w) - c >= log(u).
    """
    device = generator.device
    d = dim - 1  # S^{n-1}
    kappa = float(kappa)
    b = d / (math.sqrt(4.0 * kappa**2 + d**2) + 2.0 * kappa)
    x = (1.0 - b) / (1.0 + b)
    c = kappa * x + d * math.log(1.0 - x**2)

    w = torch.full((num_samples,), x, dtype=torch.float32, device=device)
    accepted = torch.zeros((num_samples,), dtype=torch.bool, device=device)
    for _ in range(max_iters):
        z = sample_beta(generator, d / 2.0, d / 2.0, (num_samples,))
        w_prop = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        u = torch.rand((num_samples,), generator=generator, device=device)
        acc = kappa * w_prop + d * torch.log(1.0 - x * w_prop) - c >= torch.log(u)
        w = torch.where(acc & ~accepted, w_prop, w)
        accepted |= acc
        if bool(accepted.all()):
            break
    return w


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
