"""SlowVAE baseline loss (Klindt et al.).

Port of cl_ica_tpu/losses/slowvae.py: the beta-VAE ELBO over a temporal
pair plus a gamma-weighted KL between the posterior and a Laplace
transition prior,

  L = 2·recon + beta·KL(q ‖ N(0,1)) + gamma·KL_laplace(q, rate_prior),

where KL_laplace takes the closed-form cross entropy of a Normal under a
Laplace(rate_prior) density on the difference of the pair's means, both
ways. The encoder's output packs [mu, logvar] (z_rec[:, :n] / z_rec[:, n:]).
The decoder and the mixing are callables (a ``ConvDecoder64`` or an MLP,
and the frozen g), and the reparametrisation draws from an explicit
``torch.Generator``: the call raises without one, as the JAX package's
asserts its key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .infonce import CLLoss


def _normal_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


@dataclasses.dataclass
class SlowVAELoss(CLLoss):
    """beta-VAE + Laplace-transition KL over temporal pairs; the tuple
    protocol's (loss, per item, components) with NaN per item and the
    components [recon, kl_normal, kl_laplace]."""

    dec_h: Callable  # decoder: (B, n) latents -> (B, ...) reconstruction logits
    g: Optional[Callable] = None  # mixing z -> observation (target of recon)
    gamma: float = 10.0
    beta: float = 1.0
    rate_prior: float = 6.0
    n: int = 1
    decoder_dist: str = "bernoulli"
    no_sigmoid: bool = False

    def _reconstruction_loss(self, x, x_recon):
        batch_size = x.shape[0]
        if batch_size == 0:
            raise ValueError("SlowVAELoss: an empty batch")
        if self.decoder_dist == "bernoulli":
            # summed BCE with logits / batch
            bce = (torch.clamp(x_recon, min=0) - x_recon * x
                   + torch.log1p(torch.exp(-torch.abs(x_recon))))
            return torch.sum(bce) / batch_size
        if self.decoder_dist == "gaussian":
            if not self.no_sigmoid:
                x_recon = torch.sigmoid(x_recon)
            return torch.sum((x_recon - x) ** 2) / batch_size
        return None

    @staticmethod
    def _reparametrize(generator, mu, logvar):
        std = torch.exp(logvar / 2.0)
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                          device=mu.device)
        return mu + std * eps

    @staticmethod
    def _ent_normal(logvar):
        return 0.5 * (logvar + math.log(2 * math.pi * math.e))

    @staticmethod
    def _cross_ent_normal(mu, logvar):
        return 0.5 * (mu**2 + torch.exp(logvar)) + math.log(math.sqrt(2 * math.pi))

    def _cross_ent_laplace(self, mean, logvar, rate_prior):
        var = torch.exp(logvar)
        sigma = torch.sqrt(var)
        return (
            -math.log(rate_prior / 2.0)
            + rate_prior * sigma * math.sqrt(2.0 / math.pi)
            * torch.exp(-(mean**2) / (2 * var))
            - rate_prior * mean * (1.0 - 2.0 * _normal_cdf(mean / sigma))
        )

    def _cross_ent_combined(self, mu0, mu1, logvar0, logvar1):
        logvar = torch.cat([logvar0, logvar1])
        mu = torch.cat([mu0, mu1])
        normal_entropy = self._ent_normal(logvar)
        cross_ent_normal = self._cross_ent_normal(mu, logvar)
        # couples: the Laplace cross entropy both ways
        cross_ent_laplace = self._cross_ent_laplace(
            mu0 - mu1, logvar0, self.rate_prior
        ) + self._cross_ent_laplace(mu1 - mu0, logvar1, self.rate_prior)
        return [
            torch.mean(torch.sum(x, dim=1))
            for x in (normal_entropy, cross_ent_normal, cross_ent_laplace)
        ]

    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec,
             generator: Optional[torch.Generator] = None):
        if generator is None:
            raise ValueError("SlowVAELoss needs an explicit torch.Generator "
                             "(generator=...) for its reparametrisation")
        n = self.n
        if z1.shape[1] != n:
            raise ValueError(f"SlowVAELoss(n={n}) got latents of width "
                             f"{z1.shape[1]}")
        mu0, logvar0 = z1_rec[:, :n], z1_rec[:, n:]
        mu1, logvar1 = z2_con_z1_rec[:, :n], z2_con_z1_rec[:, n:]

        pair = torch.cat([z1, z2_con_z1])
        target = self.g(pair) if self.g else pair
        z_sample = self._reparametrize(
            generator, torch.cat([mu0, mu1]), torch.cat([logvar0, logvar1]))
        recon_loss = self._reconstruction_loss(target, self.dec_h(z_sample))

        normal_entropy, cross_ent_normal, cross_ent_laplace = (
            self._cross_ent_combined(mu0, mu1, logvar0, logvar1)
        )
        kl_normal = cross_ent_normal - normal_entropy
        kl_laplace = cross_ent_laplace - normal_entropy
        vae_loss = 2 * recon_loss + self.beta * kl_normal + self.gamma * kl_laplace
        return (
            vae_loss,
            torch.full((z1.shape[0],), math.nan, dtype=vae_loss.dtype,
                       device=vae_loss.device),
            [recon_loss, kl_normal, kl_laplace],
        )

    def __call__(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec,
                 generator: Optional[torch.Generator] = None):
        return self.loss(z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec,
                         generator=generator)
