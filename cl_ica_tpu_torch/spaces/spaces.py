"""Topological spaces with probability densities, on torch tensors.

Port of cl_ica_tpu/spaces/spaces.py. Every sampler takes an explicit
``torch.Generator`` first and returns (size, n) float32 tensors on the
generator's device. Spaces are frozen dataclasses of Python scalars.
"""

from __future__ import annotations

import dataclasses
import math
from abc import ABC, abstractmethod

import torch

from . import utils as sut
from .vmf import sample_vmf


def _broadcast_mean(mean, n, device):
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    if mean.ndim == 1:
        mean = mean[None, :]
    if mean.shape[-1] != n:
        raise ValueError(f"mean has width {mean.shape[-1]}, space has {n}")
    return mean


def _tile_rows(mean, s):
    """Repeat a (size, n) mean to cover s = factor*size proposal rows in
    the (factor, size, n) order that the rejection loop folds. A (1, n)
    mean broadcasts as it is."""
    if mean.shape[0] == 1 or mean.shape[0] == s:
        return mean
    return mean.repeat(s // mean.shape[0], 1)


@dataclasses.dataclass(frozen=True)
class Space(ABC):
    """Base class. Samplers: (generator, ..., size) -> (size, n) float32."""

    @abstractmethod
    def uniform(self, generator, size: int):
        ...

    @abstractmethod
    def normal(self, generator, mean, std, size: int):
        ...

    @abstractmethod
    def laplace(self, generator, mean, lbd, size: int):
        ...

    @abstractmethod
    def generalized_normal(self, generator, mean, lbd, p, size: int):
        ...

    @property
    @abstractmethod
    def dim(self) -> int:
        ...


@dataclasses.dataclass(frozen=True)
class NRealSpace(Space):
    """Unconstrained R^N."""

    n: int

    @property
    def dim(self) -> int:
        return self.n

    def uniform(self, generator, size: int):
        raise NotImplementedError("Not defined on R^n")

    def normal(self, generator, mean, std, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)
        noise = torch.randn((size, self.n), generator=generator,
                            device=generator.device)
        return noise * std + mean

    def laplace(self, generator, mean, lbd, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)
        return sut.sample_laplace(generator, (size, self.n)) * lbd + mean

    def generalized_normal(self, generator, mean, lbd, p, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)
        return sut.sample_generalized_normal(generator, mean, lbd, p,
                                             (size, self.n))


@dataclasses.dataclass(frozen=True)
class NSphereSpace(Space):
    """Hypersphere {x : |x| = r} ⊂ R^N.

    normal/laplace/generalized_normal sample in R^N around the
    (on-sphere) mean and project back; von_mises_fisher is the intrinsic
    conditional.
    """

    n: int
    r: float = 1.0

    @property
    def dim(self) -> int:
        return self.n

    def _project(self, x):
        return x / torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True))

    def uniform(self, generator, size: int):
        # Gaussian-normalize; like the JAX package (and its reference) this
        # does not scale by r.
        return self._project(torch.randn((size, self.n), generator=generator,
                                         device=generator.device))

    def normal(self, generator, mean, std, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)
        noise = torch.randn((size, self.n), generator=generator,
                            device=generator.device)
        return self._project(noise * std + mean)

    def laplace(self, generator, mean, lbd, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)
        return self._project(
            sut.sample_laplace(generator, (size, self.n)) * lbd + mean)

    def generalized_normal(self, generator, mean, lbd, p, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)
        return self._project(
            sut.sample_generalized_normal(generator, mean, lbd, p,
                                          (size, self.n)))

    def von_mises_fisher(self, generator, mean, kappa, size: int):
        """Intrinsic Normal on the sphere."""
        mean = _broadcast_mean(mean, self.n, generator.device)
        if mean.shape[0] == 1:
            mean = mean.expand(size, self.n)
        return sample_vmf(generator, mean, kappa, size)


@dataclasses.dataclass(frozen=True)
class NBoxSpace(Space):
    """Box {x : min_ <= x_i <= max_} ⊂ R^N.

    Conditionals are truncated by elementwise rejection resampling
    (utils.truncated_rejection_resampling), whose rounds are sized from
    the least acceptance rate of the noise (utils.box_acceptance).
    ``rej_mult`` is ``--rej-mult``: candidates per rejection round =
    rej_mult × size.
    """

    n: int
    min_: float = -1.0
    max_: float = 1.0
    rej_mult: int = 1

    @property
    def dim(self) -> int:
        return self.n

    def uniform(self, generator, size: int):
        u = torch.rand((size, self.n), generator=generator,
                       device=generator.device)
        return u * (self.max_ - self.min_) + self.min_

    def _truncated(self, generator, sampler, size: int, p: float, lbd: float):
        """Truncate noise of density ∝ exp(-(|x|/lbd)^p) around a mean in
        the box."""
        acceptance = sut.box_acceptance(float(p), float(lbd),
                                        self.max_ - self.min_)
        return sut.truncated_rejection_resampling(
            sampler, generator, self.min_, self.max_, size, self.n,
            acceptance, buffer_size_factor=self.rej_mult,
        )

    def normal(self, generator, mean, std, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)

        def sampler(g, s):
            noise = torch.randn((s, self.n), generator=g, device=g.device)
            return noise * std + _tile_rows(mean, s)

        return self._truncated(generator, sampler, size, 2.0, std * math.sqrt(2.0))

    def laplace(self, generator, mean, lbd, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)

        def sampler(g, s):
            return sut.sample_laplace(g, (s, self.n)) * lbd + _tile_rows(mean, s)

        return self._truncated(generator, sampler, size, 1.0, lbd)

    def generalized_normal(self, generator, mean, lbd, p, size: int):
        mean = _broadcast_mean(mean, self.n, generator.device)

        def sampler(g, s):
            return sut.sample_generalized_normal(
                g, _tile_rows(mean, s), lbd, p, (s, self.n))

        return self._truncated(generator, sampler, size, p, lbd)
