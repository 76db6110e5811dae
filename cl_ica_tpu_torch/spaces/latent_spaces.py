"""Latent spaces: a space × marginal × conditional sampler.

Port of cl_ica_tpu/spaces/latent_spaces.py. The sampler callables take an
explicit ``torch.Generator``:

    sample_marginal(space, generator, size) -> (size, dim)
    sample_conditional(space, generator, z, size) -> (size, dim)
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .spaces import Space


class LatentSpace:
    """Combines a topological space with marginal/conditional densities."""

    def __init__(
        self,
        space: Space,
        sample_marginal: Optional[Callable] = None,
        sample_conditional: Optional[Callable] = None,
    ):
        self.space = space
        self._sample_marginal = sample_marginal
        self._sample_conditional = sample_conditional

    @property
    def sample_conditional(self):
        if self._sample_conditional is None:
            raise RuntimeError("sample_conditional was not set")
        return lambda generator, z, size, **kw: self._sample_conditional(
            self.space, generator, z, size, **kw
        )

    @sample_conditional.setter
    def sample_conditional(self, value: Callable):
        if not callable(value):
            raise TypeError("sample_conditional must be callable")
        self._sample_conditional = value

    @property
    def sample_marginal(self):
        if self._sample_marginal is None:
            raise RuntimeError("sample_marginal was not set")
        return lambda generator, size, **kw: self._sample_marginal(
            self.space, generator, size, **kw
        )

    @sample_marginal.setter
    def sample_marginal(self, value: Callable):
        if not callable(value):
            raise TypeError("sample_marginal must be callable")
        self._sample_marginal = value

    def sample_pair(self, generator: torch.Generator, size: int):
        """Draw (z ~ marginal, z̃ ~ conditional(z)): the per-step data of
        the synthetic experiment."""
        z = self.sample_marginal(generator, size)
        z_tilde = self.sample_conditional(generator, z, size)
        return z, z_tilde

    @property
    def dim(self) -> int:
        return self.space.dim


class ProductLatentSpace(LatentSpace):
    """Cartesian product of latent spaces."""

    def __init__(self, spaces: List[LatentSpace]):
        self.spaces = spaces

    def sample_conditional(self, generator, z, size: int, **kw):
        x = []
        n = 0
        for s in self.spaces:
            z_s = z[..., n : n + s.space.n]
            n += s.space.n
            x.append(s.sample_conditional(generator, z_s, size, **kw))
        return torch.cat(x, dim=-1)

    def sample_marginal(self, generator, size: int, **kw):
        x = [s.sample_marginal(generator, size, **kw) for s in self.spaces]
        return torch.cat(x, dim=-1)

    @property
    def dim(self) -> int:
        return sum(s.dim for s in self.spaces)
