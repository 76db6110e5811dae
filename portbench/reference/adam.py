"""Adam, plain: m ← β1·m + (1 − β1)·g, v ← β2·v + (1 − β2)·g²,
p ← p − lr·m̂ / (√v̂ + ε), with the bias corrections 1 − βᵗ (Kingma & Ba,
2015; optax.adam's defaults: β = (0.9, 0.999), ε = 1e-8)."""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))
