"""The synthetic (MLP-mixing) training step and throughput telemetry.

Port of cl_ica_tpu/train/trainer.py:153-178 and :309-330. One step:
sample a latent pair, z3 = roll(z1, 1), h = f∘g, z3_rec = roll(z1_rec, 1),
the InfoNCE loss (or the supervised MSE), then an Adam/AdamW step. The
JAX package scans n_log_steps such steps per device call; here a Python
loop of steps takes the scan's place, and the step returns its metrics
as device tensors so the loop synchronises once per window, not per step.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

import torch


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   cosine_steps: Optional[int] = None, kind: str = "adam",
                   betas: Tuple[float, float] = (0.9, 0.999)
                   ) -> Tuple[torch.optim.Optimizer,
                              Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """optax.adam(lr, b1, b2) -> Adam, optax.adamw(lr, b1, b2,
    weight_decay) -> AdamW (``betas`` = (b1, b2), eps 1e-8 in both
    packages). ``cosine_steps`` T adds optax.cosine_decay_schedule's closed form
    0.5·(1 + cos(π·min(t, T)/T)) as a LambdaLR, stepped once per update.
    ``kind='sgd'``: optax.sgd(lr) -> SGD, and with weight decay
    optax.chain(add_decayed_weights, sgd) -> SGD(weight_decay), which adds
    weight_decay·p to the gradient as that chain does.
    """
    kw = dict(lr=lr, betas=tuple(betas), eps=1e-8)
    if kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)
    elif kind != "adam":
        raise ValueError(f"kind must be 'adam' or 'sgd', got {kind!r}")
    elif weight_decay > 0:
        opt = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    else:
        opt = torch.optim.Adam(params, **kw)
    if cosine_steps is None:
        return opt, None
    t_max = max(int(cosine_steps), 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, t_max) / t_max)))
    return opt, sched


def make_synthetic_train_step(
    sample_pair: Callable,  # (generator, size) -> (z1, z2)
    mixing: Callable,  # g: (B, n) -> (B, d), frozen
    encoder: torch.nn.Module,  # f: (B, d) -> (B, n)
    loss_fn,  # CLLoss-protocol callable
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    supervised: bool = False,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
):
    """Returns step(generator) -> {'loss', 'loss_pos', 'loss_neg'}, 0-d
    tensors on the device, after one optimizer update of ``encoder``.

    supervised=True swaps the contrastive loss for MSE against the
    ground-truth latents (the upper-bound baseline).
    """

    def step(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        z1, z2 = sample_pair(generator, batch_size)
        z3 = torch.roll(z1, 1, dims=0)
        with torch.no_grad():
            x1, x2 = mixing(z1), mixing(z2)
        z1_rec = encoder(x1)
        z2_rec = encoder(x2)
        z3_rec = torch.roll(z1_rec, 1, dims=0)
        if supervised:
            total = torch.mean((z1_rec - z1) ** 2)
            pos = neg = total
        else:
            total, _, (pos, neg) = loss_fn(z1, z2, z3, z1_rec, z2_rec, z3_rec)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {"loss": total.detach(), "loss_pos": pos.detach(),
                "loss_neg": neg.detach()}

    return step


class Throughput:
    """pairs/sec telemetry. Call update(n) after each window of steps has
    completed on the device; read .pairs_per_sec."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup = warmup_steps
        self.count = 0
        self.pairs = 0
        self.t0 = None

    def update(self, n_pairs: int):
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()
        elif self.count > self.warmup:
            self.pairs += n_pairs

    @property
    def pairs_per_sec(self) -> Optional[float]:
        if self.t0 is None or self.pairs == 0:
            return None
        return self.pairs / (time.perf_counter() - self.t0)
