"""The synthetic (MLP-mixing) training step and throughput telemetry.

Port of cl_ica_tpu/train/trainer.py:153-178 and :309-330. One step:
sample a latent pair, z3 = roll(z1, 1), h = f∘g, z3_rec = roll(z1_rec, 1),
the InfoNCE loss (or the supervised MSE), then an Adam/AdamW step. The
JAX package scans n_log_steps such steps per device call; here the step
is captured once as a CUDA graph and replayed (train/capture.py), and it
returns its metrics as device tensors so the driver synchronises once per
window, not per step. Nothing in the step reads a device value on the
host: on CUDA Adam is ``capturable``, SGD is the fused update, and the
cosine schedule keeps its step count and learning rate on the device
(``CosineLR``).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils import profiling
from ..utils.debug import nan_check


class CosineLR:
    """optax.cosine_decay_schedule's closed form, base·0.5·(1 + cos(π·min(t,
    T)/T)), with the update count t and the learning rate as tensors on
    the parameters' device, so that a captured step updates both. Set on
    construction (t = 0) and after each ``step()``, as LambdaLR; the
    optimizer reads its group's lr tensor."""

    def __init__(self, optimizer: torch.optim.Optimizer, t_max: int):
        self.optimizer, self.t_max = optimizer, max(int(t_max), 1)
        group = optimizer.param_groups[0]
        device = group["params"][0].device
        self.base = [float(g["lr"]) for g in optimizer.param_groups]
        self.t = torch.zeros((), dtype=torch.float64, device=device)
        self.lrs = [torch.tensor(b, dtype=torch.float32, device=device)
                    for b in self.base]
        self._bind()

    def _bind(self) -> None:
        for g, lr in zip(self.optimizer.param_groups, self.lrs):
            g["lr"] = lr
        decay = 0.5 * (1.0 + torch.cos(
            math.pi * torch.clamp(self.t, max=self.t_max) / self.t_max))
        for lr, base in zip(self.lrs, self.base):
            lr.copy_(base * decay)

    def step(self) -> None:
        self.t += 1
        self._bind()

    def state_dict(self) -> dict:
        """LambdaLR's key for the update count; reading it waits for the
        device."""
        return {"last_epoch": int(self.t)}

    def load_state_dict(self, state: dict) -> None:
        """Restore the count into the same tensor, and give the optimizer
        back this schedule's lr tensors (its own ``load_state_dict`` puts
        the saved values in their place)."""
        self.t.fill_(int(state["last_epoch"]))
        self._bind()


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   cosine_steps: Optional[int] = None, kind: str = "adam",
                   betas: Tuple[float, float] = (0.9, 0.999)
                   ) -> Tuple[torch.optim.Optimizer, Optional[CosineLR]]:
    """optax.adam(lr, b1, b2) -> Adam, optax.adamw(lr, b1, b2,
    weight_decay) -> AdamW (``betas`` = (b1, b2), eps 1e-8 in both
    packages). ``cosine_steps`` T adds optax.cosine_decay_schedule's closed form
    0.5·(1 + cos(π·min(t, T)/T)) as a CosineLR, stepped once per update.
    ``kind='sgd'``: optax.sgd(lr) -> SGD, and with weight decay
    optax.chain(add_decayed_weights, sgd) -> SGD(weight_decay), which adds
    weight_decay·p to the gradient as that chain does. Adam and AdamW on
    CUDA parameters are ``capturable``: their step count and bias
    corrections stay on the device. SGD is the fused update on every
    device, p ← p − lr·(g + weight_decay·p) in one kernel that takes the
    learning rate as a tensor: on CUDA it reads a CosineLR's lr on the
    device, so an SGD step under a schedule can be captured too (the
    foreach update reads a tensor lr on the host).
    """
    params = list(params)
    capturable = bool(params) and params[0].is_cuda
    kw = dict(lr=lr, betas=tuple(betas), eps=1e-8, capturable=capturable)
    if kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr, weight_decay=weight_decay, fused=True)
    elif kind != "adam":
        raise ValueError(f"kind must be 'adam' or 'sgd', got {kind!r}")
    elif weight_decay > 0:
        opt = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    else:
        opt = torch.optim.Adam(params, **kw)
    if cosine_steps is None:
        return opt, None
    return opt, CosineLR(opt, cosine_steps)


def make_synthetic_train_step(
    sample_pair: Callable,  # (generator, size) -> (z1, z2)
    mixing: Callable,  # g: (B, n) -> (B, d), frozen
    encoder: torch.nn.Module,  # f: (B, d) -> (B, n)
    loss_fn,  # CLLoss-protocol callable
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    supervised: bool = False,
    scheduler: Optional[CosineLR] = None,
    nan_guard: bool = True,
):
    """Returns step(generator) -> {'loss', 'loss_pos', 'loss_neg'}, 0-d
    tensors on the device, after one optimizer update of ``encoder``.

    supervised=True swaps the contrastive loss for MSE against the
    ground-truth latents (the upper-bound baseline).

    The step's layers are marked (utils/profiling.py): sample,
    encoder_fwd (the frozen mixing and both encoder forwards), loss,
    backward, optimizer (with the schedule).

    Under CL_ICA_TPU_DEBUG=1 the step raises ValueError after its update
    if the loss or a gradient is not finite (utils.debug.nan_check, as the
    JAX package's checked step does when it returns). A body to be
    captured (train/capture.py) cannot read the device: build it with
    ``nan_guard=False`` and check the window's losses where they reach the
    host.
    """

    def step(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with profiling.step(next(encoder.parameters()).device):
            z1, z2 = sample_pair(generator, batch_size)
            profiling.mark("sample")
            z3 = torch.roll(z1, 1, dims=0)
            with torch.no_grad():
                x1, x2 = mixing(z1), mixing(z2)
            z1_rec = encoder(x1)
            z2_rec = encoder(x2)
            z3_rec = torch.roll(z1_rec, 1, dims=0)
            profiling.mark("encoder_fwd")
            if supervised:
                total = torch.mean((z1_rec - z1) ** 2)
                pos = neg = total
            else:
                total, _, (pos, neg) = loss_fn(z1, z2, z3, z1_rec, z2_rec, z3_rec)
            profiling.mark("loss")
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            profiling.mark("backward")
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            profiling.mark("optimizer")
        if nan_guard:
            nan_check(total, "loss")
            for p in encoder.parameters():
                if p.grad is not None:
                    nan_check(p.grad, "grads")
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
