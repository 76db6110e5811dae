"""The reference's three training steps: plain autograd and plain Adam,
from the benchmark's weights, over the batches the program's steps drew."""

from __future__ import annotations

import torch

from .adam import Adam


def follow(params0: dict, loss_fn, batches, prec, lr: float,
           betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """{"losses", "grad1", "change3"} of len(batches) steps of
    ``loss_fn(params, batch, prec)``; leaves on the host."""
    with prec.active():
        params = {k: v.detach().to(prec.dtype).clone().requires_grad_(True)
                  for k, v in params0.items()}
        opt = Adam(params, lr, betas, eps)
        losses, grad1 = [], None
        for batch in batches:
            loss = loss_fn(params, batch, prec)
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: g.detach().double().cpu() for k, g in grads.items()}
            opt.step(grads)
        change3 = {k: (p.detach().double() - params0[k].double()).cpu()
                   for k, p in params.items()}
    return {"losses": losses, "grad1": grad1, "change3": change3}
