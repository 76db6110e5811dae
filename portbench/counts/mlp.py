"""Model operations of one main_mlp step, counted from shapes.

Per row the encoder's Linear layers take Σ a·b multiply-adds (widths
n-h1-...-n); the step encodes both views, 2B rows. Forward 2 flops a
multiply-add; backward 4 (the gradients of the weights and of the
activations), except that the first layer's input takes no gradient (2).
The frozen mixing is forward only. No recomputation: the loss kernels'
recomputed logits are counted once, at their forward's 2 flops a term plus
the gradients' products (``infonce.step_flops``).
"""

from __future__ import annotations

from . import infonce


def encoder_macs(widths) -> int:
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def step_flops(cfg: dict, batch: int, p: float) -> float:
    n = cfg["n"]
    w = [n] + list(cfg["hidden"]) + [n]
    rows = 2 * batch
    first = w[0] * w[1]
    enc = rows * (2 * encoder_macs(w) + 4 * encoder_macs(w) - 2 * first)
    mix = rows * 2 * cfg["mixing_layers"] * n * n
    loss = infonce.step_flops([(batch, batch, n)])
    return float(enc + mix + loss)
