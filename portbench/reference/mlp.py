"""main_mlp's model, plain (Zimmermann et al., ICML 2021, §5.1;
brendel-group/cl-ica ``main_mlp.py``): a frozen invertible mixing
g (bias-free layers x ← x·Wᵀ, leaky ReLU of slope 0.2 between them), an
encoder f of Linear layers with leaky ReLU of slope 0.01 between them and
an output head, and InfoNCE on (f(g(z1)), f(g(z2)), roll(f(g(z1)), 1)).

Leaves are named as the program's modules name them (``linears.k.weight``,
``head.max_abs_bound``; the mixing's ``w0`` ...), so that the benchmark
hands both sides one dict of weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .infonce import dot_infonce, lp_infonce


def widths(cfg: dict) -> list:
    return [cfg["n"]] + list(cfg["hidden"]) + [cfg["n"]]


def encoder_spec(cfg: dict, head) -> list:
    w = widths(cfg)
    spec = []
    for k, (a, b) in enumerate(zip(w[:-1], w[1:])):
        spec += [(f"linears.{k}.weight", (b, a), "uniform_fan_in"),
                 (f"linears.{k}.bias", (b,), "uniform_fan_in", a)]
    if head == "learnable_box":
        spec.append(("head.max_abs_bound", (cfg["n"],), "ones"))
    elif head == "learnable_sphere":
        spec.append(("head.r", (1,), "ones"))
    return spec


def mixing_spec(cfg: dict) -> list:
    n = cfg["n"]
    return [(f"w{i}", (n, n), "mixing") for i in range(cfg["mixing_layers"])]


def mixing(ws: dict, z, cfg: dict):
    x = z
    last = cfg["mixing_layers"] - 1
    for i in range(cfg["mixing_layers"]):
        x = x @ ws[f"w{i}"].to(x.dtype).T
        if i < last:
            x = F.leaky_relu(x, cfg["mixing_slope"])
    return x


def encoder(params: dict, x, cfg: dict, head, prec):
    layers = len(widths(cfg)) - 1
    for k in range(layers):
        w, b = params[f"linears.{k}.weight"], params[f"linears.{k}.bias"]
        x = prec.out(prec.q(x) @ prec.q(w).T) + b
        if k < layers - 1:
            x = F.leaky_relu(x, cfg["encoder_slope"])
    if head == "learnable_box":
        return torch.sigmoid(x) * params["head.max_abs_bound"][None, :]
    if head in ("learnable_sphere", "fixed_sphere"):
        r = params["head.r"] if head == "learnable_sphere" else 1.0
        return x / torch.linalg.norm(x, dim=-1, keepdim=True) * r
    return x


def step_loss(params: dict, batch: dict, prec, cfg: dict, head, p: float):
    """The loss of one step: batch = {"z1", "z2", "mixing"}."""
    with torch.no_grad():
        x1 = mixing(batch["mixing"], batch["z1"].to(prec.dtype), cfg)
        x2 = mixing(batch["mixing"], batch["z2"].to(prec.dtype), cfg)
    a, b = encoder(params, x1, cfg, head, prec), encoder(params, x2, cfg, head, prec)
    c = torch.roll(a, 1, dims=0)
    items = lp_infonce(a, b, c, p, cfg["tau"]) if p else dot_infonce(a, b, c, cfg["tau"])
    return items.mean()
