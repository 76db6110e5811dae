"""The benchmark's weights, made on the device from ``--seed``.

A spec is a list of (name, shape, init) or (name, shape, init, fan_in)
from the reference's own layout (a bias takes its weight's fan-in).
Every random leaf is a slice of one draw on the device (one ``rand`` for
the uniform leaves, one ``randn`` for the normal ones), scaled per leaf,
so set-up makes the weights in two calls whatever the model's depth.

Inits: ``uniform_fan_in`` U(±1/√fan_in) (the MLP's Linear, weight and bias
by the weight's fan-in), ``he`` N(0, 2/fan_in) (convolutions),
``lecun`` N(0, 1/fan_in) (a Linear), ``mixing`` U(−1, 1) with unit
columns (the frozen mixing, the "pcl" matrices without the condition
search), ``ones``, ``zeros``.
"""

from __future__ import annotations

import math

import torch


def fan_in(shape) -> int:
    return int(math.prod(shape[1:])) if len(shape) > 1 else int(shape[0])


def make(spec, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} for ``spec``, from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    spec = [tuple(e) + (None,) * (4 - len(e)) for e in spec]
    uni = [e for e in spec if e[2] in ("uniform_fan_in", "mixing")]
    nor = [e for e in spec if e[2] in ("he", "lecun")]
    out = {}
    for group, draw in ((uni, torch.rand), (nor, torch.randn)):
        total = sum(math.prod(e[1]) for e in group)
        flat = draw(total, generator=gen, device=device, dtype=torch.float32)
        at = 0
        for name, shape, init, fan in group:
            fan = fan or fan_in(shape)
            x = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
            if init == "mixing":
                x = 2 * x - 1
                x = x / x.norm(dim=0, keepdim=True)
            elif init == "uniform_fan_in":
                x = (2 * x - 1) / math.sqrt(fan)
            elif init == "he":
                x = x * math.sqrt(2.0 / fan)
            else:
                x = x / math.sqrt(fan)
            out[name] = x.to(dtype)
    for name, shape, init, _ in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif name not in out:
            raise ValueError(f"unknown init {init!r} of {name}")
    return {e[0]: out[e[0]] for e in spec}


@torch.no_grad()
def load_into(named_tensors, weights: dict) -> None:
    """Copy ``weights`` into the program's tensors of the same names, in
    place (a captured step keeps their addresses). The names must agree."""
    named = dict(named_tensors)
    if set(named) != set(weights):
        raise KeyError("the program's leaves and the benchmark's weights "
                       f"differ: {sorted(set(named) ^ set(weights))}")
    for k, t in named.items():
        if t.shape != weights[k].shape:
            raise ValueError(f"{k}: program {tuple(t.shape)}, "
                             f"weights {tuple(weights[k].shape)}")
        t.copy_(weights[k])
