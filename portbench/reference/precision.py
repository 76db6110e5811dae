"""The precision a reference computes in.

``float64``: the reference of the float32 configurations. ``float32``: the
reference of the bfloat16 one (and of the float32 ResNet, whose float64
convolutions would outlast the window), TF32 off. The controls, one step
below what a configuration states: ``tf32`` (float32 tensors, TF32 on in
products and convolutions) for float32 with TF32 off, and ``fp8`` for
bfloat16, the usual float8 training recipe: each product's and
convolution's operands and its output rounded to float8_e4m3fn with a
per-tensor scale (amax / 448), the rounding passed straight through, and
the gradient that reaches each product's output rounded to float8_e5m2
(amax / 57344). ``bf16`` (a witness, not a control:
the reference with each product's operands rounded to bfloat16, as a
bfloat16 program's tensor cores take them) shows what rounding alone does
to the numbers a bfloat16 run is compared on.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x, dtype, top: float):
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradToE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "float32", "tf32", "fp8", "bf16"):
            raise ValueError(f"no precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as this precision holds it."""
        if self.name == "bf16":
            return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())
        if self.name != "fp8":
            return x
        return x + (_round(x.detach(), torch.float8_e4m3fn, E4M3_MAX) - x.detach())

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output: under ``fp8`` it and its gradient are rounded."""
        return _GradToE5M2.apply(self.q(y)) if self.name == "fp8" else y

    @contextlib.contextmanager
    def active(self):
        """TF32 on for ``tf32``, off for every other precision."""
        tf32 = self.name == "tf32"
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
