"""The minres norm kernels' least time, counted from shapes.

A frozen copy of ``chip_smoke.py`` ``_bn_bounds``: the four kernels
in bn_relu's mode, bytes over the memory rate (stats: x read; apply: x
read, y written; bwd: x and dy read; dx: x and dy read, dx written) against
operations over the float32 rate (stats 3, apply 3, bwd 5, dx 6 per
element). Every norm of a step is counted at bn_relu's bytes: a block's
last norm also reads the shortcut, so its true least time is longer and
the share taken against this bound is a lower one.
"""

from __future__ import annotations

import math

from . import peaks

KERNELS = ("bn_stats", "bn_apply", "bn_bwd", "bn_dx", "bn_reduce")


def bounds(shape, size: int) -> dict:
    """{kernel: (least seconds, "bytes" | "operations")} at an (N, H, W, C)
    shape of ``size``-byte elements."""
    elems = math.prod(shape)
    out = {}
    for k, passes, ops in (("bn_stats", 1, 3), ("bn_apply", 2, 3),
                           ("bn_bwd", 2, 5), ("bn_dx", 3, 6)):
        t_bytes = elems * size * passes / peaks.BYTES_PER_S
        t_ops = elems * ops / peaks.FLOPS["float32"]
        out[k] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def step_seconds(shapes, size: int) -> float:
    """Least seconds of one step's norm kernels, one norm a shape."""
    return sum(t for s in shapes for t, _ in bounds(s, size).values())
