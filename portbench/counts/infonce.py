"""The loss kernels' least time, counted from shapes.

A frozen copy of ``chip_smoke.py`` ``_bounds``, so that a later
change to the program cannot move the yardstick. A loss launches three
kernels a step (forward, dz1, dz3), each with its chunks' reduce.
Operations: a pair-feature term of the logit costs two flops (dot: multiply,
add; Lp: subtract, accumulate), and a gradient recomputes the logits and
accumulates a second product, two more. Bytes: every input read once, every
output written once. Against the float32 rate outside the tensor cores and
the device-memory rate.
"""

from __future__ import annotations

from . import peaks

KERNELS = ("neg_lse_", "dot_lse_", "lse_reduce_", "grad_reduce_")


def bounds(m: int, n_rows: int, n: int) -> dict:
    """{kernel: (least seconds, "operations" | "bytes")} of fwd, dz1, dz3 at
    m anchors, n_rows negatives and n features."""
    terms = m * n_rows * n
    operands = (m + n_rows) * n
    floats = {"fwd": operands + m,                     # lse out
              "dz1": operands + 2 * m + m * n,         # lse, ct in; dz1 out
              "dz3": operands + 2 * m + n_rows * n}    # lse, ct in; dz3 out
    out = {}
    for k, count in floats.items():
        ops = (2 if k == "fwd" else 4) * terms
        t_ops = ops / peaks.FLOPS["float32"]
        t_bytes = 4 * count / peaks.BYTES_PER_S
        out[k] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def step_seconds(shapes) -> float:
    """Least seconds of one step's loss kernels: ``shapes`` holds one
    (m, n_rows, n) for each loss the step takes."""
    return sum(t for s in shapes for t, _ in bounds(*s).values())


def step_flops(shapes) -> float:
    """The loss kernels' operations of one step (forward 2, each gradient
    4 a pair-feature term)."""
    return sum(10.0 * m * n_rows * n for m, n_rows, n in shapes)
