"""Numerical guards, on under CL_ICA_TPU_DEBUG=1.

Port of cl_ica_tpu/utils/debug.py. The JAX package's guards are checkify
checks, functionalized by ``checkify_wrap`` around a jitted step or scan so
that a failed check raises when the call returns. Eager torch has nothing
to functionalize, so there is no ``checkify_wrap`` here: ``nan_check``
reads its value and raises where it runs. An eager step calls it after the
step; a captured step (train/capture.py) cannot read a device value inside
its graph, so its driver checks the window's values where it already
brings them to the host, the boundary where the JAX package's checked scan
returns. With the flag off a guard costs one environment lookup and reads
nothing.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DEBUG_ENV = "CL_ICA_TPU_DEBUG"


def debug_enabled() -> bool:
    return os.environ.get(DEBUG_ENV, "0") == "1"


def nan_check(x, name: str = "value"):
    """Return ``x`` unchanged. Under CL_ICA_TPU_DEBUG=1 first raise
    ValueError (the base class of JAX's checkify error) if it holds a NaN
    or an Inf. ``x`` is a tensor (read on the host: a device
    synchronisation), a number or a sequence of numbers."""
    if not debug_enabled():
        return x
    if isinstance(x, torch.Tensor):
        finite = bool(torch.isfinite(x.detach()).all())
    else:
        finite = bool(np.isfinite(np.asarray(x, dtype=np.float64)).all())
    if not finite:
        raise ValueError(f"non-finite values in {name}")
    return x
