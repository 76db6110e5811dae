"""The layer stamp kernels (csrc/marks.cu) over ctypes.

Not a port of a TPU kernel: utils/profiling.py stamps the boundaries of a
training step's layers on the device, inside a captured CUDA graph too.
``stamp`` launches ``clica_mark<k>`` on the current stream.
"""

from __future__ import annotations

import ctypes

import torch

from . import runtime
from .runtime import INT, PTR

LIBRARY = "marks"


def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the stamps' library."""
    return runtime.library(LIBRARY, declare)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of a library built
    from csrc/marks.cu."""
    lib.clica_mark_launch.argtypes = [INT, PTR, PTR, INT, INT, PTR]
    lib.clica_mark_launch.restype = INT
    return lib


def stamp(k: int, ring: torch.Tensor, counter: torch.Tensor) -> None:
    """Stamp boundary ``k`` into ``ring`` ((rows, slots) int64 on a CUDA
    device; ``counter`` its (1,) int64 step counter) on the current
    stream; k = 0 opens a step. A stamp is no kernel of the step: it is
    not counted."""
    rows, slots = ring.shape
    runtime.launch(load_kernels(), "mark_launch", ring.device, k,
                   ring.data_ptr(), counter.data_ptr(), rows, slots)
