"""The layer stamp kernels (csrc/marks.cu) over ctypes.

Not a port of a TPU kernel: utils/profiling.py stamps the boundaries of a
training step's layers on the device, inside a captured CUDA graph too.
``stamp`` launches ``clica_mark<k>`` on the current stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

LIBRARY = "marks"

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the stamps' library."""
    return declare(load_library(LIBRARY))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of a library built
    from csrc/marks.cu."""
    lib.clica_mark_launch.argtypes = [_I, _P, _P, _I, _I, _P]
    lib.clica_mark_launch.restype = _I
    lib.clica_error_string.argtypes = [_I]
    lib.clica_error_string.restype = ctypes.c_char_p
    return lib


def stamp(k: int, ring: torch.Tensor, counter: torch.Tensor) -> None:
    """Stamp boundary ``k`` into ``ring`` ((rows, slots) int64 on a CUDA
    device; ``counter`` its (1,) int64 step counter) on the current
    stream; k = 0 opens a step."""
    lib = load_kernels()
    rows, slots = ring.shape
    with torch.cuda.device(ring.device):
        rc = lib.clica_mark_launch(
            k, ring.data_ptr(), counter.data_ptr(), rows, slots,
            torch.cuda.current_stream(ring.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"clica_mark<{k}> launch failed: "
                           f"{lib.clica_error_string(rc).decode()} ({rc})")
