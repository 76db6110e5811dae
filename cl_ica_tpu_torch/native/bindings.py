"""ctypes bindings of the native library (numpy in, numpy or a caller's
buffer out)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import load_native_library


def hungarian_solve_native(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of an (n, n) cost matrix: row_to_col, an (n,)
    int32 array."""
    lib = load_native_library()
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"the cost matrix must be square, got {cost.shape}")
    out = np.empty(n, dtype=np.int32)
    lib.hungarian_solve(cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out


class PackedGather:
    """Threaded row gather from a packed .npy uint8 store, the GIL released
    for the whole batch. Opening a store that cannot be mapped raises
    OSError; the library's build failing raises RuntimeError."""

    def __init__(self, path: str, row_shape, n_rows: int):
        self._handle = -1
        self._lib = load_native_library()
        self.path = path
        self.row_shape = tuple(int(s) for s in row_shape)
        self.row_bytes = int(np.prod(self.row_shape))
        self.n_rows = int(n_rows)
        self._handle = self._lib.pl_open(path.encode(), self.row_bytes, self.n_rows)
        if self._handle < 0:
            raise OSError(f"the native gather could not map {path!r} as "
                          f"{self.n_rows} rows of {self.row_bytes} bytes")

    def gather(self, indices, out=None, threads: int = 0):
        """Rows ``indices`` (B,) -> (B, *row_shape) uint8. ``out``, if given,
        is where they go: a C-contiguous uint8 numpy array or CPU tensor of
        that shape (a pinned tensor's memory too), returned. ``threads`` 0
        gathers with one thread a core. An index out of range raises
        IndexError."""
        if self._handle < 0:
            raise ValueError(f"the native gather of {self.path!r} is closed")
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        shape = (len(idx),) + self.row_shape
        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        ptr = _uint8_buffer(out, shape)
        rc = self._lib.pl_gather(self._handle, idx.ctypes.data, len(idx), ptr,
                                 int(threads))
        if rc == -2:
            raise IndexError(f"a row index out of range [0, {self.n_rows})")
        if rc != 0:
            raise RuntimeError(f"pl_gather failed with code {rc}")
        return out

    def close(self) -> None:
        if self._handle >= 0:
            self._lib.pl_close(self._handle)
            self._handle = -1

    def __del__(self):
        self.close()


def _uint8_buffer(out, shape) -> int:
    """The address of ``out``, checked to be a C-contiguous uint8 host
    buffer of ``shape``."""
    if isinstance(out, torch.Tensor):
        ok = (out.dtype == torch.uint8 and out.is_contiguous()
              and out.device.type == "cpu")
        ptr = out.data_ptr()
    else:
        ok = out.dtype == np.uint8 and out.flags.c_contiguous
        ptr = out.ctypes.data
    if not ok or tuple(out.shape) != shape:
        raise ValueError(f"the gather's output must be a C-contiguous uint8 host "
                         f"buffer of shape {shape}, got {type(out).__name__} "
                         f"{tuple(out.shape)} {out.dtype}")
    return ptr
