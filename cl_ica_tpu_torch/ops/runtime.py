"""What every kernel wrapper of ops/ shares: loading a library, launching
one of its entry points, counting launches, asking how many blocks the
card holds, and checking the feature maps and vectors handed to a kernel.

Each ``csrc/<name>.cu`` is a library with a plain C interface (built by
ops/build.py, bound with ctypes). Its wrapper module declares the C
signatures of its own entry points (``declare``) and calls
``library(name, declare)``; every library also has
``clica_error_string(rc)``, declared here. ``launch`` calls an entry point
on the current stream of a tensor's device, raises on a nonzero return
code and counts the launch.

This module is also the one seam where a test stands a fake card in for
the real one: the library it hands out (``library``), the card's SMs
(``sm_count``), the stream (``stream``), the device switch
(``device_guard``) and the feature-map check (``check_map``). Every
wrapper calls them through this module's attributes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from .build import load_library

PTR = ctypes.c_void_p  # a device pointer, or a stream
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float
DTYPES = (torch.float32, torch.bfloat16)  # what the feature-map kernels take

# The launch counters, each wrapper module's kernels in turn: fused_neg_lse's
# (ops/infonce.py), fused_dot_lse's (ops/infonce_dot.py), the stem tail's
# (ops/stem.py), the blocks' batch norm's (ops/bn_minres.py), its float8
# modes (ops/bn_minres8.py) and the argmax pool's (ops/pool_minres.py). A
# kernel and the reduction launched after it count as one launch.
KERNELS = {
    "infonce": ("fwd", "dz1", "dz3"),
    "infonce_dot": ("dot_fwd", "dot_dz1", "dot_dz3"),
    "stem": ("stem_fwd", "stem_bwd", "stem_dx"),
    "bn_minres": ("bn_stats", "bn_apply", "bn_bwd", "bn_dx"),
    "bn_minres8": ("bn_apply8", "bn_bwd8", "bn_dx8"),
    "pool_minres": ("pool_code", "pool_scatter"),
}
# Every counter: the kernels' and bn_junctions, the bn_bwd launches that
# took two upstream gradients (a ResNet block's output on its two edges,
# ops/bn_minres.py).
COUNTERS = (*(k for family in KERNELS.values() for k in family), "bn_junctions")

# Launches of each kernel since the last reset. Under a CUDA graph's
# capture a launch counts the launch it records; the captured step takes
# that back and counts each replay's launches instead (train/capture.py).
_launches: Dict[str, int] = dict.fromkeys(COUNTERS, 0)


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add launches made outside the wrappers' Python: a CUDA graph's
    replay launches the kernels its capture recorded (train/capture.py)."""
    for k, v in counts.items():
        _launches[k] += v


def bind(lib: ctypes.CDLL, declare) -> ctypes.CDLL:
    """Declare ``clica_error_string``, which every library has, then the
    library's own entry points (``declare(lib)``)."""
    lib.clica_error_string.argtypes = [INT]
    lib.clica_error_string.restype = ctypes.c_char_p
    return declare(lib)


@functools.cache
def library(name: str, declare) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use (ops/build.py)
    and bound with ``declare``."""
    return bind(load_library(name), declare)


def check(lib, rc: int, which: str) -> None:
    """Raise for a nonzero return code of one of ``lib``'s entry points."""
    if rc != 0:
        msg = lib.clica_error_string(rc).decode()
        raise RuntimeError(f"{which} kernel launch failed: {msg} ({rc})")


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_guard(device: torch.device):
    return torch.cuda.device(device)


def launch(lib, kernel: str, device: torch.device, *args,
           count: str | None = None) -> None:
    """``lib.clica_<kernel>(*args, stream)`` on ``device``'s current stream;
    a nonzero return code raises, and one launch is added to the counter
    ``count`` (None: a call that counts no kernel of the step)."""
    with device_guard(device):
        rc = getattr(lib, f"clica_{kernel}")(*args, stream(device))
    check(lib, rc, kernel.replace("_", " "))
    if count is not None:
        _launches[count] += 1


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def resident_blocks(lib, kernel: str, device_index: int, *args: int) -> int:
    """Blocks of a kernel, at these arguments, that the card holds at once:
    ``clica_<kernel>_blocks_per_sm(*args, &blocks)`` times the SMs; 0 where
    none fits (the loss libraries' answer where their first version runs)."""
    per_sm = INT()
    rc = getattr(lib, f"clica_{kernel}_blocks_per_sm")(*args, ctypes.byref(per_sm))
    check(lib, rc, f"{kernel} occupancy")
    return sm_count(device_index) * per_sm.value


def ptr(t: torch.Tensor | None) -> int | None:
    """t's device pointer, None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def vector_width(dtype: torch.dtype) -> int:
    """Channels per 16-byte vector of the feature-map kernels."""
    return 8 if dtype == torch.bfloat16 else 4


def check_map(name: str, t: torch.Tensor, like: torch.Tensor | None = None,
              shape=None) -> None:
    """What the kernels ask of a feature map: a dense (..., C) CUDA tensor,
    float32 or bfloat16, not empty, 16-byte aligned, C a multiple of the
    vector width; with ``like``, of like's dtype and device and of
    ``shape`` (like's own if None)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.ndim < 2 or t.numel() == 0:
        raise ValueError(f"{name} must be (..., C) and not empty, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(
            f"{name} must be dense (..., C) memory, got strides {t.stride()} "
            f"for shape {tuple(t.shape)}; the wrapper does not copy it (for a "
            "channels_last NCHW tensor pass t.permute(0, 2, 3, 1))")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    vec = vector_width(t.dtype)
    if t.shape[-1] % vec:
        raise ValueError(f"{name}: C = {t.shape[-1]} is not a multiple of "
                         f"{vec} ({t.dtype})")
    if like is not None:
        shape = like.shape if shape is None else torch.Size(shape)
        if t.shape != shape or t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want {tuple(shape)} {like.dtype} on {like.device}")


def check_vec(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """What the kernels ask of a per-channel vector (or a stack of them): a
    contiguous, 16-byte aligned tensor of this shape, dtype and device."""
    if (t.shape != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"{tuple(shape)} {dtype} tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
