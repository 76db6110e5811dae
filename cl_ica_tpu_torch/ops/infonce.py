"""Fused Lp-InfoNCE negative log-sum-exp: Hopper kernels and their plain
PyTorch version.

Port of cl_ica_tpu/ops/infonce_pallas.py:194-307 (``fused_neg_lse``):

    lse_i = log Σ_j exp(-Σ_k |z1_ik - z3_jk|^p / τ),   z1 (M, n), z3 (N, n)

for p ≥ 1, without the M×N matrix ever reaching device memory. The
forward and both backward kernels are CUDA C++ in csrc/infonce_lp.cu
(see the note there for what bounds them and how they differ from the
TPU kernels); this module builds and binds them (ops/build.py), wraps
them in a ``torch.autograd.Function``, and counts their launches. Where
the library has a tiled kernel for the arguments (it says which, through
``clica_neg_lse_{fwd,grad}_blocks_per_sm``), the other operand's rows go
in chunks (``split_plan``) and the wrapper allocates the chunks' partials.

On CPU tensors ``fused_neg_lse`` computes ``neg_lse_reference``, the
plain version, because there is no kernel to launch there. On CUDA
tensors it launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from .build import load_library

LIBRARY = "infonce_lp"
MAX_FEATURES = 64  # the kernels' template bound on n
MIN_CHUNK = 64  # the fewest rows of the other operand a tiled gradient block takes

# Launches of each kernel since the last reset; each wrapper adds one
# where it launches its kernel, and nowhere else. fwd/dz1/dz3 are
# fused_neg_lse's kernels (this module), dot_* are fused_dot_lse's
# (ops/infonce_dot.py), stem_* the stem tail's (ops/stem.py), bn_* the
# blocks' batch norm's (ops/bn_minres.py; bn_*8 its float8 modes,
# ops/bn_minres8.py), pool_* the argmax pool's (ops/pool_minres.py);
# bn_junctions counts the bn_bwd launches that took two upstream gradients
# (a ResNet block's output on its two edges, ops/bn_minres.py). Under a
# CUDA graph's capture a wrapper counts the launch it records; the
# captured step takes that back and counts each replay's launches instead
# (train/capture.py).
_launches: Dict[str, int] = {"fwd": 0, "dz1": 0, "dz3": 0,
                             "dot_fwd": 0, "dot_dz1": 0, "dot_dz3": 0,
                             "stem_fwd": 0, "stem_bwd": 0, "stem_dx": 0,
                             "bn_stats": 0, "bn_apply": 0, "bn_bwd": 0,
                             "bn_dx": 0, "bn_apply8": 0, "bn_bwd8": 0,
                             "bn_dx8": 0, "pool_code": 0, "pool_scatter": 0,
                             "bn_junctions": 0}


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


def neg_lse_reference(z1: torch.Tensor, z3: torch.Tensor, p: float,
                      tau: float) -> torch.Tensor:
    """The plain version: the (M, N) distances by explicit broadcast
    Σ_k |z1_ik - z3_jk|^p (not ``torch.cdist``, which may take a matmul
    path), then ``torch.logsumexp``. Autograd supplies the gradient."""
    diff = torch.abs(z1[:, None, :] - z3[None, :, :])
    d = diff.sum(-1) if p == 1.0 else (diff ** p).sum(-1)
    return torch.logsumexp(-d / tau, dim=1)


_F32P = ctypes.c_void_p
_F64P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return declare(load_library(LIBRARY))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of a library built
    from csrc/infonce_lp.cu."""
    lib.clica_neg_lse_fwd.argtypes = [_F32P, _F32P, _F32P, _F32P, _F64P, _I,
                                      _I, _I, _I, _I, _F, _F, ctypes.c_void_p]
    lib.clica_neg_lse_fwd.restype = _I
    lib.clica_neg_lse_fwd_block_rows.argtypes = []
    lib.clica_neg_lse_fwd_block_rows.restype = _I
    lib.clica_neg_lse_fwd_blocks_per_sm.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.clica_neg_lse_fwd_blocks_per_sm.restype = _I
    for fn in (lib.clica_neg_lse_dz1, lib.clica_neg_lse_dz3):
        fn.argtypes = [_F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _I, _I, _I,
                       _I, _I, _F, _F, ctypes.c_void_p]
        fn.restype = _I
    lib.clica_neg_lse_grad_block_rows.argtypes = []
    lib.clica_neg_lse_grad_block_rows.restype = _I
    lib.clica_neg_lse_grad_blocks_per_sm.argtypes = [_I, _I, _I,
                                                     ctypes.POINTER(_I)]
    lib.clica_neg_lse_grad_blocks_per_sm.restype = _I
    lib.clica_error_string.argtypes = [_I]
    lib.clica_error_string.restype = ctypes.c_char_p
    return lib


def _pmode(p: float) -> int:
    return 1 if p == 1.0 else 2 if p == 2.0 else 0


def _check_launch(lib, rc: int, which: str) -> None:
    if rc != 0:
        msg = lib.clica_error_string(rc).decode()
        raise RuntimeError(f"{which} kernel launch failed: {msg} ({rc})")


def _check_operand(name: str, t: torch.Tensor, n: int | None = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if n is not None and (t.ndim != 2 or t.shape[1] != n):
        raise ValueError(f"{name} must be (rows, {n}), got {tuple(t.shape)}")


def _check_pair(z1: torch.Tensor, z3: torch.Tensor) -> None:
    """What every kernel here asks of its two operands: z1 (M, n) and
    z3 (N, n), float32, contiguous, on one CUDA device, M, N ≥ 1,
    1 ≤ n ≤ MAX_FEATURES."""
    if z1.ndim != 2 or not 1 <= z1.shape[1] <= MAX_FEATURES:
        raise ValueError(
            f"z1 must be (M, n) with 1 <= n <= {MAX_FEATURES}, got {tuple(z1.shape)}")
    if z1.shape[0] < 1 or z3.shape[0] < 1:
        raise ValueError("z1 and z3 need at least one row each")
    _check_operand("z1", z1)
    _check_operand("z3", z3, z1.shape[1])
    if z3.device != z1.device:
        raise ValueError(f"z1 is on {z1.device}, z3 on {z3.device}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def split_plan(own_rows: int, other_rows: int, block_rows: int,
               slots: int) -> tuple[int, int]:
    """(splits, chunk) for a tiled kernel: the other operand's rows in
    ``splits`` chunks of ``chunk`` (the last may be shorter), so that the
    grid of ceil(own_rows / block_rows) x splits blocks fills as much of
    two waves of the ``slots`` blocks the card holds at once as whole
    row blocks allow, and no more (a third wave of a few blocks would
    cost a third of the time), with no chunk under MIN_CHUNK rows unless
    the other operand is."""
    row_blocks = -(-own_rows // block_rows)
    want = 2 * slots // row_blocks
    splits = max(1, min(want, other_rows // MIN_CHUNK))
    chunk = -(-other_rows // splits)
    return -(-other_rows // chunk), chunk


def tiled_slots(lib, kernel: str, device_index: int,
                *args) -> tuple[int, int] | None:
    """(own rows per block, blocks the card holds at once) of a library's
    tiled kernel, asked of ``clica_<kernel>_blocks_per_sm(*args, &blocks)``
    and ``clica_<kernel>_block_rows()``, or None where the library has no
    tiled kernel for these arguments (the first version runs, in one
    chunk)."""
    per_sm = _I()
    rc = getattr(lib, f"clica_{kernel}_blocks_per_sm")(*args, ctypes.byref(per_sm))
    _check_launch(lib, rc, f"{kernel} occupancy")
    if per_sm.value == 0:
        return None
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return getattr(lib, f"clica_{kernel}_block_rows")(), sms * per_sm.value


def chunks(rows: int, others: int, tiled) -> tuple[int, int]:
    """(splits, chunk) of a launch over ``rows`` own rows: split_plan's, or
    the other operand's rows in one chunk where ``tiled`` (from
    tiled_slots) is None."""
    return (1, others) if tiled is None else split_plan(rows, others, *tiled)


def grad_scratch(rows: int, others: int, n: int, tiled, device):
    """(chunk, part) of a gradient launch: the other operand's rows in
    chunks and the (splits, rows, n) float buffer of the chunks' partial
    sums, None for one chunk."""
    splits, chunk = chunks(rows, others, tiled)
    part = None
    if splits > 1:
        part = torch.empty((splits, rows, n), device=device, dtype=torch.float32)
    return chunk, part


def lse_scratch(rows: int, others: int, tiled, device):
    """(chunk, part_m, part_s) of a forward launch: the other operand's
    rows in chunks, and each chunk's partial (max, sum) of every row,
    (splits, rows) float and double, None for one chunk."""
    splits, chunk = chunks(rows, others, tiled)
    if splits == 1:
        return chunk, None, None
    return (chunk,
            torch.empty((splits, rows), device=device, dtype=torch.float32),
            torch.empty((splits, rows), device=device, dtype=torch.float64))


@functools.cache
def _fwd_slots(device_index: int, n: int, pmode: int) -> tuple[int, int] | None:
    return tiled_slots(load_kernels(), "neg_lse_fwd", device_index, n, pmode)


def _launch_fwd(z1, z3, p: float, tau: float) -> torch.Tensor:
    lib = load_kernels()
    (m, n), nn = z1.shape, z3.shape[0]
    lse = torch.empty(m, device=z1.device, dtype=torch.float32)
    chunk, part_m, part_s = lse_scratch(
        m, nn, _fwd_slots(z1.device.index, n, _pmode(p)), z1.device)
    with torch.cuda.device(z1.device):
        rc = lib.clica_neg_lse_fwd(z1.data_ptr(), z3.data_ptr(), lse.data_ptr(),
                                   _ptr(part_m), _ptr(part_s), chunk, m, nn, n,
                                   _pmode(p), p, tau, _stream(z1))
    _check_launch(lib, rc, "neg_lse fwd")
    _launches["fwd"] += 1  # the forward kernel and its reduce kernel
    return lse


@functools.cache
def _grad_slots(device_index: int, which: str, n: int,
                pmode: int) -> tuple[int, int] | None:
    return tiled_slots(load_kernels(), "neg_lse_grad", device_index,
                       int(which == "dz3"), n, pmode)


def _launch_bwd(which: str, z1, z3, lse, ct, p: float, tau: float):
    lib = load_kernels()
    (m, n), nn = z1.shape, z3.shape[0]
    rows, others = (m, nn) if which == "dz1" else (nn, m)
    out = torch.empty((rows, n), device=z1.device, dtype=torch.float32)
    chunk, part = grad_scratch(rows, others, n,
                               _grad_slots(z1.device.index, which, n, _pmode(p)),
                               z1.device)
    fn = lib.clica_neg_lse_dz1 if which == "dz1" else lib.clica_neg_lse_dz3
    with torch.cuda.device(z1.device):
        rc = fn(z1.data_ptr(), z3.data_ptr(), lse.data_ptr(), ct.data_ptr(),
                out.data_ptr(), _ptr(part), chunk, m, nn, n, _pmode(p), p, tau,
                _stream(z1))
    _check_launch(lib, rc, f"neg_lse {which}")
    _launches[which] += 1  # the gradient kernel and its reduce kernel
    return out


class _FusedNegLse(torch.autograd.Function):
    """lse = fused_neg_lse(z1, z3, p, τ); p and τ are not differentiable
    (the JAX custom_vjp's nondiff_argnums)."""

    @staticmethod
    def forward(ctx, z1, z3, p, tau):
        lse = _launch_fwd(z1, z3, p, tau)
        ctx.save_for_backward(z1, z3, lse)
        ctx.p, ctx.tau = p, tau
        return lse

    @staticmethod
    def backward(ctx, grad_lse):
        z1, z3, lse = ctx.saved_tensors
        ct = grad_lse.contiguous().float()  # the per-row c_i
        dz1 = dz3 = None
        if ctx.needs_input_grad[0]:
            dz1 = _launch_bwd("dz1", z1, z3, lse, ct, ctx.p, ctx.tau)
        if ctx.needs_input_grad[1]:
            dz3 = _launch_bwd("dz3", z1, z3, lse, ct, ctx.p, ctx.tau)
        return dz1, dz3, None, None


def fused_neg_lse(z1: torch.Tensor, z3: torch.Tensor, p: float,
                  tau: float) -> torch.Tensor:
    """lse_i = log Σ_j exp(-||z1_i - z3_j||_p^p / τ), shape (M,).

    z1 (M, n) and z3 (N, n), M and N independent, p ≥ 1, n ≤ 64. CUDA
    tensors run the Hopper kernels (forward here, dz1/dz3 in backward);
    CPU tensors run ``neg_lse_reference``. Anything else raises.
    """
    p, tau = float(p), float(tau)
    if z1.device.type == "cpu" and z3.device.type == "cpu":
        return neg_lse_reference(z1, z3, p, tau)
    if p < 1.0:
        raise ValueError(f"the fused kernel takes p >= 1, got p={p}")
    _check_pair(z1, z3)
    return _FusedNegLse.apply(z1, z3, p, tau)
