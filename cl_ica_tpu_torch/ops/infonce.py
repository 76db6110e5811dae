"""Fused Lp-InfoNCE negative log-sum-exp: Hopper kernels and their plain
PyTorch version.

Port of cl_ica_tpu/ops/infonce_pallas.py:194-307 (``fused_neg_lse``):

    lse_i = log Σ_j exp(-Σ_k |z1_ik - z3_jk|^p / τ),   z1 (M, n), z3 (N, n)

for p ≥ 1, without the M×N matrix ever reaching device memory. The
forward and both backward kernels are CUDA C++ in csrc/infonce_lp.cu
(see the note there for what bounds them and how they differ from the
TPU kernels); this module binds them, wraps them in a
``torch.autograd.Function`` and launches them through ops/runtime.py,
which builds the library and counts the launches. Where
the library has a tiled kernel for the arguments (it says which, through
``clica_neg_lse_{fwd,grad}_blocks_per_sm``), the other operand's rows go
in chunks (``split_plan``) and the wrapper allocates the chunks' partials.

On CPU tensors ``fused_neg_lse`` computes ``neg_lse_reference``, the
plain version, because there is no kernel to launch there. On CUDA
tensors it launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import runtime
from .runtime import FLOAT, INT, PTR

LIBRARY = "infonce_lp"
MAX_FEATURES = 64  # the kernels' template bound on n
MIN_CHUNK = 64  # the fewest rows of the other operand a tiled gradient block takes


def neg_lse_reference(z1: torch.Tensor, z3: torch.Tensor, p: float,
                      tau: float) -> torch.Tensor:
    """The plain version: the (M, N) distances by explicit broadcast
    Σ_k |z1_ik - z3_jk|^p (not ``torch.cdist``, which may take a matmul
    path), then ``torch.logsumexp``. Autograd supplies the gradient."""
    diff = torch.abs(z1[:, None, :] - z3[None, :, :])
    d = diff.sum(-1) if p == 1.0 else (diff ** p).sum(-1)
    return torch.logsumexp(-d / tau, dim=1)


def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return runtime.library(LIBRARY, declare)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of a library built
    from csrc/infonce_lp.cu."""
    lib.clica_neg_lse_fwd.argtypes = [PTR] * 5 + [INT] * 5 + [FLOAT, FLOAT, PTR]
    lib.clica_neg_lse_fwd.restype = INT
    lib.clica_neg_lse_fwd_block_rows.argtypes = []
    lib.clica_neg_lse_fwd_block_rows.restype = INT
    lib.clica_neg_lse_fwd_blocks_per_sm.argtypes = [INT, INT, ctypes.POINTER(INT)]
    lib.clica_neg_lse_fwd_blocks_per_sm.restype = INT
    for fn in (lib.clica_neg_lse_dz1, lib.clica_neg_lse_dz3):
        fn.argtypes = [PTR] * 6 + [INT] * 5 + [FLOAT, FLOAT, PTR]
        fn.restype = INT
    lib.clica_neg_lse_grad_block_rows.argtypes = []
    lib.clica_neg_lse_grad_block_rows.restype = INT
    lib.clica_neg_lse_grad_blocks_per_sm.argtypes = [INT, INT, INT,
                                                     ctypes.POINTER(INT)]
    lib.clica_neg_lse_grad_blocks_per_sm.restype = INT
    return lib


def _pmode(p: float) -> int:
    return 1 if p == 1.0 else 2 if p == 2.0 else 0


def _check_operand(name: str, t: torch.Tensor, n: int | None = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if n is not None and (t.ndim != 2 or t.shape[1] != n):
        raise ValueError(f"{name} must be (rows, {n}), got {tuple(t.shape)}")


def check_pair(z1: torch.Tensor, z3: torch.Tensor) -> None:
    """What every loss kernel asks of its two operands (ops/infonce.py and
    ops/infonce_dot.py): z1 (M, n) and z3 (N, n), float32, contiguous, on
    one CUDA device, M, N ≥ 1, 1 ≤ n ≤ MAX_FEATURES."""
    if z1.ndim != 2 or not 1 <= z1.shape[1] <= MAX_FEATURES:
        raise ValueError(
            f"z1 must be (M, n) with 1 <= n <= {MAX_FEATURES}, got {tuple(z1.shape)}")
    if z1.shape[0] < 1 or z3.shape[0] < 1:
        raise ValueError("z1 and z3 need at least one row each")
    _check_operand("z1", z1)
    _check_operand("z3", z3, z1.shape[1])
    if z3.device != z1.device:
        raise ValueError(f"z1 is on {z1.device}, z3 on {z3.device}")


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
    tiled kernel (``clica_<kernel>_blocks_per_sm(*args, &blocks)``, through
    ``runtime.resident_blocks``, and ``clica_<kernel>_block_rows()``), or
    None where the library has no tiled kernel for these arguments (the
    first version runs, in one chunk)."""
    slots = runtime.resident_blocks(lib, kernel, device_index, *args)
    if slots == 0:
        return None
    return getattr(lib, f"clica_{kernel}_block_rows")(), slots


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


def _launch_fwd(z1, z3, p: float, tau: float) -> torch.Tensor:
    lib = load_kernels()
    (m, n), nn = z1.shape, z3.shape[0]
    lse = torch.empty(m, device=z1.device, dtype=torch.float32)
    tiled = tiled_slots(lib, "neg_lse_fwd", z1.device.index, n, _pmode(p))
    chunk, part_m, part_s = lse_scratch(m, nn, tiled, z1.device)
    # one count for the forward kernel and its reduce kernel
    runtime.launch(lib, "neg_lse_fwd", z1.device, z1.data_ptr(), z3.data_ptr(),
                   lse.data_ptr(), runtime.ptr(part_m), runtime.ptr(part_s),
                   chunk, m, nn, n, _pmode(p), p, tau, count="fwd")
    return lse


def _launch_bwd(which: str, z1, z3, lse, ct, p: float, tau: float):
    lib = load_kernels()
    (m, n), nn = z1.shape, z3.shape[0]
    rows, others = (m, nn) if which == "dz1" else (nn, m)
    out = torch.empty((rows, n), device=z1.device, dtype=torch.float32)
    tiled = tiled_slots(lib, "neg_lse_grad", z1.device.index,
                        int(which == "dz3"), n, _pmode(p))
    chunk, part = grad_scratch(rows, others, n, tiled, z1.device)
    # one count for the gradient kernel and its reduce kernel
    runtime.launch(lib, f"neg_lse_{which}", z1.device, z1.data_ptr(),
                   z3.data_ptr(), lse.data_ptr(), ct.data_ptr(), out.data_ptr(),
                   runtime.ptr(part), chunk, m, nn, n, _pmode(p), p, tau,
                   count=which)
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
    check_pair(z1, z3)
    return _FusedNegLse.apply(z1, z3, p, tau)
