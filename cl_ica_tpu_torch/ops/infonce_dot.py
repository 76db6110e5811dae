"""Fused dot-product (SimCLR) InfoNCE log-sum-exp: Hopper kernels and
their plain PyTorch version.

Port of cl_ica_tpu/ops/infonce_pallas.py:310-492 (``fused_dot_lse``):

    lse_i = log Σ_j exp(z1_i · z3_j / τ),   z1 (M, n), z3 (N, n)

without the M×N matrix of logits ever reaching device memory. The forward
and both backward kernels are CUDA C++ in csrc/infonce_dot.cu (see the
note there for what bounds them and how they differ from the TPU
kernels); the three products z1 z3ᵀ, W z3 and Wᵀ z1 are computed inside
those kernels. This module binds them, wraps them in a
``torch.autograd.Function`` and launches them through ops/runtime.py,
which counts them beside ``fused_neg_lse``'s (``ops.launch_counts``).
Each kernel takes the other
operand's rows in chunks where the library has a tiled kernel for n (it
says which, ``clica_dot_lse_{fwd,grad}_blocks_per_sm``), with the same
plan as ``fused_neg_lse``'s (``ops.infonce.split_plan``).

On CPU tensors ``fused_dot_lse`` computes ``dot_lse_reference``, the
plain version, because there is no kernel to launch there. On CUDA
tensors it launches the kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import runtime
from .infonce import check_pair, grad_scratch, lse_scratch, tiled_slots
from .runtime import FLOAT, INT, PTR

LIBRARY = "infonce_dot"


def dot_lse_reference(z1: torch.Tensor, z3: torch.Tensor,
                      tau: float) -> torch.Tensor:
    """The plain version: the (M, N) logits by explicit broadcast
    Σ_k z1_ik·z3_jk (not ``@``, so that it repeats the kernel's float32
    arithmetic and cannot take a TF32 path), then ``torch.logsumexp``.
    Autograd supplies the gradient."""
    x = (z1[:, None, :] * z3[None, :, :]).sum(-1) / tau
    return torch.logsumexp(x, dim=1)


def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return runtime.library(LIBRARY, declare)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of a library built
    from csrc/infonce_dot.cu."""
    lib.clica_dot_lse_fwd.argtypes = [PTR] * 5 + [INT] * 4 + [FLOAT, PTR]
    lib.clica_dot_lse_fwd.restype = INT
    lib.clica_dot_lse_fwd_block_rows.argtypes = []
    lib.clica_dot_lse_fwd_block_rows.restype = INT
    lib.clica_dot_lse_fwd_blocks_per_sm.argtypes = [INT, ctypes.POINTER(INT)]
    lib.clica_dot_lse_fwd_blocks_per_sm.restype = INT
    for fn in (lib.clica_dot_lse_dz1, lib.clica_dot_lse_dz3):
        fn.argtypes = [PTR] * 6 + [INT] * 4 + [FLOAT, PTR]
        fn.restype = INT
    lib.clica_dot_lse_grad_block_rows.argtypes = []
    lib.clica_dot_lse_grad_block_rows.restype = INT
    lib.clica_dot_lse_grad_blocks_per_sm.argtypes = [INT, INT, ctypes.POINTER(INT)]
    lib.clica_dot_lse_grad_blocks_per_sm.restype = INT
    return lib


def _launch_fwd(z1, z3, tau: float) -> torch.Tensor:
    lib = load_kernels()
    (m, n), nn = z1.shape, z3.shape[0]
    lse = torch.empty(m, device=z1.device, dtype=torch.float32)
    tiled = tiled_slots(lib, "dot_lse_fwd", z1.device.index, n)
    chunk, part_m, part_s = lse_scratch(m, nn, tiled, z1.device)
    # one count for the forward kernel and its reduce kernel
    runtime.launch(lib, "dot_lse_fwd", z1.device, z1.data_ptr(), z3.data_ptr(),
                   lse.data_ptr(), runtime.ptr(part_m), runtime.ptr(part_s),
                   chunk, m, nn, n, tau, count="dot_fwd")
    return lse


def _launch_bwd(which: str, z1, z3, lse, ct, tau: float) -> torch.Tensor:
    lib = load_kernels()
    (m, n), nn = z1.shape, z3.shape[0]
    rows, others = (m, nn) if which == "dz1" else (nn, m)
    out = torch.empty((rows, n), device=z1.device, dtype=torch.float32)
    tiled = tiled_slots(lib, "dot_lse_grad", z1.device.index,
                        int(which == "dz3"), n)
    chunk, part = grad_scratch(rows, others, n, tiled, z1.device)
    # one count for the gradient kernel and its reduce kernel
    runtime.launch(lib, f"dot_lse_{which}", z1.device, z1.data_ptr(),
                   z3.data_ptr(), lse.data_ptr(), ct.data_ptr(), out.data_ptr(),
                   runtime.ptr(part), chunk, m, nn, n, tau, count=f"dot_{which}")
    return out


class _FusedDotLse(torch.autograd.Function):
    """lse = fused_dot_lse(z1, z3, τ); τ is not differentiable (the JAX
    custom_vjp's nondiff_argnums)."""

    @staticmethod
    def forward(ctx, z1, z3, tau):
        lse = _launch_fwd(z1, z3, tau)
        ctx.save_for_backward(z1, z3, lse)
        ctx.tau = tau
        return lse

    @staticmethod
    def backward(ctx, grad_lse):
        z1, z3, lse = ctx.saved_tensors
        ct = grad_lse.contiguous().float()  # the per-row c_i
        dz1 = dz3 = None
        if ctx.needs_input_grad[0]:
            dz1 = _launch_bwd("dz1", z1, z3, lse, ct, ctx.tau)
        if ctx.needs_input_grad[1]:
            dz3 = _launch_bwd("dz3", z1, z3, lse, ct, ctx.tau)
        return dz1, dz3, None


def fused_dot_lse(z1: torch.Tensor, z3: torch.Tensor,
                  tau: float) -> torch.Tensor:
    """lse_i = log Σ_j exp(z1_i · z3_j / τ), shape (M,).

    z1 (M, n) and z3 (N, n), M and N independent, n ≤ 64, logits of any
    sign and size. CUDA tensors run the Hopper kernels (forward here,
    dz1/dz3 in backward); CPU tensors run ``dot_lse_reference``. Anything
    else raises.
    """
    tau = float(tau)
    if z1.device.type == "cpu" and z3.device.type == "cpu":
        return dot_lse_reference(z1, z3, tau)
    if not tau > 0.0:
        raise ValueError(f"tau must be positive, got {tau}")
    check_pair(z1, z3)
    return _FusedDotLse.apply(z1, z3, tau)
