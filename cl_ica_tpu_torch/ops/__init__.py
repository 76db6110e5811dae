"""Hand-written Hopper kernels with their plain PyTorch versions.

ops/infonce.py ← cl_ica_tpu/ops/infonce_pallas.py (fused_neg_lse);
the CUDA sources are in ops/csrc and are built at first use by ops/build.py.
"""

from .infonce import (
    fused_neg_lse,
    launch_counts,
    neg_lse_reference,
    reset_launch_counts,
)

__all__ = [
    "fused_neg_lse",
    "launch_counts",
    "neg_lse_reference",
    "reset_launch_counts",
]
