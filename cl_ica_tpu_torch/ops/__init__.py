"""Hand-written Hopper kernels with their plain PyTorch versions.

ops/infonce.py     ← cl_ica_tpu/ops/infonce_pallas.py (fused_neg_lse)
ops/infonce_dot.py ← cl_ica_tpu/ops/infonce_pallas.py (fused_dot_lse)

The CUDA sources are in ops/csrc and are built at first use by
ops/build.py, one library per .cu file. ``launch_counts`` returns the
launches of all six kernels.
"""

from .infonce import (
    fused_neg_lse,
    launch_counts,
    neg_lse_reference,
    reset_launch_counts,
)
from .infonce_dot import dot_lse_reference, fused_dot_lse

__all__ = [
    "dot_lse_reference",
    "fused_dot_lse",
    "fused_neg_lse",
    "launch_counts",
    "neg_lse_reference",
    "reset_launch_counts",
]
