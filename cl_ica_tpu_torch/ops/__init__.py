"""Hand-written Hopper kernels with their plain PyTorch versions.

ops/infonce.py     ← cl_ica_tpu/ops/infonce_pallas.py (fused_neg_lse)
ops/infonce_dot.py ← cl_ica_tpu/ops/infonce_pallas.py (fused_dot_lse)
ops/stem.py        ← cl_ica_tpu/ops/stem_pallas.py (bn_relu_pool_train)
ops/bn_minres.py   ← cl_ica_tpu/ops/bn_minres.py (bn_relu, bn_add_relu,
                     bn_only; XLA passes there, four kernels here)
ops/knn.py         ← cl_ica_tpu/ops/knn.py (l2_topk; no kernel)

The CUDA sources are in ops/csrc and are built at first use by
ops/build.py, one library per .cu file. ``launch_counts`` returns the
launches of all thirteen kernels, and ``bn_junctions``, the add-relu
backward launches that took two upstream gradients; a replayed CUDA graph
adds its launches with ``add_launch_counts``.
"""

from .bn_minres import bn_add_relu, bn_only, bn_relu
from .infonce import (
    add_launch_counts,
    fused_neg_lse,
    launch_counts,
    neg_lse_reference,
    reset_launch_counts,
)
from .infonce_dot import dot_lse_reference, fused_dot_lse
from .knn import l2_topk
from .stem import (
    bn_relu_pool_reference,
    bn_relu_pool_train,
    stem_bwd_reference,
    stem_dx_reference,
    stem_fwd_reference,
)

__all__ = [
    "add_launch_counts",
    "bn_add_relu",
    "bn_only",
    "bn_relu",
    "bn_relu_pool_reference",
    "bn_relu_pool_train",
    "dot_lse_reference",
    "fused_dot_lse",
    "fused_neg_lse",
    "l2_topk",
    "launch_counts",
    "neg_lse_reference",
    "reset_launch_counts",
    "stem_bwd_reference",
    "stem_dx_reference",
    "stem_fwd_reference",
]
