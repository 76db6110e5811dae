"""Data pipelines of the port.

threedident ← cl_ica_tpu/data/threedident.py
"""

from .threedident import (
    BUDGET_ENV,
    THREEDIDENT_MEAN,
    THREEDIDENT_STD,
    PackedImageStore,
    SequentialThreeDIdent,
    StoreOverBudget,
    ThreeDIdentBatchSampler,
    normalize_3dident,
    pack_images,
)

__all__ = [
    "BUDGET_ENV",
    "THREEDIDENT_MEAN",
    "THREEDIDENT_STD",
    "PackedImageStore",
    "SequentialThreeDIdent",
    "StoreOverBudget",
    "ThreeDIdentBatchSampler",
    "normalize_3dident",
    "pack_images",
]
