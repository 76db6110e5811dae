"""Data pipelines of the port.

threedident    ← cl_ica_tpu/data/threedident.py
kitti          ← cl_ica_tpu/data/kitti.py
kitti_analysis ← cl_ica_tpu/data/kitti_analysis.py (numpy + scipy; pandas,
                 scikit-learn and matplotlib imported where used)
infinite_iterator, simple_image_dataset ← the same names there (PIL
                 imported where images are read)
"""

from .infinite_iterator import InfiniteIterator

from .kitti import (
    KittiDeviceSampler,
    KittiMasks,
    augment_mask_pairs,
    augment_mask_pairs_fast,
    interleave_pairs,
    return_data,
)
from .simple_image_dataset import SimpleImageDataset
from .threedident import (
    BUDGET_ENV,
    THREEDIDENT_MEAN,
    THREEDIDENT_STD,
    PackedImageStore,
    PrefetchingPairLoader,
    SequentialThreeDIdent,
    ThreeDIdentBatchSampler,
    normalize_3dident,
    pack_images,
)

__all__ = [
    "InfiniteIterator",
    "SimpleImageDataset",
    "KittiDeviceSampler",
    "KittiMasks",
    "augment_mask_pairs",
    "augment_mask_pairs_fast",
    "interleave_pairs",
    "return_data",
    "BUDGET_ENV",
    "THREEDIDENT_MEAN",
    "THREEDIDENT_STD",
    "PackedImageStore",
    "PrefetchingPairLoader",
    "SequentialThreeDIdent",
    "ThreeDIdentBatchSampler",
    "normalize_3dident",
    "pack_images",
]
