"""Glob-a-folder image access, for the mean/std tool.

Port of cl_ica_tpu/data/simple_image_dataset.py (numpy; PIL is imported
where images are read)."""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np


class SimpleImageDataset:
    """All images matching root/*.{png,jpg,jpeg}, sorted within each
    extension, in EXTENSIONS' order."""

    EXTENSIONS = ("png", "jpg", "jpeg")

    def __init__(self, root: str):
        self.root = root
        self.paths = sorted(
            p
            for ext in self.EXTENSIONS
            for p in glob.glob(os.path.join(root, f"*.{ext}"))
        )
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.paths)

    def batch(self, indices: Sequence[int]) -> np.ndarray:
        """uint8 (len(indices), H, W, 3) RGB images."""
        from PIL import Image

        out = []
        for i in indices:
            with Image.open(self.paths[int(i)]) as im:
                out.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
        return np.stack(out)
