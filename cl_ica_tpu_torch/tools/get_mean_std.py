"""Compute the per-channel mean/std of an image folder.

Port of cl_ica_tpu/tools/get_mean_std.py (numpy): the normalisation
constants data/threedident.py holds for the published 3DIdent renders
(mean [0.3292, 0.3278, 0.3215], std [0.0778, 0.0776, 0.0771]). Streaming
accumulation over batches in float64 (Chan et al.'s merge of the batch's
mean and variance into the running ones).

Usage: python -m cl_ica_tpu_torch.tools.get_mean_std --folder DIR [--batch 256]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.simple_image_dataset import SimpleImageDataset


def compute_mean_std(folder: str, batch: int = 256):
    """(mean, std) of every pixel's RGB in [0, 1], float64 (3,) each."""
    ds = SimpleImageDataset(folder)
    count = 0
    mean = np.zeros(3, dtype=np.float64)
    m2 = np.zeros(3, dtype=np.float64)
    for start in range(0, len(ds), batch):
        imgs = ds.batch(range(start, min(start + batch, len(ds))))
        x = imgs.astype(np.float64).reshape(-1, 3) / 255.0
        n_new = x.shape[0]
        delta = x.mean(0) - mean
        new_count = count + n_new
        mean += delta * n_new / new_count
        m2 += x.var(0) * n_new + delta**2 * count * n_new / new_count
        count = new_count
    std = np.sqrt(m2 / count)
    return mean, std


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--folder", required=True, type=str)
    parser.add_argument("--batch", default=256, type=int)
    args = parser.parse_args(argv)
    mean, std = compute_mean_std(args.folder, args.batch)
    print("mean:", np.round(mean, 4))
    print("std:", np.round(std, 4))


if __name__ == "__main__":
    main()
