"""The 3DIdent pair data, plain, from the data set's raw files.

A training pair: z ~ the latent space, z̃ ~ its conditional around z; z is
matched to its nearest rendered latent and z̃ to its nearest one other than
z's (Zimmermann et al., ICML 2021, §5.2). Images are the uint8 renders of
the matched rows, normalised by the data set's channel mean and standard
deviation, as (B, 3, H, W).
"""

from __future__ import annotations

import os

import numpy as np
import torch

MEAN = (0.3292, 0.3278, 0.3215)
STD = (0.0778, 0.0776, 0.0771)
# a float32 squared distance |q|² − 2q·t + |t|² of latents of norm ≤ 2 is
# off by a few 1e-7: a match within this of the nearest is a tie
TIE = 1e-5


def table(root: str) -> np.ndarray:
    return np.load(os.path.join(root, "raw_latents.npy"))


def store(root: str) -> np.ndarray:
    """The packed renders (N, H, W, 3), read where they lie."""
    name = [f for f in os.listdir(root) if f.startswith("images_packed_")
            and f.endswith(".u8")][0]
    return np.load(os.path.join(root, name), mmap_mode="r")


def images(packed: np.ndarray, idx, device) -> torch.Tensor:
    """Normalised float32 renders of rows ``idx``, (B, 3, H, W)."""
    rows = np.sort(np.unique(np.asarray(idx)))
    pos = np.searchsorted(rows, np.asarray(idx))
    x = torch.from_numpy(np.asarray(packed[rows])[pos]).to(device)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    x = (x.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2)


def nn_misses(tab: torch.Tensor, q: torch.Tensor, idx: torch.Tensor,
              exclude: torch.Tensor = None) -> int:
    """Rows whose chosen table row ``idx`` is not a nearest one to the query
    (within TIE), in float64; with ``exclude``, nearest among the rows other
    than ``exclude`` (and never ``exclude`` itself)."""
    tab, q = tab.double(), q.double()
    d = (q * q).sum(1)[:, None] - 2.0 * q @ tab.T + (tab * tab).sum(1)[None, :]
    if exclude is not None:
        d[torch.arange(len(q), device=q.device), exclude] = float("inf")
    chosen = d.gather(1, idx[:, None].long())[:, 0]
    return int((chosen > d.min(1).values + TIE).sum())


def outside_box(z: torch.Tensor, lo: float, hi: float, tol: float = 1e-6) -> int:
    return int(((z < lo - tol) | (z > hi + tol)).any(1).sum())


def off_sphere(z: torch.Tensor, r: float = 1.0, tol: float = 1e-5) -> int:
    return int(((torch.linalg.norm(z.double(), dim=1) - r).abs() > tol).sum())
