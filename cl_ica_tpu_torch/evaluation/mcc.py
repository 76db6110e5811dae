"""Hyvärinen-Morioka-style MCC metric (dis-lib protocol, gin/TF1-free).

The port's own copy of cl_ica_tpu/evaluation/mcc.py: plain numpy with
the dis-lib row-major (dim × samples) convention and noise-row padding.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .munkres import Munkres
from .disentanglement import _spearmanr


def correlation(x: np.ndarray, y: np.ndarray, method: str = "Pearson"):
    """Hungarian-sort rows of x to best match y, then re-correlate
    (metric.py:11-55). x, y are (dim, num_samples).

    Returns (corr_sort, sort_idx, x_sort).
    """
    x = np.array(x, copy=True)
    y = np.array(y, copy=True)
    dim = x.shape[0]

    if method == "Pearson":
        corr = np.corrcoef(y, x)[0:dim, dim:]
    elif method == "Spearman":
        corr, _ = _spearmanr(y.T, x.T)
        corr = corr[0:dim, dim:]
    else:
        raise ValueError(method)

    munk = Munkres()
    indexes = munk.compute(-np.absolute(corr))

    sort_idx = np.zeros(dim)
    x_sort = np.zeros(x.shape)
    for i in range(dim):
        sort_idx[i] = indexes[i][1]
        x_sort[i, :] = x[indexes[i][1], :]

    if method == "Pearson":
        corr_sort = np.corrcoef(y, x_sort)[0:dim, dim:]
    else:
        corr_sort, _ = _spearmanr(y.T, x_sort.T)
        corr_sort = corr_sort[0:dim, dim:]

    return corr_sort, sort_idx, x_sort


def compute_mcc(
    mus_train: np.ndarray,
    ys_train: np.ndarray,
    correlation_fn: str = "Pearson",
    random_state: Optional[np.random.RandomState] = None,
) -> Dict[str, float]:
    """MCC score dict from representation codes and ground-truth factors.

    mus_train: (rep_dim, num_samples) representations.
    ys_train:  (factor_dim, num_samples) ground-truth factors.
    Extra representation dims are padded with N(0,1) noise rows before the
    assignment, and the score averages |diag| over the true-factor rows
    only (metric.py:99-111).
    """
    random_state = random_state or np.random.RandomState(0)
    score_dict: Dict[str, float] = {}
    result = np.zeros(mus_train.shape)
    result[: ys_train.shape[0], : ys_train.shape[1]] = ys_train
    for i in range(len(mus_train) - len(ys_train)):
        result[ys_train.shape[0] + i, :] = random_state.normal(size=ys_train.shape[1])

    corr_sorted, sort_idx, _ = correlation(mus_train, result, method=correlation_fn)
    score_dict["meanabscorr"] = float(
        np.mean(np.abs(np.diag(corr_sorted)[: len(ys_train)]))
    )
    for i in range(len(corr_sorted)):
        for j in range(len(corr_sorted[0])):
            score_dict[f"corr_sorted_{i}{j}"] = float(corr_sorted[i][j])
    for i in range(len(sort_idx)):
        score_dict[f"sort_idx_{i}"] = float(sort_idx[i])
    return score_dict
