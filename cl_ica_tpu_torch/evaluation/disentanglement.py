"""Disentanglement scores: linear R² and permutation MCC.

The port's own copy of cl_ica_tpu/evaluation/disentanglement.py. The fit
is a closed-form least squares and the correlations are numpy; the
Hungarian step uses .munkres.

All functions accept anything ``np.asarray`` takes; computation is
host-side numpy (evaluation time, n≈10).
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from .munkres import Munkres


def _spearmanr(a, b):
    # scipy.stats takes seconds to import: only where a rank correlation is
    # asked for, not in every process that imports the package
    import scipy.stats

    return scipy.stats.spearmanr(a, b)


def _to_numpy(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Coefficient of determination, sklearn-compatible default
    (multioutput='uniform_average')."""
    y_true = _to_numpy(y_true)
    y_pred = _to_numpy(y_pred)
    ss_res = np.sum((y_true - y_pred) ** 2, axis=0)
    ss_tot = np.sum((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = 1.0 - ss_res / ss_tot
    r2 = np.where(ss_tot == 0, np.where(ss_res == 0, 1.0, 0.0), r2)
    return float(np.mean(r2))


def _disentanglement(z, hz, mode: str = "r2", reorder: Optional[bool] = None):
    """Core score (disentanglement_utils.py:17-60). reorder=True runs the
    Hungarian assignment on -|corr| — i.e. MCC."""
    assert mode in ("r2", "adjusted_r2", "pearson", "spearman")

    if mode == "r2":
        return r2_score(z, hz), None
    elif mode == "adjusted_r2":
        r2 = r2_score(z, hz)
        n, p = z.shape[0], z.shape[1]
        return 1.0 - (1.0 - r2) * (n - 1) / (n - p - 1), None

    dim = z.shape[-1]
    if mode == "spearman":
        raw_corr, _ = _spearmanr(z, hz)
    else:
        raw_corr = np.corrcoef(z.T, hz.T)
    corr = raw_corr[:dim, dim:]

    if reorder:
        munk = Munkres()
        indexes = munk.compute(-np.absolute(corr))
        hz_sort = np.zeros(z.shape)
        for i in range(dim):
            hz_sort[:, i] = hz[:, indexes[i][1]]
        if mode == "spearman":
            raw_corr, _ = _spearmanr(z, hz_sort)
        else:
            raw_corr = np.corrcoef(z.T, hz_sort.T)
        corr = raw_corr[:dim, dim:]

    return float(np.diag(np.abs(corr)).mean()), corr


def _linear_fit_predict(hz_train, z_train, hz_test):
    """Closed-form multi-output least squares with intercept — replaces
    sklearn.linear_model.LinearRegression (disentanglement_utils.py:95-98)."""
    x = np.concatenate([hz_train, np.ones((hz_train.shape[0], 1))], axis=1)
    beta, *_ = np.linalg.lstsq(x, z_train, rcond=None)
    xt = np.concatenate([hz_test, np.ones((hz_test.shape[0], 1))], axis=1)
    return xt @ beta


def linear_disentanglement(z, hz, mode: str = "r2", train_test_split: bool = False):
    """Disentanglement up to linear maps (disentanglement_utils.py:63-102)."""
    z = _to_numpy(z)
    hz = _to_numpy(hz)

    if train_test_split:
        n_train = len(z) // 2
        z_1, hz_1 = z[:n_train], hz[:n_train]
        z_2, hz_2 = z[n_train:], hz[n_train:]
    else:
        z_1, hz_1, z_2, hz_2 = z, hz, z, hz

    hz_pred = _linear_fit_predict(hz_1, z_1, hz_2)
    inner_result = _disentanglement(z_2, hz_pred, mode=mode, reorder=False)
    return inner_result, (z_2, hz_pred)


def _gen_permutations(n: int, sign_flips: bool):
    """All n×n permutation matrices, optionally with per-row sign flips
    (disentanglement_utils.py:163-198)."""
    signs = (1.0, -1.0) if sign_flips else (1.0,)
    for perm in itertools.permutations(range(n)):
        for sgn in itertools.product(signs, repeat=n):
            t = np.zeros((n, n))
            for row, (col, s) in enumerate(zip(perm, sgn)):
                t[row, col] = s
            yield t


def permutation_disentanglement(
    z,
    hz,
    mode: str = "r2",
    rescaling: bool = True,
    solver: str = "naive",
    sign_flips: bool = True,
    cache_permutations=None,
):
    """Disentanglement up to permutation — MCC when solver='munkres' and
    mode='pearson' (disentanglement_utils.py:105-221)."""
    assert solver in ("naive", "munkres")
    if mode in ("r2", "adjusted_r2"):
        assert solver == "naive", "R2 is only supported with the naive solver"

    z = _to_numpy(z)
    hz = _to_numpy(hz)

    def test_transformation(t, reorder):
        thz = hz @ t
        if rescaling:
            assert z.shape == hz.shape
            # per-dim least-squares diagonal rescale β_j = Σ z_j·hz_j / Σ hz_j²
            beta = np.diag((z * hz).sum(0) / (hz**2).sum(0))
            thz = hz @ beta
        return _disentanglement(z, thz, mode=mode, reorder=reorder), thz

    n = z.shape[-1]
    if solver == "naive":
        if cache_permutations:
            if not hasattr(permutation_disentanglement, "permutation_matrices"):
                permutation_disentanglement.permutation_matrices = {}
            cache = permutation_disentanglement.permutation_matrices
            key = (rescaling, n, sign_flips)
            if key not in cache:
                cache[key] = list(_gen_permutations(n, sign_flips))
            permutations = cache[key]
        else:
            permutations = list(_gen_permutations(n, sign_flips))
    else:
        permutations = [np.eye(n, dtype=z.dtype)]

    scores = [test_transformation(t, solver == "munkres") for t in permutations]
    return max(scores, key=lambda x: x[0][0])
