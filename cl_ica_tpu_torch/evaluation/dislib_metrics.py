"""Additional disentanglement_lib-style metrics: MIG and SAP.

The port's own copy of cl_ica_tpu/evaluation/dislib_metrics.py. Two
standard metrics for discrete-factor datasets, following the dis-lib
definitions:

  MIG (Mutual Information Gap): mean over factors of the normalized gap
      between the two largest mutual informations I(z_j; y_k), with
      latents discretized into bins.
  SAP (Separated Attribute Predictability): mean over factors of the gap
      between the two largest per-latent R² scores.

Conventions match the dis-lib protocol used elsewhere here:
(rep_dim, num_samples) / (factor_dim, num_samples) arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _discretize(x: np.ndarray, bins: int) -> np.ndarray:
    out = np.zeros_like(x, dtype=np.int32)
    for i in range(x.shape[0]):
        out[i] = np.digitize(x[i], np.histogram(x[i], bins)[1][:-1])
    return out


def _discrete_mutual_info(z: np.ndarray, y: np.ndarray) -> np.ndarray:
    from sklearn.metrics import mutual_info_score

    m = np.zeros((z.shape[0], y.shape[0]))
    for i in range(z.shape[0]):
        for j in range(y.shape[0]):
            m[i, j] = mutual_info_score(y[j], z[i])
    return m


def _discrete_entropy(y: np.ndarray) -> np.ndarray:
    from sklearn.metrics import mutual_info_score

    return np.array([mutual_info_score(y[j], y[j]) for j in range(y.shape[0])])


def compute_mig(
    mus: np.ndarray, ys: np.ndarray, bins: int = 20
) -> Dict[str, float]:
    """Mutual Information Gap over discretized latents."""
    z = _discretize(mus, bins)
    y = ys if np.issubdtype(ys.dtype, np.integer) else _discretize(ys, bins)
    mi = _discrete_mutual_info(z, y)  # (rep, factor)
    entropy = _discrete_entropy(y)
    sorted_mi = np.sort(mi, axis=0)[::-1]
    gaps = (sorted_mi[0] - sorted_mi[1]) / np.maximum(entropy, 1e-12)
    return {"discrete_mig": float(np.mean(gaps))}


def compute_sap(mus: np.ndarray, ys: np.ndarray) -> Dict[str, float]:
    """SAP with the continuous-factor linear-R² score matrix."""
    rep, fac = mus.shape[0], ys.shape[0]
    score = np.zeros((rep, fac))
    for i in range(rep):
        zi = mus[i]
        vz = zi.var()
        for j in range(fac):
            yj = ys[j]
            cov = np.cov(zi, yj, ddof=0)
            vy = cov[1, 1]
            if vz * vy > 1e-12:
                score[i, j] = cov[0, 1] ** 2 / (vz * vy)
    sorted_scores = np.sort(score, axis=0)[::-1]
    return {"sap_score": float(np.mean(sorted_scores[0] - sorted_scores[1]))}
