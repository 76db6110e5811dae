"""Offline statistical analysis of KITTI latent transitions.

The port's own copy of cl_ica_tpu/data/kitti_analysis.py (reference
kitti_masks/data_analysis_utils.py): the analysis that justifies the
Laplace-transition assumption, and hence p=1 in the KITTI LpSimCLR loss.
It fits candidate distributions (generalized normal, normal, Laplace) to
per-factor latent deltas, scores them with KS tests and kurtosis, and
estimates pairwise mutual information between factors. numpy and scipy
are imported at the top; pandas, scikit-learn and matplotlib only inside
the functions that use them. Not on the training path.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import scipy.stats as sps


CANDIDATES = {
    "gennorm": sps.gennorm,
    "norm": sps.norm,
    "laplace": sps.laplace,
}


def latent_deltas(dataset, max_delta_t: int = 1) -> np.ndarray:
    """Collect z_{t+dt} - z_t for all in-sequence pairs. dataset is
    data.kitti.KittiMasks; returns (N, 3)."""
    deltas = []
    for lat_seq in dataset.latents:
        lat_seq = np.asarray(lat_seq)
        for dt in range(1, max_delta_t + 1):
            if len(lat_seq) > dt:
                deltas.append(lat_seq[dt:] - lat_seq[:-dt])
    return np.concatenate(deltas, axis=0)


def fit_transition_distributions(deltas: np.ndarray) -> List[Dict]:
    """Per-factor candidate fits with KS statistics and excess kurtosis
    (data_analysis_utils.py:134-220)."""
    rows = []
    for dim in range(deltas.shape[1]):
        x = deltas[:, dim]
        x = (x - x.mean()) / (x.std() + 1e-12)
        row = {
            "dim": dim,
            "kurtosis": float(sps.kurtosis(x)),
        }
        for name, dist in CANDIDATES.items():
            params = dist.fit(x)
            ks_stat, ks_p = sps.kstest(x, name, args=params)
            row[f"{name}_params"] = tuple(float(p) for p in params)
            row[f"{name}_ks_stat"] = float(ks_stat)
            row[f"{name}_ks_p"] = float(ks_p)
            # log-likelihood of the fit (data_analysis_utils.py:175-178)
            row[f"{name}_ll"] = float(dist.logpdf(x, *params).sum())
        rows.append(row)
    return rows


def find_best(rows: List[Dict]) -> List[Dict]:
    """Per dim: candidate with the smallest KS statistic
    (data_analysis_utils.py:223-240)."""
    out = []
    for row in rows:
        best = min(CANDIDATES, key=lambda name: row[f"{name}_ks_stat"])
        out.append(
            {
                "dim": row["dim"],
                "best": best,
                "ks_stat": row[f"{best}_ks_stat"],
                "kurtosis": row["kurtosis"],
                # gennorm beta<2 means heavier-than-Gaussian tails;
                # beta≈1 is Laplace
                "gennorm_beta": row["gennorm_params"][0],
            }
        )
    return out


def factor_mutual_information(latents: np.ndarray, n_neighbors: int = 3):
    """Pairwise MI between latent factors (sklearn kNN estimator)."""
    from sklearn.feature_selection import mutual_info_regression

    d = latents.shape[1]
    mi = np.zeros((d, d))
    for i in range(d):
        mi[:, i] = mutual_info_regression(
            latents, latents[:, i], n_neighbors=n_neighbors, random_state=0
        )
    return mi


def load_csv(path: str) -> np.ndarray:
    """Load a KITTI solver log.csv ('Total Loss' header + one float per
    logged window) — the format written by cli/kitti_solver.py, mirroring
    the reference (solver.py:57-58; parsed by data_analysis_utils.py:24-78)."""
    values = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or not line[0].isdigit() and line[0] != "-":
                continue
            values.append(float(line))
    return np.asarray(values)


def generate_dataframe(dataset, max_delta_t: int = 1, mi: bool = False,
                       mi_samples: int = 20000):
    """Summary table as a pandas DataFrame: per-dim candidate fits (KS,
    log-likelihood, kurtosis) plus pairwise Pearson (and optional MI)
    between factor deltas (data_analysis_utils.py:134-220)."""
    import pandas as pd

    deltas = latent_deltas(dataset, max_delta_t)
    rows = fit_transition_distributions(deltas)
    # pairwise dependence between the factor deltas (y, x, area)
    names = ["y", "x", "area"][: deltas.shape[1]]
    for i in range(deltas.shape[1]):
        for j in range(i + 1, deltas.shape[1]):
            r, pval = sps.pearsonr(deltas[:, i], deltas[:, j])
            for row in rows:
                row[f"pearson_{names[i]}_{names[j]}"] = float(r)
    if mi:
        from sklearn.feature_selection import mutual_info_regression

        rng = np.random.default_rng(0)
        idx = rng.choice(
            len(deltas), min(mi_samples, len(deltas)), replace=False
        )
        for i in range(deltas.shape[1]):
            for j in range(i + 1, deltas.shape[1]):
                v = float(
                    mutual_info_regression(
                        deltas[idx, i].reshape(-1, 1), deltas[idx, j],
                        random_state=0,
                    )[0]
                )
                for row in rows:
                    row[f"mi_{names[i]}_{names[j]}"] = v
    return pd.DataFrame(rows)


def find_best_dataframe(df, criterion: str = "ll"):
    """Per-dim winner by criterion ('ll' largest, 'ks_p' largest, or
    'ks_stat' smallest) — data_analysis_utils.find_best(:223-240)."""
    cols = [c for c in df.columns if c.endswith(f"_{criterion}")
            or (criterion == "ks_stat" and c.endswith("_ks_stat"))]
    sub = df[cols].astype(float)
    winner = sub.idxmin(axis=1) if criterion == "ks_stat" else sub.idxmax(axis=1)
    out = df[["dim", "kurtosis"]].copy()
    out[f"best_{criterion}"] = [c.rsplit("_", 1 + criterion.count("_"))[0]
                                for c in winner]
    return out


# ---- matplotlib debug plots (data_analysis_utils.py:88-133) ----


def plot_delta_hist(deltas: np.ndarray, dim: int, bins: int = 100,
                    semilogy: bool = True, ax=None):
    """Histogram of one factor's transition deltas (plot_diff analog)."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    ax.hist(deltas[:, dim], bins=bins)
    if semilogy:
        ax.set_yscale("log")
    ax.set_title(f"delta dim {dim}")
    return ax


def visualize_mask(mask: np.ndarray, ax=None):
    """Show one mask frame (data_analysis_utils.visualize_mask)."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    ax.imshow(np.asarray(mask))
    ax.axis("off")
    return ax


def plot_loss_csv(path: str, ax=None):
    """Plot a solver log.csv loss trace."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    ax.plot(load_csv(path))
    ax.set_xlabel("log window")
    ax.set_ylabel("loss")
    return ax
