"""Frozen invertible mixing networks g: z -> x.

Port of cl_ica_tpu/models/invertible.py. ``construct_invertible_mlp`` is
the JAX package's numpy construction, call for call, so the same
``np.random.default_rng(seed)`` gives bit-identical weights. The forward
applies ``x @ W.T`` per layer (torch's (out, in) convention already),
bias-free, with the weights held as buffers: g is never trained.
"""

from __future__ import annotations

from typing import List, Literal, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import smooth_leaky_relu

_ACTS = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "elu": lambda x: F.elu(x, alpha=1.0),
    "smooth_leaky_relu": lambda x: smooth_leaky_relu(x, alpha=0.2),
    "softplus": F.softplus,
}


class InvertibleMLP(nn.Module):
    """Frozen n→n MLP mixing. Callable on (B, n) tensors."""

    def __init__(self, weights: List[np.ndarray], act: str):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"activation function {act} not defined")
        self.act_name = act
        self.n_layers = len(weights)
        for i, w in enumerate(weights):
            self.register_buffer(f"w{i}", torch.as_tensor(
                np.asarray(w, dtype=np.float32)))

    @property
    def weights(self):
        return tuple(getattr(self, f"w{i}") for i in range(self.n_layers))

    def forward(self, x):
        act = _ACTS[self.act_name]
        for i, w in enumerate(self.weights):
            x = x @ w.T
            if i < self.n_layers - 1:
                x = act(x)
        return x


def construct_invertible_mlp(
    n: int = 20,
    n_layers: int = 2,
    n_iter_cond_thresh: int = 10000,
    cond_thresh_ratio: float = 0.25,
    weight_matrix_init: Union[Literal["pcl"], Literal["rvs"]] = "pcl",
    act_fct: str = "leaky_relu",
    rng: np.random.Generator | None = None,
) -> InvertibleMLP:
    """Create an (approximately) invertible frozen mixing MLP.

    "pcl": U(-1,1) matrices, column-L2-normalized, kept when their
    condition number is at most the ``cond_thresh_ratio`` quantile of a
    pool of ``n_iter_cond_thresh`` draws. "rvs": scipy ortho_group.
    """
    if act_fct not in _ACTS:
        raise ValueError(f"activation function {act_fct} not defined")
    rng = rng or np.random.default_rng()

    weights: List[np.ndarray] = []
    if weight_matrix_init == "pcl":
        def batched_conds(k: int) -> tuple[np.ndarray, np.ndarray]:
            a = rng.uniform(-1, 1, (k, n, n))
            a = a / np.sqrt(np.sum(a * a, axis=1, keepdims=True))
            s = np.linalg.svd(a, compute_uv=False)
            return a, s[:, 0] / s[:, -1]

        _, cond_list = batched_conds(n_iter_cond_thresh)
        cond_list.sort()
        cond_thresh = cond_list[int(n_iter_cond_thresh * cond_thresh_ratio)]
        for _ in range(n_layers):
            while True:
                cands, conds = batched_conds(256)
                ok = np.flatnonzero(conds <= cond_thresh)
                if len(ok):
                    weights.append(cands[ok[0]].astype(np.float32))
                    break
    elif weight_matrix_init == "rvs":
        from scipy.stats import ortho_group  # seconds to import: only here

        for _ in range(n_layers):
            weights.append(ortho_group.rvs(n, random_state=rng).astype(np.float32))
    else:
        raise ValueError(f"weight matrix init {weight_matrix_init} not implemented")

    return InvertibleMLP(weights, act_fct)
