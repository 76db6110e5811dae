"""Batched exact k-NN over the rendered-latent table.

Port of cl_ica_tpu/ops/knn.py:22-48. The whole batch of queries is matched
at once on the device: one float32 product (‖q‖² − 2 q·tᵀ + ‖t‖²) and
``torch.topk``, chunked over queries so that the (block, N) distance
block stays bounded. The product is outside any hand-written kernel in
the JAX package too, so it is ``torch.matmul``; it must not run in TF32
(the distances of near neighbours differ in the low bits), so TF32 is
switched off around it whatever the caller's setting.
"""

from __future__ import annotations

from typing import Tuple

import torch


def l2_topk(table: torch.Tensor, queries: torch.Tensor, k: int = 1,
            block_q: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k smallest squared L2 distances of queries (B, d) to the
    rows of table (N, d): (indices (B, k) int64, sqdists (B, k)), ascending.
    """
    table = table.float()
    queries = queries.float()
    t_sq = torch.sum(table * table, dim=-1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def block_fn(q):
            q_sq = torch.sum(q * q, dim=-1)
            d = q_sq[:, None] - 2.0 * torch.matmul(q, table.T) + t_sq[None, :]
            neg_d, idx = torch.topk(-d, k, dim=1)
            return idx, -neg_d

        b = queries.shape[0]
        if b <= block_q or b % block_q != 0:
            return block_fn(queries)
        parts = [block_fn(q) for q in queries.split(block_q)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
