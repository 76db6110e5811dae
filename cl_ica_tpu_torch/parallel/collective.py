"""Global negatives: the contrastive losses over ranks that each hold B/W
rows of the batch.

Port of cl_ica_tpu/parallel/collective.py (``shardmap_cl_loss``,
``gspmd_safe_loss``: one routing function here, since the fused kernels'
per-rank block needs no wrapper; ``store_gather_scatter`` and
``sharded_store_gather``, the row-sharded image store's gathers, at the
end). Everything here runs over the mesh's data group: on a 2-D mesh the
ranks of one model group hold the same rows and compute the same loss.
A step under a mesh
(parallel/sharded.py) encodes its own rows, gathers every rank's z1_rec
with ``global_negatives`` and
takes z3_rec = roll(gathered, 1): the global batch's negatives, across
the ranks' boundaries, as one device's z3_rec = roll(z1_rec, 1). The loss
then sees its own rows of z1_rec and z2_rec and all B rows of z3_rec:

- SimCLRLoss, and LpSimCLRLoss with p ≥ 1 and ``pow``, take that
  rectangular (B/W) × B block as it is, through their fused kernels on
  CUDA (the objects accept M ≠ N rows), and return the mean of the rank's
  rows; the non-compat Lp form's log-count is z3_rec's, the global B;
- every other loss (p < 1, which builds its matrix transposed;
  Uniformity, whose logmeanexp runs over each z3 row; AlignmentUniformity;
  any other CLLoss) sees the whole global batch, z1_rec and z2_rec gathered
  too, and returns the whole batch's value on every rank;
- SplitCombinedCLLoss and CombinedCLLoss route each member by its own type
  over its columns (Uniformity over the gathered rows; Alignment and the
  Jacobian loss, which are per row, over the rank's own).

The gradient rule. Each rank back-propagates the value its loss returned.
Every cross-rank operation sums in its backward: the gather hands each
rank the sum over ranks of its rows' cotangents, and the norms' statistics
(ops/collectives.py, ops/bn_minres.py, ops/stem.py) sum their backward
over the ranks. So the ranks' parameter gradients add up to the gradient
of the sum of the values they back-propagated, which is W times the global
loss: W times the mean of the rank's rows over the ranks for the first
kind, W copies of the global value for the second. parallel/sharded.py
averages the parameter gradients over the ranks, which leaves exactly the
gradient of the global-batch loss, with parameters and optimizer state
alike on every rank. The values reported are averaged over the ranks as
well (for the second kind, an average of equal values).
"""

from __future__ import annotations

import torch

from ..losses import (
    CLLoss,
    ConditionalPairCLLoss,
    LpSimCLRLoss,
    MarginalPairCLLoss,
    MarginalSingleCLLoss,
    SimCLRLoss,
    SplitCombinedCLLoss,
)
from ..ops.collectives import all_reduce_sum_, gather_rows, reduce_scatter_rows
from .mesh import Mesh, mesh_rows


def global_negatives(mesh: Mesh, z1_rec: torch.Tensor) -> torch.Tensor:
    """z3_rec of the global batch: roll(every data rank's z1_rec, in rank
    order, 1), all B rows on every rank; differentiable (its backward sums
    over the ranks)."""
    return torch.roll(gather_rows(z1_rec, mesh.data_group), 1, dims=0)


def kernel_eligible(loss) -> bool:
    """The losses whose rows are independent given all the negatives: the
    fused kernels' domain (SimCLR; Lp with p ≥ 1 and ``pow``)."""
    return isinstance(loss, SimCLRLoss) or (
        isinstance(loss, LpSimCLRLoss) and float(loss.p) >= 1.0 and loss.pow)


class _OnRanks(CLLoss):
    """A loss computed over the mesh; see the module docstring. Called as a
    CLLoss with the rank's rows of z1, z2_con_z1, z1_rec and z2_con_z1_rec
    and the global z3_rec of ``global_negatives``; z3 (ground truth) is
    unused by every loss that takes it and may be None."""

    def __init__(self, mesh: Mesh, loss):
        self.mesh, self.inner = mesh, loss

    def _rows(self, n_global: int) -> slice:
        return mesh_rows(self.mesh, n_global)

    def _gathered(self, a):
        return None if a is None else gather_rows(a, self.mesh.data_group)

    def _whole(self, loss, z1, z2_con_z1, z1_rec, z2_con_z1_rec, z3_rec):
        """``loss`` over the whole batch: (value, the rank's per-item rows,
        components)."""
        z1_all = torch.roll(z3_rec, -1, dims=0)  # the gathered z1_rec, exactly
        total, per_item, comps = loss(
            self._gathered(z1), self._gathered(z2_con_z1), None, z1_all,
            self._gathered(z2_con_z1_rec), z3_rec)
        return total, per_item[self._rows(z3_rec.shape[0])], comps


class _WholeBatch(_OnRanks):
    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        return self._whole(self.inner, z1, z2_con_z1, z1_rec, z2_con_z1_rec,
                           z3_rec)


class _Split(_OnRanks):
    """SplitCombinedCLLoss's dispatch, each member over its columns by its
    own route."""

    def loss(self, z1, z2_con_z1, z3, z1_rec, z2_con_z1_rec, z3_rec):
        loss_values, per_item_values, individual = [], [], []
        for l, s, e in self.inner.losses_and_indices:
            c = lambda a: None if a is None else a[:, s:e]
            if isinstance(l, MarginalPairCLLoss):
                z3c = c(z3_rec)
                tl, lpi, ils = l(torch.roll(z3c, -1, dims=0), z3c)
                lpi = lpi[self._rows(z3c.shape[0])]
            elif isinstance(l, ConditionalPairCLLoss):
                tl, lpi, ils = l(c(z1_rec), c(z2_con_z1_rec))
            elif isinstance(l, CLLoss):
                tl, lpi, ils = gspmd_safe_loss(self.mesh, l)(
                    c(z1), c(z2_con_z1), None, c(z1_rec), c(z2_con_z1_rec),
                    c(z3_rec))
            elif isinstance(l, MarginalSingleCLLoss):
                tl, lpi, ils = l(c(z1))
            else:
                raise ValueError(f"Invalid loss type: {type(l)}")
            loss_values.append(tl)
            per_item_values.append(lpi)
            individual.append(ils)
        weights = self.inner.weights
        total = sum(w * l for l, w in zip(loss_values, weights))
        per_item = sum(w * lpi for lpi, w in zip(per_item_values, weights))
        return total, per_item, list(zip(loss_values, individual, individual))


def gspmd_safe_loss(mesh: Mesh, loss):
    """The loss to hand a step under ``mesh``: the rectangular block for a
    kernel-eligible SimCLR/LpSimCLR loss (the object itself), each member
    by its own route for a split or combined loss, the whole gathered
    batch for anything else (module docstring). The name is the JAX
    package's, whose GSPMD partitioning of the materialised loss this
    routing reproduces."""
    if kernel_eligible(loss):
        return loss
    if isinstance(loss, SplitCombinedCLLoss):
        return _Split(mesh, loss)
    if isinstance(loss, CLLoss):
        return _WholeBatch(mesh, loss)
    raise TypeError(f"gspmd_safe_loss: not a CLLoss: {type(loss)}")


# ---------------------------------------------------------------------------
# the row-sharded image store
# ---------------------------------------------------------------------------


def _owned_rows(mesh: Mesh, store_shape, block: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """(B, ...) uint8: the rows of ``idx`` that the rank's block of the
    padded store holds, zeros elsewhere: each row has one nonzero owner
    over the data group, so their uint8 sum is the row itself."""
    per = store_shape[0] // mesh.n_data
    local = idx - mesh.data_index * per
    mine = (local >= 0) & (local < per)
    rows = block[local.clamp(0, per - 1)]
    return rows * mine.view((-1,) + (1,) * (rows.ndim - 1)).to(rows.dtype)


def _check_store(mesh: Mesh, store_shape) -> None:
    if store_shape[0] % mesh.n_data:
        raise ValueError(f"a store of {store_shape[0]} rows is not divisible by "
                         f"the data axis ({mesh.n_data}): pad it "
                         "(pad_rows_to_multiple)")


def store_gather_scatter(mesh: Mesh, store_shape):
    """Row-gather from the row-sharded store, returning the rank's rows of
    the batch: fn(block, idx) -> (B/D, ...) uint8, where ``block`` is the
    rank's (N/D, ...) rows of the PADDED store of ``store_shape`` (data
    index d holds rows [d·N/D, (d+1)·N/D)) and ``idx`` the global batch's
    (B,) store rows, the same on every rank. Each rank contributes the
    requested rows it owns and zeros elsewhere, and one uint8
    reduce-scatter over the data group leaves each its own B/D rows (the
    same rows ``mesh_rows`` picks): (D − 1)/D of the batch's bytes cross
    the ranks, one byte a pixel. A batch the data axis does not divide is
    refused."""
    _check_store(mesh, store_shape)

    def gather(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if idx.shape[0] % mesh.n_data:
            raise ValueError(f"batch {idx.shape[0]} not divisible by "
                             f"{mesh.n_data} shards")
        return reduce_scatter_rows(_owned_rows(mesh, store_shape, block, idx),
                                   mesh.data_group)

    return gather


def sharded_store_gather(mesh: Mesh, store_shape):
    """The replicated variant: fn(block, idx) -> the whole (B, ...) batch
    on every rank, uint8, by one all-reduce of the owned rows over the data
    group (the JAX package's psum of float32 rows; the values are the
    same)."""
    _check_store(mesh, store_shape)

    def gather(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum_(_owned_rows(mesh, store_shape, block, idx),
                               mesh.data_group)

    return gather
