"""The data-parallel group of a step, and the collectives its norms,
loss, tensor-parallel layers and image store call.

Under ``--mesh N`` each of N ranks holds B/N rows of the batch
(parallel/). Three things then cross ranks, and all three go through
this module:

  the negatives   ``gather_rows``: every rank's rows of z1_rec, in rank
                  order, so that z3 = roll(all of them) is the global
                  batch's; its backward sums each rank's cotangent of
                  every row back to the rank that owns the row;
  the statistics  ``all_reduce_mean`` (with autograd, for the norms whose
                  gradient runs through their statistics), and
                  ``all_reduce_mean_`` and ``all_reduce_sum_`` (in place,
                  for the norm kernels' wrappers, which write their own
                  backward): the batch
                  mean and E[x²] of every norm, and its backward sums,
                  over all ranks' rows;
  the gradients   parallel/sharded.py averages the parameters' gradients
                  after the backward.

Under ``--mesh-model M`` (parallel/tensor.py) a fourth thing crosses
the ranks of a model group, which hold the same rows and each a block of
every split layer's channels:

  the channels    ``gather_channels``: every rank's block of the last dim
                  (NHWC channels, Linear features), in rank order. Its
                  backward hands each rank the cotangent of its block:
                  summed over the ranks (``reduce_backward``, where each
                  rank's consumer saw only part of the gathered tensor's
                  uses, as a split layer does) or the rank's own slice
                  (where every rank computed the same thing from it);
                  ``sum_backward`` is the identity whose backward sums
                  over the ranks, for a whole tensor a split layer takes.

``reduce_scatter_rows`` is the image store's uint8 reduce-scatter
(parallel/collective.py).

``data_group(group)`` sets the group for a step's forward and backward;
``current_group()`` is None outside it, and then no caller communicates
and each computes exactly what it computes on one device. Ranks hold
equal row counts, so a mean of the ranks' means is the global mean.

Kept in ops/, below the norm kernels' wrappers and the models that call
it; parallel/ holds the launcher, the losses' routing and the steps.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_state = {"group": None}


def current_group():
    """The data-parallel process group of the running step, or None."""
    return _state["group"]


@contextlib.contextmanager
def data_group(group):
    """Make ``group`` the data-parallel group until the block ends."""
    prev = _state["group"]
    _state["group"] = group
    try:
        yield group
    finally:
        _state["group"] = prev


def world_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """t ← the sum of every rank's t, in place (no autograd)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean_(t: torch.Tensor, group) -> torch.Tensor:
    """t ← the mean of every rank's t, in place (no autograd)."""
    return all_reduce_sum_(t, group).div_(world_of(group))


class _AllReduceMean(torch.autograd.Function):
    """y = (1/W) Σ_r x_r on every rank. Its backward is the same mean of
    the ranks' cotangents: each rank's loss reaches every rank's x through
    y, and the ranks' losses are summed (parallel/collective.py)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_mean_(
            x.detach().clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_mean_(
            g.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's x, differentiable."""
    return _AllReduceMean.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """cat(every rank's x, in rank order) along rows. The backward hands
    each rank the sum over ranks of the cotangent of its own rows: NCCL's
    reduce-scatter, or gloo's all-reduce and the rank's slice (gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        world = world_of(group)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.rows = group, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        group, m = ctx.group, ctx.rows
        if dist.get_backend(group) == "nccl":
            out = torch.empty((m,) + tuple(g.shape[1:]), dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=group)
            return out, None
        g = g.clone()
        all_reduce_sum_(g, group)
        r = dist.get_rank(group)
        return g[r * m:(r + 1) * m], None


def gather_rows(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Every rank's rows of x, in rank order; differentiable."""
    return _GatherRows.apply(x, group)


def _rank_in(group) -> int:
    return dist.get_rank(group)


def _sum_block(g: torch.Tensor, group, width: int) -> torch.Tensor:
    """The rank's block of the last dim of the sum over ranks of g: NCCL's
    reduce-scatter (over the blocks moved to dim 0), or gloo's all-reduce
    and the rank's slice."""
    world = world_of(group)
    if dist.get_backend(group) == "nccl":
        blocks = g.reshape(*g.shape[:-1], world, width).movedim(-2, 0).contiguous()
        out = torch.empty(g.shape[:-1] + (width,), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, blocks, op=dist.ReduceOp.SUM, group=group)
        return out
    g = g.contiguous().clone()
    all_reduce_sum_(g, group)
    r = _rank_in(group)
    return g[..., r * width:(r + 1) * width].contiguous()


class _GatherChannels(torch.autograd.Function):
    """cat(every rank's x, in rank order) along the last dim; the backward
    is the sum over ranks of the rank's block (``reduce``) or its slice."""

    @staticmethod
    def forward(ctx, x, group, reduce):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world_of(group))]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.width, ctx.reduce = group, x.shape[-1], reduce
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        if ctx.reduce:
            return _sum_block(g, ctx.group, w), None, None
        r = _rank_in(ctx.group)
        return g[..., r * w:(r + 1) * w].contiguous(), None, None


def gather_channels(x: torch.Tensor, group, reduce_backward: bool) -> torch.Tensor:
    """Every model rank's block of x's last dim, in rank order;
    differentiable (module docstring)."""
    return _GatherChannels.apply(x, group, reduce_backward)


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.group), None


def sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; its cotangent is summed over the ranks of ``group``."""
    return _SumBackward.apply(x, group)


def reduce_scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The rank's block of rows of the sum over ranks of t (B, ...), in
    t's dtype (uint8 for the image store: one nonzero addend a row, so
    nothing overflows). NCCL's reduce-scatter, or gloo's all-reduce and
    the rank's rows (gloo has no reduce-scatter)."""
    world, t = world_of(group), t.contiguous()
    m = t.shape[0] // world
    if dist.get_backend(group) == "nccl":
        out = torch.empty((m,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM, group=group)
        return out
    all_reduce_sum_(t, group)
    r = _rank_in(group)
    return t[r * m:(r + 1) * m]
