"""Data-parallel (and tensor-parallel) training steps with global
negatives and global batch statistics, and the tensor-parallel placement
rule.

Port of cl_ica_tpu/parallel/sharded.py. Each of the D ranks of a data
group holds the same model shards and B/D rows of each batch (``mesh_rows``):
it draws the global batch from the same generator stream as every other
rank (so ``--mesh N`` trains on the batch one device would), keeps its
rows, encodes them with every norm's statistics taken over the data
group's rows (``ops.collectives.data_group``), takes the loss against the
global negatives (parallel/collective.py), back-propagates, and averages
the parameter gradients over the data group in one flat all-reduce a dtype
before the optimizer step. The result is the global-batch step of one
device, up to the order of floating-point sums; at N = 1 it is that step
exactly. The reported values are averaged over the data group.

Under ``--mesh-model M`` the model is sharded by ``tp_param_rule`` and
runs channel-parallel over the model group (parallel/tensor.py); the steps
are the same code, since the model's output, the loss and every replicated
computation are the same on each rank of a model group.

The steps themselves read nothing on the host, so main_mlp captures the
synthetic one, collectives and all, when the group's backend is NCCL
(train/capture.py). Under CL_ICA_TPU_DEBUG=1 the synthetic and KITTI steps
raise ValueError after a step whose loss, averaged over the ranks, is not
finite (utils.debug.nan_check, on every rank alike, as the JAX package's
checked mesh step does; ``nan_guard=False`` leaves it to the caller of a
captured step); main_3dident checks its two steps' values itself, under
the JAX package's names for them.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..ops.collectives import all_reduce_mean_, data_group, gather_rows
from ..utils.debug import nan_check
from .collective import global_negatives, gspmd_safe_loss
from .mesh import Mesh, mesh_rows


def tp_param_rule(shape, n_model: int) -> bool:
    """Whether the JAX package's ``tp_param_rule`` splits a tensor of this
    torch shape over a model axis of ``n_model``; a split is always on dim
    0 here: a conv's OIHW output channels (the last dim of Flax's HWIO), a
    Linear's (out, in) rows (the columns of Flax's (in, out) Dense kernel),
    a 1-D vector of at least ``n_model`` entries. Anything whose dim does
    not divide is replicated (at n = 10 the head splits over 2 and stays
    whole over 4)."""
    if n_model <= 1:
        return False
    if len(shape) in (2, 4):
        return shape[0] % n_model == 0
    if len(shape) == 1:
        return shape[0] % n_model == 0 and shape[0] >= n_model
    return False


def shard_of(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's block of dim 0 of a whole tensor the rule splits."""
    k = t.shape[0] // mesh.n_model
    return t[mesh.model_index * k:(mesh.model_index + 1) * k].clone()


def cut_shards(state: dict, mesh: Mesh) -> dict:
    """The rank's shards of a dict of whole tensors (a state dict), each
    split by ``tp_param_rule`` on its whole shape; the rest as it is."""
    return {k: shard_of(v, mesh) if torch.is_tensor(v) and tp_param_rule(
        v.shape, mesh.n_model) else v for k, v in state.items()}


def join_shards(state: dict, split: dict, mesh: Mesh) -> dict:
    """Whole tensors from the rank's shards: the tensors named in
    ``split`` with True are gathered over the model group (every rank of
    it calls this, in one order); the rest as they are."""
    out = {}
    for k, v in state.items():
        if split.get(k):
            parts = [torch.empty_like(v) for _ in range(mesh.n_model)]
            dist.all_gather(parts, v.contiguous(), group=mesh.model_group)
            v = torch.cat(parts)
        out[k] = v
    return out


def ranks_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the data group of a detached tensor (a reported
    value; the same on every rank of a model group)."""
    return all_reduce_mean_(t.detach().clone(), mesh.data_group)


def average_gradients(optimizer: torch.optim.Optimizer, mesh: Mesh) -> None:
    """Every parameter's gradient ← its mean over the data group: one flat
    all-reduce for each dtype. A parameter with no gradient has none on
    any rank (the ranks run one model), and stays without."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        all_reduce_mean_(flat, mesh.data_group)
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def update(optimizer, scheduler, total: torch.Tensor, mesh: Mesh) -> None:
    """Back-propagate the rank's value, average the gradients over the
    ranks, and take the optimizer (and schedule) step."""
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    average_gradients(optimizer, mesh)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()


def make_sharded_synthetic_train_step(
    mesh: Mesh,
    sample_pair: Callable,  # (generator, size) -> (z1, z2)
    mixing: Callable,  # g, frozen
    encoder: torch.nn.Module,
    loss_fn,
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    supervised: bool = False,
    scheduler=None,
    nan_guard: bool = True,
):
    """train.make_synthetic_train_step over the mesh: step(generator) ->
    {'loss', 'loss_pos', 'loss_neg'}, each averaged over the data group.
    The global pair is drawn on every rank; the rank mixes and encodes its
    rows. supervised=True is the MSE to the ground-truth latents (a mean
    over the rank's rows; the ranks' average is the batch's). A body to be
    captured is built with ``nan_guard=False``."""
    rows = mesh_rows(mesh, batch_size)
    loss_fn = None if supervised else gspmd_safe_loss(mesh, loss_fn)

    def step(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        z1, z2 = sample_pair(generator, batch_size)
        z1, z2 = z1[rows], z2[rows]
        with torch.no_grad():
            x1, x2 = mixing(z1), mixing(z2)
        with data_group(mesh.data_group):
            z1_rec = encoder(x1)
            z2_rec = encoder(x2)
            if supervised:
                total = torch.mean((z1_rec - z1) ** 2)
                pos = neg = total
            else:
                z3_rec = global_negatives(mesh, z1_rec)
                total, _, (pos, neg) = loss_fn(z1, z2, None, z1_rec, z2_rec,
                                               z3_rec)
            update(optimizer, scheduler, total, mesh)
        loss, pos, neg = ranks_mean(torch.stack([total, pos, neg]), mesh)
        if nan_guard:
            nan_check(loss, "loss")
        return {"loss": loss, "loss_pos": pos, "loss_neg": neg}

    return step


def make_sharded_data_train_step(mesh: Mesh, encoder: torch.nn.Module, loss_fn,
                                 optimizer, scheduler=None):
    """The step for image pairs (main_kitti): step(x1, x2) on the rank's
    rows of a batch of pairs, both frames in one forward, the loss against
    the global negatives. Returns (loss, mean ‖z1‖), each the whole
    batch's."""
    loss_fn = gspmd_safe_loss(mesh, loss_fn)

    def step(x1: torch.Tensor, x2: torch.Tensor):
        with data_group(mesh.data_group):
            z = encoder(torch.cat([x1, x2])[:, None])
            z1, z2 = z[:x1.shape[0]], z[x1.shape[0]:]
            total = loss_fn(None, None, None, z1, z2,
                            global_negatives(mesh, z1))[0]
            znorm = torch.linalg.norm(z1.detach(), dim=1).mean()
            update(optimizer, scheduler, total, mesh)
        loss, znorm = ranks_mean(torch.stack([total, znorm]), mesh)
        return nan_check(loss, "loss"), znorm

    return step


def make_sharded_3dident_train_step(mesh: Mesh, model: torch.nn.Module,
                                    split_loss: Callable, optimizer,
                                    scheduler=None):
    """The unsupervised 3DIdent step: step(x, x̃) on the rank's rows of both
    views (normalised images), ONE forward of its 2B/W images (its x rows,
    then its x̃ rows; the norms' statistics are the whole 2B batch's, so
    this differs from one device's [x; x̃] forward only in the order of
    sums), z3 = roll(all ranks' z1), the split loss. ``split_loss`` takes
    (z1_rec, z2_rec, z3_rec) with z3_rec global (build_split_loss with
    ``wrap=functools.partial(gspmd_safe_loss, mesh)``). Returns (loss,
    sigma of the per-item loss over the whole batch). With ``optimizer``
    None (nothing to train) only the loss is computed."""

    def step(x1: torch.Tensor, x2: torch.Tensor):
        b = x1.shape[0]
        with data_group(mesh.data_group), torch.set_grad_enabled(optimizer is not None):
            z = model(torch.cat([x1, x2], dim=0))
            z1r, z2r = z[:b], z[b:]
            total, per_item, _ = split_loss(z1r, z2r, global_negatives(mesh, z1r))
            if optimizer is not None:
                update(optimizer, scheduler, total, mesh)
        with torch.no_grad():
            sigma = gather_rows(per_item.detach(), mesh.data_group).std(unbiased=False)
        return ranks_mean(total, mesh), sigma

    return step


def make_sharded_3dident_sup_step(mesh: Mesh, model: torch.nn.Module,
                                  sup_loss: Callable, optimizer,
                                  scheduler=None):
    """The supervised 3DIdent step: step(x, z) on the rank's rows; the
    regression loss over the gathered predictions and targets of the whole
    batch (R² needs the whole batch's variance), so every rank holds the
    global value."""

    def step(x: torch.Tensor, z: torch.Tensor):
        with data_group(mesh.data_group):
            pred = gather_rows(model(x), mesh.data_group)
            total = sup_loss(pred, gather_rows(z, mesh.data_group))
            update(optimizer, scheduler, total, mesh)
        return total.detach()

    return step


def pad_rows_to_multiple(arr, multiple: int):
    """Pad (N, ...) with zero rows so N % multiple == 0 (equal shards);
    returns (padded, original_n)."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    pad_block = np.zeros((pad,) + tuple(arr.shape[1:]), dtype=arr.dtype)
    return np.concatenate([np.asarray(arr), pad_block], axis=0), n
