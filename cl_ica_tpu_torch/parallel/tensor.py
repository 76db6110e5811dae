"""Channel (tensor) parallelism over a mesh's model axis: ``--mesh-model M``.

The JAX package places every parameter by ``tp_param_rule``
(parallel/sharded.py) and leaves the layers to GSPMD; here the layers are
the model's own, and ``tensor_parallel(model, mesh)`` turns the model of a
rank into its channel-parallel shard, in place:

- every parameter and buffer the rule splits keeps the rank's block of its
  dim 0 (the rank at model index k of M holds channels [k·C/M, (k+1)·C/M)
  of a conv or Linear's output, and the same block of the per-channel
  vectors that follow it);
- each Linear or Conv2d takes its whole input: a channel-split input is
  gathered over the model group just before the layer
  (``ops.collectives.gather_channels``), and a split layer computes the
  rank's block of its output from it; a replicated layer computes the
  whole output on every rank;
- activations stay channel-split between the layers, so every per-channel
  operation runs on the rank's block as a whole local tensor, and the
  hand-written kernels take exactly that: the minres and minres8 norms,
  the stem's norm and pool (``StemBNReLUPool``, ``MinResBNPool``), the
  plain norms, relu, the residual add and the global average pool;
- the model's last Linear (the output layer) gathers its output, so that
  what comes after it (the ThreeDIdentEncoder's column split, the sphere
  and box heads, the loss, which needs z's whole columns) sees the whole
  tensor on every rank; a learnable box head gathers its split bound. The
  MLP's GroupNorm normalises the gathered features and applies its
  affine to the rank's block.

The gradient. Where every rank of a model group computes the same thing
from a gathered tensor (a replicated layer, a head, the loss), the
cotangent that reaches the gather is the same on every rank and complete,
and the gather hands each rank its own slice. Where a split layer (or
GroupNorm's block) takes the gathered tensor, each rank's cotangent is its
block's part only, and the gather's backward sums the ranks' parts
(``reduce_backward``); a whole tensor that feeds a split layer sums its
cotangent over the ranks the same way (``sum_backward``). So each rank's
parameter gradients are exactly the global ones of its shards, a
replicated parameter's the same on every rank of the model group, and
the data group's average (parallel/sharded.py) is left as it was.

The groups are bound to the layers here; the norms take their statistics
over the data group the step sets (``ops.collectives.data_group``), in
which every rank holds the same channels.

``whole_state_dict`` / ``load_whole_state_dict`` and the optimizer's
``whole_optimizer_state`` / ``load_whole_optimizer_state`` move between a
rank's shards and the whole tensors a checkpoint holds (the keys and
shapes of a ``--mesh N`` run's): Adam's state follows its parameter, and
Adam is elementwise, so the rank's Adam on its shards is the slices of
the whole one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import SoftclipLayer
from ..ops.collectives import gather_channels, sum_backward
from .mesh import Mesh
from .sharded import cut_shards, join_shards, shard_of, tp_param_rule


def _input_hook(group, split: bool, channel_dim: int, full: int):
    """A Linear's (channel_dim −1) or a conv's (channel_dim 1) pre-hook: its
    input made whole (module docstring)."""

    def hook(module, args):
        x = args[0]
        if x.shape[channel_dim] == full:
            if split and x.requires_grad:
                return (sum_backward(x, group),) + args[1:]
            return None
        if channel_dim == -1:
            return (gather_channels(x, group, split),) + args[1:]
        # a conv's logical (N, C, H, W), channels_last in memory: gather
        # along the last dim of its NHWC view
        nhwc = gather_channels(x.permute(0, 2, 3, 1), group, split)
        return (nhwc.permute(0, 3, 1, 2),) + args[1:]

    return hook


def _output_hook(group):
    """The output layer's hook: its split output gathered (slice backward)."""

    def hook(module, args, out):
        return gather_channels(out, group, False)

    return hook


class _ChannelSoftclip(SoftclipLayer):
    """A learnable box head on the whole output, its bound gathered."""

    def forward(self, x):
        bound = gather_channels(self.max_abs_bound, self.tp_group, False)
        return torch.sigmoid(x) * bound[None, :]


class _ChannelGroupNorm(nn.GroupNorm):
    """GroupNorm over the gathered features, its affine on the rank's
    block (weight and bias are the rank's shards)."""

    def forward(self, x):
        whole = gather_channels(x, self.tp_group, True)
        y = F.group_norm(whole, self.num_groups, None, None, self.eps)
        w = self.weight.shape[0]
        k = self.tp_index
        return y[..., k * w:(k + 1) * w] * self.weight + self.bias


def tensor_parallel(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``model`` (whole, as every rank built it from one seed) made the
    running rank's channel-parallel shard, in place; see the module
    docstring. Returns it. Nothing changes on a mesh without a model axis."""
    m = mesh.n_model
    if m <= 1:
        return model
    group = mesh.model_group
    split = {}
    for name, p in model.named_parameters():
        split[name] = tp_param_rule(p.shape, m)
        if split[name]:
            p.data = shard_of(p.data, mesh)
    for prefix, mod in model.named_modules():
        for name, b in list(mod._buffers.items()):
            if b is None:
                continue
            key = f"{prefix}.{name}" if prefix else name
            split[key] = tp_param_rule(b.shape, m)
            if split[key]:
                mod._buffers[name] = shard_of(b, mesh)
    linears = [mod for mod in model.modules() if isinstance(mod, nn.Linear)]
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.register_forward_pre_hook(_input_hook(
                group, mod.weight.shape[0] != mod.out_features, -1, mod.in_features))
        elif isinstance(mod, nn.Conv2d):
            mod.register_forward_pre_hook(_input_hook(
                group, mod.weight.shape[0] != mod.out_channels, 1, mod.in_channels))
        elif (isinstance(mod, SoftclipLayer) and not mod.fixed_abs_bound
              and mod.max_abs_bound.shape[0] != mod.n):
            mod.__class__, mod.tp_group = _ChannelSoftclip, group
        elif isinstance(mod, nn.GroupNorm) and mod.weight.shape[0] != mod.num_channels:
            mod.__class__, mod.tp_group, mod.tp_index = (
                _ChannelGroupNorm, group, mesh.model_index)
    out = linears[-1]
    if out.weight.shape[0] != out.out_features:
        out.register_forward_hook(_output_hook(group))
    model.tp_split = split
    model.tp_mesh = mesh
    return model


def _is_sharded(model) -> bool:
    return getattr(model, "tp_mesh", None) is not None


def whole_state_dict(model: nn.Module) -> dict:
    """The state dict of whole tensors (every rank of the model group
    calls this); the model's own state dict where it is not sharded."""
    state = model.state_dict()
    if not _is_sharded(model):
        return state
    return join_shards(state, model.tp_split, model.tp_mesh)


def load_whole_state_dict(model: nn.Module, state: dict) -> None:
    """Load a state dict of whole tensors into the (sharded) model."""
    if _is_sharded(model):
        state = cut_shards(state, model.tp_mesh)
    model.load_state_dict(state)


def _param_names(optimizer, model) -> list:
    """The model's names of the optimizer's parameters, in the order of
    its state dict's indices."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_state(optimizer, model, state: dict, fn) -> dict:
    """``state`` (an optimizer state dict) with ``fn(tensor, name)`` applied
    to each per-parameter tensor shaped like its parameter's whole or
    shard."""
    names = _param_names(optimizer, model)
    per = {}
    for i, entry in state["state"].items():
        per[i] = {k: fn(v, names[i]) if torch.is_tensor(v) and v.ndim else v
                  for k, v in entry.items()}
    return {"state": per, "param_groups": state["param_groups"]}


def whole_optimizer_state(optimizer, model: nn.Module) -> dict:
    """The optimizer's state dict with whole tensors (every rank of the
    model group calls this)."""
    state = optimizer.state_dict()
    if not _is_sharded(model):
        return state
    mesh, split = model.tp_mesh, model.tp_split
    return _map_state(optimizer, model, state, lambda v, name: join_shards(
        {name: v}, split, mesh)[name])


def load_whole_optimizer_state(optimizer, model: nn.Module, state: dict) -> None:
    """Load an optimizer state dict of whole tensors into the optimizer of
    the (sharded) model."""
    if _is_sharded(model):
        mesh, split = model.tp_mesh, model.tp_split
        state = _map_state(optimizer, model, state, lambda v, name: (
            shard_of(v, mesh) if split[name] else v))
    optimizer.load_state_dict(state)
