"""Flax variables <-> the port's state dicts: ``MLPEncoder``, ``ResNet``
and the 3DIdent encoder.

The JAX package's encoder variables (as numpy arrays) map onto the port's
parameters by name:

    params/TorchLinear_k/kernel  (fan_in, out)  -> linears.k.weight (out, fan_in)
    params/TorchLinear_k/bias                   -> linears.k.bias
    params/BatchNorm_k/{scale,bias}             -> norms.k.{weight,bias}
    batch_stats/BatchNorm_k/{mean,var}          -> norms.k.{running_mean,running_var}
    params/GroupNorm_k/{scale,bias}             -> norms.k.{weight,bias}
    params/RescaleLayer_0/r                     -> head.r
    params/SoftclipLayer_0/max_abs_bound        -> head.max_abs_bound

Dense kernels are transposed; nothing else is. The frozen mixing needs no
conversion: its weights are already applied as x @ W.T in both packages.

The ResNet (``resnet_params_from_flax`` / ``resnet_params_to_flax``):

    params/conv_init/kernel  HWIO (kh, kw, in, out) -> conv_init.weight OIHW
    params/bn_init/{scale,bias}, batch_stats/bn_init/{mean,var}
                                   -> bn_init.{weight,bias,running_mean,running_var}
    {BasicBlock,Bottleneck}_i/Conv_k/kernel        -> blocks.i.convs.k.weight
    .../{FastBatchNorm,MinResBN,BatchNorm}_k/...   -> blocks.i.norms.k....
    .../conv_proj/kernel, .../norm_proj/...        -> blocks.i.conv_proj, norm_proj
    params/Dense_0/{kernel,bias}                   -> fc.{weight,bias}

and the 3DIdent encoder (``threedident_params_from_flax`` / ``..._to_flax``):
``ResNet_0`` (or ``MLPEncoder_0`` under --dummy-mixing) -> ``backbone``,
``Dense_0`` -> ``dense``, and the constraint heads by the Flax names the
encoder reports (``ThreeDIdentEncoder.flax_head_names``). An unknown leaf
raises in every converter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_NORM_PARAMS = {"scale": "weight", "bias": "bias"}
_NORM_STATS = {"mean": "running_mean", "var": "running_var"}
_HEADS = {("RescaleLayer_0", "r"): "head.r",
          ("SoftclipLayer_0", "max_abs_bound"): "head.max_abs_bound"}


def encoder_params_from_flax(flax_vars) -> Dict[str, torch.Tensor]:
    """Flax variables ({'params': ..., ['batch_stats': ...]}, or the bare
    'params' tree) -> a state dict for ``MLPEncoder.load_state_dict``."""
    params = flax_vars.get("params", flax_vars)
    stats = flax_vars.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.as_tensor(np.array(value, dtype=np.float32))

    for name, leaves in params.items():
        prefix, _, idx = name.rpartition("_")
        if prefix == "TorchLinear":
            put(f"linears.{idx}.weight", np.asarray(leaves["kernel"]).T)
            put(f"linears.{idx}.bias", leaves["bias"])
        elif prefix in ("BatchNorm", "GroupNorm"):
            for src, dst in _NORM_PARAMS.items():
                put(f"norms.{idx}.{dst}", leaves[src])
            if prefix == "BatchNorm":
                for src, dst in _NORM_STATS.items():
                    put(f"norms.{idx}.{dst}", stats[name][src])
                sd[f"norms.{idx}.num_batches_tracked"] = torch.tensor(0)
        else:
            for leaf, value in leaves.items():
                if (name, leaf) not in _HEADS:
                    raise KeyError(f"unknown encoder parameter {name}/{leaf}")
                put(_HEADS[(name, leaf)], value)
    return sd


def encoder_params_to_flax(state_dict) -> dict:
    """Inverse of ``encoder_params_from_flax``: a state dict -> the Flax
    variables tree of numpy float32 arrays ({'params': ...} plus
    'batch_stats' when the encoder has batch norm)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}
    norm_kind = "GroupNorm"
    if any(k.endswith("running_mean") for k in sd):
        norm_kind = "BatchNorm"
    heads = {v: k for k, v in _HEADS.items()}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "linears":
            leaf = {"weight": "kernel", "bias": "bias"}[parts[2]]
            params.setdefault(f"TorchLinear_{parts[1]}", {})[leaf] = (
                value.T.copy() if leaf == "kernel" else value)
        elif parts[0] == "norms":
            name = f"{norm_kind}_{parts[1]}"
            if parts[2] in ("weight", "bias"):
                leaf = {"weight": "scale", "bias": "bias"}[parts[2]]
                params.setdefault(name, {})[leaf] = value
            elif parts[2] in ("running_mean", "running_var"):
                leaf = {"running_mean": "mean", "running_var": "var"}[parts[2]]
                stats.setdefault(name, {})[leaf] = value
        elif key in heads:
            name, leaf = heads[key]
            params.setdefault(name, {})[leaf] = value
        else:
            raise KeyError(f"unknown encoder state {key}")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


_NORM_CLASSES = ("FastBatchNorm", "MinResBN", "BatchNorm")
_BLOCK_CLASSES = ("BasicBlock", "Bottleneck")


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(np.array(value, dtype=np.float32))


def _norm_from_flax(sd, key, params, stats, where):
    for leaf in params:
        if leaf not in _NORM_PARAMS:
            raise KeyError(f"unknown parameter {where}/{leaf}")
        sd[f"{key}.{_NORM_PARAMS[leaf]}"] = _f32(params[leaf])
    for leaf in stats:
        if leaf not in _NORM_STATS:
            raise KeyError(f"unknown statistic {where}/{leaf}")
        sd[f"{key}.{_NORM_STATS[leaf]}"] = _f32(stats[leaf])


def _conv_from_flax(sd, key, leaves, where):
    if set(leaves) != {"kernel"}:
        raise KeyError(f"unknown parameter in {where}: {sorted(leaves)}")
    # HWIO -> OIHW
    sd[f"{key}.weight"] = _f32(np.transpose(np.asarray(leaves["kernel"]), (3, 2, 0, 1)))


def resnet_params_from_flax(flax_vars) -> Dict[str, torch.Tensor]:
    """Flax ``ResNet`` variables ({'params', 'batch_stats'}) -> a state
    dict for the port's ``ResNet.load_state_dict``."""
    params = flax_vars["params"]
    stats = flax_vars.get("batch_stats") or {}
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        prefix, _, idx = name.rpartition("_")
        if name == "conv_init":
            _conv_from_flax(sd, "conv_init", leaves, name)
        elif name == "bn_init":
            _norm_from_flax(sd, "bn_init", leaves, stats.get(name, {}), name)
        elif name == "Dense_0":
            if set(leaves) != {"kernel", "bias"}:
                raise KeyError(f"unknown parameter in {name}: {sorted(leaves)}")
            sd["fc.weight"] = _f32(np.asarray(leaves["kernel"]).T)
            sd["fc.bias"] = _f32(leaves["bias"])
        elif prefix in _BLOCK_CLASSES:
            block_stats = stats.get(name, {})
            for sub, sub_leaves in leaves.items():
                sub_prefix, _, k = sub.rpartition("_")
                where = f"{name}/{sub}"
                if sub == "conv_proj":
                    _conv_from_flax(sd, f"blocks.{idx}.conv_proj", sub_leaves, where)
                elif sub == "norm_proj":
                    _norm_from_flax(sd, f"blocks.{idx}.norm_proj", sub_leaves,
                                    block_stats.get(sub, {}), where)
                elif sub_prefix == "Conv":
                    _conv_from_flax(sd, f"blocks.{idx}.convs.{k}", sub_leaves, where)
                elif sub_prefix in _NORM_CLASSES:
                    _norm_from_flax(sd, f"blocks.{idx}.norms.{k}", sub_leaves,
                                    block_stats.get(sub, {}), where)
                else:
                    raise KeyError(f"unknown ResNet module {where}")
        else:
            raise KeyError(f"unknown ResNet module {name}")
    return sd


def resnet_params_to_flax(state_dict, norm_name: str = "FastBatchNorm") -> dict:
    """Inverse of ``resnet_params_from_flax``. ``norm_name`` is the Flax
    class name of the blocks' norms: 'FastBatchNorm' (norm_kind 'fast',
    what --fused-stem uses), 'MinResBN' ('minres') or 'BatchNorm'."""
    if norm_name not in _NORM_CLASSES:
        raise ValueError(f"norm_name must be one of {_NORM_CLASSES}")
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    n_convs = {}
    for key in sd:
        parts = key.split(".")
        if parts[0] == "blocks" and parts[2] == "convs":
            n_convs[parts[1]] = max(n_convs.get(parts[1], 0), int(parts[3]) + 1)
    params: dict = {}
    stats: dict = {}
    norm_leaf = {**{v: ("p", k) for k, v in _NORM_PARAMS.items()},
                 **{v: ("s", k) for k, v in _NORM_STATS.items()}}

    def put_norm(path, leaf, value):
        kind, name = norm_leaf[leaf]
        node = params if kind == "p" else stats
        for part in path:
            node = node.setdefault(part, {})
        node[name] = value

    for key, value in sd.items():
        parts = key.split(".")
        if key == "conv_init.weight":
            params.setdefault("conv_init", {})["kernel"] = value.transpose(2, 3, 1, 0).copy()
        elif parts[0] == "bn_init" and parts[1] in norm_leaf:
            put_norm(["bn_init"], parts[1], value)
        elif key == "fc.weight":
            params.setdefault("Dense_0", {})["kernel"] = value.T.copy()
        elif key == "fc.bias":
            params.setdefault("Dense_0", {})["bias"] = value
        elif parts[0] == "blocks":
            block = (f"{'Bottleneck' if n_convs.get(parts[1]) == 3 else 'BasicBlock'}"
                     f"_{parts[1]}")
            if parts[2] == "convs" and parts[4] == "weight":
                params.setdefault(block, {})[f"Conv_{parts[3]}"] = {
                    "kernel": value.transpose(2, 3, 1, 0).copy()}
            elif parts[2] == "conv_proj" and parts[3] == "weight":
                params.setdefault(block, {})["conv_proj"] = {
                    "kernel": value.transpose(2, 3, 1, 0).copy()}
            elif parts[2] == "norms" and parts[4] in norm_leaf:
                put_norm([block, f"{norm_name}_{parts[3]}"], parts[4], value)
            elif parts[2] == "norm_proj" and parts[3] in norm_leaf:
                put_norm([block, "norm_proj"], parts[3], value)
            else:
                raise KeyError(f"unknown ResNet state {key}")
        else:
            raise KeyError(f"unknown ResNet state {key}")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def threedident_params_from_flax(flax_vars, head_names: Dict[str, str]
                                 ) -> Dict[str, torch.Tensor]:
    """Flax ``ThreeDIdentEncoder`` variables -> a state dict for the
    port's. ``head_names`` maps the Flax names of the constraint heads
    that hold a parameter onto the port's attributes
    (``ThreeDIdentEncoder.flax_head_names()``)."""
    params = flax_vars["params"]
    stats = flax_vars.get("batch_stats") or {}
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        if name == "ResNet_0":
            sub = resnet_params_from_flax(
                {"params": leaves, "batch_stats": stats.get(name, {})})
            sd.update({f"backbone.{k}": v for k, v in sub.items()})
        elif name == "MLPEncoder_0":
            sub = encoder_params_from_flax({"params": leaves})
            sd.update({f"backbone.{k}": v for k, v in sub.items()})
        elif name == "Dense_0":
            if set(leaves) != {"kernel", "bias"}:
                raise KeyError(f"unknown parameter in {name}: {sorted(leaves)}")
            sd["dense.weight"] = _f32(np.asarray(leaves["kernel"]).T)
            sd["dense.bias"] = _f32(leaves["bias"])
        elif name in head_names:
            for leaf, value in leaves.items():
                if leaf not in ("r", "max_abs_bound"):
                    raise KeyError(f"unknown encoder parameter {name}/{leaf}")
                sd[f"{head_names[name]}.{leaf}"] = _f32(value)
        else:
            raise KeyError(f"unknown encoder module {name}")
    return sd


def threedident_params_to_flax(state_dict, head_names: Dict[str, str],
                               norm_name: str = "FastBatchNorm") -> dict:
    """Inverse of ``threedident_params_from_flax``."""
    attrs = {v: k for k, v in head_names.items()}
    backbone = {k[len("backbone."):]: v for k, v in state_dict.items()
                if k.startswith("backbone.")}
    params: dict = {}
    out = {"params": params}
    if backbone:
        if any(k.startswith("linears.") for k in backbone):
            params["MLPEncoder_0"] = encoder_params_to_flax(backbone)["params"]
        else:
            sub = resnet_params_to_flax(backbone, norm_name)
            params["ResNet_0"] = sub["params"]
            if "batch_stats" in sub:
                out["batch_stats"] = {"ResNet_0": sub["batch_stats"]}
    for key, value in state_dict.items():
        if key.startswith("backbone."):
            continue
        value = value.detach().cpu().numpy()
        attr, _, leaf = key.rpartition(".")
        if key == "dense.weight":
            params.setdefault("Dense_0", {})["kernel"] = value.T.copy()
        elif key == "dense.bias":
            params.setdefault("Dense_0", {})["bias"] = value
        elif attr in attrs and leaf in ("r", "max_abs_bound"):
            params.setdefault(attrs[attr], {})[leaf] = value
        else:
            raise KeyError(f"unknown encoder state {key}")
    return out
