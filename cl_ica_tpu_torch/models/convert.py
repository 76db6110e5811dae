"""Flax ``MLPEncoder`` variables <-> ``MLPEncoder`` state dict.

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
