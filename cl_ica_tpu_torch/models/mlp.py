"""MLP encoder factory.

Port of cl_ica_tpu/models/mlp.py: a Linear stack with LeakyReLU (slope
0.01), optional batch or group norm, and an output-constraint head. Both
weight and bias are drawn from U(±1/√fan_in), from an explicit
generator: the layers are made with ``skip_init`` so that their own
initialisation never reads the global RNG.

Submodule names are what models/convert.py maps Flax names onto:
``linears.k`` ← ``TorchLinear_k``, ``norms.k`` ← ``BatchNorm_k`` /
``GroupNorm_k``, ``head`` ← ``RescaleLayer_0`` / ``SoftclipLayer_0``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm1d, Linear, RescaleLayer, SoftclipLayer


def _norm_layer(kind: str, width: int) -> nn.Module:
    if kind == "bn":
        # Flax BatchNorm: running = 0.99·running + 0.01·batch, eps 1e-5
        return BatchNorm1d(width, eps=1e-5, momentum=0.01)
    if kind == "gn":
        # Flax GroupNorm(num_groups=1): LayerNorm over features, eps 1e-6
        return nn.GroupNorm(1, width, eps=1e-6)
    raise ValueError(f"layer_normalization must be None, 'bn' or 'gn', got {kind!r}")


def _head(kind: Optional[str], n_out: int, kwargs: dict) -> nn.Module:
    if kind is None:
        return nn.Identity()
    if kind == "fixed_sphere":
        return RescaleLayer(fixed_r=True, **kwargs)
    if kind == "learnable_sphere":
        return RescaleLayer(init_r=1.0, fixed_r=False)
    if kind == "fixed_box":
        return SoftclipLayer(n=n_out, fixed_abs_bound=True, **kwargs)
    if kind == "learnable_box":
        return SoftclipLayer(n=n_out, fixed_abs_bound=False, **kwargs)
    raise ValueError(kind)


class MLPEncoder(nn.Module):
    """LeakyReLU MLP with optional normalization and constraint head.

    output_normalization ∈ {None, 'fixed_sphere', 'learnable_sphere',
    'fixed_box', 'learnable_box'}; layer_normalization ∈ {None, 'bn', 'gn'}.

    dtype: optional compute dtype of the Linear stack (torch.bfloat16 is
    main_mlp's --bf16). Each Linear casts its input, weight and bias to it,
    as the JAX package's TorchLinear does; parameters stay float32, a norm
    layer computes in float32, and the output is cast to float32 before
    the head, so the head, the loss and its kernels see float32.
    """

    def __init__(
        self,
        n_in: int,
        n_out: int,
        hidden: Sequence[int],
        layer_normalization: Optional[str] = None,
        output_normalization: Optional[str] = None,
        output_normalization_kwargs=None,
        generator: Optional[torch.Generator] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        widths = [n_in] + list(hidden) + [n_out]
        self.linears = nn.ModuleList(
            torch.nn.utils.skip_init(Linear, a, b)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.norms = nn.ModuleList(
            _norm_layer(layer_normalization, w) for w in hidden
        ) if layer_normalization is not None else None
        self.head = _head(output_normalization, n_out,
                          dict(output_normalization_kwargs or {}))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(±1/√fan_in) for weight and bias, drawn from ``generator``,
        which lives on the layers' device (main_mlp initialises on the
        CPU and then moves the encoder, so a seed gives the same weights
        on every device)."""
        for lin in self.linears:
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        last = len(self.linears) - 1
        low = self.dtype is not None
        for i, lin in enumerate(self.linears):
            x = lin(x.to(self.dtype) if low else x)
            if i < last:
                if self.norms is not None:
                    x = self.norms[i](x.float() if low else x)
                x = F.leaky_relu(x, negative_slope=0.01)
        return self.head(x.float() if low else x)


def get_mlp(
    n_in: int,
    n_out: int,
    layers: Sequence[int],
    layer_normalization: Optional[str] = None,
    output_normalization: Optional[str] = None,
    output_normalization_kwargs=None,
    generator: Optional[torch.Generator] = None,
    dtype: Optional[torch.dtype] = None,
) -> MLPEncoder:
    """Factory mirroring cl_ica_tpu.models.get_mlp; ``dtype`` is the
    Linear stack's compute dtype (parameters and the head stay float32)."""
    if len(layers) == 0 and n_in != n_out:
        raise ValueError("Network with no layers must have matching n_in/n_out")
    return MLPEncoder(
        n_in=n_in,
        n_out=n_out,
        hidden=layers,
        layer_normalization=layer_normalization,
        output_normalization=output_normalization,
        output_normalization_kwargs=output_normalization_kwargs,
        generator=generator,
        dtype=dtype,
    )
