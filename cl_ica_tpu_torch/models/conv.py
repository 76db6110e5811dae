"""64×64 conv encoder of the KITTI Masks experiment.

Port of cl_ica_tpu/models/conv.py:18 (``ConvEncoder64``, the beta-VAE
encoder of Higgins et al. stripped to its encoder and trained
contrastively). The input is NCHW (B, nc, 64, 64), where the JAX package
takes NHWC; models/convert.py maps the Flax variables onto this module's
parameters. The initialisation is the JAX package's: Flax's
``kaiming_normal``, a normal truncated at ±2 standard deviations and
rescaled to variance 2/fan_in, for every convolution and the Linear, and
zero biases.

The decoder of the same file (``ConvDecoder64``) is not ported: it waits
for the SlowVAE loss that needs it (ROADMAP A14, fault C7).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import SoftclipLayer

# the standard deviation of a unit normal truncated at ±2
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def he_normal_(weight: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> None:
    """Flax's ``kaiming_normal``: a normal truncated at ±2 standard
    deviations, rescaled to variance 2/fan_in (fan_in = in × kh × kw for
    a convolution, in for a Linear)."""
    std = math.sqrt(2.0 / weight[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class ConvEncoder64(nn.Module):
    """(B, nc, 64, 64) → (B, z_dim).

    conv(32,4,s2,p1) → conv(32,4,s2,p1) → conv(64,4,s2,p1) →
    conv(64,4,s2,p1) → conv(256,4,valid) → Linear(256, z_dim)
    [→ Softclip(z_dim, 1.0, learnable) with ``box_norm``], each conv
    followed by a ReLU.
    """

    def __init__(self, z_dim: int = 10, nc: int = 3, box_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.nc, self.box_norm = z_dim, nc, box_norm
        widths = (nc, 32, 32, 64, 64)
        convs = [nn.Conv2d(a, b, 4, stride=2, padding=1)
                 for a, b in zip(widths[:-1], widths[1:])]
        convs.append(nn.Conv2d(64, 256, 4))
        self.convs = nn.ModuleList(convs)
        self.fc = nn.Linear(256, z_dim)
        self.head = (SoftclipLayer(z_dim, 1.0, fixed_abs_bound=False)
                     if box_norm else None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in (*self.convs, self.fc):
            he_normal_(layer.weight, generator)
            layer.bias.zero_()
        if self.head is not None:
            self.head.max_abs_bound.fill_(1.0)

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        if x.shape[2:] != (1, 1):
            raise ValueError(f"ConvEncoder64 takes 64×64 images; the last "
                             f"convolution gave {tuple(x.shape[2:])}, not 1×1")
        # 1×1 maps: NCHW and NHWC flatten alike
        x = self.fc(x.flatten(1))
        return x if self.head is None else self.head(x)
