"""64×64 conv encoder of the KITTI Masks experiment, and its decoder.

Port of cl_ica_tpu/models/conv.py: ``ConvEncoder64`` (:18, the beta-VAE
encoder of Higgins et al. stripped to its encoder and trained
contrastively) and ``ConvDecoder64`` (:49, the beta-VAE decoder the
SlowVAE loss reconstructs through). Images are NCHW (B, nc, H, W), where
the JAX package takes NHWC; models/convert.py maps the Flax variables onto
these modules' parameters. The initialisation is the JAX package's: Flax's
``kaiming_normal``, a normal truncated at ±2 standard deviations and
rescaled to variance 2/fan_in, for every convolution, transposed
convolution and Linear, and zero biases.

The decoder follows the JAX package's output size (ROADMAP C7, followed):
(B, nc, 34, 34), not 64×64. Flax's stride-2 ``ConvTranspose`` with padding
((1, 1), (1, 1)) gives 2·in − 2, as ``ConvTranspose2d(..., stride=2,
padding=2)`` does: 1 → 4 → 6 → 10 → 18 → 34.
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
               generator: Optional[torch.Generator] = None,
               fan_in: Optional[int] = None) -> None:
    """Flax's ``kaiming_normal``: a normal truncated at ±2 standard
    deviations, rescaled to variance 2/fan_in (fan_in = in × kh × kw for
    a convolution, in for a Linear; a transposed convolution's (in, out,
    kh, kw) weight passes its own)."""
    fan_in = weight[0].numel() if fan_in is None else fan_in
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
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


class ConvDecoder64(nn.Module):
    """(B, z_dim) → (B, nc, 34, 34) logits (no sigmoid; the loss applies
    one where it needs it).

    Linear(z_dim, 256) → ReLU → deconv(64,4,valid) → deconv(64,4,s2) →
    deconv(32,4,s2) → deconv(32,4,s2) → deconv(nc,4,s2), a ReLU after each
    but the last. Flax's transposed convolution does not flip its kernel
    (``transpose_kernel=False``) and torch's does: models/convert.py flips
    the kernels' spatial axes.
    """

    def __init__(self, z_dim: int = 10, nc: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.nc = z_dim, nc
        self.fc = nn.Linear(z_dim, 256)
        widths = (256, 64, 64, 32, 32, nc)
        self.deconvs = nn.ModuleList(
            [nn.ConvTranspose2d(256, 64, 4)]
            + [nn.ConvTranspose2d(a, b, 4, stride=2, padding=2)
               for a, b in zip(widths[1:-1], widths[2:])])
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        he_normal_(self.fc.weight, generator)
        self.fc.bias.zero_()
        for layer in self.deconvs:
            c_in, _, kh, kw = layer.weight.shape
            he_normal_(layer.weight, generator, fan_in=c_in * kh * kw)
            layer.bias.zero_()

    def forward(self, z):
        x = F.relu(self.fc(z)).view(z.shape[0], 256, 1, 1)
        for layer in self.deconvs[:-1]:
            x = F.relu(layer(x))
        return self.deconvs[-1](x)
