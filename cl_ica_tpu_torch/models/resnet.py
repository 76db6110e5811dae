"""ResNet-18/34/50/101/152 (v1, post-activation).

Port of cl_ica_tpu/models/resnet.py: the 3DIdent image encoder's
backbone. 7×7/2 stem convolution (padding 3, no bias), norm → relu → 3×3/2
max pool (or the fused ``StemBNReLUPool``), four stages of ``BasicBlock``
(18/34) or ``Bottleneck`` (50/101/152), global mean pool, ``Linear``,
float32 output. The last norm of every block starts with a zero scale.

Images are logical (N, C, H, W) tensors held ``channels_last`` in memory
(the JAX package's NHWC). Submodule names are what models/convert.py maps
the Flax names onto: ``conv_init``, ``bn_init``, ``blocks.i`` ←
``BasicBlock_i``/``Bottleneck_i`` with ``convs.k`` ← ``Conv_k``,
``norms.k`` ← ``FastBatchNorm_k``/``MinResBN_k``/``BatchNorm_k``,
``conv_proj``, ``norm_proj``, and ``fc`` ← ``Dense_0``.

``norm_kind`` 'batch', 'fast' and 'minres' are the same mathematics in
the JAX package (three ways to spend less device memory on a TPU) and
are one module here, ``FastBatchNorm2d``. What the JAX package tried
against its TPU's byte floor and kept opt-in waits (ROADMAP A14) and
raises: ``norm_kind='minres8'``, ``stem_pool='argmax'``, the ``s2d`` and
``s2d_exact`` stems, ``remat``.

``dtype=torch.bfloat16`` computes the backbone in bfloat16 the way the
MLP encoder does: parameters stay float32 and are cast at use, the
norms' statistics are float32, and the output is float32.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FastBatchNorm2d, StemBNReLUPool

_NORM_KINDS = ("batch", "fast", "minres", "none")


def _waits(what: str):
    return NotImplementedError(
        f"{what} is not ported to cl_ica_tpu_torch (ROADMAP.md item A14)")


def _same_padding(size: int, kernel: int, stride: int):
    """(low, high) zero padding of one axis under the JAX package's 'SAME'
    rule: the output has ceil(size / stride) positions and the odd unit of
    padding goes to the high side. A 3×3 stride-2 convolution over an even
    axis is padded (0, 1), not torch's symmetric (1, 1)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _Conv(nn.Conv2d):
    """Bias-free convolution whose weight is cast to the input's dtype.
    ``padding=None`` is 'SAME' as the JAX package pads it."""

    def __init__(self, c_in, c_out, kernel, stride=1, padding=None):
        super().__init__(c_in, c_out, kernel, stride, padding or 0, bias=False)
        self.same = padding is None

    def forward(self, x):
        padding = self.padding
        if self.same:
            k, s = self.kernel_size[0], self.stride[0]
            ph, pw = _same_padding(x.shape[2], k, s), _same_padding(x.shape[3], k, s)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                padding = (ph[0], pw[0])
            else:
                x, padding = F.pad(x, (*pw, *ph)), 0
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, padding)


def _norm(kind: str, width: int, zero_init: bool = False) -> nn.Module:
    if kind == "none":
        return nn.Identity()
    return FastBatchNorm2d(width, eps=1e-5, momentum=0.1, zero_init=zero_init)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, norm_kind: str):
        super().__init__()
        self.convs = nn.ModuleList([_Conv(c_in, filters, 3, stride),
                                    _Conv(filters, filters, 3)])
        self.norms = nn.ModuleList([_norm(norm_kind, filters),
                                    _norm(norm_kind, filters, zero_init=True)])
        self.conv_proj = self.norm_proj = None
        if c_in != filters or stride != 1:
            self.conv_proj = _Conv(c_in, filters, 1, stride)
            self.norm_proj = _norm(norm_kind, filters)

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = self.norms[1](self.convs[1](y))
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, norm_kind: str):
        super().__init__()
        out = filters * 4
        self.convs = nn.ModuleList([_Conv(c_in, filters, 1),
                                    _Conv(filters, filters, 3, stride),
                                    _Conv(filters, out, 1)])
        self.norms = nn.ModuleList([_norm(norm_kind, filters),
                                    _norm(norm_kind, filters),
                                    _norm(norm_kind, out, zero_init=True)])
        self.conv_proj = self.norm_proj = None
        if c_in != out or stride != 1:
            self.conv_proj = _Conv(c_in, out, 1, stride)
            self.norm_proj = _norm(norm_kind, out)

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = F.relu(self.norms[1](self.convs[1](y)))
        y = self.norms[2](self.convs[2](y))
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """``forward(x)`` takes (N, 3, H, W) and returns float32
    (N, num_classes); training or eval statistics follow ``self.training``
    (the JAX package's ``train`` argument)."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls,
        num_classes: int,
        num_filters: int = 64,
        dtype: Optional[torch.dtype] = None,
        stem: str = "conv7",
        norm_kind: str = "batch",
        remat: bool = False,
        fused_stem_pool: bool = False,
        stem_pool: str = "xla",
        in_channels: int = 3,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if norm_kind == "minres8":
            raise _waits("norm_kind='minres8' (float8 norm residuals)")
        if norm_kind not in _NORM_KINDS:
            raise ValueError(f"norm_kind must be one of {_NORM_KINDS} or "
                             f"'minres8', got {norm_kind!r}")
        if stem in ("s2d", "s2d_exact"):
            raise _waits(f"stem={stem!r} (space-to-depth stem)")
        if stem != "conv7":
            raise ValueError(f"unknown stem {stem!r}")
        if stem_pool == "argmax":
            raise _waits("stem_pool='argmax' (argmax-code pool)")
        if stem_pool != "xla":
            raise ValueError(f"unknown stem_pool {stem_pool!r}")
        if remat:
            raise _waits("remat=True (block rematerialisation)")
        if fused_stem_pool and norm_kind == "none":
            # the fused stem always batch-normalises; with the no-norm
            # diagnostic it would quietly diverge from the unfused path
            raise ValueError(
                "fused_stem_pool=True applies BatchNorm in the stem "
                "and cannot be combined with norm_kind='none'")
        self.dtype = dtype
        self.fused_stem_pool = fused_stem_pool
        self.conv_init = _Conv(in_channels, num_filters, 7, 2, 3)
        self.bn_init = (StemBNReLUPool(num_filters, eps=1e-5, momentum=0.1)
                        if fused_stem_pool else _norm(norm_kind, num_filters))
        blocks, c_in = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(c_in, filters,
                                        2 if i > 0 and j == 0 else 1, norm_kind))
                c_in = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(c_in, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's initialisers from an explicit generator:
        convolutions N(0, 2/fan_in) (kaiming normal), the Linear a
        truncated normal of variance 1/fan_in (lecun normal) with a zero
        bias. Norm scales are 1, or 0 for a block's last norm."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        lecun_normal_(self.fc.weight, generator)
        self.fc.bias.zero_()

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.conv_init(x.contiguous(memory_format=torch.channels_last))
        if self.fused_stem_pool:
            x = self.bn_init(x)
        else:
            x = F.max_pool2d(F.relu(self.bn_init(x)), kernel_size=3, stride=2,
                             padding=1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))
        return x.float()


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """Flax's default Dense initialiser: a normal truncated at ±2 standard
    deviations, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=Bottleneck)
