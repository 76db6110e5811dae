"""ResNet-18/34/50/101/152 (v1, post-activation).

Port of cl_ica_tpu/models/resnet.py: the 3DIdent image encoder's
backbone. 7×7/2 stem convolution (padding 3, no bias), norm → relu → 3×3/2
max pool (with 'minres' the norm, relu and pool of ``MinResBNPool``; or the
fused ``StemBNReLUPool``), four stages of ``BasicBlock``
(18/34) or ``Bottleneck`` (50/101/152), global mean pool, ``Linear``,
float32 output. The last norm of every block starts with a zero scale.

Images are logical (N, C, H, W) tensors held ``channels_last`` in memory
(the JAX package's NHWC). Submodule names are what models/convert.py maps
the Flax names onto: ``conv_init``, ``bn_init``, ``blocks.i`` ←
``BasicBlock_i``/``Bottleneck_i`` with ``convs.k`` ← ``Conv_k``,
``norms.k`` ← ``FastBatchNorm_k``/``MinResBN_k``/``BatchNorm_k``,
``conv_proj``, ``norm_proj``, and ``fc`` ← ``Dense_0``.

A block takes its input as a pair (x for its first convolution, x_res for
its shortcut) and returns its output as one: the stem's output is one
tensor on both, and the mean pool takes the last block's first. With
'minres' a block's output pair is its last norm's two autograd edges of
one tensor (ops/bn_minres.py ``bn_add_relu``), so that the gradients of
the next block's convolution and shortcut reach that norm's backward
apart, which adds them in its own pass; with the other kinds it is one
tensor twice, whose gradients autograd adds.

``norm_kind`` 'batch', 'fast' and 'minres' are the same mathematics in
the JAX package (three ways to spend less device memory on a TPU).
'batch' and 'fast' are one module here, ``FastBatchNorm2d``, under
autograd. The stem of 'minres' (the CLIs' default) is ``MinResBNPool``: in
training, where its kernels take the stem's map, the norm, relu and pool
are one function (ops/pool_minres.py ``bn_relu_pool``) whose backward keeps
x and a uint8 argmax code, with the output of the JAX package's norm, relu
and max pool bit for bit; elsewhere it is ``MinResBN2d`` then
``F.max_pool2d``. The blocks' norms are ``MinResBN2d``, as the JAX
package's ``fused_bn`` blocks run them: each block's first norms fuse the
relu, the projection's norm has none, and a block's
last norm takes the shortcut and fuses the add and the relu, each one
function whose backward keeps only x (and, for a block's last norm, the
block's output) (ops/bn_minres.py). 'minres8' is the same with the float8
residual (``MinResBN2d(residuals_f8=True)``, ops/bn_minres8.py).

The JAX package's other options: ``stem_pool='argmax'`` with 'minres' is
its ``MinResBNPool`` at the stem's norm, relu and pool, which 'minres' has
here whatever ``stem_pool``; with 'minres8' it raises, as there (minres8
keeps ``MinResBN2d`` and the library's pool at its stem: the argmax pool
has no float8 residual); with the other kinds, and under
``fused_stem_pool``, it is ignored, as there. ``stem='s2d'`` is a 2×2
space-to-depth (3 → 12 channels) and a 4×4 stride-1 'SAME' convolution;
``stem='s2d_exact'`` computes conv7's function from conv7's (64, 3, 7, 7)
weight, zero-padded to 8×8 and rearranged into the 4×4 kernel over the
space-to-depth input. Both are cuDNN convolutions. ``remat=True`` runs each
block under ``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, where the norms leave their running buffers
alone (``layers.recomputing``), so a step updates them once.

``dtype=torch.bfloat16`` computes the backbone in bfloat16 the way the
MLP encoder does: parameters stay float32 and are cast at use, the
norms' statistics are float32, and the output is float32.

In training, the forward marks the parts of the step's FWD_LAYER layer
(utils/profiling.py; cli/main_3dident.py marks the layer itself after the
forward): ``backbone_fwd.stem`` after the stem's pool and
``backbone_fwd.stage1`` to ``.stage4`` after each stage's last block.
Outside a marked step a mark does nothing; the blocks that ``remat``
recomputes hold none.
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils import profiling
from .layers import (
    FastBatchNorm2d,
    Linear,
    MinResBN2d,
    MinResBNPool,
    StemBNReLUPool,
    recomputing,
)

_NORM_KINDS = ("batch", "fast", "minres", "minres8", "none")
FWD_LAYER = "backbone_fwd"  # the step's layer whose parts the forward marks
_MINRES = ("minres", "minres8")
_STEMS = ("conv7", "s2d", "s2d_exact")


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


def _norm(kind: str, width: int, zero_init: bool = False,
          act: str = "relu") -> nn.Module:
    """The norm of ``kind``; ``act`` is the activation a 'minres' or
    'minres8' norm fuses (the other kinds leave it to the caller)."""
    if kind == "none":
        return nn.Identity()
    if kind in _MINRES:
        return MinResBN2d(width, eps=1e-5, momentum=0.1, zero_init=zero_init,
                          act=act, residuals_f8=kind == "minres8")
    return FastBatchNorm2d(width, eps=1e-5, momentum=0.1, zero_init=zero_init)


def space_to_depth(x):
    """(N, C, H, W) → (N, 4C, H/2, W/2), channel (a·2 + b)·C + c holding
    x[c, 2i + a, 2j + b]: the JAX package's NHWC reshape and transpose."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, 4 * c, h // 2, w // 2).contiguous(
        memory_format=torch.channels_last)


def s2d_exact_weight(weight):
    """conv7's (O, C, 7, 7) weight as the (O, 4C, 4, 4) kernel over the
    space-to-depth input: zero-padded to 8×8 at the top and left (tap
    u = 2k + a − 1), then (k, a) and (l, b) split, a and b moved into the
    channels in space_to_depth's order."""
    o, c = weight.shape[:2]
    w8 = F.pad(weight, (1, 0, 1, 0)).reshape(o, c, 4, 2, 4, 2)
    return w8.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)


def _checkpoint_contexts():
    """The forward as is; the recompute under ``recomputing()``."""
    return contextlib.nullcontext(), recomputing()


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
            self.norm_proj = _norm(norm_kind, filters, act="none")
        self.minres = norm_kind in _MINRES

    def forward(self, x, x_res):
        if self.minres:  # the JAX package's fused_bn block
            y = self.convs[1](self.norms[0](self.convs[0](x)))
            if self.conv_proj is not None:
                x_res = self.norm_proj(self.conv_proj(x_res))
            return self.norms[1](y, res=x_res)
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = self.norms[1](self.convs[1](y))
        if self.conv_proj is not None:
            x_res = self.norm_proj(self.conv_proj(x_res))
        y = F.relu(x_res + y)
        return y, y


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
            self.norm_proj = _norm(norm_kind, out, act="none")
        self.minres = norm_kind in _MINRES

    def forward(self, x, x_res):
        if self.minres:  # the JAX package's fused_bn block
            y = self.convs[1](self.norms[0](self.convs[0](x)))
            y = self.convs[2](self.norms[1](y))
            if self.conv_proj is not None:
                x_res = self.norm_proj(self.conv_proj(x_res))
            return self.norms[2](y, res=x_res)
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = F.relu(self.norms[1](self.convs[1](y)))
        y = self.norms[2](self.convs[2](y))
        if self.conv_proj is not None:
            x_res = self.norm_proj(self.conv_proj(x_res))
        y = F.relu(x_res + y)
        return y, y


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
        if norm_kind not in _NORM_KINDS:
            raise ValueError(f"norm_kind must be one of {_NORM_KINDS}, got "
                             f"{norm_kind!r}")
        if stem not in _STEMS:
            raise ValueError(f"unknown stem {stem!r}")
        if stem_pool not in ("xla", "argmax"):
            raise ValueError(f"unknown stem_pool {stem_pool!r}")
        if fused_stem_pool and norm_kind == "none":
            # the fused stem always batch-normalises; with the no-norm
            # diagnostic it would quietly diverge from the unfused path
            raise ValueError(
                "fused_stem_pool=True applies BatchNorm in the stem "
                "and cannot be combined with norm_kind='none'")
        argmax = stem_pool == "argmax" and not fused_stem_pool
        if argmax and norm_kind == "minres8":
            # the argmax pool has no float8 residual: the stem, the largest
            # activation, would quietly keep its full-precision input
            raise ValueError(
                "stem_pool='argmax' does not support norm_kind='minres8' "
                "(the argmax-pool stem keeps bf16 residuals); use "
                "norm_kind='minres' or the default stem_pool='xla'")
        self.dtype = dtype
        self.fused_stem_pool = fused_stem_pool
        self.stem = stem
        self.remat = remat
        # s2d_exact keeps conv7's weight; s2d convolves 4x4 over 4C channels
        self.conv_init = (_Conv(4 * in_channels, num_filters, 4) if stem == "s2d"
                          else _Conv(in_channels, num_filters, 7, 2, 3))
        if fused_stem_pool:
            self.bn_init = StemBNReLUPool(num_filters, eps=1e-5, momentum=0.1)
        elif norm_kind == "minres":  # either stem_pool
            self.bn_init = MinResBNPool(num_filters, eps=1e-5, momentum=0.1)
        else:  # stem_pool='argmax' with another norm is ignored, as in JAX
            self.bn_init = _norm(norm_kind, num_filters)
        blocks, c_in = [], num_filters
        self.stage_ends = {}  # index of a stage's last block -> its mark
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(c_in, filters,
                                        2 if i > 0 and j == 0 else 1, norm_kind))
                c_in = filters * block_cls.expansion
            self.stage_ends[len(blocks) - 1] = f"{FWD_LAYER}.stage{i + 1}"
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(c_in, num_classes)
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
        x = x.contiguous(memory_format=torch.channels_last)
        if self.stem == "s2d_exact":
            w = s2d_exact_weight(self.conv_init.weight).to(x.dtype)
            x = F.conv2d(F.pad(space_to_depth(x), (2, 1, 2, 1)), w)
        elif self.stem == "s2d":
            x = self.conv_init(space_to_depth(x))
        else:
            x = self.conv_init(x)
        if isinstance(self.bn_init, (StemBNReLUPool, MinResBNPool)):
            x = self.bn_init(x)  # norm, relu and pool
        elif isinstance(self.bn_init, MinResBN2d):  # norm and relu in one
            x = F.max_pool2d(self.bn_init(x), kernel_size=3, stride=2, padding=1)
        else:
            x = F.max_pool2d(F.relu(self.bn_init(x)), kernel_size=3, stride=2,
                             padding=1)
        if self.training:
            profiling.mark(f"{FWD_LAYER}.stem")
        remat = self.remat and torch.is_grad_enabled()
        x_res = x
        for k, block in enumerate(self.blocks):
            # no block draws random numbers: nothing to stash or restore
            x, x_res = (checkpoint(block, x, x_res, use_reentrant=False,
                                   preserve_rng_state=False,
                                   context_fn=_checkpoint_contexts)
                        if remat else block(x, x_res))
            if self.training and k in self.stage_ends:
                profiling.mark(self.stage_ends[k])
        x = x.mean(dim=(2, 3))
        x = self.fc(x)
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
