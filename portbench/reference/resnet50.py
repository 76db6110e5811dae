"""main_3dident's encoder and loss with ``--encoder rn50``, plain: ResNet-50
v1 (He et al., 2016, arXiv:1512.03385, Table 1, "50-layer") in the
paper's 3DIdent setup (Zimmermann et al., ICML 2021, §5.2;
brendel-group/cl-ica ``main_3dident.py --encoder rn50``).

The stem, the heads and the loss are ``resnet18.py``'s: a 7×7/2
convolution (padding 3), batch norm on the batch's statistics (biased
variance, ε = 1e-5) and ReLU, a 3×3/2 max pool (padding 1); a global mean,
a Linear to 10·n, leaky ReLU (0.01), a Linear to n, the first ``n_pos``
columns as they are and the rest onto a sphere of learnable radius r;
Lp-InfoNCE (p = 2) on the first columns plus dot-product InfoNCE on the
rest, each over (z1, z2, roll(z1, 1)). The blocks are bottlenecks: four
stages of (3, 4, 6, 3), a 1×1 convolution to the block's width (64, 128,
256, 512) with norm and ReLU, a 3×3 at that width carrying the stage's
stride (as torchvision's ``resnet50`` and the program place it) with norm
and ReLU, a 1×1 to four times the width with norm, and at each stage's
first block a 1×1 projection of the shortcut (with the stride) and its
norm; the block's output is relu(shortcut + branch). Padding follows the
program's 'SAME' rule. Leaves are named as the program's modules name
them.

The one departure from a straight forward pass: 1024 float32 images do
not fit on the card with every activation kept, so the stem and each
block run under ``torch.utils.checkpoint`` (non-reentrant), which computes
the same arithmetic again in the backward; nothing is approximated. The
step runs under its precision's ``active()`` (TF32 off in products and
convolutions for every precision but the ``tf32`` control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .infonce import dot_infonce, lp_infonce
from .resnet18 import _norm_spec, conv, norm

STAGES = (3, 4, 6, 3)
WIDTH = 64
EXPANSION = 4
# The benchmark's weights draw each block's last norm scale N(0, 1/16),
# standard deviation 0.25, where every other norm scale is 1. The program
# starts these at 0, which leaves a block's convolutions no first gradient
# to compare; at 1, as the ResNet18 cells have them, sixteen residual
# branches at full strength make the step so sensitive to rounding that a
# bfloat16 first gradient turns as far from float32's as an fp8 one (the
# median leaf's 1 − cos 0.80-0.86 against fp8's 0.97 on an H100, where the
# float32 program reads 1e-4; with this draw 0.09-0.13 against 0.50-0.68).
# No constant init exists in portbench/lib/weights.py, so the scale is a
# draw of that size.
LAST_SCALE_FAN = 16


def blocks() -> list:
    """(c_in, width, stride, projection) of each bottleneck block."""
    out, c_in = [], WIDTH
    for i, size in enumerate(STAGES):
        for j in range(size):
            f = WIDTH * 2 ** i
            stride = 2 if i > 0 and j == 0 else 1
            out.append((c_in, f, stride, c_in != EXPANSION * f or stride != 1))
            c_in = EXPANSION * f
    return out


def spec(n_latents: int) -> list:
    """(name, shape, init) or (name, shape, init, fan_in) of every trained
    leaf."""
    b = "backbone"
    out = [(f"{b}.conv_init.weight", (WIDTH, 3, 7, 7), "he")]
    out += _norm_spec(f"{b}.bn_init", WIDTH)
    for k, (c_in, f, _, proj) in enumerate(blocks()):
        p = f"{b}.blocks.{k}"
        out += [(f"{p}.convs.0.weight", (f, c_in, 1, 1), "he"),
                (f"{p}.convs.1.weight", (f, f, 3, 3), "he"),
                (f"{p}.convs.2.weight", (EXPANSION * f, f, 1, 1), "he")]
        out += _norm_spec(f"{p}.norms.0", f) + _norm_spec(f"{p}.norms.1", f)
        out += [(f"{p}.norms.2.weight", (EXPANSION * f,), "lecun", LAST_SCALE_FAN),
                (f"{p}.norms.2.bias", (EXPANSION * f,), "zeros")]
        if proj:
            out.append((f"{p}.conv_proj.weight", (EXPANSION * f, c_in, 1, 1), "he"))
            out += _norm_spec(f"{p}.norm_proj", EXPANSION * f)
    c = EXPANSION * WIDTH * 2 ** (len(STAGES) - 1)
    out += [(f"{b}.fc.weight", (10 * n_latents, c), "lecun"),
            (f"{b}.fc.bias", (10 * n_latents,), "zeros"),
            ("dense.weight", (n_latents, 10 * n_latents), "lecun"),
            ("dense.bias", (n_latents,), "zeros"),
            ("head_p.r", (1,), "ones")]
    return out


def _stem(x, params: dict, prec):
    b = "backbone"
    x = conv(x, params[f"{b}.conv_init.weight"], 2, prec, padding=3)
    return F.max_pool2d(F.relu(norm(x, params, f"{b}.bn_init")), 3, 2, 1)


def _block(x, params: dict, k: int, stride: int, proj: bool, prec):
    p = f"backbone.blocks.{k}"
    y = F.relu(norm(conv(x, params[f"{p}.convs.0.weight"], 1, prec), params,
                    f"{p}.norms.0"))
    y = F.relu(norm(conv(y, params[f"{p}.convs.1.weight"], stride, prec), params,
                    f"{p}.norms.1"))
    y = norm(conv(y, params[f"{p}.convs.2.weight"], 1, prec), params, f"{p}.norms.2")
    if proj:
        x = norm(conv(x, params[f"{p}.conv_proj.weight"], stride, prec), params,
                 f"{p}.norm_proj")
    return F.relu(x + y)


def encoder(params: dict, x, n_pos: int, prec):
    b = "backbone"
    x = checkpoint(_stem, x, params, prec, use_reentrant=False)
    for k, (_, _, stride, proj) in enumerate(blocks()):
        x = checkpoint(_block, x, params, k, stride, proj, prec, use_reentrant=False)
    h = x.mean(dim=(2, 3))
    h = prec.out(prec.q(h) @ prec.q(params[f"{b}.fc.weight"]).T) + params[f"{b}.fc.bias"]
    h = F.leaky_relu(h, 0.01)
    h = prec.out(prec.q(h) @ prec.q(params["dense.weight"]).T) + params["dense.bias"]
    ang = h[:, n_pos:]
    ang = ang / torch.linalg.norm(ang, dim=-1, keepdim=True) * params["head_p.r"]
    return torch.cat([h[:, :n_pos], ang], dim=1)


def step_loss(params: dict, batch: dict, prec, n_pos: int, p: float):
    """The loss of one step: batch = {"x1", "x2"}, normalised images."""
    with prec.active():
        x = torch.cat([batch["x1"], batch["x2"]]).to(prec.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        z = encoder(params, x, n_pos, prec)
        b = batch["x1"].shape[0]
        z1, z2 = z[:b], z[b:]
        z3 = torch.roll(z1, 1, dims=0)
        return (lp_infonce(z1[:, :n_pos], z2[:, :n_pos], z3[:, :n_pos], p).mean()
                + dot_infonce(z1[:, n_pos:], z2[:, n_pos:], z3[:, n_pos:]).mean())
