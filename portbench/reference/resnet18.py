"""main_3dident's encoder and loss, plain (Zimmermann et al., ICML 2021,
§5.2; brendel-group/cl-ica ``main_3dident.py``): ResNet18 v1 (He et al.,
2016) with a 7×7/2 stem (padding 3), batch norm on the batch's statistics
(biased variance, ε = 1e-5) and ReLU, a 3×3/2 max pool (padding 1), four
stages of two basic blocks (a 1×1 projection with its norm where the shape
changes), a global mean, a Linear to 10·n, leaky ReLU (0.01), a Linear to
n, and the heads: the first ``n_pos`` columns as they are, the rest onto a
sphere of learnable radius r. The loss: Lp-InfoNCE (p = 2) on the first
columns plus dot-product InfoNCE on the rest, each over (z1, z2,
roll(z1, 1)).

Padding follows the program's 'SAME' rule (the JAX original's): a 3×3
stride-2 convolution over an even size pads (0, 1), a stride-1 one (1, 1).
Leaves are named as the program's modules name them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .infonce import dot_infonce, lp_infonce

STAGES = (2, 2, 2, 2)
WIDTH = 64


def blocks() -> list:
    """(c_in, filters, stride, projection) of each basic block."""
    out, c_in = [], WIDTH
    for i, size in enumerate(STAGES):
        for j in range(size):
            filters = WIDTH * 2 ** i
            stride = 2 if i > 0 and j == 0 else 1
            out.append((c_in, filters, stride, c_in != filters or stride != 1))
            c_in = filters
    return out


def _norm_spec(prefix: str, c: int) -> list:
    return [(f"{prefix}.weight", (c,), "ones"), (f"{prefix}.bias", (c,), "zeros")]


def spec(n_latents: int) -> list:
    """(name, shape, init) of every trained leaf."""
    b = "backbone"
    out = [(f"{b}.conv_init.weight", (WIDTH, 3, 7, 7), "he")]
    out += _norm_spec(f"{b}.bn_init", WIDTH)
    for k, (c_in, f, _, proj) in enumerate(blocks()):
        p = f"{b}.blocks.{k}"
        out += [(f"{p}.convs.0.weight", (f, c_in, 3, 3), "he"),
                (f"{p}.convs.1.weight", (f, f, 3, 3), "he")]
        out += _norm_spec(f"{p}.norms.0", f) + _norm_spec(f"{p}.norms.1", f)
        if proj:
            out.append((f"{p}.conv_proj.weight", (f, c_in, 1, 1), "he"))
            out += _norm_spec(f"{p}.norm_proj", f)
    c = WIDTH * 2 ** (len(STAGES) - 1)
    out += [(f"{b}.fc.weight", (10 * n_latents, c), "lecun"),
            (f"{b}.fc.bias", (10 * n_latents,), "zeros"),
            ("dense.weight", (n_latents, 10 * n_latents), "lecun"),
            ("dense.bias", (n_latents,), "zeros"),
            ("head_p.r", (1,), "ones")]
    return out


def _same(size: int, k: int, s: int) -> tuple:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int, prec, padding=None):
    k = w.shape[-1]
    if padding is None:
        ph, pw = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
        x = F.pad(x, (*pw, *ph))
        padding = 0
    return prec.out(F.conv2d(prec.q(x), prec.q(w), None, stride, padding))


def norm(x, params: dict, prefix: str):
    return F.batch_norm(x, None, None, params[f"{prefix}.weight"],
                        params[f"{prefix}.bias"], training=True, eps=1e-5)


def encoder(params: dict, x, n_pos: int, prec):
    b = "backbone"
    x = conv(x, params[f"{b}.conv_init.weight"], 2, prec, padding=3)
    x = F.max_pool2d(F.relu(norm(x, params, f"{b}.bn_init")), 3, 2, 1)
    for k, (_, _, stride, proj) in enumerate(blocks()):
        p = f"{b}.blocks.{k}"
        y = F.relu(norm(conv(x, params[f"{p}.convs.0.weight"], stride, prec),
                        params, f"{p}.norms.0"))
        y = norm(conv(y, params[f"{p}.convs.1.weight"], 1, prec), params, f"{p}.norms.1")
        if proj:
            x = norm(conv(x, params[f"{p}.conv_proj.weight"], stride, prec),
                     params, f"{p}.norm_proj")
        x = F.relu(x + y)
    h = x.mean(dim=(2, 3))
    h = prec.out(prec.q(h) @ prec.q(params[f"{b}.fc.weight"]).T) + params[f"{b}.fc.bias"]
    h = F.leaky_relu(h, 0.01)
    h = prec.out(prec.q(h) @ prec.q(params["dense.weight"]).T) + params["dense.bias"]
    ang = h[:, n_pos:]
    ang = ang / torch.linalg.norm(ang, dim=-1, keepdim=True) * params["head_p.r"]
    return torch.cat([h[:, :n_pos], ang], dim=1)


def step_loss(params: dict, batch: dict, prec, n_pos: int, p: float):
    """The loss of one step: batch = {"x1", "x2"}, normalised images."""
    x = torch.cat([batch["x1"], batch["x2"]]).to(prec.dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    z = encoder(params, x, n_pos, prec)
    b = batch["x1"].shape[0]
    z1, z2 = z[:b], z[b:]
    z3 = torch.roll(z1, 1, dims=0)
    return (lp_infonce(z1[:, :n_pos], z2[:, :n_pos], z3[:, :n_pos], p).mean()
            + dot_infonce(z1[:, n_pos:], z2[:, n_pos:], z3[:, n_pos:]).mean())
