"""Model operations of one main_3dident step (ResNet-50), counted from
shapes.

He et al. 2016, Table 1, "50-layer": stages (3, 4, 6, 3) of bottleneck
blocks, a 1×1 convolution to the block's width, a 3×3 at that width
carrying the stage's stride, a 1×1 to four times the width, and a 1×1
projection (with the stride) at each stage's first block. A convolution's
multiply-adds are C_in·C_out·k²·H_out·W_out an image; the Linear layers'
a·b. Forward 2 flops a multiply-add; backward 4 (weights and activations),
except the stem's convolution, whose input (the images) takes no gradient:
2. Norms, pools and activations are not counted (a few operations an
element against hundreds). The step encodes 2B images.
"""

from __future__ import annotations

STAGES = (3, 4, 6, 3)
WIDTH = 64
EXPANSION = 4


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def layer_macs(image: int, n_latents: int) -> list:
    """(name, multiply-adds an image) of every convolution and Linear."""
    out = []
    s = _out(image, 2)                       # conv7/2, padding 3
    out.append(("stem", 3 * WIDTH * 49 * s * s))
    s = _out(s, 2)                           # max pool 3/2
    c_in = WIDTH
    for i, size in enumerate(STAGES):
        for j in range(size):
            f = WIDTH * 2 ** i
            stride = 2 if i > 0 and j == 0 else 1
            so = _out(s, stride)
            out.append((f"b{i}{j}.conv0", c_in * f * s * s))
            out.append((f"b{i}{j}.conv1", f * f * 9 * so * so))
            out.append((f"b{i}{j}.conv2", f * EXPANSION * f * so * so))
            if c_in != EXPANSION * f or stride != 1:
                out.append((f"b{i}{j}.proj", c_in * EXPANSION * f * so * so))
            c_in, s = EXPANSION * f, so
    out.append(("fc", c_in * 10 * n_latents))
    out.append(("dense", 10 * n_latents * n_latents))
    return out


def step_flops(image: int, n_latents: int, batch: int) -> float:
    images = 2 * batch
    total = 0
    for name, macs in layer_macs(image, n_latents):
        total += macs * (4 if name == "stem" else 6)
    return float(images * total)
