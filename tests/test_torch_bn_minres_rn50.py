"""The minres norm's kernels (ops/bn_minres.py over csrc/bn_minres.cu) at
every norm shape of ResNet-50's blocks at 1024 images, on the card:
chip_smoke.py's hold of phase 2 (``_hold_bn``: the statistics, and apply,
the backward sums and dx of bn_relu, bn_add_relu and bn_only, against
their plain versions at its bars, and bn_add_relu's backward with two
upstream gradients against their add, bit for bit), one shape and dtype a
case.

CUDA kernels have no CPU route, so those tests need the card and skip
without it; nothing here imports JAX, so that they run there:

    python -m pytest --noconftest tests/test_torch_bn_minres_rn50.py -m chip

On the CPU: the plain two-addend backward at the widths of ResNet-50's
block outputs (256 to 2048 channels), against one tensor on both edges.
"""

import pytest
import torch

import chip_smoke
from cl_ica_tpu_torch.ops import bn_minres

# the channels of ResNet-50's block outputs, each the input of a junction
RN50_JUNCTION_CHANNELS = sorted({c for *_, c in chip_smoke.RN50_NORMS if c >= 256})


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", chip_smoke.RN50_NORMS,
                         ids=[f"{h}x{w}x{c}" for _, h, w, c in chip_smoke.RN50_NORMS])
def test_kernels_hold_their_plain_versions_at_resnet50_shapes(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    gen = torch.Generator(device="cuda").manual_seed(shape[1] * 10_000 + shape[3])
    chip_smoke._hold_bn(shape, dtype, gen, {})
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", RN50_JUNCTION_CHANNELS)
def test_plain_two_addend_backward_at_resnet50_widths(c, dtype):
    # bn_add_relu's output on two edges, each into its own consumer, against
    # one tensor on both, whose gradients autograd adds: x, res, scale,
    # bias and both consumers' gradients bit for bit
    g = torch.Generator().manual_seed(c)
    x, res, w1, w2 = (torch.randn(2, 3, 3, c, generator=g).to(dtype) for _ in range(4))
    scale, bias = 1.0 + 0.3 * torch.randn(c, generator=g), torch.randn(c, generator=g)
    grads = []
    for pair in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, res, scale, bias, w1, w2)]
        y, y_res, _, _ = bn_minres.bn_add_relu(*leaves[:4])
        ((y * leaves[4]).float().sum()
         + ((y_res if pair else y) * leaves[5]).float().sum()).backward()
        grads.append([t.grad for t in leaves])
    assert all(torch.equal(p, q) for p, q in zip(*grads))
