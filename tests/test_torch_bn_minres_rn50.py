"""The minres norm's kernels (ops/bn_minres.py over csrc/bn_minres.cu) at
every norm shape of ResNet-50's blocks at 1024 images, on the card:
chip_smoke.py's hold of phase 2 (``_hold_bn``: the statistics, and apply,
the backward sums and dx of bn_relu, bn_add_relu and bn_only, against
their plain versions at its bars), one shape and dtype a case.

CUDA kernels have no CPU route, so every test here needs the card and
skips without it; nothing here imports JAX, so that it runs there:

    python -m pytest --noconftest tests/test_torch_bn_minres_rn50.py -m chip
"""

import pytest
import torch

import chip_smoke


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
