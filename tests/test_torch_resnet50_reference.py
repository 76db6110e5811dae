"""ResNet-50 on main_3dident's path against the benchmark's plain reference
(portbench/reference/resnet50.py), and the benchmark's ResNet-50 counts.

The port's ``ThreeDIdentEncoder`` as ``main_3dident.build_encoder`` makes
it for ``--encoder rn50`` (minres norms, whose CPU route is their plain
versions, and the minres stem), in training, with the benchmark's seeded
weights (``portbench.lib.weights``), its split loss over (z1, z2,
roll(z1)), against the reference's loss and every leaf's gradient, both in
float32, at 32×32 images and B = 4 pairs. The reference imports nothing of
the program, so this holds two independent writings of the network to each
other; the benchmark's check holds the card's bfloat16 step to the same
reference at full size.
"""

import math
import statistics

import pytest
import torch

from cl_ica_tpu_torch.cli import main_3dident
from portbench.counts import resnet50 as rn50_counts
from portbench.drivers.threedident_scan_rn50 import Session
from portbench.lib import weights
from portbench.reference import resnet50 as ref
from portbench.reference.precision import Precision

torch.set_num_threads(1)

N_POS, N_SPHERE = 3, 8


def _port(seed):
    args = main_3dident.parse_args(["--offline-dataset", "unused", "--encoder", "rn50",
                                    "--batch-size", "4"])
    model = main_3dident.build_encoder(args, N_POS + N_SPHERE, N_POS,
                                       torch.Generator().manual_seed(seed)).train()
    w = weights.make(ref.spec(N_POS + N_SPHERE), seed, "cpu")
    weights.load_into(model.named_parameters(), w)
    return model, main_3dident.build_split_loss(args, N_POS), w


def _images(seed, b=4, size=32):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, 3, size, size, generator=gen) for _ in range(2)]


@pytest.mark.parametrize("seed", [0, 2])
def test_port_holds_to_the_plain_reference(seed):
    model, split_loss, w = _port(seed)
    x1, x2 = _images(seed)
    total, _ = main_3dident.unsupervised_objective(model, split_loss, x1, x2)
    named = dict(model.named_parameters())
    got = dict(zip(named, torch.autograd.grad(total, list(named.values()))))

    prec = Precision("float32")
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want_loss = ref.step_loss(params, {"x1": x1, "x2": x2}, prec, N_POS, 2.0)
    want = dict(zip(params, torch.autograd.grad(want_loss, list(params.values()))))

    assert set(got) == set(want) and len(want) == 3 + 16 * 9 + 4 * 3 + 5
    # Both in float32, summed in other orders (the minres variance is
    # E[x²] − E[x]², the library's a two-pass one), through 53 norms over as
    # few as 8 positions a channel (stage 4 is 1×1 here), which pass the
    # roundings on: over seeds 0-6 the port lay up to 4.1e-6 from the
    # reference on the loss and 9.3e-3 on the gradients (as below), seed 2
    # the farthest. A wrong layer reads 3e-2 and above on the loss and 1.4
    # and above on the gradients (the stride on the first 1×1, a relu left
    # out).
    assert float(total.detach()) == pytest.approx(float(want_loss.detach()), rel=1e-4)
    # each leaf's gradient gap against the larger of its norm and the
    # median leaf's (portbench/lib/check.py's denominator: a leaf whose
    # gradient cancels to round-off is judged on the scale of the others)
    median = statistics.median(float(g.norm()) for g in want.values())
    for k, g in want.items():
        gap = float((got[k] - g).norm()) / max(float(g.norm()), median)
        assert gap <= 0.05, (k, gap)


def test_counts_match_the_hand_figures():
    layers = rn50_counts.layer_macs(224, N_POS + N_SPHERE)
    conv = sum(m for name, m in layers if name not in ("fc", "dense"))
    assert conv == 4_087_136_256  # He et al. 2016 give 3.8e9 FLOPs (multiply-adds)
    macs = dict(layers)
    assert macs["stem"] == 3 * 64 * 49 * 112 * 112
    assert macs["b00.conv0"] == 64 * 64 * 56 * 56
    assert macs["b10.conv0"] == 256 * 128 * 56 * 56  # the stride is the 3×3's
    assert macs["b10.conv1"] == 128 * 128 * 9 * 28 * 28
    assert macs["b10.proj"] == 256 * 512 * 28 * 28
    assert macs["b32.conv2"] == 512 * 2048 * 7 * 7
    assert macs["fc"] == 2048 * 110 and macs["dense"] == 110 * 11
    assert len(layers) == 1 + 16 * 3 + 4 + 2
    flops = rn50_counts.step_flops(224, 11, 512)
    head = 6 * (macs["fc"] + macs["dense"])
    assert flops == 1024 * (6 * conv - 2 * macs["stem"] + head)
    assert math.isclose(flops, 24.87e12, rel_tol=1e-3)


def test_norm_shapes_are_the_53_norms():
    shapes = Session.norm_shapes(224)
    assert len(shapes) == 53
    assert shapes[0] == (112, 112, 64) and shapes[-1] == (7, 7, 2048)
    assert shapes[1:5] == [(56, 56, 64), (56, 56, 64), (56, 56, 256), (56, 56, 256)]
    assert shapes.count((7, 7, 2048)) == 4 and shapes.count((14, 14, 1024)) == 7
    assert sorted(set(shapes[1:]), key=lambda s: (-s[0], s[2])) == [
        (56, 56, 64), (56, 56, 128), (56, 56, 256), (28, 28, 128), (28, 28, 256),
        (28, 28, 512), (14, 14, 256), (14, 14, 512), (14, 14, 1024), (7, 7, 512),
        (7, 7, 2048)]
