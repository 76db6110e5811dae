"""The operation and byte counts against hand counts at small shapes."""

import math

import pytest

from portbench.counts import bn_minres, infonce, mlp, peaks, resnet18


def test_loss_bounds_by_hand():
    # m = 2 anchors, 3 negatives, n = 4 features: 24 pair-feature terms
    b = infonce.bounds(2, 3, 4)
    assert b["fwd"][0] == pytest.approx(max(2 * 24 / 67e12, 4 * (5 * 4 + 2) / 3.35e12))
    assert b["dz1"][0] == pytest.approx(max(4 * 24 / 67e12, 4 * (20 + 4 + 8) / 3.35e12))
    assert b["dz3"][0] == pytest.approx(max(4 * 24 / 67e12, 4 * (20 + 4 + 12) / 3.35e12))
    assert b["fwd"][1] == "bytes"  # tiny shapes are bound by bytes
    big = infonce.bounds(6144, 6144, 10)
    assert big["fwd"][1] == "operations"
    assert big["fwd"][0] == pytest.approx(2 * 6144 * 6144 * 10 / 67e12)
    assert infonce.step_flops([(2, 3, 4)]) == 10 * 24


def test_bn_bounds_by_hand():
    b = bn_minres.bounds((2, 3, 3, 4), 4)  # 72 elements of 4 bytes
    assert b["bn_stats"][0] == pytest.approx(max(72 * 4 / 3.35e12, 72 * 3 / 67e12))
    assert b["bn_dx"][0] == pytest.approx(max(72 * 4 * 3 / 3.35e12, 72 * 6 / 67e12))
    half = bn_minres.bounds((2, 3, 3, 4), 2)
    assert half["bn_apply"][0] == pytest.approx(72 * 2 * 2 / 3.35e12)
    assert bn_minres.step_seconds([(2, 3, 3, 4)], 4) == pytest.approx(
        sum(t for t, _ in b.values()))


def test_mlp_flops_by_hand():
    cfg = {"n": 2, "hidden": [3], "mixing_layers": 1}
    # widths 2-3-2: 12 multiply-adds a row; rows 2B = 4
    enc = 4 * (2 * 12 + 4 * 12 - 2 * 6)
    mix = 4 * 2 * 1 * 4
    loss = 10 * 2 * 2 * 2
    assert mlp.step_flops(cfg, 2, 1.0) == enc + mix + loss


def test_resnet18_macs_by_hand():
    layers = dict(resnet18.layer_macs(32, 11))
    assert layers["stem"] == 3 * 64 * 49 * 16 * 16
    assert layers["b00.conv0"] == 64 * 64 * 9 * 8 * 8
    assert layers["b10.conv0"] == 64 * 128 * 9 * 4 * 4
    assert layers["b10.proj"] == 64 * 128 * 4 * 4
    assert layers["b31.conv1"] == 512 * 512 * 9 * 1 * 1
    assert layers["fc"] == 512 * 110 and layers["dense"] == 110 * 11
    assert len(layers) == 1 + 16 + 3 + 2
    # ResNet18 at 224: 1.81 GMAC an image (He et al. 2016 give 1.8 GFLOPs)
    total = sum(m for _, m in resnet18.layer_macs(224, 11))
    assert 1.80e9 < total < 1.83e9
    flops = resnet18.step_flops(32, 11, 2)
    assert flops == 4 * (6 * sum(layers.values()) - 2 * layers["stem"])


def test_peaks():
    assert peaks.FLOPS["float32"] == 67e12 and peaks.FLOPS["bfloat16"] == 989e12
    assert math.isclose(peaks.BYTES_PER_S, 3.35e12)
