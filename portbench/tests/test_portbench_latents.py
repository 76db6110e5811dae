"""The closed forms that hold the drawn latents to their distribution
(``reference/latents.py``), against plain NumPy draws; and a run whose
sampler draws the conditional at the wrong scale coming out not correct."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import latents
from portbench.tests.tiny import tiny_run


@pytest.mark.parametrize("kappa", [0.5, 3.7, 20.0])
def test_vmf_mean_cos_on_the_2_sphere_is_coth_minus_inverse(kappa):
    assert latents.vmf_mean_cos(3, kappa) == pytest.approx(
        1 / math.tanh(kappa) - 1 / kappa, rel=1e-12)


def _numpy_vmf(rng, d, kappa, n):
    """Mean direction e_0: the cosine w by inverting its CDF on a grid of
    its density ∝ exp(κw)(1 − w²)^((d−3)/2), a uniform tangent direction."""
    w = np.linspace(-1, 1, 200_001)[1:-1]
    dens = np.exp(kappa * (w - 1)) * (1 - w * w) ** ((d - 3) / 2)
    cdf = np.cumsum(dens)
    cdf /= cdf[-1]
    cos = np.interp(rng.uniform(size=n), cdf, w)
    v = rng.normal(size=(n, d - 1))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.concatenate([cos[:, None], np.sqrt(1 - cos * cos)[:, None] * v], 1)


@pytest.mark.parametrize("d,kappa", [(10, 20.0), (8, 10.0)])
def test_vmf_mean_cos_against_numpy_draws(d, kappa):
    z = _numpy_vmf(np.random.default_rng(d), d, kappa, 400_000)
    mc = z[:, 0]
    assert abs(mc.mean() - latents.vmf_mean_cos(d, kappa)) < 5 * mc.std() / math.sqrt(mc.size)


@pytest.mark.parametrize("lo,hi,p,lam", [(0.0, 1.0, 1.0, 0.05), (-1.0, 1.0, 2.0, 0.1 * math.sqrt(2)),
                                         (0.0, 1.0, 1.0, 0.5)])
def test_box_gap_mean_against_numpy_rejection(lo, hi, p, lam):
    rng = np.random.default_rng(1)
    a = rng.uniform(lo, hi, 400_000)
    t = (rng.laplace(0, lam, (a.size, 60)) if p == 1
         else rng.normal(0, lam / math.sqrt(2), (a.size, 60)))
    x = a[:, None] + t
    first = ((x >= lo) & (x <= hi)).argmax(1)
    gap = np.abs(x[np.arange(a.size), first] - a)
    assert abs(gap.mean() - latents.box_gap_mean(lo, hi, p, lam)) < 5 * gap.std() / math.sqrt(a.size)


def test_statistics_of_plain_draws_are_small_and_of_wrong_ones_large():
    rng = np.random.default_rng(2)
    box = [{"kind": "box", "min": 0.0, "max": 1.0, "conditional": "laplace", "scale": 0.05}]
    z1 = rng.uniform(0, 1, (6144, 10))
    x = z1[None] + rng.laplace(0, 0.05, (40,) + z1.shape)
    ok = (x >= 0) & (x <= 1)
    z2 = np.take_along_axis(x, ok.argmax(0)[None], 0)[0]
    pair = (torch.from_numpy(z1), torch.from_numpy(z2))
    assert latents.sample_z([pair], box) < 5
    wide = dict(box[0], scale=0.055)
    assert latents.sample_z([pair], [wide]) > 10
    sphere = [{"kind": "sphere", "r": 1.0, "conditional": "vmf", "kappa": 20.0}]
    z = torch.from_numpy(_numpy_vmf(rng, 10, 20.0, 6144))
    e0 = torch.zeros_like(z)
    e0[:, 0] = 1.0
    stats = latents.statistics(e0, z, sphere)
    assert abs(stats["0.sphere.cos"]) < 5
    assert abs(latents.statistics(e0, z, [dict(sphere[0], kappa=22.0)])["0.sphere.cos"]) > 10


@pytest.mark.parametrize("name", ["mlp-box-p1-b6144", "mlp-sphere-p2-b65536"])
def test_a_sampler_at_the_wrong_scale_is_not_correct(name, monkeypatch):
    from cl_ica_tpu_torch.spaces import spaces

    sound = tiny_run(name, 7)["compared"]["sample_z"]
    lap, vmf = spaces.NBoxSpace.laplace, spaces.NSphereSpace.von_mises_fisher
    monkeypatch.setattr(spaces.NBoxSpace, "laplace",
                        lambda self, g, mean, lbd, size: lap(self, g, mean, 3 * lbd, size))
    monkeypatch.setattr(spaces.NSphereSpace, "von_mises_fisher",
                        lambda self, g, mean, kappa, size: vmf(self, g, mean, kappa / 3, size))
    broken = tiny_run(name, 7)
    assert broken["correct"] is False
    got = broken["compared"]["sample_z"]
    assert got["value"] > got["limit"] > sound["value"]
    assert got["value"] >= 3 * sound["value"]
