"""cl_ica_tpu_torch.spaces against the JAX package's samplers.

Deterministic transforms are compared value for value. Torch and JAX
random streams never match, so samplers are compared by distribution:
moments and a two-sample KS test at 20k draws against the JAX sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

from cl_ica_tpu import spaces as jsp
from cl_ica_tpu_torch import spaces as tsp
from cl_ica_tpu_torch.spaces import utils as tsu

torch.set_num_threads(1)

DRAWS = 20_000


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_spherical_to_cartesian_matches():
    # float32 sin/cos/cumprod of two libraries: 2 ulps of the unit radius
    rng = np.random.default_rng(0)
    phi = rng.uniform(0, np.pi, size=(64, 5)).astype(np.float32)
    phi[:, -1] *= 2
    r = rng.uniform(0.5, 2, size=64).astype(np.float32)
    want = np.asarray(jsp.spherical_to_cartesian(jnp.asarray(r), jnp.asarray(phi)))
    got = tsp.spherical_to_cartesian(torch.tensor(r), torch.tensor(phi)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    flat = tsp.spherical_to_cartesian(1.0, torch.tensor(phi[0])).numpy()
    np.testing.assert_allclose(flat, np.asarray(jsp.spherical_to_cartesian(1.0, phi[0])),
                               rtol=0, atol=5e-7)


def test_cartesian_to_spherical_matches():
    x = np.random.default_rng(1).normal(size=(64, 6)).astype(np.float32)
    x[0, -1] = 0.0  # the 2π wrap of the last angle at x[-1] <= 0
    wr, wphi = jsp.cartesian_to_spherical(jnp.asarray(x))
    gr, gphi = tsp.cartesian_to_spherical(torch.tensor(x))
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-6, atol=0)
    np.testing.assert_allclose(gphi.numpy(), np.asarray(wphi), rtol=0, atol=2e-6)
    back = tsp.spherical_to_cartesian(gr, gphi).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=2e-5)


def _box():
    return tsp.NBoxSpace(4, 0.0, 1.0), jsp.NBoxSpace(4, 0.0, 1.0)


SAMPLERS = {
    # name: (torch sampler(generator), jax sampler(key)), each -> (DRAWS, n)
    "uniform": (lambda g: tsp.NBoxSpace(3, -1.0, 2.0).uniform(g, DRAWS),
                lambda k: jsp.NBoxSpace(3, -1.0, 2.0).uniform(k, DRAWS)),
    "normal": (lambda g: tsp.NRealSpace(3).normal(g, [0.5, 0, -1], 2.0, DRAWS),
               lambda k: jsp.NRealSpace(3).normal(k, jnp.array([0.5, 0, -1]), 2.0, DRAWS)),
    "laplace": (lambda g: tsp.NRealSpace(3).laplace(g, [0.0, 1, 0], 1.5, DRAWS),
                lambda k: jsp.NRealSpace(3).laplace(k, jnp.array([0.0, 1, 0]), 1.5, DRAWS)),
    "gennormal3": (
        lambda g: tsp.NRealSpace(3).generalized_normal(g, [0.0, 0, 0], 1.0, 3, DRAWS),
        lambda k: jsp.NRealSpace(3).generalized_normal(k, jnp.zeros(3), 1.0, 3, DRAWS)),
    "box_laplace": (
        lambda g: tsp.NBoxSpace(3, 0.0, 1.0).laplace(g, [0.02, 0.5, 0.98], 0.05, DRAWS),
        lambda k: jsp.NBoxSpace(3, 0.0, 1.0).laplace(k, jnp.array([0.02, 0.5, 0.98]), 0.05, DRAWS)),
    # the cosine to the mean direction carries the whole vMF distribution
    "vmf20": (lambda g: tsp.NSphereSpace(10).von_mises_fisher(g, np.eye(10)[0], 20.0, DRAWS),
              lambda k: jsp.NSphereSpace(10).von_mises_fisher(k, jnp.eye(10)[0], 20.0, DRAWS)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_jax_distribution(name):
    # Fixed seeds make the outcome deterministic; the KS bar p > 1e-3 and
    # means/stds within 5 standard errors hold for samplers that agree
    t_fn, j_fn = SAMPLERS[name]
    got = t_fn(_gen(1)).numpy().astype(np.float64)
    want = np.asarray(jax.jit(j_fn)(jax.random.PRNGKey(1)), dtype=np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    cols = [0] if name == "vmf20" else range(got.shape[1])
    for c in cols:
        a, b = got[:, c], want[:, c]
        assert sps.ks_2samp(a, b).pvalue > 1e-3, (name, c)
        se = np.std(b) / np.sqrt(len(b))
        assert abs(np.mean(a) - np.mean(b)) < 5 * np.sqrt(2) * se, (name, c)
        assert abs(np.std(a) / np.std(b) - 1) < 0.05, (name, c)


@pytest.mark.parametrize("alpha", [1 / 3, 1.0, 4.5])
def test_gamma_sampler_matches_scipy(alpha):
    x = tsu.sample_gamma(_gen(2), alpha, (DRAWS,)).numpy()
    assert np.all(x > 0)
    assert sps.kstest(x, "gamma", args=(alpha,)).pvalue > 1e-3


@pytest.mark.parametrize("cond", ["normal", "laplace", "gennormal"])
def test_box_conditionals_stay_in_the_box(cond):
    space = tsp.NBoxSpace(5, 0.0, 1.0)
    z = space.uniform(_gen(3), 512)
    g = _gen(4)
    x = {"normal": lambda: space.normal(g, z, 0.3, 512),
         "laplace": lambda: space.laplace(g, z, 0.3, 512),
         "gennormal": lambda: space.generalized_normal(g, z, 0.3, 3, 512)}[cond]()
    assert x.shape == (512, 5)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


@pytest.mark.parametrize("cond", ["uniform", "normal", "laplace", "vmf"])
def test_sphere_samples_have_unit_norm(cond):
    space = tsp.NSphereSpace(6)
    g = _gen(5)
    z = space.uniform(g, 512)
    x = {"uniform": lambda: z,
         "normal": lambda: space.normal(g, z, 0.2, 512),
         "laplace": lambda: space.laplace(g, z, 0.2, 512),
         "vmf": lambda: space.von_mises_fisher(g, z, 20.0, 512)}[cond]()
    np.testing.assert_allclose(torch.linalg.norm(x, dim=-1).numpy(), 1.0, atol=1e-5)


def test_rej_mult_takes_a_per_row_mean():
    """ROADMAP C2: with rej_mult > 1 the JAX box conditionals add a
    (size, n) mean to (rej_mult*size, n) proposals and fail to broadcast;
    the port tiles the mean, and the distribution does not change."""
    mean = torch.full((DRAWS // 4, 2), 0.9)
    mean[:, 1] = 0.1
    one = tsp.NBoxSpace(2, 0.0, 1.0).laplace(_gen(6), mean, 0.2, DRAWS // 4)
    three = tsp.NBoxSpace(2, 0.0, 1.0, rej_mult=3).laplace(_gen(7), mean, 0.2, DRAWS // 4)
    assert three.shape == one.shape
    assert float(three.min()) >= 0.0 and float(three.max()) <= 1.0
    for c in range(2):
        assert sps.ks_2samp(one[:, c].numpy(), three[:, c].numpy()).pvalue > 1e-3
    with pytest.raises((TypeError, ValueError)):
        jsp.NBoxSpace(2, 0.0, 1.0, rej_mult=3).laplace(
            jax.random.PRNGKey(0), jnp.asarray(mean.numpy()), 0.2, DRAWS // 4)


def test_samplers_use_only_their_generator():
    state = torch.get_rng_state()
    box = tsp.LatentSpace(tsp.NBoxSpace(3, 0.0, 1.0),
                          lambda sp, g, s: sp.uniform(g, s),
                          lambda sp, g, z, s: sp.laplace(g, z, 0.1, s))
    sph = tsp.LatentSpace(tsp.NSphereSpace(4),
                          lambda sp, g, s: sp.uniform(g, s),
                          lambda sp, g, z, s: sp.von_mises_fisher(g, z, 10.0, s))
    prod = tsp.ProductLatentSpace([box, sph])
    a = prod.sample_pair(_gen(8), 64)
    b = prod.sample_pair(_gen(8), 64)
    assert torch.equal(torch.get_rng_state(), state)
    assert prod.dim == 7 and a[0].shape == a[1].shape == (64, 7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[1][:, :3].min()) >= 0.0 and float(a[1][:, :3].max()) <= 1.0
    np.testing.assert_allclose(torch.linalg.norm(a[1][:, 3:], dim=-1).numpy(), 1.0,
                               atol=1e-5)
