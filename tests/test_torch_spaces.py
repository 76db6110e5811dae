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
from cl_ica_tpu_torch.spaces import vmf as vmf_mod

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
    # every marginal and conditional that main_mlp's build_latent_space
    # builds: sphere uniform / Normal / Laplace, box Normal / generalized
    # normal p=3 / uniform on [-1, 1], the unbounded generalized normal
    "sphere_uniform": (lambda g: tsp.NSphereSpace(5).uniform(g, DRAWS),
                       lambda k: jsp.NSphereSpace(5).uniform(k, DRAWS)),
    "sphere_normal": (
        lambda g: tsp.NSphereSpace(5).normal(g, np.eye(5)[0], 0.3, DRAWS),
        lambda k: jsp.NSphereSpace(5).normal(k, jnp.eye(5)[0], 0.3, DRAWS)),
    "sphere_laplace": (
        lambda g: tsp.NSphereSpace(5).laplace(g, np.eye(5)[0], 0.3, DRAWS),
        lambda k: jsp.NSphereSpace(5).laplace(k, jnp.eye(5)[0], 0.3, DRAWS)),
    "box_normal": (
        lambda g: tsp.NBoxSpace(3, 0.0, 1.0).normal(g, [0.02, 0.5, 0.98], 0.1, DRAWS),
        lambda k: jsp.NBoxSpace(3, 0.0, 1.0).normal(k, jnp.array([0.02, 0.5, 0.98]), 0.1, DRAWS)),
    "box_gennormal3": (
        lambda g: tsp.NBoxSpace(3, 0.0, 1.0).generalized_normal(
            g, [0.02, 0.5, 0.98], 0.1, 3, DRAWS),
        lambda k: jsp.NBoxSpace(3, 0.0, 1.0).generalized_normal(
            k, jnp.array([0.02, 0.5, 0.98]), 0.1, 3, DRAWS)),
    "box_uniform_pm1": (lambda g: tsp.NBoxSpace(3, -1.0, 1.0).uniform(g, DRAWS),
                        lambda k: jsp.NBoxSpace(3, -1.0, 1.0).uniform(k, DRAWS)),
    "gennormal05": (
        lambda g: tsp.NRealSpace(3).generalized_normal(g, [0.0, 0, 0], 1.0, 0.5, DRAWS),
        lambda k: jsp.NRealSpace(3).generalized_normal(k, jnp.zeros(3), 1.0, 0.5, DRAWS)),
    # the cosine to the mean direction carries the whole vMF distribution
    **{f"vmf{kappa:g}": (
        lambda g, kappa=kappa: tsp.NSphereSpace(10).von_mises_fisher(
            g, np.eye(10)[0], kappa, DRAWS),
        lambda k, kappa=kappa: jsp.NSphereSpace(10).von_mises_fisher(
            k, jnp.eye(10)[0], kappa, DRAWS))
       for kappa in (1.0, 5.0, 20.0, 100.0, 500.0)},
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_jax_distribution(name):
    # Fixed seeds make the outcome deterministic; the KS bar p > 1e-3 and
    # means/stds within 5 standard errors hold for samplers that agree
    t_fn, j_fn = SAMPLERS[name]
    got = t_fn(_gen(1)).numpy().astype(np.float64)
    want = np.asarray(jax.jit(j_fn)(jax.random.PRNGKey(1)), dtype=np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    cols = [0] if name.startswith("vmf") else range(got.shape[1])
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


# ---------------------------------------------------------------------------
# the fixed rounds of the rejection samplers
# ---------------------------------------------------------------------------

B, N, STEPS = 6144, 10, 300_000  # main_mlp's batch and width, a long run
MC = 1_000_000


def _lower(hits: np.ndarray) -> float:
    """A Monte Carlo acceptance rate less five standard errors."""
    p = float(np.mean(hits))
    return p - 5 * np.sqrt(p * (1 - p) / hits.size)


def _gamma_rate(a: float) -> float:
    rng = np.random.default_rng(0)
    d = a - 1 / 3
    c = 1 / np.sqrt(9 * d)
    x, u = rng.normal(size=MC), rng.uniform(size=MC)
    v = (1 + c * x) ** 3
    with np.errstate(invalid="ignore", divide="ignore"):
        ok = (v > 0) & (np.log(u) < 0.5 * x * x + d - d * v + d * np.log(v))
    return _lower(ok)


def _wood_rate(kappa: float, dim: int) -> float:
    rng = np.random.default_rng(1)
    d = dim - 1
    b = d / (np.sqrt(4 * kappa**2 + d**2) + 2 * kappa)
    x = (1 - b) / (1 + b)
    c = kappa * x + d * np.log(1 - x**2)
    z = rng.beta(d / 2, d / 2, size=MC)
    w = (1 - (1 + b) * z) / (1 - (1 - b) * z)
    return _lower(kappa * w + d * np.log(1 - x * w) - c >= np.log(rng.uniform(size=MC)))


def _box_rate(kind: str, scale: float, width: float = 1.0) -> float:
    """A mean on the wall: half the mass of |noise| <= width."""
    dist = {"laplace": sps.laplace(scale=scale), "normal": sps.norm(scale=scale),
            "gennormal3": sps.gennorm(3, scale=scale)}[kind]
    return dist.cdf(width) - 0.5


def _sites(config: str):
    """(acceptance from an independent estimate, elements, rounds the
    sampler draws) of every rejection draw of one step of main_mlp at
    n = 10, B = 6144, with --c-param as given."""
    kind, param = config.split(":")
    param = float(param)
    if kind == "vmf":
        wood = tsu.rounds_for(vmf_mod.wood_acceptance(param, N), B)
        beta = (wood, B)  # each Beta proposal is two Gamma(9/2) draws
        rounds = tsu.rounds_for(tsu.gamma_acceptance(4.5), wood * B)
        return [(_wood_rate(param, N), B, wood)] + [(_gamma_rate(4.5), wood * B, rounds)] * 2
    p, lbd = {"laplace": (1.0, param), "normal": (2.0, param * np.sqrt(2)),
              "gennormal3": (3.0, param)}[kind]
    k = tsu.rounds_for(tsu.box_acceptance(p, lbd, 1.0), B * N)
    sites = [(_box_rate(kind, param), B * N, k)]
    if kind == "gennormal3":  # Gamma(1/3) under every proposal, boosted to 4/3
        sites.append((_gamma_rate(4 / 3), k * B * N,
                      tsu.rounds_for(tsu.gamma_acceptance(4 / 3), k * B * N)))
    return sites


@pytest.mark.parametrize("config", [
    "vmf:1", "vmf:5", "vmf:20", "vmf:100", "vmf:500",
    "laplace:0.05", "laplace:1", "normal:0.05", "normal:1", "gennormal3:0.05",
    "gennormal3:1",
])
def test_rounds_keep_a_fallback_below_one_in_a_million_runs(config):
    """Each draw's rounds R, from the sampler's own acceptance rate, make
    the chance that any element of a B = 6144 step falls back during a
    300k-step run, elements · steps · (1 - rate)^R summed over the step's
    draws, below 1e-6, with the rate taken from an estimate independent
    of the sampler's (Monte Carlo less five standard errors, or the
    noise's CDF with the mean on the box's wall)."""
    chance = 0.0
    for rate, elements, rounds in _sites(config):
        chance += elements * STEPS * (1.0 - rate) ** rounds
    assert chance < 1e-6, (config, _sites(config))


def test_rounds_are_what_the_budget_needs():
    """rounds_for is the least R with elements·RUN_STEPS·(1-a)^R below the
    budget: one round fewer misses it."""
    for a, elements in ((0.95, 61440), (0.5, 61440), (0.775, 6144)):
        r = tsu.rounds_for(a, elements)
        assert elements * tsu.RUN_STEPS * (1 - a) ** r < tsu.FALLBACK_BUDGET
        assert elements * tsu.RUN_STEPS * (1 - a) ** (r - 1) >= tsu.FALLBACK_BUDGET


def test_fallbacks_are_counted_on_the_device_and_keep_the_jax_values(monkeypatch):
    """With one round, a box far narrower than the noise leaves elements
    unaccepted: they take the JAX loop's final value (0 clipped into the
    box; Wood's w = x), the count says how many, and a reset zeros it in
    place."""
    tsu.reset_fallback_counts()
    count = tsu.fallback_count("cpu")
    monkeypatch.setattr(tsu, "rounds_for", lambda acceptance, elements: 1)
    space = tsp.NBoxSpace(4, 0.5, 0.51)
    x = space.laplace(_gen(9), torch.full((256, 4), 0.505), 1.0, 256)
    missed = int(count)
    assert 0 < missed < x.numel()
    assert int((x == 0.5).sum()) >= missed  # 0 clipped into [0.5, 0.51]
    tsu.reset_fallback_counts()
    assert tsu.fallback_count("cpu") is count and int(count) == 0
    monkeypatch.undo()  # the Gamma draws' rounds as they are; Wood's cut to 1
    monkeypatch.setattr(vmf_mod, "rounds_for", lambda acceptance, elements: 1)
    w = vmf_mod._sample_weights(_gen(10), 500.0, 10, 4096)
    b, x0, _ = vmf_mod._wood_constants(500.0, 9)
    assert int(count) == int((w == np.float32(x0)).sum()) > 0


def test_rounds_follow_the_configuration():
    """A wider noise in the box, or a vMF further from uniform, takes more
    rounds; --rej-mult rounds them up to whole rounds of its candidates."""
    assert tsu.rounds_for(tsu.box_acceptance(1.0, 1.0, 1.0), 100) > tsu.rounds_for(
        tsu.box_acceptance(1.0, 0.05, 1.0), 100)
    assert tsu.rounds_for(vmf_mod.wood_acceptance(500.0, 10), 100) > tsu.rounds_for(
        vmf_mod.wood_acceptance(1.0, 10), 100)
    seen = []
    sampler = lambda g, s: seen.append(s) or torch.rand((s, 2), generator=g)
    tsu.truncated_rejection_resampling(sampler, _gen(11), 0.0, 1.0, 8, 2, 0.5,
                                       buffer_size_factor=3)
    k = tsu.rounds_for(0.5, 16)
    assert seen == [8 * (-(-k // 3) * 3)]
