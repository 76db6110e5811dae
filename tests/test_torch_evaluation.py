"""cl_ica_tpu_torch.evaluation against cl_ica_tpu.evaluation.

The port keeps its own copy of the evaluation code (numpy + scipy) and of
the native Hungarian solver, so on the same seeded inputs the two give
equal results, exactly: every comparison here is ``==`` on floats or
arrays. Both route n >= 20 to the C++ solver (each package's own build).
"""

import inspect

import numpy as np
import pytest

from cl_ica_tpu import evaluation as jax_eval
from cl_ica_tpu_torch import evaluation as port_eval


def _latents(seed, n_samples=512, n=6):
    """Ground truth z and an entangled, noisy, permuted recovery hz."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n_samples, n)).astype(np.float32)
    mix = np.eye(n)[rng.permutation(n)] * rng.choice([-1.0, 1.0], n)
    mix = mix + 0.1 * rng.normal(size=(n, n))
    hz = (z @ mix + 0.05 * rng.normal(size=z.shape)).astype(np.float32)
    return z, hz


def test_the_port_exports_the_same_names():
    assert sorted(port_eval.__all__) == sorted(jax_eval.__all__)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["r2", "adjusted_r2", "pearson", "spearman"])
@pytest.mark.parametrize("split", [False, True])
def test_linear_disentanglement_is_equal(seed, mode, split):
    z, hz = _latents(seed)
    (want, want_raw), want_pair = jax_eval.linear_disentanglement(
        z, hz, mode=mode, train_test_split=split)
    (got, got_raw), got_pair = port_eval.linear_disentanglement(
        z, hz, mode=mode, train_test_split=split)
    assert got == want
    np.testing.assert_array_equal(got_raw, want_raw)
    for g, w in zip(got_pair, want_pair):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode, solver, rescaling", [
    ("pearson", "munkres", True),   # main_mlp's call
    ("pearson", "munkres", False),
    ("spearman", "munkres", True),
    ("r2", "naive", True),
])
def test_permutation_disentanglement_is_equal(seed, mode, solver, rescaling):
    z, hz = _latents(seed, n=4)
    (want, want_raw), want_hz = jax_eval.permutation_disentanglement(
        z, hz, mode=mode, solver=solver, rescaling=rescaling)
    (got, got_raw), got_hz = port_eval.permutation_disentanglement(
        z, hz, mode=mode, solver=solver, rescaling=rescaling)
    assert got == want
    np.testing.assert_array_equal(got_raw, want_raw)
    np.testing.assert_array_equal(got_hz, want_hz)


@pytest.mark.parametrize("shape", [(1, 1), (4, 4), (10, 10), (5, 8), (8, 5),
                                   (19, 19)])
def test_hungarian_is_equal_below_the_native_threshold(shape):
    cost = np.random.default_rng(sum(shape)).normal(size=shape)
    assert port_eval.hungarian(cost) == jax_eval.hungarian(cost)
    assert (port_eval.Munkres().compute(cost)
            == jax_eval.Munkres().compute(cost))


@pytest.mark.parametrize("shape", [(20, 20), (24, 24), (21, 30), (40, 25),
                                   (64, 64)])
def test_hungarian_takes_the_native_solver_from_20_as_jax(shape):
    """n >= 20 goes to the C++ solver in both packages, assignment for
    assignment (the JAX library is built: the router would otherwise fall
    back to its Python solver); prefer_native forces either route."""
    from cl_ica_tpu.native import native_available

    assert native_available()
    assert (inspect.signature(port_eval.hungarian).parameters["prefer_native"].default
            is None)
    cost = np.random.default_rng(sum(shape)).normal(size=shape)
    got = port_eval.hungarian(cost)
    assert got == jax_eval.hungarian(cost) == jax_eval.hungarian(cost, prefer_native=True)
    assert (port_eval.hungarian(cost, prefer_native=False)
            == jax_eval.hungarian(cost, prefer_native=False))
    want_cost = sum(cost[r, c] for r, c in jax_eval.hungarian(cost, prefer_native=False)
                    if r < shape[0] and c < shape[1])
    got_cost = sum(cost[r, c] for r, c in got if r < shape[0] and c < shape[1])
    assert got_cost == pytest.approx(want_cost, abs=1e-9)
    small = cost[:10, :10]
    assert (port_eval.hungarian(small, prefer_native=True)
            == jax_eval.hungarian(small, prefer_native=True))


def test_hungarian_with_tied_costs_is_equal():
    cost = np.random.default_rng(3).integers(0, 3, size=(7, 7)).astype(float)
    assert port_eval.hungarian(cost) == jax_eval.hungarian(cost)


@pytest.mark.parametrize("method", ["Pearson", "Spearman"])
@pytest.mark.parametrize("extra_rows", [0, 2])
def test_compute_mcc_is_equal(method, extra_rows):
    z, hz = _latents(4, n=5)
    rng = np.random.default_rng(9)
    mus = np.concatenate([hz.T, rng.normal(size=(extra_rows, len(hz)))])
    want = jax_eval.compute_mcc(mus, z.T, correlation_fn=method)
    got = port_eval.compute_mcc(mus, z.T, correlation_fn=method)
    assert got == want
    for g, w in zip(port_eval.correlation(hz.T, z.T, method),
                    jax_eval.correlation(hz.T, z.T, method)):
        np.testing.assert_array_equal(g, w)


def test_r2_score_and_sap_are_equal():
    z, hz = _latents(6)
    assert port_eval.r2_score(z, hz) == jax_eval.r2_score(z, hz)
    assert port_eval.compute_sap(hz.T, z.T) == jax_eval.compute_sap(hz.T, z.T)


def test_pad_matrix_is_equal():
    rows = [[1.0, 2.0, 3.0], [4.0, 5.0]]
    assert (port_eval.Munkres().pad_matrix(rows, 7)
            == jax_eval.Munkres().pad_matrix(rows, 7))
