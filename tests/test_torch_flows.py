"""cl_ica_tpu_torch.models.flows against cl_ica_tpu.models.flows.

The same numpy inputs go through the Flax flow and the port's, whose
parameters come from the Flax variables through flow_params_from_flax:
forward, log-det and inverse within 1e-5 relative to the largest value
(absolute for GIN's log-det, which is 0 up to rounding). Then the JAX
package's own flow contracts on the port: exact inverses, GIN volume
preserving, GLOW's log-det equal to the Jacobian's (torch.func.jacrev),
the identity initialisation, the frozen mixing, n_in == n_out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.models import flows as jax_flows
from cl_ica_tpu_torch.models import (
    CouplingFlow,
    FrozenFlow,
    construct_invertible_flow,
    flow_params_from_flax,
    get_flow,
)

torch.set_num_threads(1)
BAR = 1e-5


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _pair(n, coupling, init_identity, num_nodes, seed=0):
    """The Flax flow and its variables, and the port's flow holding them.
    The variables are the Flax init's tree (``jax.eval_shape``) filled by
    numpy at Flax's Dense scale, 1/sqrt(fan_in) (biases 0.01), with the subnets' last
    layers zero under ``init_identity`` (as the Flax init makes them): eager
    Flax calls on them take a second, where jitting each case took four."""
    jf = jax_flows.get_flow(n, n, init_identity, coupling, num_nodes)
    shapes = jax.eval_shape(jf.init, jax.random.PRNGKey(seed), jnp.zeros((1, n)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(k, "key", None) for k in path]
        if init_identity and "Dense_2" in names:
            return np.zeros(leaf.shape, np.float32)
        fan_in = leaf.shape[0] if names[-1] == "kernel" else 1
        scale = 1.0 / np.sqrt(fan_in) if names[-1] == "kernel" else 0.01
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tf = get_flow(n, n, init_identity, coupling, num_nodes)
    tf.load_state_dict(flow_params_from_flax(variables))
    return jf, variables, tf


@pytest.mark.parametrize("init_identity", [False, True])
@pytest.mark.parametrize("n", [2, 3, 10])
@pytest.mark.parametrize("coupling", ["gin", "glow"])
def test_flow_matches_jax(coupling, n, init_identity):
    # 4 blocks: at 8 the float32 round trip of either package loses digits
    # at random weights (values of order 1e3-1e4), so the inverses would be
    # compared in their rounding
    jf, variables, tf = _pair(n, coupling, init_identity, num_nodes=4)
    x = np.random.default_rng(n).normal(size=(64, n)).astype(np.float32)
    y_j, ld_j = jf.apply(variables, x, method=jax_flows.CouplingFlow.forward)
    with torch.no_grad():
        y_t, ld_t = tf.forward_with_logdet(torch.from_numpy(x))
        x_t = tf.inverse(torch.from_numpy(np.array(y_j)))
    assert rel_err(y_t.numpy(), y_j) <= BAR
    if init_identity:
        np.testing.assert_array_equal(y_t.numpy(), x)
        np.testing.assert_array_equal(ld_t.numpy(), 0.0)
    elif coupling == "gin":
        assert np.max(np.abs(ld_t.numpy() - np.asarray(ld_j))) <= BAR
    else:
        assert rel_err(ld_t.numpy(), ld_j) <= BAR
    assert rel_err(x_t.numpy(), jf.apply(
        variables, y_j, method=jax_flows.CouplingFlow.inverse)) <= BAR
    # the call is the Flax module's __call__: y alone
    with torch.no_grad():
        np.testing.assert_array_equal(tf(torch.from_numpy(x)).numpy(), y_t.numpy())


def test_flow_matches_jax_at_eight_blocks():
    """The default depth, forward and log-det (the inverse is the 4-block
    case's: each block's inverse is held there)."""
    for coupling in ("gin", "glow"):
        jf, variables, tf = _pair(10, coupling, False, num_nodes=8, seed=3)
        x = np.random.default_rng(1).normal(size=(256, 10)).astype(np.float32)
        y_j, ld_j = jf.apply(variables, x, method=jax_flows.CouplingFlow.forward)
        with torch.no_grad():
            y_t, ld_t = tf.forward_with_logdet(torch.from_numpy(x))
        assert rel_err(y_t.numpy(), y_j) <= BAR, coupling
        if coupling == "glow":
            assert rel_err(ld_t.numpy(), ld_j) <= BAR


@pytest.mark.parametrize("coupling", ["gin", "glow"])
@pytest.mark.parametrize("n", [4, 7])
def test_flow_invertible(coupling, n):
    flow = get_flow(n, n, coupling_block=coupling, num_nodes=4,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(16, n, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, logdet = flow.forward_with_logdet(x)
        x_rec = flow.inverse(y)
    assert y.shape == x.shape and logdet.shape == (16,)
    np.testing.assert_allclose(x_rec.numpy(), x.numpy(), rtol=1e-4, atol=1e-5)


def _jacobians(flow, x):
    return torch.stack([torch.func.jacrev(lambda v: flow(v[None])[0])(row)
                        for row in x])


def test_gin_volume_preserving():
    flow = get_flow(6, 6, coupling_block="gin", num_nodes=3,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    _, logdet = flow.forward_with_logdet(x)
    np.testing.assert_allclose(logdet.detach().numpy(), 0.0, atol=1e-5)
    det = torch.linalg.det(_jacobians(flow, x).double())
    np.testing.assert_allclose(det.abs().detach().numpy(), 1.0, rtol=1e-4)


def test_glow_logdet_matches_jacobian():
    flow = get_flow(4, 4, coupling_block="glow", num_nodes=2,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(2))
    _, logdet = flow.forward_with_logdet(x)
    _, logabsdet = torch.linalg.slogdet(_jacobians(flow, x).double())
    np.testing.assert_allclose(logdet.detach().numpy(), logabsdet.detach().numpy(),
                               rtol=1e-3, atol=1e-4)


def test_identity_init():
    flow = get_flow(6, 6, init_identity=True, num_nodes=4)
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(flow(x).detach().numpy(), x.numpy(), atol=1e-6)
    # only the subnets' last layers start at zero
    assert float(flow.blocks[0].subnet1.denses[0].weight.detach().abs().max()) > 0


def test_frozen_flow_mixing():
    g = construct_invertible_flow(5, generator=torch.Generator().manual_seed(0))
    assert isinstance(g, FrozenFlow) and isinstance(g.flow, CouplingFlow)
    assert not any(p.requires_grad for p in g.parameters())
    x = torch.randn(10, 5, generator=torch.Generator().manual_seed(3),
                    requires_grad=True)
    y = g(x)
    assert y.shape == (10, 5)
    y.sum().backward()  # the input still takes a gradient
    assert x.grad is not None and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(g.inverse(y).detach().numpy(), x.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    # without a generator the seed comes from numpy's global generator
    np.random.seed(7)
    a = construct_invertible_flow(5)
    np.random.seed(7)
    b = construct_invertible_flow(5)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_get_flow_requires_square():
    with pytest.raises(AssertionError):
        jax_flows.get_flow(4, 5)
    with pytest.raises(ValueError, match="n_in 4 != n_out 5"):
        get_flow(4, 5)
    with pytest.raises(ValueError, match="coupling_block"):
        get_flow(4, 4, coupling_block="nice")


def test_soft_clamp_keeps_the_jax_constant():
    """0.636, not 2/π: the log-scale's bound is 2·0.636·π/2."""
    from cl_ica_tpu_torch.models.flows import _soft_scale

    s = np.array([-1e6, -3.0, 0.0, 0.5, 1e6], dtype=np.float32)
    np.testing.assert_array_equal(
        _soft_scale(torch.from_numpy(s)).numpy(),
        np.asarray(jax_flows._soft_scale(jnp.asarray(s))))


def test_converter_refuses_unknown_parameters():
    with pytest.raises(KeyError, match="CouplingFlow"):
        flow_params_from_flax({"params": {"blocks_0": {"subnet3": {}}}})
    with pytest.raises(KeyError, match="CouplingFlow"):
        flow_params_from_flax({"params": {"head": {}}})
