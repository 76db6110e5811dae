"""cl_ica_tpu_torch.models against the JAX package's models.

Mixing weights come from the same numpy construction and must be
bit-equal. The encoder gets the Flax parameters through
encoder_params_from_flax and must give the same outputs and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.models import construct_invertible_mlp as jax_construct
from cl_ica_tpu.models import get_mlp as jax_get_mlp
from cl_ica_tpu.models.invertible import _ACTS as JAX_ACTS
from cl_ica_tpu.models.layers import RescaleLayer as JaxRescaleLayer
from cl_ica_tpu_torch.models import (
    RescaleLayer,
    construct_invertible_mlp,
    encoder_params_from_flax,
    encoder_params_to_flax,
    get_mlp,
)
from cl_ica_tpu_torch.models.invertible import _ACTS

torch.set_num_threads(1)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("init", ["pcl", "rvs"])
def test_mixing_weights_bit_equal(init):
    kw = dict(n=5, n_layers=3, n_iter_cond_thresh=500, cond_thresh_ratio=0.25,
              weight_matrix_init=init)
    want = jax_construct(rng=np.random.default_rng(4), **kw)
    got = construct_invertible_mlp(rng=np.random.default_rng(4), **kw)
    assert len(got.weights) == len(want.weights) == 3
    for g, w in zip(got.weights, want.weights):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_activation_tables_agree():
    assert set(_ACTS) == set(JAX_ACTS)


@pytest.mark.parametrize("act", sorted(_ACTS))
def test_mixing_forward_matches(act):
    # 1e-6 relative to the largest output: float32 matmuls summed in
    # different orders (the slopes are 0.2 for the mixing's leaky relus)
    kw = dict(n=6, n_layers=3, n_iter_cond_thresh=500, cond_thresh_ratio=0.25,
              act_fct=act)
    jg = jax_construct(rng=np.random.default_rng(1), **kw)
    tg = construct_invertible_mlp(rng=np.random.default_rng(1), **kw)
    z = np.random.default_rng(2).normal(size=(64, 6)).astype(np.float32)
    assert rel_err(tg(torch.tensor(z)).numpy(), jg(jnp.asarray(z))) <= 1e-6


ENCODERS = [
    dict(),
    dict(output_normalization="learnable_sphere"),
    dict(output_normalization="learnable_box"),
    dict(output_normalization="fixed_sphere"),
    dict(layer_normalization="gn"),
    dict(layer_normalization="bn"),
    dict(layer_normalization="bn", output_normalization="learnable_box"),
]


def _pair(kw, seed=0):
    jf = jax_get_mlp(4, 4, [8, 16, 8], **kw)
    x = np.random.default_rng(seed).normal(size=(32, 4)).astype(np.float32)
    jvars = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    tf = get_mlp(4, 4, [8, 16, 8], **kw)
    tf.load_state_dict(encoder_params_from_flax(jvars))
    return jf, jvars, tf, x


@pytest.mark.parametrize("kw", ENCODERS, ids=lambda kw: "-".join(kw.values()) or "plain")
@pytest.mark.parametrize("train", [False, True])
def test_encoder_matches_flax(kw, train):
    # outputs to 1e-5 and grads to 1e-4 relative to their largest entry:
    # float32 matmuls and norm statistics summed in different orders
    jf, jvars, tf, x = _pair(kw)
    cot = np.random.default_rng(9).normal(size=(32, 4)).astype(np.float32)
    bn = kw.get("layer_normalization") == "bn"

    def jax_obj(params):
        vars_ = {**jvars, "params": params}
        if bn and train:
            out, _ = jf.apply(vars_, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        else:
            out = jf.apply(vars_, jnp.asarray(x), train=train)
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.value_and_grad(jax_obj, has_aux=True)(jvars["params"])

    tf.train(train)
    out = tf(torch.tensor(x))
    (out * torch.tensor(cot)).sum().backward()
    assert rel_err(out.detach().numpy(), want) <= 1e-5

    grads = encoder_params_from_flax({"params": jax.tree.map(np.asarray, want_grads)}
                                     | ({"batch_stats": jvars["batch_stats"]} if bn else {}))
    named = dict(tf.named_parameters())
    assert set(named) <= set(grads)
    largest = max(float(np.max(np.abs(g.numpy()))) for g in grads.values())
    for name, p in named.items():
        got, w = p.grad.numpy(), grads[name].numpy()
        if bn and train and name.startswith("linears.") and name.endswith(".bias") \
                and int(name.split(".")[1]) < len(tf.linears) - 1:
            # batch statistics remove a bias feeding batch norm: its true
            # gradient is 0 and both packages return rounding noise
            assert max(np.max(np.abs(got)), np.max(np.abs(w))) <= 1e-5 * largest
            continue
        assert rel_err(got, w) <= 1e-4, name


@pytest.mark.parametrize("kw", ENCODERS, ids=lambda kw: "-".join(kw.values()) or "plain")
def test_converter_round_trip_is_exact(kw):
    _, jvars, tf, _ = _pair(kw, seed=3)
    back = encoder_params_to_flax(tf.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jvars)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jvars)):
        np.testing.assert_array_equal(a, b)
    sd = encoder_params_from_flax(back)
    for k, v in tf.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_encoder_init_uses_only_its_generator():
    state = torch.get_rng_state()
    a = get_mlp(4, 4, [8, 8], generator=torch.Generator().manual_seed(5))
    b = get_mlp(4, 4, [8, 8], generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q)
    for lin in a.linears:
        bound = 1 / np.sqrt(lin.in_features)
        assert float(lin.weight.detach().abs().max()) <= bound
        assert float(lin.bias.detach().abs().max()) <= bound


def test_rescale_leq_matches_flax():
    x = np.random.default_rng(6).normal(size=(16, 3)).astype(np.float32) * 2
    jl = JaxRescaleLayer(init_r=1.5, fixed_r=True, mode="leq")
    want = jl.apply({}, jnp.asarray(x))
    got = RescaleLayer(init_r=1.5, fixed_r=True, mode="leq")(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
