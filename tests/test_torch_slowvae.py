"""cl_ica_tpu_torch's SlowVAE loss, ConvDecoder64 and positional encodings
against the JAX package's.

SlowVAELoss: the same numpy latents, encodings, decoder and mixing, and
the same reparametrisation noise (jax.random.normal(key), handed to the
port by replacing its ``_reparametrize`` in the test only): the total and
the three components within 1e-5 relative, the gradients with respect to
the encodings within 1e-4 (jax.grad against autograd), for the bernoulli
and gaussian decoders and gaussian with no_sigmoid. ConvDecoder64 with
the Flax variables converted (conv_decoder_params_from_flax): the output,
(B, nc, 34, 34) as the JAX module's (B, 34, 34, nc), within 1e-5, the
parameter gradients within 1e-4. The positional encodings exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.losses.slowvae import SlowVAELoss as JaxSlowVAELoss
from cl_ica_tpu.models import conv as jax_conv
from cl_ica_tpu.models import layers as jax_layers
from cl_ica_tpu_torch.losses import SlowVAELoss
from cl_ica_tpu_torch.models import (
    ConvDecoder64,
    PositionalEncoding,
    PositionalEncoding2D,
    conv_decoder_params_from_flax,
)

torch.set_num_threads(1)
N, B, D = 3, 16, 5


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(z1=f32(B, N), z2=f32(B, N), z1_rec=f32(B, 2 * N, scale=0.5),
                z2_rec=f32(B, 2 * N, scale=0.5), dec=f32(N, D), mix=f32(N, D),
                noise=np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (2 * B, N))))


@pytest.mark.parametrize("decoder_dist, no_sigmoid", [
    ("bernoulli", False), ("gaussian", False), ("gaussian", True)])
def test_slowvae_loss_matches_jax(decoder_dist, no_sigmoid, monkeypatch):
    v = _inputs()
    kw = dict(gamma=10.0, beta=1.0, rate_prior=6.0, n=N,
              decoder_dist=decoder_dist, no_sigmoid=no_sigmoid)
    # a linear decoder and a sigmoid mixing (a Bernoulli target lies in [0, 1])
    jloss = JaxSlowVAELoss(dec_h=lambda z: z @ v["dec"],
                           g=lambda z: jax.nn.sigmoid(z @ v["mix"]), **kw)
    tdec, tmix = torch.from_numpy(v["dec"]), torch.from_numpy(v["mix"])
    tloss = SlowVAELoss(dec_h=lambda z: z @ tdec,
                        g=lambda z: torch.sigmoid(z @ tmix), **kw)
    noise = torch.from_numpy(np.array(v["noise"]))
    monkeypatch.setattr(SlowVAELoss, "_reparametrize", staticmethod(
        lambda generator, mu, logvar: mu + torch.exp(logvar / 2.0) * noise))

    def jax_total(z1_rec, z2_rec):
        total, per_item, comps = jloss(v["z1"], v["z2"], None, z1_rec, z2_rec,
                                       None, key=jax.random.PRNGKey(0))
        return total, (per_item, comps)

    (want, (want_item, want_comps)), want_grads = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(v["z1_rec"], v["z2_rec"])
    z1_rec = torch.tensor(v["z1_rec"], requires_grad=True)
    z2_rec = torch.tensor(v["z2_rec"], requires_grad=True)
    got, got_item, got_comps = tloss(
        torch.from_numpy(v["z1"]), torch.from_numpy(v["z2"]), None, z1_rec,
        z2_rec, None, generator=torch.Generator().manual_seed(0))
    got.backward()
    assert rel_err(got.detach(), want) <= 1e-5
    for g, w in zip(got_comps, want_comps):
        assert rel_err(g.detach(), w) <= 1e-5
    assert got_item.shape == (B,) and torch.isnan(got_item).all()
    assert np.isnan(np.asarray(want_item)).all()
    for g, w in zip((z1_rec.grad, z2_rec.grad), want_grads):
        assert rel_err(g, w) <= 1e-4


def test_slowvae_loss_needs_a_generator_and_the_latent_width():
    loss = SlowVAELoss(dec_h=lambda z: z, n=N, decoder_dist="gaussian")
    z = torch.zeros(4, N)
    zr = torch.zeros(4, 2 * N)
    with pytest.raises(ValueError, match="torch.Generator"):
        loss(z, z, None, zr, zr, None)
    with pytest.raises(ValueError, match="width"):
        loss(torch.zeros(4, N + 1), z, None, zr, zr, None,
             generator=torch.Generator())
    # the reparametrisation draws from the generator it is given
    a = loss(z, z, None, zr, zr, None, generator=torch.Generator().manual_seed(1))
    b = loss(z, z, None, zr, zr, None, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0])


def _decoder_pair(nc, seed=0):
    """The Flax decoder's variables (its init's tree, filled by numpy) and
    the port's decoder holding them."""
    jd = jax_conv.ConvDecoder64(z_dim=10, nc=nc)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    rng = np.random.default_rng(seed)

    def fill(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 100
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    variables = jax.tree.map(fill, shapes)
    td = ConvDecoder64(z_dim=10, nc=nc)
    td.load_state_dict(conv_decoder_params_from_flax(variables))
    return jd, variables, td


@pytest.mark.parametrize("nc", [1, 3])
def test_conv_decoder_matches_jax(nc):
    jd, variables, td = _decoder_pair(nc)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(4, 10)).astype(np.float32)
    ct = rng.normal(size=(4, 34, 34, nc)).astype(np.float32)

    def objective(params):
        out = jd.apply({"params": params}, z)
        return jnp.sum(out * ct), out

    (_, want), grads = jax.value_and_grad(objective, has_aux=True)(variables["params"])
    out = td(torch.from_numpy(z))
    assert out.shape == (4, nc, 34, 34) and want.shape == (4, 34, 34, nc)
    assert rel_err(out.detach().permute(0, 2, 3, 1), want) <= 1e-5
    (out * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    want_grads = conv_decoder_params_from_flax(jax.tree.map(np.asarray, grads))
    got_grads = dict(td.named_parameters())
    assert set(want_grads) == set(got_grads)
    for name, w in want_grads.items():
        assert rel_err(got_grads[name].grad, w) <= 1e-4, name


def test_conv_decoder_init_and_converter():
    """Flax's kaiming_normal per layer (fan_in = in·kh·kw of a transposed
    convolution's (in, out, kh, kw) weight), zero biases; the converter
    refuses a leaf it does not know."""
    dec = ConvDecoder64(10, 1, generator=torch.Generator().manual_seed(0))
    for layer in dec.deconvs:
        c_in, _, kh, kw = layer.weight.shape
        std = np.sqrt(2.0 / (c_in * kh * kw)) / 0.87962566103423978
        assert float(layer.weight.detach().abs().max()) <= 2 * std + 1e-6
        assert float(layer.weight.detach().std()) > 0.5 * std * 0.87962566103423978
        assert float(layer.bias.detach().abs().max()) == 0.0
    with pytest.raises(KeyError, match="ConvDecoder64"):
        conv_decoder_params_from_flax({"params": {"Conv_0": {"kernel": 0, "bias": 0}}})


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 1, 1, 1), (3, 2, 6, 6)])
def test_positional_encodings_equal_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    # channel-first, as the JAX module
    want = jax_layers.PositionalEncoding().apply({}, x)
    got = PositionalEncoding()(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the JAX 2-D module on NHWC against the port's on its NCHW layout
    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want2d = jax_layers.PositionalEncoding2D().apply({}, nhwc)
    xt = torch.from_numpy(nhwc).permute(0, 3, 1, 2)  # channels_last memory
    got2d = PositionalEncoding2D()(xt)
    assert got2d.shape == (shape[0], 2 + shape[1], shape[2], shape[3])
    np.testing.assert_array_equal(got2d.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want2d))
    if shape[1] > 1 and shape[2] * shape[3] > 1:
        assert got2d.is_contiguous(memory_format=torch.channels_last)
