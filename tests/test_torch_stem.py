"""ops/stem.py (the fused stem tail) against cl_ica_tpu/ops/stem_pallas.py.

The same numpy inputs go through the JAX function, whose Pallas kernels
run in interpret mode as in tests/test_stem_pallas.py, and through the
port, which on CPU tensors runs the plain versions of its two CUDA
kernels. The kernels themselves are held against those plain versions on
the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cl_ica_tpu.ops.stem_pallas import bn_relu_pool_train as jax_stem
from cl_ica_tpu_torch.models.layers import FastBatchNorm2d, StemBNReLUPool
from cl_ica_tpu_torch.ops import launch_counts
from cl_ica_tpu_torch.ops import stem
from cl_ica_tpu_torch.ops.stem import (
    bn_relu_pool_reference,
    bn_relu_pool_train,
    launch_stem_bwd,
    launch_stem_fwd,
    stem_bwd_reference,
    stem_fwd_reference,
)

torch.set_num_threads(1)

SHAPES = [(3, 16, 16, 8), (2, 12, 20, 16)]


def _data(seed, n=3, h=16, w=16, c=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    scale = (1.0 + 0.5 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    return x, scale, bias


def _tied(seed, shape):
    """Inputs on five levels: most 3x3 windows hold equal values."""
    x, scale, bias = _data(seed, *shape)
    return np.round(x).astype(np.float32), scale, bias


def _jax_grads(x, scale, bias, dtype=jnp.float32):
    def loss(x, s, b):
        o, _, _ = jax_stem(x, s, b, 1e-5, True)
        return jnp.sum(jnp.sin(3.0 * o.astype(jnp.float32)))

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias))


def _torch_grads(fn, x, scale, bias, dtype=torch.float32):
    xs = torch.tensor(x, dtype=dtype, requires_grad=True)
    s = torch.tensor(scale, requires_grad=True)
    b = torch.tensor(bias, requires_grad=True)
    out, _, _ = fn(xs, s, b)
    torch.sin(3.0 * out.float()).sum().backward()
    return xs.grad, s.grad, b.grad


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_kernel(shape):
    # The JAX test's own bars are atol 1e-6 (pooled) and 1e-7 (mean, var),
    # between two JAX functions that share one float32 reduction. Across
    # the packages the reductions differ: on the CPU XLA's float32 E[x²]
    # is up to 7e-7 off the float64 value and torch's 1e-7, which moves
    # rstd, and with it every output, by ~4e-7 relative. So the variance
    # is held to 1e-6, each package's to the float64 value too, and the
    # pooled output to 1e-6 + 2e-6·|want|; the next test removes the
    # statistics from the comparison and keeps the 1e-6.
    x, scale, bias = _data(0, *shape)
    want, wmean, wvar = jax_stem(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-5, True)
    got, mean, var = bn_relu_pool_train(torch.tensor(x), torch.tensor(scale),
                                        torch.tensor(bias))
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=2e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(wmean), atol=1e-7)
    np.testing.assert_allclose(var.numpy(), np.asarray(wvar), atol=1e-6)
    x64 = x.astype(np.float64)
    var64 = (x64 ** 2).mean((0, 1, 2)) - x64.mean((0, 1, 2)) ** 2
    np.testing.assert_allclose(var.numpy(), var64, atol=1e-6)
    np.testing.assert_allclose(np.asarray(wvar), var64, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_on_the_jax_statistics_matches_jax_kernel(shape):
    # a and b folded from the JAX function's own mean and var: what is left
    # is the affine, the relu and the pool, at the JAX test's own bar
    x, scale, bias = _data(0, *shape)
    want, wmean, wvar = jax_stem(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-5, True)
    rstd = jax.lax.rsqrt(wvar + 1e-5)
    a = torch.tensor(np.asarray(rstd * scale))
    b = torch.tensor(np.asarray(bias - wmean * rstd * scale))
    got = stem_fwd_reference(torch.tensor(x), a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_kernel(shape):
    x, scale, bias = _data(1, *shape)
    want = _jax_grads(x, scale, bias)
    got = _torch_grads(bn_relu_pool_train, x, scale, bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_ties_go_to_the_first_position_as_in_jax(shape):
    # with inputs on a few levels most windows tie, and dx follows the JAX
    # kernel's routing. A window routed to another position would move dx
    # by a whole g (order 1). Through the whole function the cotangent
    # 3·cos(3·out) carries the two packages' float32 statistics (see the
    # forward test), so the bar here is the gradients' 1e-4; the next test
    # holds the routing itself to 1e-6.
    x, scale, bias = _tied(2, shape)
    want = _jax_grads(x, scale, bias)
    got = _torch_grads(bn_relu_pool_train, x, scale, bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_routed_gradient_on_ties_matches_jax_backward_kernel(shape):
    # the backward kernel alone on tied inputs, both given the same a, b,
    # mean and rstd: dy is the routed g under the relu mask, no statistics
    # in the way, held to 1e-6 (up to four g's are added, in another order)
    from cl_ica_tpu.ops.stem_pallas import _run_bwd

    x, scale, bias = _tied(3, shape)
    rng = np.random.default_rng(4)
    n, h, w, c = shape
    g = rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32)
    mean = x.mean((0, 1, 2)).astype(np.float32)
    rstd = (1.0 / np.sqrt(x.var((0, 1, 2)) + 1e-5)).astype(np.float32)
    a, b = rstd * scale, bias - mean * rstd * scale
    wdy, wsb, wsg = _run_bwd(*(jnp.asarray(t) for t in (x, g, a, b, mean, rstd)),
                             True)
    dy, sb, sg = stem_bwd_reference(*(torch.tensor(t) for t in (x, g, a, b, mean, rstd)))
    ties = 0
    z = np.maximum(x * a + b, 0)
    for i in range(0, h - 1, 2):  # windows without padding suffice to count
        for j in range(0, w - 1, 2):
            win = z[:, i:i + 3, j:j + 3].reshape(n, -1, c)
            ties += int(((win == win.max(1, keepdims=True)).sum(1) > 1).sum())
    assert ties > 0.5 * n * (h // 2) * (w // 2) * c  # most windows tie
    np.testing.assert_allclose(dy.numpy(), np.asarray(wdy), atol=1e-6)
    np.testing.assert_allclose(sb.numpy(), np.asarray(wsb), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(sg.numpy(), np.asarray(wsg), atol=1e-4, rtol=1e-5)


def test_tie_order_differs_from_last_wins():
    # a 2x2 image of equal positive values: its one window ties four ways,
    # and the first position (0, 0) takes the whole gradient
    x = torch.ones((1, 2, 2, 8))
    a, b = torch.ones(8), torch.zeros(8)
    g = torch.full((1, 1, 1, 8), 3.0)
    dy, sb, sg = stem_bwd_reference(x, g, a, b, torch.zeros(8), torch.ones(8))
    want = torch.zeros((1, 2, 2, 8))
    want[0, 0, 0] = 3.0
    assert torch.equal(dy, want)
    assert torch.equal(sb, torch.full((8,), 3.0))


@pytest.mark.parametrize("shape", SHAPES)
def test_bfloat16_forward_matches_jax_kernel(shape):
    x, scale, bias = _data(3, *shape)
    want, _, _ = jax_stem(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                          jnp.asarray(bias), 1e-5, True)
    got, mean, var = bn_relu_pool_train(
        torch.tensor(x, dtype=torch.bfloat16), torch.tensor(scale),
        torch.tensor(bias))
    assert got.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_bfloat16_grads_match_jax_kernel():
    x, scale, bias = _data(4)
    want = _jax_grads(x, scale, bias, jnp.bfloat16)
    got = _torch_grads(bn_relu_pool_train, x, scale, bias, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    # dx is rounded to bfloat16 in both; dscale, dbias are float32 sums of
    # bfloat16-rounded terms
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)
    # both packages sum the same bfloat16-rounded terms in float32: they
    # differ by the order of the sum only (a wrong sum would be off by far
    # more; bfloat16 itself moves these sums by 1e-2 of their size)
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_torch_max_pool(shape):
    # a second check of the forward, through a library's pooling
    x, scale, bias = _data(5, *shape)
    xt = torch.tensor(x)
    mean, var, rstd = stem.batch_statistics(xt, 1e-5)
    a = rstd * torch.tensor(scale)
    b = torch.tensor(bias) - mean * rstd * torch.tensor(scale)
    z = F.relu(xt * a + b).permute(0, 3, 1, 2)
    want = F.max_pool2d(z, 3, 2, 1).permute(0, 2, 3, 1)
    assert torch.equal(stem_fwd_reference(xt, a, b), want)


def test_grads_match_autograd_of_the_composition():
    # untied inputs: the hand-written backward equals autograd through
    # torch's own batch-norm arithmetic, relu and max_pool2d
    x, scale, bias = _data(6)

    def composed(xs, s, b):
        m = xs.mean((0, 1, 2))
        v = (xs * xs).mean((0, 1, 2)) - m * m
        y = (xs - m) * torch.rsqrt(v + 1e-5) * s + b
        return (F.max_pool2d(F.relu(y).permute(0, 3, 1, 2), 3, 2, 1)
                .permute(0, 2, 3, 1), None, None)

    got = _torch_grads(bn_relu_pool_train, x, scale, bias)
    want = _torch_grads(composed, x, scale, bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=1e-4)


def test_statistics_outputs_carry_no_gradient():
    x, scale, bias = _data(7)
    xs = torch.tensor(x, requires_grad=True)
    s = torch.tensor(scale, requires_grad=True)
    b = torch.tensor(bias, requires_grad=True)
    out, mean, var = bn_relu_pool_train(xs, s, b)
    assert out.requires_grad and not mean.requires_grad and not var.requires_grad
    (out.sum() + 100.0 * (mean.sum() + var.sum())).backward()
    with_stats = xs.grad.clone()
    xs.grad = None
    bn_relu_pool_train(xs, s, b)[0].sum().backward()
    assert torch.equal(with_stats, xs.grad)


@pytest.mark.parametrize("shape", [(1, 15, 16, 8), (1, 16, 15, 8)])
def test_odd_height_or_width_raises(shape):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match="even H and W"):
        bn_relu_pool_train(x, torch.ones(8), torch.zeros(8))


def test_plain_route_and_public_function_agree_on_cpu():
    x, scale, bias = _data(8)
    got = _torch_grads(bn_relu_pool_train, x, scale, bias)
    want = _torch_grads(bn_relu_pool_reference, x, scale, bias)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch_counts()["stem_fwd"] == launch_counts()["stem_bwd"] == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    # asked for the kernel, a CPU tensor raises: nothing gives way to the
    # plain version
    x = torch.zeros((1, 4, 4, 8))
    v = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch_stem_fwd(x, v, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch_stem_bwd(x, torch.zeros((1, 2, 2, 8)), v, v, v, v)


def _norm_pair(cls, c, seed):
    rng = np.random.default_rng(seed)
    m = cls(c)
    with torch.no_grad():
        m.weight.copy_(torch.tensor(1.0 + 0.3 * rng.normal(size=c)))
        m.bias.copy_(torch.tensor(0.1 * rng.normal(size=c)))
        m.running_mean.copy_(torch.tensor(0.2 * rng.normal(size=c)))
        m.running_var.copy_(torch.tensor(1.0 + 0.2 * rng.uniform(size=c)))
    return m


def test_stem_module_eval_mode_is_the_plain_composition():
    x = torch.tensor(np.random.default_rng(9).normal(size=(2, 8, 12, 12)),
                     dtype=torch.float32)
    m = _norm_pair(StemBNReLUPool, 8, 10).eval()
    norm = _norm_pair(FastBatchNorm2d, 8, 10).eval()
    want = F.max_pool2d(F.relu(norm(x)), 3, 2, 1)
    assert torch.equal(m(x), want)
    rstd = torch.rsqrt(m.running_var + 1e-5)
    direct = ((x - m.running_mean[None, :, None, None])
              * (rstd * m.weight)[None, :, None, None]
              + m.bias[None, :, None, None])
    np.testing.assert_allclose(norm(x).detach().numpy(), direct.detach().numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("channels_last", [True, False])
def test_stem_module_training_matches_unfused_and_updates_running(channels_last):
    x = torch.tensor(np.random.default_rng(11).normal(size=(3, 8, 12, 12)),
                     dtype=torch.float32)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    fused = _norm_pair(StemBNReLUPool, 8, 12).train()
    plain = _norm_pair(FastBatchNorm2d, 8, 12).train()
    got = fused(x)
    want = F.max_pool2d(F.relu(plain(x)), 3, 2, 1)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6)
    assert got.shape == (3, 8, 6, 6)
    np.testing.assert_allclose(fused.running_mean.numpy(),
                               plain.running_mean.numpy(), atol=1e-7)
    np.testing.assert_allclose(fused.running_var.numpy(),
                               plain.running_var.numpy(), atol=1e-7)
    # momentum 0.1 and the unbiased correction n/(n-1)
    n = 3 * 12 * 12
    var = x.var(dim=(0, 2, 3), unbiased=False)
    start = _norm_pair(FastBatchNorm2d, 8, 12).running_var
    np.testing.assert_allclose(plain.running_var.numpy(),
                               (0.9 * start + 0.1 * var * n / (n - 1)).numpy(),
                               atol=1e-6)
