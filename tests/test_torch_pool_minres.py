"""ops/pool_minres.py and MinResBNPool against cl_ica_tpu/ops/pool_minres.py,
on the CPU.

The same numpy inputs go through the JAX custom VJP ``bn_relu_pool``
(under ``jax.jit``, through ``jax.vjp``) and the port's Function, which on
CPU tensors runs the plain versions of the code and scatter kernels and of
the bn kernels; chip_smoke.py holds the kernels to those plain versions on
the card. Bars: the pooled output and the statistics float32 1e-5 of the
largest magnitude, bfloat16 two bfloat16 ulps of it (the two packages'
statistics sum in other orders); the codes byte for byte given the same
relu(x·a + b); gradients float32 1e-4, bfloat16 two ulps. Against the
plain composition (MinResBN2d, then F.max_pool2d under autograd): the
output and the running buffers bit for bit, gradients at float32's
rounding (1e-5 of the largest, the JAX package's own test holds 3e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cl_ica_tpu.ops import pool_minres as jax_pool
from cl_ica_tpu_torch.models.layers import MinResBN2d, MinResBNPool
from cl_ica_tpu_torch.ops import bn_minres as bm
from cl_ica_tpu_torch.ops import launch_counts, reset_launch_counts
from cl_ica_tpu_torch.ops import pool_minres as pm

torch.set_num_threads(1)

EPS = 1e-5
BF16_ULP = 2.0 ** -7
SHAPES = [(3, 8, 8, 4), (2, 12, 16, 5), (1, 4, 4, 1)]


def _data(seed, shape, tied=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 2
    if tied:  # five levels: most windows hold equal values
        x = np.round(x * 0.75) / 2
    c = shape[-1]
    scale = 1.0 + 0.4 * rng.normal(size=c)
    bias = 0.3 * rng.normal(size=c)
    dp = rng.normal(size=(shape[0], shape[1] // 2, shape[2] // 2, c))
    return tuple(a.astype(np.float32) for a in (x, scale, bias, dp))


@functools.lru_cache(maxsize=None)
def _jax_vjp():
    def run(x, scale, bias, dp):
        out, pull = jax.vjp(lambda *a: jax_pool.bn_relu_pool(*a, EPS), x, scale, bias)
        return out, pull((dp, jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))
    return jax.jit(run)


def _port(x, scale, bias, dp):
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    out = pm.bn_relu_pool(*leaves, EPS)
    (out[0].float() * dp.float()).sum().backward()
    return out, [t.grad for t in leaves]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_values_and_gradients_match_jax(shape, dtype):
    x, scale, bias, dp = _data(SHAPES.index(shape), shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    (jp, jmean, jvar), jgrads = _jax_vjp()(
        jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(dp).astype(jdt))
    (p, mean, var), grads = _port(torch.tensor(x).to(tdt), torch.tensor(scale),
                                  torch.tensor(bias), torch.tensor(dp).to(tdt))
    assert p.dtype == tdt and p.shape == (shape[0], shape[1] // 2, shape[2] // 2,
                                          shape[3])
    bar = 2 * BF16_ULP if dtype == "bfloat16" else 1e-5
    grad_bar = 2 * BF16_ULP if dtype == "bfloat16" else 1e-4
    for got, want in ((p, jp), (mean, jmean), (var, jvar)):
        assert _rel(_np(got), _np(want)) <= bar
    for got, want in zip(grads, jgrads):
        assert _rel(_np(got), _np(want)) <= grad_bar


@pytest.mark.parametrize("tied", [False, True], ids=["normal", "tied"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codes_and_pooled_are_the_jax_lines(dtype, tied):
    # given the same a and b: relu(x·a + b) in x's dtype, then the first
    # maximum of each padded window, code byte for byte (JAX's int8)
    x, scale, bias, _ = _data(3, (2, 8, 12, 6), tied)
    tx = torch.tensor(x).to(dtype)
    mean, _, rstd = bm.channel_stats(tx, EPS)
    a, b = bm.affine(torch.tensor(scale), torch.tensor(bias), mean, rstd, dtype)
    pooled, code = pm.pool_code_reference(tx, a, b)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    z = jnp.maximum(jnp.asarray(tx.float().numpy()).astype(jdt)
                    * jnp.asarray(a.float().numpy()).astype(jdt)
                    + jnp.asarray(b.float().numpy()).astype(jdt), 0)
    jp, jcode = jax.jit(jax_pool._pool_fwd_core)(z)
    np.testing.assert_array_equal(_np(pooled), _np(jp))
    assert code.dtype == torch.uint8
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode).astype(np.uint8))
    # and the pooled map is F.max_pool2d of the minres norm's output
    want = F.max_pool2d(bm.bn_apply_reference(tx, a, b).permute(0, 3, 1, 2), 3, 2, 1)
    assert torch.equal(pooled, want.permute(0, 2, 3, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_is_the_jax_stencil(dtype):
    x, scale, bias, dp = _data(4, (2, 8, 10, 3), tied=True)
    tx = torch.tensor(x)
    mean, _, rstd = bm.channel_stats(tx, EPS)
    a, b = bm.affine(torch.tensor(scale), torch.tensor(bias), mean, rstd, torch.float32)
    _, code = pm.pool_code_reference(tx, a, b)
    tdp = torch.tensor(dp).to(dtype)
    dz = pm.pool_scatter_reference(tdp, code, 8, 10)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax.jit(jax_pool._dz_stencil, static_argnums=(2, 3))(
        jnp.asarray(tdp.float().numpy()).astype(jdt),
        jnp.asarray(code.numpy().astype(np.int8)), 8, 10)
    assert dz.dtype == dtype
    np.testing.assert_array_equal(_np(dz), _np(want))


def test_ties_go_to_the_first_position_as_in_max_pool2d():
    # quantized inputs force ties inside windows: the gradient is routed as
    # F.max_pool2d's backward routes it (first wins, row-major), with the
    # JAX package's weights of the pooled cells
    x, _, _, _ = _data(7, (2, 8, 8, 3), tied=True)
    scale, bias = torch.ones(3), torch.zeros(3)
    w = torch.arange(1.0, 2 * 4 * 4 * 3 + 1).reshape(2, 4, 4, 3)
    tx = torch.tensor(x).requires_grad_()
    (pm.bn_relu_pool(tx, scale, bias, EPS)[0] * w).sum().backward()
    norm = MinResBN2d(3).train()
    tx2 = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    p = F.max_pool2d(norm(tx2), 3, 2, 1)
    (p * w.permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), tx2.grad.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5 * float(tx.grad.abs().max()))
    jg = jax.jit(jax.grad(lambda x: jnp.sum(
        jax_pool.bn_relu_pool(x, jnp.ones(3), jnp.zeros(3), EPS)[0] * jnp.asarray(w))))(
        jnp.asarray(x))
    assert _rel(tx.grad.numpy(), np.asarray(jg)) <= 1e-4


def test_an_all_zero_window_names_its_first_position_in_the_image():
    # the relu zeroes every value: each window's code is its first
    # position inside the image (a zero is a value; the padding is not),
    # as in F.max_pool2d's indices and the JAX comparator
    x = -np.abs(np.random.default_rng(2).normal(size=(1, 4, 6, 2))).astype(np.float32)
    tx = torch.tensor(x)
    a, b = torch.ones(2), torch.zeros(2)
    pooled, code = pm.pool_code_reference(tx, a, b)
    assert not bool(pooled.any())
    _, idx = F.max_pool2d(bm.bn_apply_reference(tx, a, b).permute(0, 3, 1, 2), 3, 2, 1,
                          return_indices=True)
    idx = idx.permute(0, 2, 3, 1)
    ho = torch.arange(2).view(1, 2, 1, 1)
    wo = torch.arange(3).view(1, 1, 3, 1)
    row = idx // 6 - (2 * ho - 1)
    col = idx % 6 - (2 * wo - 1)
    assert torch.equal(code.long(), row * 3 + col)
    np.testing.assert_array_equal(code.numpy()[0, :, :, 0], [[4, 3, 3], [1, 0, 0]])
    dp = torch.ones(1, 2, 3, 2)
    dz = pm.pool_scatter_reference(dp, code, 4, 6)
    want = torch.ops.aten.max_pool2d_with_indices_backward(
        dp.permute(0, 3, 1, 2), torch.zeros(1, 2, 4, 6), [3, 3], [2, 2], [1, 1],
        [1, 1], False, idx.permute(0, 3, 1, 2))
    assert torch.equal(dz, want.permute(0, 2, 3, 1))


def test_odd_spatial_sizes_raise_as_in_jax():
    with pytest.raises(ValueError, match="even"):
        pm.bn_relu_pool(torch.zeros(1, 7, 8, 3), torch.ones(3), torch.zeros(3), EPS)
    with pytest.raises(ValueError, match="even"):
        jax_pool.bn_relu_pool(jnp.zeros((1, 7, 8, 3)), jnp.ones(3), jnp.zeros(3), EPS)


def test_saved_tensors_are_x_and_the_code():
    # the minimal residual: x, an int8-sized code a pooled value, (C,)
    # vectors; no relu'd map, no int64 indices
    x, scale, bias, _ = _data(5, (2, 8, 8, 4))
    tx = torch.tensor(x, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        pooled, _, _ = pm.bn_relu_pool(tx, torch.tensor(scale, requires_grad=True),
                                       torch.tensor(bias, requires_grad=True), EPS)
    big = [t for t in saved if t.numel() > 4]
    assert [t.data_ptr() for t in big if t.numel() == tx.numel()] == [tx.data_ptr()]
    codes = [t for t in big if t.numel() == pooled.numel()]
    assert len(big) == 2 and len(codes) == 1 and codes[0].dtype == torch.uint8
    assert all(t.dtype != torch.int64 for t in saved)


def test_cpu_tensors_launch_nothing_and_the_wrappers_refuse_them():
    x, scale, bias, dp = _data(6, (2, 8, 8, 4))
    reset_launch_counts()
    _port(torch.tensor(x), torch.tensor(scale), torch.tensor(bias), torch.tensor(dp))
    assert not any(launch_counts().values())
    t = torch.zeros((2, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pm.launch_pool_code(t, torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        pm.launch_pool_scatter(torch.zeros((2, 4, 4, 8)),
                               torch.zeros((2, 4, 4, 8), dtype=torch.uint8), 8, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_is_the_minres_norm_and_max_pool(dtype):
    # MinResBNPool against MinResBN2d then F.max_pool2d under autograd (the
    # ResNet's stem_pool='xla'): the output and the running buffers bit for
    # bit, the gradients to float32 rounding; the same state dict keys
    x, scale, bias, dp = _data(8, (4, 8, 8, 8))
    nchw = lambda a: torch.tensor(a).permute(0, 3, 1, 2).contiguous().to(dtype)
    outs = []
    for argmax in (True, False):
        norm = (MinResBNPool(8) if argmax else MinResBN2d(8)).train()
        norm.weight.data, norm.bias.data = torch.tensor(scale), torch.tensor(bias)
        xs = nchw(x).requires_grad_()
        p = norm(xs) if argmax else F.max_pool2d(norm(xs), 3, 2, 1)
        (p.float() * nchw(dp).float()).sum().backward()
        outs.append((p.detach(), norm.running_mean, norm.running_var, xs.grad,
                     norm.weight.grad, norm.bias.grad, list(norm.state_dict())))
    got, want = outs
    for i in (0, 1, 2):
        assert torch.equal(got[i], want[i])
    assert got[6] == want[6]
    tol = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    for g, w in zip(got[3:6], want[3:6]):
        assert _rel(_np(g), _np(w)) <= tol


def test_module_eval_is_the_plain_composition():
    norm = MinResBNPool(4)
    norm.running_mean.normal_(generator=torch.Generator().manual_seed(0))
    norm.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(1))
    plain = MinResBN2d(4)
    plain.load_state_dict(norm.state_dict())
    norm.eval(), plain.eval()
    x = torch.randn(2, 4, 6, 6)
    assert torch.equal(norm(x), F.max_pool2d(plain(x), 3, 2, 1))
