"""ops/bn_minres8.py and MinResBN2d(residuals_f8=True) against
cl_ica_tpu/ops/bn_minres8.py, on the CPU.

The same numpy inputs and cotangents go through the JAX custom VJPs (under
``jax.jit``, through ``jax.vjp``) and through the port's Functions, which
on CPU tensors run the plain versions of the three float8 modes of the
bn kernels; chip_smoke.py holds the kernels to those plain versions on the
card. Bars: outputs and the statistics as tests/test_torch_bn_minres.py
(float32 1e-5 of the largest magnitude, bfloat16 two bfloat16 ulps of it);
gradients float32 1e-4, bfloat16 two bfloat16 ulps: the two packages
quantize the same float32 x̂, so their xq agree but where x̂'s float32
rounding, which differs by the order of the statistics' sums, crosses a
rounding point of e4m3fn (none did at these inputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.ops import bn_minres8 as jax_bn8
from cl_ica_tpu_torch.models import layers
from cl_ica_tpu_torch.models.layers import MinResBN2d
from cl_ica_tpu_torch.ops import bn_minres as bm
from cl_ica_tpu_torch.ops import bn_minres8 as b8
from cl_ica_tpu_torch.ops import launch_counts, reset_launch_counts
from torch_fake_card import on_fake_card

torch.set_num_threads(1)

SHAPES = [(4, 6, 6, 16), (3, 5, 7, 24)]
FUNCTIONS = ("bn_relu8", "bn_add_relu8", "bn_only8")
BF16_ULP = 2.0 ** -7
EPS = 1e-5


def _data(seed, shape, zero_scale=False):
    """x like a convolution's output, res, a cotangent, the norm's scale
    (all 0 for a block's last norm) and bias."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * rng.uniform(0.5, 1.5, c)
         + 0.3 * rng.normal(size=c)).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    scale = (np.zeros(c) if zero_scale else 1.0 + 0.5 * rng.normal(size=c))
    bias = 0.1 * rng.normal(size=c)
    return x, res, dy, scale.astype(np.float32), bias.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_vjp(fn):
    """(outputs, gradients) of the JAX function under jit."""
    f = getattr(jax_bn8, fn)
    if fn == "bn_add_relu8":
        def run(x, res, scale, bias, dy):
            out, pull = jax.vjp(lambda *a: f(*a, EPS), x, res, scale, bias)
            return out, pull((dy, jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))
    else:
        def run(x, res, scale, bias, dy):
            out, pull = jax.vjp(lambda *a: f(*a, EPS), x, scale, bias)
            return out, pull((dy, jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))
    return jax.jit(run)


def _port(fn, x, res, scale, bias, dy, module=b8):
    """The port's function on CPU tensors: (y, mean, var) and the
    gradients (dx[, dres], dscale, dbias) of sum(y · dy)."""
    name = fn if module is b8 else fn.removesuffix("8")
    args = [x] + ([res] if "add" in fn else []) + [scale, bias]
    leaves = [a.clone().requires_grad_() for a in args]
    out = getattr(module, name)(*leaves, EPS)  # bn_add_relu's y_res unused
    y, mean, var = out[0], out[-2], out[-1]
    (y.float() * dy.float()).sum().backward()
    return (y, mean, var), [t.grad for t in leaves]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


@pytest.mark.parametrize("zero_scale", [False, True], ids=["scale", "zero-scale"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_values_and_gradients_match_jax(fn, shape, dtype, zero_scale):
    x, res, dy, scale, bias = _data(10 * FUNCTIONS.index(fn) + SHAPES.index(shape),
                                    shape, zero_scale)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cast = lambda a: jnp.asarray(a).astype(jdt)
    (jy, jmean, jvar), jgrads = _jax_vjp(fn)(
        cast(x), cast(res), jnp.asarray(scale), jnp.asarray(bias), cast(dy))
    tx, tres, tdy = (torch.tensor(a).to(tdt) for a in (x, res, dy))
    (y, mean, var), grads = _port(fn, tx, tres, torch.tensor(scale),
                                  torch.tensor(bias), tdy)
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    bar = 2 * BF16_ULP if dtype == "bfloat16" else 1e-5
    grad_bar = 2 * BF16_ULP if dtype == "bfloat16" else 1e-4
    for got, want in ((mean, jmean), (var, jvar), (y, jy)):
        assert _rel(_np(got), _np(want)) <= bar
    assert len(grads) == len(jgrads) == (4 if fn == "bn_add_relu8" else 3)
    for got, want in zip(grads, jgrads):
        assert got.dtype == (tdt if got.ndim == 4 else torch.float32)
        assert _rel(_np(got), _np(want)) <= grad_bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_forward_is_minres_bit_for_bit(fn, dtype):
    # only the saved residual changes: y, mean and var are bn_minres's
    x, res, dy, scale, bias = _data(5, SHAPES[1])
    args = [torch.tensor(a).to(dtype) for a in (x, res)] + [
        torch.tensor(scale), torch.tensor(bias), torch.tensor(dy).to(dtype)]
    got, _ = _port(fn, *args)
    want, _ = _port(fn, *args, module=bm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_quantized_xhat_error_bound():
    # e4m3fn keeps three mantissa bits: 2^-4 relative, 2^-10 absolute at
    # the subnormals (the JAX package's own bound)
    xh = torch.tensor(np.random.default_rng(0).normal(size=4096), dtype=torch.float32)
    q = b8.quantize_reference(xh, torch.zeros(()), torch.ones(())).float()
    assert bool(((q - xh).abs() <= 2.0 ** -4 * xh.abs() + 2.0 ** -10).all())


@pytest.mark.parametrize("value", [448.0, 464.0, 465.0, 500.0, np.inf, -500.0,
                                   -np.inf, np.nan, 3 * 2.0 ** -11, -1e-12])
def test_e4m3_bytes_follow_the_jax_conversion(value):
    # C9: past 464 (the midpoint of 448 and the format's missing next
    # step), at infinities and at NaN the JAX package's conversion gives
    # NaN with the sign, where PyTorch's own cast saturates to ±448; 464
    # itself rounds (to even) to 448; subnormals round to nearest even
    x = np.array([value], np.float32)
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.float8_e4m3fn).view(jnp.uint8))(
        jnp.asarray(x)))
    got = b8.quantize_reference(torch.tensor(x), torch.zeros(()), torch.ones(()))
    assert got.dtype == torch.float8_e4m3fn
    assert got.view(torch.uint8).numpy().tolist() == want.tolist()


def test_quantize_is_the_jax_line_on_normalised_data():
    x, _, _, _, _ = _data(6, SHAPES[0])
    tx = torch.tensor(x)
    mean, _, rstd = bm.channel_stats(tx, EPS)
    want = np.asarray(jax.jit(jax_bn8._quantize)(
        jnp.asarray(x), jnp.asarray(mean.numpy()), jnp.asarray(rstd.numpy())
    ).view(jnp.uint8))
    got = b8.quantize_reference(tx, mean, rstd).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


# the JAX package's bars for the gradients against the exact minres
# gradients (relative L2): the sums' quantization noise (bn_only8) and the
# relu gates that read the quantized x̂
_TOL = {"bn_relu8": 0.15, "bn_add_relu8": 0.25, "bn_only8": 0.03}


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_grads_match_exact_within_quantization(fn):
    x, res, dy, scale, bias = _data(7, (8, 16, 16, 8))
    args = [torch.tensor(a) for a in (x, res, scale, bias, dy)]
    _, got = _port(fn, *args)
    _, want = _port(fn, *args, module=bm)
    for g, w in zip(got, want):
        assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) < _TOL[fn]


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_statistics_outputs_carry_no_gradient(fn):
    x, res, _, scale, bias = _data(0, SHAPES[0])
    args = [torch.tensor(x, requires_grad=True)] + (
        [torch.tensor(res, requires_grad=True)] if "add" in fn else []) + [
        torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)]
    y, mean, var = getattr(b8, fn)(*args, EPS)
    assert y.requires_grad and not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_the_float8_residual_is_saved_in_place_of_x(fn):
    # saved at activation size: xq (one byte an element) and, for the add,
    # res, as the JAX VJP keeps them; never x, y or a float copy of x̂
    x, res, _, scale, bias = _data(1, SHAPES[1])
    tx = torch.tensor(x, requires_grad=True)
    tres = torch.tensor(res, requires_grad=True)
    ts, tb = (torch.tensor(a, requires_grad=True) for a in (scale, bias))
    saved, outputs = [], []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        if fn == "bn_add_relu8":
            outputs.append(b8.bn_add_relu8(tx, tres, ts, tb, EPS)[0])
        else:
            outputs.append(getattr(b8, fn)(tx, ts, tb, EPS)[0])
    big = [t for t in saved if t.numel() == tx.numel()]
    assert big[0].dtype == torch.float8_e4m3fn
    assert [t.data_ptr() for t in big[1:]] == ([tres.data_ptr()]
                                               if fn == "bn_add_relu8" else [])
    assert all(t.data_ptr() not in (tx.data_ptr(), outputs[0].data_ptr())
               for t in saved)
    assert all(t.numel() == x.shape[-1] for t in saved if t.numel() != tx.numel())


def test_add_mode_gates_on_the_quantized_pre_activation_at_the_kink():
    # elements placed at the relu's kink, where xh·scale + bias + res and
    # the exact x·a + b + res lie on opposite sides of 0: the gate reads the
    # quantized x̂ and res (the JAX _mask8), so those elements take the
    # other branch than the output y's sign would give them
    rng = np.random.default_rng(11)
    shape = (4, 4, 4, 8)
    x = rng.normal(size=shape).astype(np.float32)
    scale = np.ones(8, np.float32)
    bias = np.zeros(8, np.float32)
    tx = torch.tensor(x)
    mean, _, rstd = bm.channel_stats(tx, EPS)
    xhat = ((tx - mean) * rstd).numpy()
    xq = b8.quantize_reference(tx, mean, rstd).float().numpy()
    # res cancels the exact pre-activation up to half its gap to xq's value
    res = (-(xhat + xq) / 2).astype(np.float32)
    dy = np.ones(shape, np.float32)
    (y, _, _), grads = _port("bn_add_relu8", tx, torch.tensor(res),
                             torch.tensor(scale), torch.tensor(bias),
                             torch.tensor(dy))
    gate = torch.tensor(xq + res > 0)
    flipped = gate != (y.detach() > 0)
    assert int(flipped.sum()) > 10
    # the residual's gradient is g itself: the quantized gate, not y's sign
    assert torch.equal(grads[1] != 0, gate)
    _, jgrads = _jax_vjp("bn_add_relu8")(jnp.asarray(x), jnp.asarray(res),
                                          jnp.asarray(scale), jnp.asarray(bias),
                                          jnp.asarray(dy))
    np.testing.assert_array_equal(grads[1].numpy(), np.asarray(jgrads[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu, res", [(True, False), (True, True), (False, False)])
def test_plain_versions_are_the_jax_lines(dtype, relu, res):
    # the backward sums and dx as the JAX package writes them (_mask8,
    # _bwd_core8), given the same xq and rstd
    x, r, dy, scale, bias = _data(3, SHAPES[1])
    tx, tr, tdy = (torch.tensor(a).to(dtype) for a in (x, r, dy))
    mean, _, rstd = bm.channel_stats(tx, EPS)
    xq = b8.quantize_reference(tx, mean, rstd)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jxh = jnp.asarray(xq.float().numpy()).astype(jdt)
    jdy = jnp.asarray(tdy.float().numpy()).astype(jdt)
    jres = jnp.asarray(tr.float().numpy()).astype(jdt) if res else None
    g_want = (jax_bn8._mask8(jxh, jnp.asarray(scale), jnp.asarray(bias), jdy, res=jres)
              if relu else jdy)
    dx_want, dscale_want, dbias_want = jax_bn8._bwd_core8(
        jxh, jnp.asarray(scale), jnp.asarray(rstd.numpy()), g_want)
    s, t = torch.tensor(scale).to(dtype), torch.tensor(bias).to(dtype)
    rr = tr if res else None
    sum_g, sum_gxh = b8.bwd8_reference(xq, tdy, s, t, rr, relu)
    k = b8.dx8_factors(torch.tensor(scale), rstd, sum_g, sum_gxh,
                       tx.numel() // tx.shape[-1], dtype)
    dx, g = b8.dx8_reference(xq, tdy, k, s, t, rr, relu)
    np.testing.assert_array_equal(g.float().numpy(), _np(g_want))
    assert _rel(sum_gxh.numpy(), dscale_want) <= 1e-5
    assert _rel(sum_g.numpy(), dbias_want) <= 1e-5
    bar = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    assert _rel(dx.float().numpy(), _np(dx_want)) <= bar


@pytest.mark.parametrize("launch, args", [
    ("launch_apply8", lambda x, v, q, k: (x, v, v, v.float(), v.float())),
    ("launch_bwd8", lambda x, v, q, k: (q, x, v, v)),
    ("launch_dx8", lambda x, v, q, k: (q, x, k, v, v)),
])
def test_kernel_wrappers_refuse_cpu_tensors(launch, args):
    # a wrapper never takes the plain version: off the card it raises
    x = torch.zeros((2, 4, 4, 8))
    q = torch.zeros((2, 4, 4, 8), dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(b8, launch)(*args(x, torch.ones(8), q, torch.ones(3, 8)))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x, res, dy, scale, bias = _data(2, SHAPES[0])
    reset_launch_counts()
    for fn in FUNCTIONS:
        _port(fn, *(torch.tensor(a) for a in (x, res, scale, bias, dy)))
    assert not any(launch_counts().values())


class _FakeBnLib:
    """csrc/bn_minres.cu's library, recording each call's arguments."""

    def __init__(self):
        self.calls = []
        for kernel in ("stats", "apply8", "bwd8", "dx8"):
            setattr(self, f"clica_bn_{kernel}",
                    lambda *args, _k=kernel: self.calls.append((_k,) + args) or 0)
        self.clica_error_string = lambda code: b"invalid argument"


@pytest.mark.parametrize("act, res", [("relu", False), ("relu", True), ("none", False)])
def test_module_hands_the_float8_residual_to_the_library(monkeypatch, act, res):
    # MinResBN2d(residuals_f8=True) through the kernel route on CPU tensors,
    # every launch into a stand-in library: the statistics, the apply
    # kernel's float8 mode writing xq, and the backward's two modes reading
    # that xq (and res), in the right modes
    lib = _FakeBnLib()
    on_fake_card(monkeypatch, lib)
    monkeypatch.setattr(b8, "_check_xq", lambda *a: None)
    for name in ("bn_relu8", "bn_add_relu8", "bn_only8"):
        monkeypatch.setattr(layers, name, lambda *a, _n=name, **k: b8._minres8(
            a[0], a[1] if _n == "bn_add_relu8" else None,
            *a[-3:] if _n != "bn_add_relu8" else a[2:5],
            relu=_n != "bn_only8", use_kernels=True))
    x = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    norm = MinResBN2d(8, act=act, residuals_f8=True).train()
    reset_launch_counts()
    y = norm(x, res=r if res else None)
    if res:  # one tensor twice: no pair of edges under minres8
        y, y_res = y
        assert y is y_res
    y.mean(dim=(2, 3)).sum().backward()
    assert [c[0] for c in lib.calls] == ["stats", "apply8", "bwd8", "dx8"]
    mode = {("relu", False): bm.RELU, ("relu", True): bm.ADD_RELU,
            ("none", False): bm.ONLY}[act, res]
    _, apply, bwd, dx = lib.calls
    assert apply[1] == x.data_ptr() and apply[2] == (r if res else x).data_ptr()
    xq = apply[8]
    assert bwd[1] == dx[1] == xq
    if res:
        assert bwd[3] == dx[3] == r.data_ptr()
    assert apply[11:13] == bwd[10:12] == dx[11:13] == (0, mode)
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "bn_stats": 1,
                               "bn_apply8": 1, "bn_bwd8": 1, "bn_dx8": 1}


@pytest.mark.parametrize("act, res", [("relu", False), ("relu", True), ("none", False)])
def test_module_runs_bn_minres8_and_updates_running_as_minres(act, res):
    # MinResBN2d(residuals_f8=True) against MinResBN2d: the same outputs
    # and running buffers bit for bit, the same parameter and buffer
    # names; its gradients are bn_minres8's functions'
    x, r, dy, scale, bias = _data(4, (3, 6, 6, 16))
    nchw = lambda a: torch.tensor(a).permute(0, 3, 1, 2).contiguous()
    outs = []
    for f8 in (True, False):
        norm = MinResBN2d(16, act=act, residuals_f8=f8).train()
        norm.weight.data, norm.bias.data = torch.tensor(scale), torch.tensor(bias)
        xs, rs = nchw(x).requires_grad_(), nchw(r)
        y = norm(xs, res=rs if res else None)
        y = y[0] if res else y  # the pair's first edge alone
        (y * nchw(dy)).sum().backward()
        outs.append((y.detach(), norm.running_mean, norm.running_var, xs.grad,
                     norm.state_dict().keys()))
    (y8, m8, v8, g8, k8), (y, m, v, g, k) = outs
    assert torch.equal(y8, y) and torch.equal(m8, m) and torch.equal(v8, v)
    assert k8 == k
    fn = "bn_add_relu8" if res else "bn_relu8" if act == "relu" else "bn_only8"
    _, want = _port(fn, torch.tensor(x), torch.tensor(r), torch.tensor(scale),
                    torch.tensor(bias), torch.tensor(dy))
    np.testing.assert_allclose(g8.permute(0, 2, 3, 1).numpy(), want[0].numpy(),
                               rtol=1e-6, atol=1e-7)
