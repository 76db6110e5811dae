"""ops/bn_minres.py and models/layers.py MinResBN2d against
cl_ica_tpu/ops/bn_minres.py, on the CPU.

The same numpy inputs and cotangents go through the JAX custom VJPs (under
``jax.jit``, through ``jax.vjp``) and through the port's Functions, which on
CPU tensors run the plain versions of the four CUDA kernels; the kernels
themselves are held against those plain versions on the card by
chip_smoke.py. Bars: float32 values 1e-5 and gradients 1e-4 of the
largest magnitude; bfloat16 two bfloat16 ulps of it (the two packages
round bfloat16 intermediates at other places).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cl_ica_tpu.ops import bn_minres as jax_bn
from cl_ica_tpu_torch.models import layers
from cl_ica_tpu_torch.models.layers import FastBatchNorm2d, MinResBN2d
from cl_ica_tpu_torch.ops import bn_minres as bm
from cl_ica_tpu_torch.ops import launch_counts, reset_launch_counts
from torch_fake_card import on_fake_card

torch.set_num_threads(1)

SHAPES = [(4, 6, 6, 16), (3, 5, 7, 24)]
FUNCTIONS = ("bn_relu", "bn_add_relu", "bn_only")
BF16_ULP = 2.0 ** -7
EPS = 1e-5


def _data(seed, shape, zero_scale=False):
    """x like a convolution's output (per-channel scale and offset), res,
    a cotangent, and the norm's scale (all 0 for a block's last norm) and
    bias."""
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
def _jax_vjp(fn, dtype):
    """(outputs, gradients) of the JAX function under jit: y, mean, var and
    the cotangent's dx (dres), dscale, dbias."""
    if fn == "bn_add_relu":
        def run(x, res, scale, bias, dy):
            out, pull = jax.vjp(lambda *a: jax_bn.bn_add_relu(*a, EPS),
                                x, res, scale, bias)
            return out, pull((dy, jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))
    else:
        f = getattr(jax_bn, fn)

        def run(x, res, scale, bias, dy):
            out, pull = jax.vjp(lambda *a: f(*a, EPS), x, scale, bias)
            return out, pull((dy, jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))
    return jax.jit(run)


def _port(fn, x, res, scale, bias, dy):
    """The port's function on CPU tensors: (y, mean, var) and the
    gradients (dx[, dres], dscale, dbias) of sum(y · dy)."""
    args = [x] + ([res] if fn == "bn_add_relu" else []) + [scale, bias]
    leaves = [a.clone().requires_grad_() for a in args]
    out = getattr(bm, fn)(*leaves, EPS)  # bn_add_relu's y_res left unused
    y, mean, var = out[0], out[-2], out[-1]
    (y.float() * dy.float()).sum().backward()
    return (y, mean, var), [t.grad for t in leaves]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


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
    (jy, jmean, jvar), jgrads = _jax_vjp(fn, jdt)(
        cast(x), cast(res), jnp.asarray(scale), jnp.asarray(bias), cast(dy))
    tx, tres, tdy = (torch.tensor(a).to(tdt) for a in (x, res, dy))
    (y, mean, var), grads = _port(fn, tx, tres, torch.tensor(scale),
                                  torch.tensor(bias), tdy)
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    as_np = lambda t: t.detach().float().numpy()
    jnp_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    value_bar = 2 * BF16_ULP if dtype == "bfloat16" else 1e-5
    grad_bar = 2 * BF16_ULP if dtype == "bfloat16" else 1e-4
    # the statistics are float32 sums in both packages; in bfloat16 the
    # port rounds x² to bfloat16 first, as the eager jnp.square does, where
    # XLA under jit keeps it in float32
    for got, want in ((mean, jmean), (var, jvar)):
        assert _rel(as_np(got), jnp_np(want)) <= value_bar
    assert _rel(as_np(y), jnp_np(jy)) <= value_bar
    assert len(grads) == len(jgrads) == (4 if fn == "bn_add_relu" else 3)
    for got, want in zip(grads, jgrads):
        assert got.dtype == (tdt if got.ndim == 4 else torch.float32)
        assert _rel(as_np(got), jnp_np(want)) <= grad_bar


def two_edges_against_autograds_add(x, res, scale, bias, w1, w2, edges):
    """bn_add_relu's gradients with its output's two edges, y and y_res, each
    into a consumer of its own (a product with w1, w2: a convolution's and
    a shortcut's stand-ins), and with one tensor on both consumers, whose
    gradients autograd adds before the one-addend backward; ``edges`` names
    the consumers used. ([x, res, scale, bias, w1, w2] gradients) of each:
    two edges first."""
    out = []
    for pair in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, res, scale, bias, w1, w2)]
        y, y_res, _, _ = bm.bn_add_relu(*leaves[:4], EPS)
        if not pair:
            y_res = y
        terms = {"both": (y * leaves[4], y_res * leaves[5]),
                 "y": (y * leaves[4],), "y_res": (y_res * leaves[5],)}[edges]
        sum(t.float().sum() for t in terms).backward()
        out.append([t.grad for t in leaves])
    return out


@pytest.mark.parametrize("edges", ["both", "y", "y_res"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_two_edges_give_autograds_add_bit_for_bit(dtype, edges):
    # the backward adds the two upstream gradients in x's dtype, as
    # autograd's add does: x, res, scale, bias and both consumers' gradients
    # equal the single tensor's bit for bit; an edge left unused brings no
    # gradient, and the other alone is the one-addend backward
    x, r, _, scale, bias = _data(5, SHAPES[1])
    rng = np.random.default_rng(6)
    w1, w2 = (torch.tensor(rng.normal(size=x.shape)).to(dtype) for _ in range(2))
    tx, tr = (torch.tensor(a).to(dtype) for a in (x, r))
    pair, single = two_edges_against_autograds_add(
        tx, tr, torch.tensor(scale), torch.tensor(bias), w1, w2, edges)
    used = {"both": (4, 5), "y": (4,), "y_res": (5,)}[edges]
    for i, (got, want) in enumerate(zip(pair, single)):
        if i in (4, 5) and i not in used:
            assert got is None and want is None
            continue
        assert got.dtype == want.dtype and torch.equal(got, want), i


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_statistics_outputs_carry_no_gradient(fn):
    x, res, _, scale, bias = _data(0, SHAPES[0])
    args = [torch.tensor(x, requires_grad=True)] + (
        [torch.tensor(res, requires_grad=True)] if fn == "bn_add_relu" else []) + [
        torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)]
    out = getattr(bm, fn)(*args, EPS)
    assert len(out) == (4 if fn == "bn_add_relu" else 3)
    assert all(t.requires_grad for t in out[:-2])
    assert not out[-2].requires_grad and not out[-1].requires_grad


def _saved(fn, x, res, scale, bias):
    """Every tensor the forward saves for the backward."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x, res, scale, bias)
    return saved


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_only_x_and_the_output_are_saved_at_activation_size(fn):
    # the minimal residual: bn_relu and bn_only keep x, bn_add_relu x and
    # its own output y (which the next layer keeps anyway; the JAX VJP
    # keeps res, which for a projection shortcut nothing else keeps), and
    # nothing else of an activation's size (no pre-activation, no relu
    # mask, no normalised x, no res); the composition under autograd keeps
    # more
    x, res, _, scale, bias = _data(1, SHAPES[1])
    tx = torch.tensor(x, requires_grad=True)
    tres = torch.tensor(res, requires_grad=True)
    ts, tb = (torch.tensor(a, requires_grad=True) for a in (scale, bias))
    outputs = []

    def minres(x, res, scale, bias):
        if fn == "bn_add_relu":
            outputs.append(bm.bn_add_relu(x, res, scale, bias, EPS)[0])
        else:
            outputs.append(getattr(bm, fn)(x, scale, bias, EPS)[0])

    saved = _saved(minres, tx, tres, ts, tb)
    big = [t for t in saved if t.numel() == tx.numel()]
    want = [tx, outputs[0]] if fn == "bn_add_relu" else [tx]
    assert len(big) == len(want)
    assert all(s.data_ptr() == w.data_ptr() for s, w in zip(big, want))
    assert all(s.data_ptr() != tres.data_ptr() for s in saved)
    assert all(t.numel() == x.shape[-1] for t in saved if t.numel() != tx.numel())

    def composed(x, res, scale, bias):
        norm = FastBatchNorm2d(x.shape[-1]).train()
        y = norm(x.permute(0, 3, 1, 2))
        y = y + res.permute(0, 3, 1, 2) if fn == "bn_add_relu" else y
        return F.relu(y) if fn != "bn_only" else y

    more = [t for t in _saved(composed, tx, tres, ts, tb) if t.numel() == tx.numel()]
    assert len(more) > len(big)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x, res, dy, scale, bias = _data(2, SHAPES[0])
    reset_launch_counts()
    for fn in FUNCTIONS:
        _port(fn, torch.tensor(x), torch.tensor(res), torch.tensor(scale),
              torch.tensor(bias), torch.tensor(dy))
    assert not any(launch_counts().values())


@pytest.mark.parametrize("launch, args", [
    ("launch_stats", lambda x, v, k: (x, EPS)),
    ("launch_apply", lambda x, v, k: (x, v, v)),
    ("launch_bwd", lambda x, v, k: (x, x, v, v)),
    ("launch_dx", lambda x, v, k: (x, x, k, v, v)),
])
def test_kernel_wrappers_refuse_cpu_tensors(launch, args):
    # a wrapper never takes the plain version: off the card it raises
    x = torch.zeros((2, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(bm, launch)(*args(x, torch.ones(8), torch.ones(3, 8)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu, res", [(True, False), (True, True), (False, False)])
def test_plain_versions_are_the_jax_lines(dtype, relu, res):
    # apply, the backward sums and dx as the JAX package writes them
    # (_affine, _mask_grad, _bn_bwd_core), given the same statistics
    x, r, dy, scale, bias = _data(3, SHAPES[1])
    tx, tr, tdy = (torch.tensor(a).to(dtype) for a in (x, r, dy))
    mean, var, rstd = bm.channel_stats(tx, EPS)
    a, b = bm.affine(torch.tensor(scale), torch.tensor(bias), mean, rstd, dtype)
    ja, jb = jax_bn._affine(jnp.asarray(scale), jnp.asarray(bias),
                            jnp.asarray(mean.numpy()), jnp.asarray(rstd.numpy()),
                            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_array_equal(a.float().numpy(), np.asarray(ja, np.float32))
    np.testing.assert_array_equal(b.float().numpy(), np.asarray(jb, np.float32))
    rr = tr if res else None
    # bn_add_relu's backward masks with its output's sign
    y = bm.bn_apply_reference(tx, a, b, rr, relu) if res else None
    jx, jdy = (jnp.asarray(t.float().numpy()).astype(ja.dtype) for t in (tx, tdy))
    jres = jnp.asarray(tr.float().numpy()).astype(ja.dtype) if res else None
    g_want = jax_bn._mask_grad(jx, ja, jb, jdy, res=jres) if relu else jdy
    dx_want, dscale_want, dbias_want = jax_bn._bn_bwd_core(
        jx, jnp.asarray(scale), jnp.asarray(mean.numpy()),
        jnp.asarray(rstd.numpy()), g_want)
    sum_g, sum_gx, g = bm.bn_bwd_reference(tx, tdy, a, b, y, relu)
    dscale, dbias, k = bm.dx_factors(torch.tensor(scale), mean, rstd, sum_g,
                                     sum_gx, tx.numel() // tx.shape[-1], dtype)
    if res:  # bn_add_relu's dx is bn_only's on the g its sums wrote
        dx = bm.bn_dx_reference(tx, g, k, a, b, relu=False)
    else:
        assert g is None
        g = bm._masked(tx, tdy, a, b, None, relu)
        dx = bm.bn_dx_reference(tx, tdy, k, a, b, relu)
    f = lambda t: t.detach().float().numpy()
    np.testing.assert_array_equal(f(g), np.asarray(g_want, np.float32))
    bar = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    assert _rel(f(dscale), dscale_want) <= 1e-5
    assert _rel(f(dbias), dbias_want) <= 1e-5
    assert _rel(f(dx), np.asarray(dx_want, np.float32)) <= bar


@pytest.mark.parametrize("positions, c, dtype, sms, want", [
    (1024 * 112 * 112, 64, torch.float32, 132, 528),
    (1024 * 7 * 7, 512, torch.float32, 132, 528),
    (1024 * 56 * 56, 64, torch.bfloat16, 132, 528),
    (200, 16, torch.float32, 132, 4),      # 64 positions a pass
    (105, 24, torch.float32, 2, 3),        # 6 vectors: 42 positions a pass
    (9, 2064, torch.float32, 132, 9)])     # 516 vectors: 3 slices of 172
def test_grid_rows(positions, c, dtype, sms, want):
    # as many blocks as the positions need at THREADS // vectors of a
    # slice a pass, at most BLOCKS_PER_SM an SM
    assert bm.grid_rows(positions, c, dtype, sms) == want


class _FakeBnLib:
    """csrc/bn_minres.cu's library, recording each call's arguments and
    returning ``rc``."""

    def __init__(self, rc=0):
        self.calls = []

        def entry(name):
            return lambda *args: self.calls.append((name,) + args) or rc

        for kernel in ("stats", "apply", "bwd", "dx"):
            setattr(self, f"clica_bn_{kernel}", entry(kernel))
        self.clica_error_string = lambda code: b"invalid argument"


@contextlib.contextmanager
def _fake_card(monkeypatch, lib):
    """MinResBN2d's functions on CPU tensors through the kernel route,
    every launch into ``lib`` on a card of 132 SMs; each map handed to the
    library is checked dense and recorded with its data pointer."""
    maps = []

    def check(name, t, like=None):
        assert t.is_contiguous(), name
        maps.append((name, t.data_ptr()))

    on_fake_card(monkeypatch, lib, check_map=check)
    for fn, res, relu in (("bn_relu", False, True), ("bn_add_relu", True, True),
                          ("bn_only", False, False)):
        def kernel_route(x, *args, _res=res, _relu=relu):
            r = args[0] if _res else None
            scale, bias, eps = args[1:] if _res else args
            y, y_res, mean, var = bm._minres(x, r, scale, bias, eps, _relu, True)
            return (y, y_res, mean, var) if _res else (y, mean, var)
        monkeypatch.setattr(layers, fn, kernel_route)
    yield maps


@pytest.mark.parametrize("act, res, edges", [
    ("relu", False, 1), ("relu", True, 1), ("relu", True, 2), ("none", False, 1)])
def test_module_hands_dense_channels_last_pointers_to_the_library(monkeypatch, act, res,
                                                                  edges):
    # x and res in place, the output y made by the library, and the
    # backward's reads (x, dy, with res the output y, and with both of its
    # edges used the second upstream gradient) all dense; with res the sums'
    # pass writes g, which dx reads in bn_only's mode
    lib = _FakeBnLib()
    x = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    w = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    r.requires_grad_()
    norm = MinResBN2d(8, act=act).train()
    reset_launch_counts()
    bm.reset_dy_copies()
    with _fake_card(monkeypatch, lib) as maps:
        out = norm(x, res=r if res else None)
        y, y_res = out if res else (out, None)
        assert y.shape == x.shape and y.is_contiguous(memory_format=torch.channels_last)
        if res:  # one tensor on two edges: outputs 0 and 1 of one node
            (node, i), = y.grad_fn.next_functions
            assert y_res.data_ptr() == y.data_ptr() and i == 0
            assert y_res.grad_fn.next_functions == ((node, 1),)
        # the mean pool's backward hands a gradient that is not dense NHWC;
        # the second edge's is dense
        loss = y.mean(dim=(2, 3)).sum()
        (loss + (y_res * w).sum() if edges == 2 else loss).backward()
    mode = {("relu", False): bm.RELU, ("relu", True): bm.ADD_RELU,
            ("none", False): bm.ONLY}[act, res]
    assert [c[0] for c in lib.calls] == ["stats", "apply", "bwd", "dx"]
    grid = bm.grid_rows(50, 8, torch.float32, 132)
    stats, apply, bwd, dx = lib.calls
    # x and res reach the library in place (no copy), dy as one dense copy
    assert stats[1] == x.data_ptr() and apply[1] == x.data_ptr()
    assert stats[4:] == (50, 8, 0, grid, EPS, None)
    assert apply[2] == (r if res else x).data_ptr()
    assert apply[6:] == (50, 8, 0, mode, grid, None)
    assert bwd[1] == dx[1] == x.data_ptr()
    assert (bwd[3] is None) == (edges == 1)
    assert bwd[4] == (apply[5] if res else x.data_ptr())
    assert (bwd[9] is None) != res
    assert dx[2] == (bwd[9] if res else bwd[2])
    assert bwd[10:] == (50, 8, 0, mode, grid, None)
    assert dx[7:] == (50, 8, 0, bm.ONLY if res else mode, grid, None)
    assert bm.dy_copies() == 1
    assert ("dy", bwd[2]) in maps
    if edges == 2:
        assert ("dy_res", bwd[3]) in maps
    assert launch_counts() == {**{k: 0 for k in launch_counts()},
                               "bn_stats": 1, "bn_apply": 1, "bn_bwd": 1, "bn_dx": 1,
                               "bn_junctions": int(edges == 2)}
    assert x.grad.shape == x.shape and (r.grad is not None) == res


def test_a_failing_library_raises(monkeypatch):
    lib = _FakeBnLib(rc=1)
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    with _fake_card(monkeypatch, lib):
        with pytest.raises(RuntimeError, match="bn stats kernel launch failed: "
                                               "invalid argument"):
            MinResBN2d(8).train()(x)
    assert len(lib.calls) == 1


@pytest.mark.parametrize("act, res", [("relu", False), ("relu", True), ("none", False)])
def test_module_training_matches_the_composition_and_updates_running(act, res):
    # MinResBN2d against FastBatchNorm2d (+ res) (+ relu) under autograd:
    # outputs, running buffers and every gradient
    x, r, dy, scale, bias = _data(4, (3, 6, 6, 16))
    nchw = lambda a: torch.tensor(a).permute(0, 3, 1, 2).contiguous()
    got_norm, want_norm = MinResBN2d(16, act=act), FastBatchNorm2d(16)
    for n in (got_norm, want_norm):
        n.weight.data = torch.tensor(scale)
        n.bias.data = torch.tensor(bias)
        n.train()
    outs = []
    for norm, minres in ((got_norm, True), (want_norm, False)):
        xs, rs = nchw(x).requires_grad_(), nchw(r).requires_grad_()
        if minres:
            y = norm(xs, res=rs if res else None)
        else:
            y = norm(xs)
            y = y + rs if res else y
            y = F.relu(y) if act == "relu" else y
            y = (y, y) if res else y
        if res:  # a cotangent on each of the pair's two edges
            y, y_res = y
            (y * nchw(dy) + y_res * nchw(dy[::-1].copy())).sum().backward()
        else:
            (y * nchw(dy)).sum().backward()
        outs.append((y.detach(), xs.grad, rs.grad, norm.weight.grad, norm.bias.grad,
                     norm.running_mean, norm.running_var))
    for got, want in zip(*outs):
        if want is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


def test_module_eval_is_the_plain_composition():
    norm = MinResBN2d(8)
    norm.running_mean.normal_(generator=torch.Generator().manual_seed(0))
    norm.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(1))
    x, r = torch.randn(2, 8, 4, 4), torch.randn(2, 8, 4, 4)
    plain = FastBatchNorm2d(8)
    plain.load_state_dict(norm.state_dict())
    norm.eval(), plain.eval()
    y, y_res = norm(x, res=r)
    assert y is y_res and torch.equal(y, F.relu(plain(x) + r))
    assert torch.equal(norm(x), F.relu(plain(x)))
    norm.act = "none"
    assert torch.equal(norm(x), plain(x))


def test_module_refuses_what_the_jax_module_refuses():
    with pytest.raises(ValueError, match="act"):
        MinResBN2d(8, act="gelu")
    with pytest.raises(ValueError, match="relu"):
        MinResBN2d(8, act="none").train()(torch.randn(2, 8, 2, 2),
                                          res=torch.randn(2, 8, 2, 2))
    assert MinResBN2d(8).state_dict().keys() == FastBatchNorm2d(8).state_dict().keys()
