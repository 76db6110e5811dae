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
from cl_ica_tpu_torch.ops import launch_counts, reset_launch_counts, runtime
from cl_ica_tpu_torch.ops import pool_minres as pm
from cl_ica_tpu_torch.ops import stem
from torch_fake_card import on_fake_card

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


# (C, H, W, dtype, whether the kernels take it): a --mesh-model M rank's
# stem holds C/M of the 64 channels; 4 and 12 are no multiple of
# bfloat16's 8-channel vector, 6 of float32's 4; 1028 float32 channels are
# 257 vectors; 7 rows are odd
_ROUTES = [(8, 8, 8, torch.float32, True), (8, 8, 8, torch.bfloat16, True),
           (4, 8, 8, torch.float32, True), (4, 8, 8, torch.bfloat16, False),
           (12, 6, 8, torch.bfloat16, False), (6, 8, 8, torch.float32, False),
           (1028, 2, 2, torch.float32, False), (8, 7, 8, torch.float32, False),
           (8, 8, 8, torch.float16, False)]


@pytest.mark.parametrize("c, h, w, dtype, fused", _ROUTES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_module_routes_by_what_the_kernels_take(monkeypatch, c, h, w, dtype, fused):
    # training mode runs bn_relu_pool where pm.takes says its kernels take
    # the map, and MinResBN2d then F.max_pool2d elsewhere; both give the
    # composition's output and running buffers bit for bit
    import cl_ica_tpu_torch.models.layers as layers
    calls, real = [], layers.bn_relu_pool
    monkeypatch.setattr(layers, "bn_relu_pool",
                        lambda x, *a, **k: calls.append(x.shape) or real(x, *a, **k))
    g = torch.Generator().manual_seed(c + h)
    x = (2 * torch.randn(2, h, w, c, generator=g)).to(dtype)
    assert pm.takes(x) is fused
    outs = []
    for norm in (MinResBNPool(c), MinResBN2d(c)):
        with torch.no_grad():
            norm.bias.normal_(generator=torch.Generator().manual_seed(1))
        xs = x.permute(0, 3, 1, 2).requires_grad_()
        p = norm.train()(xs) if isinstance(norm, MinResBNPool) else F.max_pool2d(
            norm.train()(xs), 3, 2, 1)
        p.float().sum().backward()
        outs.append((p.detach(), norm.running_mean, norm.running_var))
    assert len(calls) == int(fused)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_module_eval_is_the_plain_composition():
    norm = MinResBNPool(4)
    norm.running_mean.normal_(generator=torch.Generator().manual_seed(0))
    norm.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(1))
    plain = MinResBN2d(4)
    plain.load_state_dict(norm.state_dict())
    norm.eval(), plain.eval()
    x = torch.randn(2, 4, 6, 6)
    assert torch.equal(norm(x), F.max_pool2d(plain(x), 3, 2, 1))


# ---------------------------------------------------------------------------
# the code kernel's persistent grid (pool_code_plan), its walk and its rule
# ---------------------------------------------------------------------------


def _code_walk(plan, shape, dtype, stages=4):
    """A mirror of pool_code_kernel's walk (csrc/stem_pool.cu): block (b,
    slice) takes tiles b, b + grid, ...; tile t is strip t % strips, segment
    (t // strips) % segs of image t // (strips · segs). Its step k, k0 − 1 ..
    k1 − 1, takes load c, stage k: x rows 2k and 2k + 1 (the first step row
    2k0 − 1 alone, none for k0 = 0), columns 2j0 − 1 .. 2j0 + 2ws − 1
    inside the image; the tile's threads own window columns j0 .. j0 + ws −
    1 inside the image and the slice's vectors, and a step past the first
    writes window row k from row 2k − 1, carried from the step before, and
    the stage's two rows. Returns how often each (image, window row, window
    column, vector) is written; checks that the producer, ``stages`` loads
    ahead at the start and one more after each step's barrier, has issued a
    step's load before the step waits for it, and that every column a
    window reads was staged."""
    n, h, w, c = shape
    ho, wo, cvs = h // 2, w // 2, c // runtime.vector_width(dtype)
    count = np.zeros((n, ho, wo, cvs), np.int32)
    for sl in range(plan.slices):
        v0 = sl * plan.cv
        for b in range(plan.grid):
            tiles = range(b, plan.tiles, plan.grid)
            loads = []  # the producer's order: (tile, stage)
            for t in tiles:
                k0 = t // plan.strips % plan.segs * plan.ks
                loads += [(t, st) for st in range(k0 - 1, min(k0 + plan.ks, ho))]
            step = 0
            for t in tiles:
                j0 = t % plan.strips * plan.ws
                rest = t // plan.strips
                k0 = rest % plan.segs * plan.ks
                k1 = min(k0 + plan.ks, ho)
                img = rest // plan.segs
                assert img < n and k0 < ho and j0 < wo
                j1 = min(j0 + plan.ws, wo)
                staged = set(range(max(0, 2 * j0 - 1), min(w, 2 * j0 + 2 * plan.ws)))
                assert all({2 * j, 2 * j + 1} <= staged and (j == 0 or 2 * j - 1 in staged)
                           for j in range(j0, j1))
                carried = None
                for k in range(k0 - 1, k1):
                    issued = min(len(loads), stages + step)
                    assert step < issued and loads[step] == (t, k)
                    if k >= k0:
                        assert carried == (2 * k - 1 if k > 0 else None)
                        count[img, k, j0:j1, v0:v0 + plan.cv] += 1
                    carried = 2 * k + 1 if k >= 0 else None
                    step += 1
            assert step == len(loads)
    return count


# (N, H, W, C); "256v": C of 256 vectors of the dtype, the widest
_CODE_SHAPES = [
    (1024, 112, 112, 64),  # main_3dident's stem tail at 1024 images
    (1, 2, 2, 8),          # one window
    (1, 112, 112, 64),     # one image
    (2, 10, 70, 64),       # Wo = 35: no strip divides it
    (3, 30, 14, 24),       # Ho = 15: ragged segments
    (1, 6, 10, "256v"),    # 16 slices
]


@pytest.mark.parametrize("slots", [1, 7, 264, 396])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _CODE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_code_walk_writes_every_window_once(shape, dtype, slots):
    n, h, w, c = shape
    if c == "256v":
        c = 256 * runtime.vector_width(dtype)
    shape = (n, h, w, c)
    plan = pm.pool_code_plan(*shape, dtype, slots)
    ho, wo, cvs = h // 2, w // 2, c // runtime.vector_width(dtype)
    # the kernel's own constraints on a plan (clica_pool_code refuses others)
    assert plan.cv >= 1 and plan.ws >= 1 and plan.ks >= 1
    assert (plan.ws + 1) * plan.cv <= stem.THREADS and plan.cv <= stem.MAX_SLICE
    assert (plan.slices - 1) * plan.cv < cvs <= plan.slices * plan.cv
    assert (plan.strips - 1) * plan.ws < wo <= plan.strips * plan.ws
    assert (plan.segs - 1) * plan.ks < ho <= plan.segs * plan.ks
    assert plan.tiles == n * plan.segs * plan.strips
    assert 1 <= plan.grid <= plan.tiles
    assert plan.grid * plan.slices <= max(slots, plan.slices)  # one wave
    count = _code_walk(plan, shape, dtype)
    assert count.min() == 1 and count.max() == 1
    assert pm.pool_code_plan(*shape, dtype, slots) == plan  # a fixed plan


@pytest.mark.parametrize("dtype, slots, want", [
    # (1024, 112, 112, 64): 4 strips of 14 window columns in float32 (15 x
    # 16 threads), 2 of 28 in bfloat16 (29 x 8); a whole image's rows a
    # tile at two blocks an SM
    (torch.float32, 264, (16, 1, 14, 4, 56, 1, 4096, 264)),
    (torch.float32, 396, (16, 1, 14, 4, 28, 2, 8192, 396)),
    (torch.bfloat16, 264, (8, 1, 28, 2, 56, 1, 2048, 264)),
    (torch.bfloat16, 396, (8, 1, 28, 2, 14, 4, 8192, 396)),
])
def test_pool_code_plan_at_the_main_path(dtype, slots, want):
    assert tuple(pm.pool_code_plan(1024, 112, 112, 64, dtype, slots)) == want


def _kernel_z(x, a, b):
    """z as the code kernel computes it: the float32 product and sum each
    rounded to x's dtype, then the relu, once an input element."""
    y = (x.float() * a.float()).to(x.dtype).float() + b.float()
    return y.to(x.dtype).float().clamp_(min=0)


def _kernel_rule(z):
    """pool_code_kernel's winner rule on z (N, H, W, C), in float32: each
    row's first maximum over the window's columns 2j − 1 (none at j = 0),
    2j and 2j + 1, with its column; then the window's, row by row: the row
    2k − 1 carried from the window above (none at k = 0), then 2k and 2k +
    1, a row taking the window only where its maximum is greater."""
    n, h, w, c = z.shape
    below = torch.full((n, h, 1, c), -1.0)
    m = torch.cat([below, z[:, :, 1:w - 1:2]], 2)  # column 2j − 1
    d = torch.zeros(m.shape, dtype=torch.uint8)
    for col, cand in ((1, z[:, :, 0::2]), (2, z[:, :, 1::2])):
        take = cand > m
        m = torch.where(take, cand, m)
        d = torch.where(take, col, d)
    pooled, code = [], []
    top_m, top_d = torch.full_like(m[:, 0], -1.0), torch.zeros_like(d[:, 0])
    for k in range(h // 2):
        wm, wd = top_m, top_d
        for r, base in ((2 * k, 3), (2 * k + 1, 6)):
            take = m[:, r] > wm
            wm = torch.where(take, m[:, r], wm)
            wd = torch.where(take, d[:, r] + base, wd)
        pooled.append(wm)
        code.append(wd)
        top_m, top_d = m[:, 2 * k + 1], d[:, 2 * k + 1]  # the carried row
    return torch.stack(pooled, 1), torch.stack(code, 1)


def _tie_case(case, shape, seed):
    """Inputs that tie: x on a few levels (zeros of both signs among them),
    a = 0 (z = relu(b), a constant a channel), or a < 0 with x ≥ 0 and b
    ≤ 0, so that every window is all zeros."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = np.round(rng.normal(size=shape) * 0.75) / 2
    a = rng.normal(size=c)
    b = 0.3 * rng.normal(size=c)
    if case == "a=0":
        a = np.where(np.arange(c) % 2, 0.0, -0.0)
    if case == "a<0":
        x, a, b = np.abs(x) + 0.25, -0.5 - np.abs(a), -np.abs(b)
    return x.astype(np.float32), a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("case", ["levels", "a=0", "a<0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernels_winner_rule_is_the_first_maximum(dtype, case):
    # rows first, the bottom row carried: the codes of pool_code_reference
    # byte for byte and of the JAX _pool_fwd_core, pooled bit for bit
    shape = (2, 8, 14, 8)
    x, a, b = (torch.tensor(v).to(dtype) for v in _tie_case(case, shape, 11))
    z = _kernel_z(x, a, b)
    pooled, code = _kernel_rule(z)
    want_p, want_c = pm.pool_code_reference(x, a, b)
    assert torch.equal(code, want_c)
    assert torch.equal(pooled.to(dtype), want_p)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp, jcode = jax.jit(jax_pool._pool_fwd_core)(jnp.asarray(z.numpy()).astype(jdt))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode).astype(np.uint8))
    np.testing.assert_array_equal(pooled.numpy(), _np(jp))
    if case == "a<0":  # each window's first position inside the image
        first = np.zeros((4, 7), np.uint8)
        first[0, 0], first[0, 1:], first[1:, 0] = 4, 3, 1
        assert not bool(pooled.any())
        assert (code.numpy() == first[None, :, :, None]).all()


class _FakeCodeLib:
    """csrc/stem_pool.cu's library, recording each call's arguments; three
    code blocks fit an SM."""

    def __init__(self):
        self.calls = []

    def clica_pool_code_blocks_per_sm(self, *args):
        self.calls.append(("blocks_per_sm",) + args[:-1])
        args[-1]._obj.value = 3
        return 0

    def clica_pool_code(self, *args):
        self.calls.append(("code",) + args)
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_code_launch_takes_the_plan(monkeypatch, dtype):
    # launch_pool_code asks the library how many code blocks fit an SM for
    # the geometry, hands pool_code_plan whole to the kernel with the
    # shape, and counts one launch
    lib = _FakeCodeLib()
    on_fake_card(monkeypatch, lib)
    shape = (1024, 112, 112, 64)
    x = torch.zeros(shape, device="meta", dtype=dtype)
    v = torch.zeros(64, device="meta", dtype=dtype)
    before = launch_counts()
    pooled, code = pm.launch_pool_code(x, v, v)
    plan = pm.pool_code_plan(*shape, dtype, 3 * 132)
    bf16 = int(dtype == torch.bfloat16)
    assert lib.calls[0] == ("blocks_per_sm", plan.cv, plan.ws, bf16)
    call = lib.calls[1]
    assert call[0] == "code" and len(call) == 20
    assert call[6:] == (*shape, bf16, *plan, None)
    assert pooled.shape == code.shape == (1024, 56, 56, 64)
    assert code.dtype == torch.uint8 and pooled.dtype == dtype
    before["pool_code"] += 1
    assert launch_counts() == before
