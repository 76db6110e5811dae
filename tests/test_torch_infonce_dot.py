"""cl_ica_tpu_torch.ops.infonce_dot and SimCLRLoss against the JAX package.

The same numpy inputs go through the JAX function and the port. On the
CPU the port's fused_dot_lse is its plain version (dot_lse_reference);
the JAX side runs its Pallas kernel in interpret mode, as tests/test_ops.py
does. The Hopper kernels themselves are compared with the plain version
on the card by chip_smoke.py: pytest cannot start there.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.losses import SimCLRLoss as JaxSimCLRLoss
from cl_ica_tpu.ops import fused_dot_lse as jax_fused_dot_lse
from cl_ica_tpu_torch.losses import SimCLRLoss
from cl_ica_tpu_torch.ops import (
    dot_lse_reference,
    fused_dot_lse,
    launch_counts,
    reset_launch_counts,
)

torch.set_num_threads(1)


def _rolled(m, n_rows, n_feat, seed, scale=0.5):
    """z1 (m, n) and z3 (n_rows, n) with z3[(i+1) % n_rows] = z1[i], as
    z3_rec = roll(z1_rec, 1) gives."""
    rng = np.random.default_rng(seed)
    z1 = (scale * rng.normal(size=(m, n_feat))).astype(np.float32)
    z3 = (scale * rng.normal(size=(n_rows, n_feat))).astype(np.float32)
    for i in range(min(m, n_rows)):
        z3[(i + 1) % n_rows] = z1[i]
    return z1, z3


@pytest.mark.parametrize("n_feat", [3, 6, 8, 10, 16])
@pytest.mark.parametrize("tau", [0.5, 1.0])
@pytest.mark.parametrize("shape", [(7, 7), (50, 50), (32, 96), (96, 32)])
def test_dot_lse_matches_jax_kernel(tau, shape, n_feat):
    # tolerances of tests/test_ops.py: values rtol 1e-4 / atol 1e-5, both
    # grads rtol 5e-3 / atol 5e-4 (float32 sums in different orders); the
    # cotangent is not constant across rows, as after logaddexp and mean.
    # n: main_3dident's angular slice (8), main_mlp's latents (10), and the
    # widths around the kernel's instances (3, 6, 16)
    m, n_rows = shape
    z1, z3 = _rolled(m, n_rows, n_feat, seed=m + n_rows + n_feat)
    ct = np.linspace(0.5, 1.5, m).astype(np.float32)

    def jax_obj(a, b):
        lse = jax_fused_dot_lse(a, b, tau, 32, True)
        return jnp.sum(lse * ct), lse

    (_, want), (want_d1, want_d3) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(z1), jnp.asarray(z3))

    a = torch.tensor(z1, requires_grad=True)
    b = torch.tensor(z3, requires_grad=True)
    got = fused_dot_lse(a, b, tau)
    (got * torch.tensor(ct)).sum().backward()

    assert got.shape == (m,) and a.grad.shape == z1.shape and b.grad.shape == z3.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    for g, w in ((a.grad, want_d1), (b.grad, want_d3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-4)


def test_reference_is_the_closed_form():
    # lse against float64 numpy, and the gradient against the softmax
    # closed form dz1 = (c/τ ⊙ W) @ z3, dz3 = (c/τ ⊙ W)ᵀ @ z1; 1e-5 relative
    z1, z3 = _rolled(20, 30, 5, seed=2)
    ct = np.linspace(0.5, 1.5, 20)
    tau = 0.7
    x = z1.astype(np.float64) @ z3.astype(np.float64).T / tau
    lse = np.log(np.exp(x - x.max(1, keepdims=True)).sum(1)) + x.max(1)
    cw = np.exp(x - lse[:, None]) * (ct / tau)[:, None]

    a = torch.tensor(z1, requires_grad=True)
    b = torch.tensor(z3, requires_grad=True)
    got = dot_lse_reference(a, b, tau)
    (got * torch.tensor(ct, dtype=torch.float32)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), lse, rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), cw @ z3, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), cw.T @ z1, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_feat", [3, 8, 10, 13])
def test_zero_features_change_nothing(n_feat):
    # The argument the kernel's instances rest on: a runtime n is staged
    # into NF = 4, 8, 12 or 16 features, zero past n. Padding z1 and z3 with
    # zero features to 16 leaves the value and the first n columns of both
    # gradients as they were, to 1e-5 of their largest entry (the plain
    # version's float32 sum over 16 products groups them otherwise than
    # over n), and the padded columns' gradients exactly 0.
    z1, z3 = _rolled(40, 56, n_feat, seed=n_feat)
    ct = torch.linspace(0.5, 1.5, 40)
    out = []
    for width in (n_feat, 16):
        a, b = (torch.tensor(np.pad(z, ((0, 0), (0, width - n_feat))),
                             requires_grad=True) for z in (z1, z3))
        lse = dot_lse_reference(a, b, 0.7)
        (lse * ct).sum().backward()
        out.append((lse.detach(), a.grad, b.grad))
    (lse, d1, d3), (lse_p, d1_p, d3_p) = out
    for got, want in ((lse_p, lse), (d1_p[:, :n_feat], d1), (d3_p[:, :n_feat], d3)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(d1_p[:, n_feat:], torch.zeros(40, 16 - n_feat))
    assert torch.equal(d3_p[:, n_feat:], torch.zeros(56, 16 - n_feat))


def _round_to_float32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32, ties to even (normal range)."""
    if x == 0:
        return x
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length() - 23
    while x / Fraction(2) ** e >= 2 ** 24:
        e += 1
    while x / Fraction(2) ** e < 2 ** 23:
        e -= 1
    m = x / Fraction(2) ** e
    whole, rest = divmod(m.numerator, m.denominator)
    if 2 * rest > m.denominator or (2 * rest == m.denominator and whole % 2):
        whole += 1
    return sign * whole * Fraction(2) ** e


@pytest.mark.parametrize("tau", [0.05, 0.7, 1.0, 0.1, 0.3, 1.7, 0.013, 9.0])
def test_quotient_is_the_division(tau):
    # csrc/infonce_common.cuh's quotient(), the x of both tiled forwards and
    # of the dot's tiled gradients: with rtau = RN(1 / tau), q =
    # RN(d * rtau), then RN(q + RN(d - q * tau) * rtau) by two fmaf, must
    # be RN(d / tau) bit for bit, the division's x (Markstein's theorem).
    # Every step is one float32 rounding of an exact rational, as fmaf and
    # the product round on the card.
    rng = np.random.default_rng(int(1000 * tau))
    t = Fraction(float(np.float32(tau)))
    rtau = _round_to_float32(1 / t)
    ds = np.concatenate([rng.normal(size=500) * 10.0 ** rng.uniform(-6, 3, 500),
                         rng.uniform(-900, 900, 250)]).astype(np.float32)
    for d in map(Fraction, ds.astype(np.float64)):
        q = _round_to_float32(d * rtau)
        remainder = d - q * t
        assert _round_to_float32(remainder) == remainder  # exact in one fmaf
        got = _round_to_float32(q + remainder * rtau)
        assert got == _round_to_float32(d / t), (float(d), tau)


@pytest.mark.parametrize("shape", [(16, 16), (8, 24)])
def test_large_logits_stay_finite(shape):
    # rows of norm up to 30 at τ = 0.05: logits of order ±1e4, far past
    # where exp overflows float32; value and grads stay finite and agree
    # with float64 to 1e-5 of their largest entry (the softmax is one-hot
    # on these inputs, so float32 rounding of a logit cannot move a weight)
    z1, z3 = (30 * z / np.linalg.norm(z, axis=1, keepdims=True)
              for z in _rolled(*shape, 10, seed=8))

    out = {}
    for dtype in (torch.float32, torch.float64):
        a = torch.tensor(z1, dtype=dtype, requires_grad=True)
        b = torch.tensor(z3, dtype=dtype, requires_grad=True)
        lse = fused_dot_lse(a, b, 0.05)
        lse.sum().backward()
        out[dtype] = (lse.detach(), a.grad, b.grad)
    assert float(out[torch.float64][0].abs().max()) > 1e4
    for got, want in zip(out[torch.float32], out[torch.float64]):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _simclr_inputs(seed):
    rng = np.random.default_rng(seed)
    z1r = rng.normal(size=(24, 5)).astype(np.float32)
    z2r = (z1r + 0.3 * rng.normal(size=z1r.shape)).astype(np.float32)
    return z1r, z2r, np.roll(z1r, 1, axis=0)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("use_fused", [None, False])
def test_simclr_loss_matches_jax(normalize, jax_fused, use_fused):
    # per-item losses to 1e-5; grads to 1e-4 of their largest entry
    # (float32 sums in different orders). The JAX side runs both of its
    # routes; its fused one is SimCLRLoss's fused branch written out, so
    # that the Pallas kernel can be asked for interpret mode.
    z1r, z2r, z3r = _simclr_inputs(5)
    jl = JaxSimCLRLoss(normalize=normalize, tau=0.8, use_fused=False)

    def jax_obj(a, b, c):
        if jax_fused:
            if normalize:
                a, b, c = (z / jnp.linalg.norm(z, axis=-1, keepdims=True)
                           for z in (a, b, c))
            pos = jnp.sum(a * b, axis=-1)
            lse = jax_fused_dot_lse(a, c, 0.8, 32, True)
            per_item = 2 * (0.5 * (-pos / 0.8)
                            + 0.5 * jnp.logaddexp(lse, pos / 0.8))
            return jnp.mean(per_item), per_item
        total, per_item, _ = jl(None, None, None, a, b, c)
        return total, per_item

    (_, want_items), want_grads = jax.value_and_grad(
        jax_obj, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(z1r), jnp.asarray(z2r), jnp.asarray(z3r))

    leaves = [torch.tensor(z, requires_grad=True) for z in (z1r, z2r, z3r)]
    tl = SimCLRLoss(normalize=normalize, tau=0.8, use_fused=use_fused)
    total, items, comps = tl(None, None, None, *leaves)
    total.backward()

    np.testing.assert_allclose(items.detach().numpy(), np.asarray(want_items),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(total.detach()), float(np.mean(want_items)), rtol=1e-5)
    assert len(comps) == 2
    for leaf, w in zip(leaves, want_grads):
        w = np.asarray(w)
        assert np.max(np.abs(leaf.grad.numpy() - w)) <= 1e-4 * np.max(np.abs(w))


def test_simclr_components_match_jax():
    z1r, z2r, z3r = _simclr_inputs(6)
    _, _, want = JaxSimCLRLoss(tau=0.6, alpha=0.3, use_fused=False)(
        None, None, None, *(jnp.asarray(z) for z in (z1r, z2r, z3r)))
    _, _, got = SimCLRLoss(tau=0.6, alpha=0.3)(
        None, None, None, *(torch.tensor(z) for z in (z1r, z2r, z3r)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_simclr_route_through_the_wrapper_equals_materialized():
    # on the CPU the wrapper is the plain version; appending the positive
    # column and folding it in with logaddexp are the same function
    # (1e-6: one logsumexp against logaddexp of a logsumexp)
    z1r, z2r, z3r = (torch.tensor(z) for z in _simclr_inputs(7))

    class ThroughWrapper(SimCLRLoss):
        def _fused_ok(self, z):
            return True

    fused = ThroughWrapper(tau=0.9)(None, None, None, z1r, z2r, z3r)
    plain = SimCLRLoss(tau=0.9, use_fused=False)(None, None, None, z1r, z2r, z3r)
    torch.testing.assert_close(fused[1], plain[1], rtol=1e-6, atol=1e-6)


def test_use_fused_true_on_cpu_raises():
    z = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        SimCLRLoss(use_fused=True)(None, None, None, z, z, z)


def test_launch_counters_stay_zero_on_the_cpu():
    reset_launch_counts()
    z1, z3 = (torch.tensor(z, requires_grad=True) for z in _rolled(9, 9, 4, seed=1))
    fused_dot_lse(z1, z3, 1.0).sum().backward()
    SimCLRLoss()(None, None, None, z1, z1, z3)[0].backward()
    assert launch_counts() == {"fwd": 0, "dz1": 0, "dz3": 0,
                               "dot_fwd": 0, "dot_dz1": 0, "dot_dz3": 0,
                               "stem_fwd": 0, "stem_bwd": 0, "stem_dx": 0,
                               "bn_stats": 0, "bn_apply": 0, "bn_bwd": 0,
                               "bn_dx": 0, "bn_apply8": 0, "bn_bwd8": 0,
                               "bn_dx8": 0, "pool_code": 0, "pool_scatter": 0,
                               "bn_junctions": 0}


@pytest.mark.parametrize("where", ["z1", "z3"])
def test_off_cpu_tensor_never_takes_the_plain_version(where):
    # a tensor on another device goes to the kernel's checks, which raise
    # for anything but CUDA; only two CPU tensors run dot_lse_reference
    z = {k: torch.zeros(4, 3) for k in ("z1", "z3")}
    z[where] = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor|is on"):
        fused_dot_lse(z["z1"], z["z3"], 1.0)


@pytest.mark.parametrize("shape, tau, match", [
    ((4, 65), 1.0, "n <= 64"),
    ((0, 3), 1.0, "at least one row"),
    ((4, 3), 0.0, "tau must be positive"),
])
def test_kernel_arguments_out_of_range_raise(shape, tau, match):
    z1 = torch.zeros(shape, device="meta")
    with pytest.raises(ValueError, match=match):
        fused_dot_lse(z1, torch.zeros(4, shape[1], device="meta"), tau)
