"""cl_ica_tpu_torch.ops.infonce and losses.infonce against the JAX package.

The same numpy inputs go through the JAX function and the port. On the
CPU the port's fused_neg_lse is its plain version (neg_lse_reference);
the JAX side runs its Pallas kernel in interpret mode, as tests/test_ops.py
does. The Hopper kernels themselves are compared with the plain version
on the card by chip_smoke.py: pytest cannot start there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.losses import LpSimCLRLoss as JaxLpSimCLRLoss
from cl_ica_tpu.ops import fused_neg_lse as jax_fused_neg_lse
from cl_ica_tpu_torch.losses import LpSimCLRLoss
from cl_ica_tpu_torch.ops import fused_neg_lse, launch_counts

torch.set_num_threads(1)


def _rolled(m, n_rows, n_feat, seed):
    """z1 (m, n) and z3 (n_rows, n) with z3[(i+1) % n_rows] = z1[i]: the
    exact zeros of z3_rec = roll(z1_rec, 1)."""
    rng = np.random.default_rng(seed)
    z1 = (0.5 * rng.normal(size=(m, n_feat))).astype(np.float32)
    z3 = (0.5 * rng.normal(size=(n_rows, n_feat))).astype(np.float32)
    for i in range(min(m, n_rows)):
        z3[(i + 1) % n_rows] = z1[i]
    return z1, z3


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("shape", [(50, 50), (64, 64), (32, 64)])
def test_neg_lse_matches_jax_kernel(p, shape):
    # tolerances of tests/test_ops.py: the Pallas p=2 tile uses the dot
    # identity, the port the direct sum, so they differ in rounding
    m, n_rows = shape
    z1, z3 = _rolled(m, n_rows, 6, seed=int(p * 10) + m)
    ct = np.linspace(0.5, 1.5, m).astype(np.float32)
    tau = 1.3

    def jax_obj(a, b):
        lse = jax_fused_neg_lse(a, b, p, tau, 32, True)
        return jnp.sum(lse * ct), lse

    (_, want), (want_d1, want_d3) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(z1), jnp.asarray(z3))

    a = torch.tensor(z1, requires_grad=True)
    b = torch.tensor(z3, requires_grad=True)
    got = fused_neg_lse(a, b, p, tau)
    (got * torch.tensor(ct)).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    for g, w in ((a.grad, want_d1), (b.grad, want_d3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-4)


def _jax_and_port(z1, z3, p, tau, block, dtype=torch.float32):
    """(value, dz1, dz3) of sum(c * lse) from the JAX kernel in interpret
    mode and from the port's CPU route (its plain version) in ``dtype``."""
    ct = np.linspace(0.5, 1.5, z1.shape[0]).astype(np.float32)

    def jax_obj(a, b):
        lse = jax_fused_neg_lse(a, b, p, tau, block, True)
        return jnp.sum(lse * ct), lse

    (_, lse), grads = jax.value_and_grad(jax_obj, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z1), jnp.asarray(z3))
    a = torch.tensor(z1, dtype=dtype, requires_grad=True)
    b = torch.tensor(z3, dtype=dtype, requires_grad=True)
    got = fused_neg_lse(a, b, p, tau)
    (got * torch.tensor(ct, dtype=dtype)).sum().backward()
    return ([np.asarray(x) for x in (lse, *grads)],
            [x.detach().numpy() for x in (got, a.grad, b.grad)])


def test_neg_lse_matches_jax_kernel_at_the_3dident_split_shape():
    """main_3dident's split loss hands fused_neg_lse the 3 position columns
    of a (1024, 11) output: z1 its first 512 rows, z3 = roll(z1, 1), p = 2,
    tau = 1. Tolerances of tests/test_ops.py, as above."""
    rng = np.random.default_rng(5)
    z1 = rng.normal(size=(1024, 11)).astype(np.float32)[:512, :3]
    z1 = np.ascontiguousarray(z1)
    want, got = _jax_and_port(z1, np.roll(z1, 1, axis=0), 2.0, 1.0, 128)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_neg_lse_at_collapsed_inputs(p):
    """Rows of one point plus noise of 1e-3, z3 shifted by 3e-3, as an
    encoder early in training gives them: every weight near 1/N, the terms
    of a row of one sign, gradients of order 1e-2. The port's direct sum
    Σ w (z1 - z3) stays within 1e-5 of its own float64 result; the JAX
    kernel's p = 2 identity z1·Σw - w@z3 subtracts numbers of order 1 and
    keeps ~1e-4 of it. So the two agree to 1e-4 of the largest gradient,
    and the port's kernels keep the direct form."""
    rng = np.random.default_rng(9)
    c = rng.normal(size=(1, 10))
    z1 = (c + 1e-3 * rng.normal(size=(64, 10))).astype(np.float32)
    z3 = (c + 3e-3 + 1e-3 * rng.normal(size=(64, 10))).astype(np.float32)
    want, got = _jax_and_port(z1, z3, p, 0.7, 32)
    _, exact = _jax_and_port(z1, z3, p, 0.7, 32, torch.float64)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, w, e in zip(got[1:], want[1:], exact[1:]):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        assert np.abs(g - e).max() <= 1e-5 * np.abs(e).max()


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("n_feat", [3, 8, 10, 13])
def test_zero_features_change_nothing(p, n_feat):
    # What the tiled forward's instances rest on: a runtime n is staged into
    # NF = 4, 8, 10, 12 or 16 features, zero past n, and |0 - 0|^p adds 0
    # to every distance. Padding z1 and z3 with zero features to 16 leaves
    # the value and the first n columns of both gradients as they were, to
    # 1e-5 of their largest entry (the plain version's float32 sum over 16
    # terms groups them otherwise than over n), and the padded columns'
    # gradients exactly 0 (sgn(0) = 0 at p = 1).
    z1, z3 = _rolled(40, 56, n_feat, seed=n_feat)
    ct = torch.linspace(0.5, 1.5, 40)
    out = []
    for width in (n_feat, 16):
        a, b = (torch.tensor(np.pad(z, ((0, 0), (0, width - n_feat))),
                             requires_grad=True) for z in (z1, z3))
        lse = fused_neg_lse(a, b, p, 0.7)
        (lse * ct).sum().backward()
        out.append((lse.detach(), a.grad, b.grad))
    (lse, d1, d3), (lse_p, d1_p, d3_p) = out
    for got, want in ((lse_p, lse), (d1_p[:, :n_feat], d1), (d3_p[:, :n_feat], d3)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(d1_p[:, n_feat:], torch.zeros(40, 16 - n_feat))
    assert torch.equal(d3_p[:, n_feat:], torch.zeros(56, 16 - n_feat))


@pytest.mark.parametrize("p", [0.5, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("pow_", [True, False])
def test_lp_simclr_loss_matches_jax(p, compat, pow_):
    # per-item losses to 1e-5 relative; grads to 1e-4 of their largest
    # entry (float32 sums taken in different orders). z3 = roll(z1) gives
    # exact zeros, which p >= 2 with pow handles alike in both packages.
    # Elsewhere a zero is ill-conditioned or ambiguous: for p < 1 it meets
    # the eps guard's |eps|^(p-1) = 1e6 slope; without pow, p = 2 takes the
    # sqrt of the dot identity's rounding residue; for p = 1 the packages
    # take different subgradients (see the test below). There z3 is
    # offset from the roll.
    rng = np.random.default_rng(7)
    z1r = rng.normal(size=(24, 5)).astype(np.float32)
    z2r = (z1r + 0.3 * rng.normal(size=z1r.shape)).astype(np.float32)
    z3r = np.roll(z1r, 1, axis=0)
    if p <= 1 or not pow_:
        z3r = (z3r + 0.05 * rng.normal(size=z3r.shape)).astype(np.float32)
    jl = JaxLpSimCLRLoss(p=p, tau=0.8, simclr_compatibility_mode=compat,
                         pow=pow_, use_fused=False)

    def jax_obj(a, b, c):
        total, per_item, _ = jl(None, None, None, a, b, c)
        return total, per_item

    (_, want_items), want_grads = jax.value_and_grad(
        jax_obj, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(z1r), jnp.asarray(z2r), jnp.asarray(z3r))

    leaves = [torch.tensor(z, requires_grad=True) for z in (z1r, z2r, z3r)]
    tl = LpSimCLRLoss(p=p, tau=0.8, simclr_compatibility_mode=compat, pow=pow_)
    total, items, comps = tl(None, None, None, *leaves)
    total.backward()

    np.testing.assert_allclose(items.detach().numpy(), np.asarray(want_items),
                               rtol=1e-5, atol=1e-5)
    assert len(comps) == 2
    for leaf, w in zip(leaves, want_grads):
        w = np.asarray(w)
        assert np.max(np.abs(leaf.grad.numpy() - w)) <= 1e-4 * np.max(np.abs(w))


def test_p1_subgradient_at_zero_follows_the_kernel():
    """ROADMAP C1. Where z1_i == z3_j exactly (every step, through the
    roll), JAX's materialized p=1 path takes d|x|/dx = 1
    (jax.grad(jnp.abs)(0.) == 1.), while its Pallas kernel, the torch
    reference and this port take sgn(0) = 0."""
    z1, z3 = _rolled(32, 32, 4, seed=11)
    ct = np.linspace(0.5, 1.5, 32).astype(np.float32)

    def materialized(a, b):
        d = jnp.sum(jnp.abs(a[:, None, :] - b[None, :, :]), axis=-1)
        return jnp.sum(jax.scipy.special.logsumexp(-d, axis=1) * ct)

    def kernel(a, b):
        return jnp.sum(jax_fused_neg_lse(a, b, 1.0, 1.0, 32, True) * ct)

    args = (jnp.asarray(z1), jnp.asarray(z3))
    want_kernel = jax.grad(kernel, argnums=(0, 1))(*args)
    want_mat = jax.grad(materialized, argnums=(0, 1))(*args)

    a, b = (torch.tensor(z, requires_grad=True) for z in (z1, z3))
    (fused_neg_lse(a, b, 1.0, 1.0) * torch.tensor(ct)).sum().backward()
    for g, wk, wm in zip((a.grad, b.grad), want_kernel, want_mat):
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=5e-3, atol=5e-4)
        assert np.max(np.abs(g.numpy() - np.asarray(wm))) > 1e-2


def test_use_fused_true_on_cpu_raises():
    z = torch.zeros(8, 3)
    loss = LpSimCLRLoss(p=2, use_fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        loss(None, None, None, z, z, z)


def test_default_route_on_cpu_is_materialized():
    rng = np.random.default_rng(3)
    z1, z2 = (torch.tensor(rng.normal(size=(16, 4)).astype(np.float32))
              for _ in range(2))
    z3 = torch.roll(z1, 1, dims=0)
    before = launch_counts()
    auto = LpSimCLRLoss(p=1, simclr_compatibility_mode=True)(None, None, None, z1, z2, z3)
    plain = LpSimCLRLoss(p=1, simclr_compatibility_mode=True, use_fused=False)(
        None, None, None, z1, z2, z3)
    assert launch_counts() == before
    torch.testing.assert_close(auto[1], plain[1], rtol=0, atol=0)
