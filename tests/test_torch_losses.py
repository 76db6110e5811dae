"""cl_ica_tpu_torch.losses against cl_ica_tpu.losses: Alignment,
Uniformity, the Split/Combined combinators, AlignmentUniformity,
JacobianDeterminant and R2, on the same seeded numpy inputs.

Tolerances: totals and per-item losses rtol 1e-5 (float32 sums in
different orders); gradients to 1e-4 of their largest entry.
(LpSimCLRLoss is in test_torch_infonce.py, SimCLRLoss in
test_torch_infonce_dot.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu import losses as jl
from cl_ica_tpu_torch import losses as tl

torch.set_num_threads(1)


def _six(seed, b=20, n=8):
    """z1, z2, z3 and their reconstructions, z3 = roll(z1)."""
    rng = np.random.default_rng(seed)
    z1 = rng.normal(size=(b, n)).astype(np.float32)
    z2 = (z1 + 0.2 * rng.normal(size=z1.shape)).astype(np.float32)
    z1r = (z1 + 0.3 * rng.normal(size=z1.shape)).astype(np.float32)
    z2r = (z2 + 0.3 * rng.normal(size=z1.shape)).astype(np.float32)
    return z1, z2, np.roll(z1, 1, 0), z1r, z2r, np.roll(z1r, 1, 0)


def _jax_value_and_grads(loss, arrays, wrt):
    def obj(*diff):
        full = list(arrays)
        for i, a in zip(wrt, diff):
            full[i] = a
        total, per_item, _ = loss(*full)
        return total, per_item

    (total, items), grads = jax.value_and_grad(
        obj, argnums=tuple(range(len(wrt))), has_aux=True)(
            *(jnp.asarray(arrays[i]) for i in wrt))
    return float(total), np.asarray(items), [np.asarray(g) for g in grads]


def _torch_value_and_grads(loss, arrays, wrt):
    tensors = [torch.tensor(a, requires_grad=i in wrt) for i, a in enumerate(arrays)]
    total, items, _ = loss(*tensors)
    total.backward()
    return (float(total.detach()), items.detach().numpy(),
            [tensors[i].grad.numpy() for i in wrt])


def _assert_same(got, want, nan_items=False):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    if nan_items:
        assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
        assert got[1].shape == want[1].shape
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[2], want[2]):
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w))


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_alignment_loss_matches_jax(p):
    _, _, _, z1r, z2r, _ = _six(0)
    want = _jax_value_and_grads(jl.AlignmentLoss(p=p), [z1r, z2r], (0, 1))
    got = _torch_value_and_grads(tl.AlignmentLoss(p=p), [z1r, z2r], (0, 1))
    _assert_same(got, want)


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_uniformity_loss_matches_jax(p):
    # z3 is offset from the roll: at an exact zero the packages take
    # different subgradients of |x| (ROADMAP C1)
    _, _, _, z1r, _, z3r = _six(1)
    z3r = z3r + np.float32(0.05)
    want = _jax_value_and_grads(jl.UniformityLoss(p=p), [z1r, z3r], (0, 1))
    got = _torch_value_and_grads(tl.UniformityLoss(p=p), [z1r, z3r], (0, 1))
    _assert_same(got, want)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_alignment_uniformity_loss_matches_jax(alpha):
    arrays = list(_six(2))
    arrays[5] = arrays[5] + np.float32(0.05)
    want = _jax_value_and_grads(jl.AlignmentUniformityLoss(alpha=alpha), arrays, (3, 4, 5))
    got = _torch_value_and_grads(tl.AlignmentUniformityLoss(alpha=alpha), arrays, (3, 4, 5))
    _assert_same(got, want)


@pytest.mark.parametrize("use_fused", [None, False])
def test_split_loss_over_two_column_chunks_matches_jax(use_fused):
    # 3DIdent's shape of loss: Lp-InfoNCE on columns 0:3, SimCLR on 3:8.
    # The members get column slices, which are not contiguous; on both of
    # the port's routes (the wrappers' plain versions here, use_fused=None,
    # and the materialized path) the result is the JAX package's.
    arrays = _six(3)
    make = lambda m, fused: m.SplitCombinedCLLoss(
        [(m.LpSimCLRLoss(p=2, tau=0.9, simclr_compatibility_mode=True,
                         use_fused=fused), 0, 3),
         (m.SimCLRLoss(tau=0.7, use_fused=fused), 3, 8)],
        weights=[1.0, 0.5])
    want = _jax_value_and_grads(make(jl, False), arrays, (3, 4, 5))
    got = _torch_value_and_grads(make(tl, use_fused), arrays, (3, 4, 5))
    _assert_same(got, want)


def test_split_loss_hands_the_wrappers_contiguous_operands(monkeypatch):
    # the kernels take contiguous operands only; both losses copy a column
    # slice before they call their wrapper
    from cl_ica_tpu_torch.losses import infonce as mod

    seen = []

    def spy(name, plain):
        def call(z1, z3, *rest):
            seen.append((name, z1.is_contiguous(), z3.is_contiguous()))
            return plain(z1, z3, *rest)
        return call

    monkeypatch.setattr(mod, "fused_neg_lse", spy("lp", mod.fused_neg_lse))
    monkeypatch.setattr(mod, "fused_dot_lse", spy("dot", mod.fused_dot_lse))

    class Lp(tl.LpSimCLRLoss):
        def _fused_ok(self, z):
            return True

    class Dot(tl.SimCLRLoss):
        def _fused_ok(self, z):
            return True

    arrays = [torch.tensor(a) for a in _six(4)]
    assert not arrays[3][:, 0:3].is_contiguous()
    tl.SplitCombinedCLLoss([(Lp(p=1), 0, 3), (Dot(), 3, 8)])(*arrays)
    assert seen == [("lp", True, True), ("dot", True, True)]


def test_split_loss_dispatches_every_protocol_like_jax():
    # one member of each protocol: CLLoss, negative-pair, positive-pair
    arrays = list(_six(5))
    arrays[5] = arrays[5] + np.float32(0.05)
    make = lambda m: m.SplitCombinedCLLoss(
        [(m.LpSimCLRLoss(p=1, use_fused=False), 0, 4),
         (m.UniformityLoss(), 2, 6),
         (m.AlignmentLoss(p=1.0), 4, None)],
        weights=[0.5, 2.0, 1.0])
    want = _jax_value_and_grads(make(jl), arrays, (3, 4, 5))
    got = _torch_value_and_grads(make(tl), arrays, (3, 4, 5))
    _assert_same(got, want)

    _, _, parts = make(tl)(*(torch.tensor(a) for a in arrays))
    assert len(parts) == 3 and all(len(p) == 3 for p in parts)


def test_combined_loss_applies_to_the_full_width():
    # PARITY.md deviation 1, as in the JAX package: (0, None) is every column
    arrays = _six(6)
    make = lambda m: m.CombinedCLLoss(
        [m.LpSimCLRLoss(p=2, use_fused=False), m.SimCLRLoss(use_fused=False)],
        weights=[1.0, 0.25])
    want = _jax_value_and_grads(make(jl), arrays, (3, 4, 5))
    got = _torch_value_and_grads(make(tl), arrays, (3, 4, 5))
    _assert_same(got, want)


@pytest.mark.parametrize("bad", [
    [("not a triple",)],
    [(tl.AlignmentLoss(), 0.5, 3)],
])
def test_split_loss_rejects_malformed_entries(bad):
    with pytest.raises(ValueError):
        tl.SplitCombinedCLLoss(bad)


def test_split_loss_rejects_an_unknown_member_type():
    arrays = [torch.tensor(a) for a in _six(7)]
    with pytest.raises(ValueError, match="Invalid loss type"):
        tl.SplitCombinedCLLoss([(object(), 0, 3)])(*arrays)


def test_jacobian_determinant_loss_matches_jax():
    # h is a small tanh network; value and the gradient with respect to its
    # weights (forward-mode Jacobian under reverse-mode grad in both)
    rng = np.random.default_rng(8)
    w1 = rng.normal(size=(4, 4)).astype(np.float32)
    w2 = rng.normal(size=(4, 4)).astype(np.float32)
    z = rng.normal(size=(6, 4)).astype(np.float32)

    def jax_obj(a, b):
        loss = jl.JacobianDeterminantLoss(lambda x: jnp.tanh(x @ a) @ b)
        total, items, _ = loss(jnp.asarray(z))
        return total, items

    (want_total, want_items), want_grads = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(w1), jnp.asarray(w2))

    a, b = (torch.tensor(w, requires_grad=True) for w in (w1, w2))
    total, items, parts = tl.JacobianDeterminantLoss(
        lambda x: torch.tanh(x @ a) @ b)(torch.tensor(z))
    total.backward()
    _assert_same((float(total.detach()), items.numpy(), [a.grad.numpy(), b.grad.numpy()]),
                 (float(want_total), np.asarray(want_items),
                  [np.asarray(g) for g in want_grads]), nan_items=True)
    assert len(parts) == 1


def test_jacobian_determinant_loss_needs_a_batch():
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        tl.JacobianDeterminantLoss(lambda x: x)(torch.zeros(4))


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("mode", ["negative_r2", "r2"])
def test_r2_loss_matches_jax(reduction, mode):
    rng = np.random.default_rng(9)
    y = rng.normal(size=(32, 5)).astype(np.float32)
    y_pred = (y + 0.4 * rng.normal(size=y.shape)).astype(np.float32)
    want = jl.R2Loss(reduction=reduction, mode=mode)(jnp.asarray(y_pred), jnp.asarray(y))
    got = tl.R2Loss(reduction=reduction, mode=mode)(torch.tensor(y_pred), torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_r2_loss_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        tl.R2Loss(mode="adjusted")


def test_alignment_uniformity_rejects_alpha_out_of_range():
    with pytest.raises(ValueError, match="alpha"):
        tl.AlignmentUniformityLoss(alpha=1.5)
