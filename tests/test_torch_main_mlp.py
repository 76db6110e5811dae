"""cl_ica_tpu_torch.cli.main_mlp and the training step against the JAX
package: the parser, three training steps from the same parameters and
batches, small end-to-end CPU runs, the refused flags, and the import
boundary (no jax, flax, optax or orbax)."""

import argparse
import csv
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cl_ica_tpu.cli import main_mlp as jax_main
from cl_ica_tpu.losses import LpSimCLRLoss as JaxLpSimCLRLoss
from cl_ica_tpu.models import construct_invertible_mlp as jax_construct
from cl_ica_tpu.models import get_mlp as jax_get_mlp
from cl_ica_tpu.train import TrainState, make_synthetic_train_step as jax_step
from cl_ica_tpu_torch.cli import main_mlp
from cl_ica_tpu_torch.losses import LpSimCLRLoss
from cl_ica_tpu_torch.models import (
    construct_invertible_mlp,
    encoder_params_from_flax,
    get_mlp,
)
from cl_ica_tpu_torch.train import make_optimizer, make_synthetic_train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser_of(parse_args, monkeypatch):
    def grab(self, *args, **kwargs):
        raise _Captured(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Captured) as info:
            parse_args([])
    return info.value.parser


def _spec(parser):
    return {
        tuple(a.option_strings): (a.dest, a.default, a.type, a.choices,
                                  a.nargs, a.const, type(a).__name__)
        for a in parser._actions
    }


def test_parser_has_the_same_flags(monkeypatch):
    want = _spec(_parser_of(jax_main.parse_args, monkeypatch))
    got = _spec(_parser_of(main_mlp.parse_args, monkeypatch))
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--mesh-model", "2"],
    ["--mesh", "4", "--mesh-model", "3"],
    ["--mesh", "5"],
    ["--save-every", "5"],
    ["--seeds", "2", "--mesh", "2"],
    ["--seeds", "2", "--resume-training"],
    ["--seeds", "2", "--save-every", "5", "--save-dir", "x"],
])
def test_parser_checks_match(argv, capsys):
    with pytest.raises(SystemExit) as want:
        jax_main.parse_args(argv)
    with pytest.raises(SystemExit) as got:
        main_mlp.parse_args(argv)
    assert got.value.code == want.value.code


@pytest.mark.parametrize("argv, item", [
    (["--seeds", "2"], "A7"),
    (["--mesh", "2"], "A13"),
    (["--save-every", "5", "--save-dir", "SAVE"], "A6"),
    (["--resume", "--save-dir", "SAVE"], "A6"),
    (["--bf16"], "A4"),
    (["--profile-dir", "SAVE"], "A14"),
    (["--p", "0"], "B2"),
])
def test_unported_flags_exit_naming_the_roadmap_item(argv, item, tmp_path, capsys):
    argv = [str(tmp_path) if a == "SAVE" else a for a in argv]
    with pytest.raises(SystemExit, match=f"ROADMAP.md item {item}"):
        main_mlp.main(argv, device="cpu")


def test_main_needs_cuda_unless_told_otherwise(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main_mlp.main(["--n", "4"])


WIDTHS = [40, 200, 200, 200, 200, 40]  # main_mlp's n*10, n*50 at n = 4


@pytest.mark.parametrize("p, head", [(2, None), (3, "learnable_box")])
def test_three_steps_match_the_jax_trainer(p, head):
    """Same mixing, converted encoder params and batches through both
    trainers. Losses to 1e-5 relative. First-step grads to 1e-3 of each
    tensor's largest entry plus 2e-4 of the step's largest grad: at
    initialisation the encoder's outputs are nearly collapsed, so the
    materialized p=2 distance |a|²+|b|²-2a·b cancels most of its digits
    (the last bias, whose true grad is 0 for this translation-invariant
    loss, comes out at 1e-4 of the largest grad in both packages). Adam's
    step is at most lr per entry, so even a rounding-level grad whose sign
    flips moves a parameter by at most 2·lr a step: params after 3 steps
    agree within 6·lr everywhere, and in the median within 1e-3·lr."""
    n, b, lr, steps = 4, 64, 1e-3, 3
    rng = np.random.default_rng(p)
    z1s = rng.normal(size=(steps, b, n)).astype(np.float32)
    z2s = (z1s + 0.1 * rng.normal(size=z1s.shape)).astype(np.float32)
    kw = dict(n=n, n_layers=3, n_iter_cond_thresh=500, cond_thresh_ratio=0.25)
    jg = jax_construct(rng=np.random.default_rng(0), **kw)
    tg = construct_invertible_mlp(rng=np.random.default_rng(0), **kw)

    jf = jax_get_mlp(n, n, WIDTHS, output_normalization=head)
    params = jf.init(jax.random.PRNGKey(0), jnp.zeros((2, n)))
    tf = get_mlp(n, n, WIDTHS, output_normalization=head)
    tf.load_state_dict(encoder_params_from_flax(jax.tree.map(np.asarray, params)))

    # the JAX step draws its batch from split(state.key); look the batch up
    # by that key so both trainers see the same data each step
    key, data_keys = jax.random.PRNGKey(42), []
    k = key
    for _ in range(steps):
        k, kd = jax.random.split(k)
        data_keys.append(kd)
    table = jnp.stack(data_keys)

    def jax_sample_pair(kd, size):
        i = jnp.argmax(jnp.all(table == kd[None], axis=1))
        return jnp.asarray(z1s)[i], jnp.asarray(z2s)[i]

    jloss = JaxLpSimCLRLoss(p=p, simclr_compatibility_mode=True, use_fused=False)
    opt = optax.adam(lr)
    jstep = jax_step(jax_sample_pair, jg, lambda prm, x: jf.apply(prm, x), jloss,
                     opt, b, donate=False)
    state = TrainState.create(params, opt.init(params), key)

    def objective(prm):
        h = lambda z: jf.apply(prm, jg(z))
        z1r, z2r = h(jnp.asarray(z1s[0])), h(jnp.asarray(z2s[0]))
        return jloss(None, None, None, z1r, z2r, jnp.roll(z1r, 1, axis=0))[0]

    want_grads = encoder_params_from_flax(
        jax.tree.map(np.asarray, jax.grad(objective)(params)))

    batches = iter(zip(z1s, z2s))
    topt, _ = make_optimizer(tf.parameters(), lr)
    tstep = make_synthetic_train_step(
        lambda gen, size: tuple(torch.tensor(z) for z in next(batches)),
        tg, tf, LpSimCLRLoss(p=p, simclr_compatibility_mode=True), topt, b)

    for t in range(steps):
        state, jm = jstep(state)
        tm = tstep(None)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        if t == 0:
            got = {k: v.grad.numpy() for k, v in tf.named_parameters()}
            largest = max(np.max(np.abs(w.numpy())) for w in want_grads.values())
            for name, g in got.items():
                w = want_grads[name].numpy()
                assert np.max(np.abs(g - w)) <= (
                    1e-3 * np.max(np.abs(w)) + 2e-4 * largest), name

    final = encoder_params_from_flax(jax.tree.map(np.asarray, state.params))
    diffs = np.concatenate([
        np.abs(v.detach().numpy() - final[k].numpy()).ravel()
        for k, v in tf.named_parameters()])
    assert diffs.max() <= 2 * steps * lr
    assert np.median(diffs) <= 1e-3 * lr


@pytest.mark.parametrize("argv", [
    "--space-type sphere --c-p 0 --c-param 20 --p 2",
    "--space-type box --c-p 1 --p 1 --box-norm",
])
def test_main_runs_end_to_end_on_cpu(argv, tmp_path, capsys):
    save = tmp_path / "run"
    lin, perm = main_mlp.main(
        argv.split() + "--n 4 --batch-size 256 --only-unsupervised --n-steps 10 "
        "--n-log-steps 5 --num-eval-batches 2 --seed 3 --save-dir".split()
        + [str(save)], device="cpu")
    assert np.isfinite(lin) and np.isfinite(perm)
    with open(save / "log.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["step"]) for r in rows] == [1, 6, 11, 16, 21, 26, 30]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert (save / "args.json").exists()

    # the frozen mixing is the JAX package's for the same seed
    want_g = jax_construct(n=4, n_layers=3, n_iter_cond_thresh=25000,
                           cond_thresh_ratio=0.0, rng=np.random.default_rng(3))
    with np.load(save / "g.npz") as g:
        for i, w in enumerate(want_g.weights):
            np.testing.assert_array_equal(g[f"arr_{i}"], np.asarray(w))

    # the encoder pickle is a Flax variables tree the JAX encoder applies
    with open(save / "unsup_f.pkl", "rb") as fh:
        tree = pickle.load(fh)
    head = "learnable_box" if "--box-norm" in argv else None
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    want = jax_get_mlp(4, 4, WIDTHS, output_normalization=head).apply(tree, jnp.asarray(x))
    tf = get_mlp(4, 4, WIDTHS, output_normalization=head)
    tf.load_state_dict(encoder_params_from_flax(tree))
    np.testing.assert_allclose(tf(torch.tensor(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import cl_ica_tpu_torch.cli.main_mlp, cl_ica_tpu_torch.ops.build\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "print(bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _space_args(**kw):
    base = dict(space_type="box", n=4, box_min=0.0, box_max=1.0, sphere_r=1.0,
                m_p=0, c_p=2, m_param=1.0, c_param=0.05, rej_mult=1)
    base.update(kw)
    return argparse.Namespace(**base)


GRID = [(s, m, c) for s in ("box", "sphere", "unbounded") for m in (0, 1, 2, 3)
        for c in (0, 1, 2, 3) if not (s == "unbounded" and m == 0)
        and not (c == 0 and s != "sphere")]


@pytest.mark.parametrize("space_type, m_p, c_p", GRID)
def test_every_marginal_conditional_builds_and_samples(space_type, m_p, c_p):
    # the dispatch table of build_latent_space, as tests/test_main_mlp_config.py
    # covers it for the JAX CLI; c_p = 0 is the vMF conditional (sphere only)
    args = _space_args(space_type=space_type, m_p=m_p, c_p=c_p,
                       c_param=20.0 if c_p == 0 else 0.05)
    ls = main_mlp.build_latent_space(args, torch.device("cpu"))
    z, zt = ls.sample_pair(torch.Generator().manual_seed(0), 32)
    assert z.shape == zt.shape == (32, 4)
    assert torch.isfinite(z).all() and torch.isfinite(zt).all()
    if space_type == "box":
        assert float(torch.cat([z, zt]).min()) >= 0.0
        assert float(torch.cat([z, zt]).max()) <= 1.0
    elif space_type == "sphere":
        np.testing.assert_allclose(torch.linalg.norm(zt, dim=-1).numpy(), 1.0, atol=1e-5)


def test_uniform_marginal_on_unbounded_space_raises():
    ls = main_mlp.build_latent_space(_space_args(space_type="unbounded"),
                                     torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        ls.sample_marginal(torch.Generator(), 8)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("cosine", [False, True])
def test_optimizer_matches_optax(weight_decay, cosine):
    # optax.adam/adamw(+cosine_decay_schedule) against make_optimizer on the
    # same gradients; 10 updates with a 6-step schedule also cover the
    # clamp at min(t, T). Each update rounds the float32 parameter once, in
    # a different order in the two libraries: 2 ulps of it per step.
    lr, horizon, steps = 1e-2, 6, 10
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=5).astype(np.float32)
    target = rng.normal(size=5).astype(np.float32)
    sched = optax.cosine_decay_schedule(lr, horizon) if cosine else lr
    jopt = optax.adamw(sched, weight_decay=weight_decay) if weight_decay else optax.adam(sched)
    jx = jnp.asarray(x0)
    state = jopt.init(jx)
    tx = torch.nn.Parameter(torch.tensor(x0))
    topt, tsched = make_optimizer([tx], lr, weight_decay,
                                  cosine_steps=horizon if cosine else None)
    for _ in range(steps):
        updates, state = jopt.update(jx - target, state, jx)
        jx = optax.apply_updates(jx, updates)
        tx.grad = tx.detach() - torch.tensor(target)
        topt.step()
        if tsched is not None:
            tsched.step()
    ulp = np.spacing(np.abs(np.asarray(jx)).max().astype(np.float32))
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), rtol=0,
                               atol=2 * steps * ulp)
