"""cl_ica_tpu_torch.cli.main_mlp and the training step against the JAX
package: the parser, three training steps from the same parameters and
batches, the bfloat16 encoder, small end-to-end CPU runs, checkpoint and
resume, the --seeds ensemble, the refused flags, and the import boundary
(no jax, flax, optax or orbax, and nothing of cl_ica_tpu)."""

import argparse
import csv
import glob
import json
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
from cl_ica_tpu.losses import SimCLRLoss as JaxSimCLRLoss
from cl_ica_tpu.models import construct_invertible_mlp as jax_construct
from cl_ica_tpu.models import get_mlp as jax_get_mlp
from cl_ica_tpu.train import TrainState, make_synthetic_train_step as jax_step
from cl_ica_tpu_torch.cli import main_mlp
from cl_ica_tpu_torch.losses import LpSimCLRLoss, SimCLRLoss
from cl_ica_tpu_torch.models import (
    construct_invertible_mlp,
    encoder_params_from_flax,
    get_mlp,
)
from cl_ica_tpu_torch.train import (
    checkpoint,
    make_optimizer,
    make_synthetic_train_step,
)

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


MESH_RUN = ["--n", "4", "--batch-size", "16", "--n-steps", "1", "--n-log-steps", "2",
            "--num-eval-batches", "1", "--seed", "0", "--only-unsupervised"]


@pytest.mark.parametrize("argv, item", [
    # --mesh is ported (A13): two gloo ranks on the CPU run to the end
    (["--mesh", "2"] + MESH_RUN, None),
    # and --mesh-model (A13b): the encoder channel-split over the two
    (["--mesh", "2", "--mesh-model", "2"] + MESH_RUN, None),
])
def test_unported_flags_exit_naming_the_roadmap_item(argv, item, tmp_path, capfd):
    # no flag of main_mlp is left unported: each mesh layout runs on gloo
    # ranks to the end and prints its layout (the test keeps its name)
    assert item is None
    assert np.all(np.isfinite(main_mlp.main(argv, device="cpu")))
    data = 1 if "--mesh-model" in argv else 2
    assert (f"mesh: 2 ranks ({data} data x {3 - data} model), gloo, eager step"
            in capfd.readouterr().out)


@pytest.mark.parametrize("argv", [["--n", "4"], ["--n", "4", "--p", "0"],
                                  ["--n", "4", "--seeds", "2"]])
def test_main_needs_cuda_unless_told_otherwise(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main_mlp.main(argv)


WIDTHS = [40, 200, 200, 200, 200, 40]  # main_mlp's n*10, n*50 at n = 4


@pytest.mark.parametrize("p, head", [(2, None), (3, "learnable_box"),
                                     (0, "fixed_sphere")])
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
    agree within 6·lr everywhere, and in the median within 1e-3·lr.
    p = 0 is main_mlp's --p 0: dot-product SimCLR under the fixed-sphere
    head, in both packages."""
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

    if p:
        jloss = JaxLpSimCLRLoss(p=p, simclr_compatibility_mode=True, use_fused=False)
        tloss = LpSimCLRLoss(p=p, simclr_compatibility_mode=True)
    else:
        jloss = JaxSimCLRLoss(normalize=False, use_fused=False)
        tloss = SimCLRLoss(normalize=False)
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
        tg, tf, tloss, topt, b)

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
    "--space-type sphere --c-p 0 --c-param 20 --p 0",
    "--space-type sphere --c-p 0 --c-param 20 --p 0 --bf16",
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
    head = ("learnable_box" if "--box-norm" in argv
            else "fixed_sphere" if "--p 0" in argv else None)
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    want = jax_get_mlp(4, 4, WIDTHS, output_normalization=head).apply(tree, jnp.asarray(x))
    tf = get_mlp(4, 4, WIDTHS, output_normalization=head)
    tf.load_state_dict(encoder_params_from_flax(tree))
    np.testing.assert_allclose(tf(torch.tensor(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_port_imports_no_jax():
    # nor anything of the JAX package, not even a module there that imports
    # no jax: 'cl_ica_tpu' and every 'cl_ica_tpu.*' stay out of sys.modules
    code = (
        "import sys\n"
        "import cl_ica_tpu_torch.cli.main_mlp, cl_ica_tpu_torch.ops.build\n"
        "import cl_ica_tpu_torch.cli.main_3dident, cl_ica_tpu_torch.data\n"
        "import cl_ica_tpu_torch.models.resnet, cl_ica_tpu_torch.ops.stem\n"
        "import cl_ica_tpu_torch.ops.knn\n"
        "import cl_ica_tpu_torch.tools.make_synthetic_3dident\n"
        "import cl_ica_tpu_torch.cli.main_kitti, cl_ica_tpu_torch.data.kitti, cl_ica_tpu_torch.tools.make_synthetic_kitti\n"
        "import cl_ica_tpu_torch.parallel\n"
        "import cl_ica_tpu_torch.utils, cl_ica_tpu_torch.models.flows\n"
        "import cl_ica_tpu_torch.losses.slowvae, cl_ica_tpu_torch.tools.get_mean_std\n"
        "import cl_ica_tpu_torch.tools.generate_3dident_latents\n"
        "import cl_ica_tpu_torch.tools.render_3dident, cl_ica_tpu_torch.tools.blender_scene\n"
        "import chip_smoke\n"
        "import tools.profile_torch_step\n"
        "import tools.compare_lse_kernels\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                    'cl_ica_tpu'))\n"
        "print(bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_name_no_module_of_the_jax_package():
    # no import statement of cl_ica_tpu in the port, chip_smoke.py or the
    # two tools (prose may name the package it was ported from)
    import re

    pattern = re.compile(r"^\s*(from|import)\s+cl_ica_tpu(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_torch_step.py"),
             os.path.join(REPO, "tools", "compare_lse_kernels.py")]
    for root, _, names in os.walk(os.path.join(REPO, "cl_ica_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    assert any(f.endswith(os.path.join('cli', 'main_3dident.py')) for f in files)
    for path in files:
        with open(path) as fh:
            assert not pattern.search(fh.read()), path


def _bf16_pair(n, widths, head, seed):
    """The JAX bfloat16 encoder, its float32 twin and the port's bfloat16
    encoder, all with the same (converted) float32 parameters."""
    jf = jax_get_mlp(n, n, widths, output_normalization=head, dtype=jnp.bfloat16)
    jf32 = jax_get_mlp(n, n, widths, output_normalization=head)
    params = jf.init(jax.random.PRNGKey(seed), jnp.zeros((2, n)))
    tf = get_mlp(n, n, widths, output_normalization=head, dtype=torch.bfloat16)
    tf.load_state_dict(encoder_params_from_flax(jax.tree.map(np.asarray, params)))
    return jf, jf32, params, tf


@pytest.mark.parametrize("head", [None, "fixed_sphere", "learnable_box"])
def test_bf16_encoder_forward_matches_jax(head):
    """get_mlp(dtype=bfloat16) against the JAX get_mlp(dtype=jnp.bfloat16)
    at main_mlp's depth: float32 parameters and output, bfloat16 Linear
    stack. bfloat16 keeps 8 bits of mantissa and the two frameworks
    accumulate the products in different orders, so outputs agree to 2e-2
    of the largest output: far below the O(1) error of a wrong cast, far
    above float32's 1e-6."""
    n = 4
    x = np.random.default_rng(0).normal(size=(64, n)).astype(np.float32)
    jf, _, params, tf = _bf16_pair(n, WIDTHS, head, seed=1)
    want = jf.apply(params, jnp.asarray(x))
    got = tf(torch.tensor(x)).detach()
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tf.parameters())
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) <= 2e-2 * np.max(np.abs(want))
    # and the bfloat16 stack is really on: it differs from the float32 one
    ref = get_mlp(n, n, WIDTHS, output_normalization=head)
    ref.load_state_dict(tf.state_dict())
    assert float((ref(torch.tensor(x)).detach() - got).abs().max()) > 1e-5


@pytest.mark.parametrize("head", [None, "fixed_sphere"])
def test_bf16_encoder_gradients_match_jax(head):
    """Gradients of a weighted sum of the outputs, float32 like the
    parameters. One hidden layer: each bfloat16 rounding is then one of a
    few, and the two packages agree to 3e-2 of a tensor's largest entry.
    At main_mlp's depth of seven layers the roundings compound (either
    package's bfloat16 gradient is up to 0.25 of the largest entry away
    from its own float32 gradient), so there the port is held to being as
    near to the JAX float32 gradient as the JAX bfloat16 gradient is,
    within a factor of 2."""
    n = 4
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, n)).astype(np.float32)
    wsum = rng.normal(size=(64, n)).astype(np.float32)

    def grads(widths):
        jf, jf32, params, tf = _bf16_pair(n, widths, head, seed=3)
        obj = lambda f: lambda prm: jnp.sum(f.apply(prm, jnp.asarray(x)) * wsum)
        conv = lambda g: {k: v.numpy() for k, v in encoder_params_from_flax(
            jax.tree.map(np.asarray, g)).items()}
        (tf(torch.tensor(x)) * torch.tensor(wsum)).sum().backward()
        got = {k: v.grad for k, v in tf.named_parameters()}
        assert all(g.dtype == torch.float32 for g in got.values())
        return ({k: g.numpy() for k, g in got.items()},
                conv(jax.grad(obj(jf))(params)), conv(jax.grad(obj(jf32))(params)))

    got, want, _ = grads([40])
    for name, w in want.items():
        assert np.max(np.abs(got[name] - w)) <= 3e-2 * np.max(np.abs(w)), name

    got, want, exact = grads(WIDTHS)
    for name, e in exact.items():
        scale = np.max(np.abs(e))
        ours = np.max(np.abs(got[name] - e)) / scale
        theirs = np.max(np.abs(want[name] - e)) / scale
        assert ours <= 2 * theirs + 1e-2, (name, ours, theirs)


def test_encoder_keeps_the_dtype_it_was_cast_to():
    # only the bf16 option casts to float32 before the head: a float64
    # copy of the encoder (the exact step chip_smoke.py compares with)
    # computes and returns float64
    f = get_mlp(4, 4, WIDTHS, output_normalization="fixed_sphere").double()
    out = f(torch.zeros(3, 4, dtype=torch.float64) + 0.5)
    assert out.dtype == torch.float64


RESUME = ("--space-type sphere --c-p 0 --c-param 20 --p 0 --n 3 --batch-size 64 "
          "--n-steps 40 --more-unsupervised 1 --n-log-steps 10 "
          "--num-eval-batches 2 --seed 0 --save-every 20").split()


class _Outage(Exception):
    pass


def _stop_at_save(monkeypatch, n, after=False):
    """A simulated outage at the n-th checkpoint: before it is written, or
    (after=True) right after it is complete."""
    save = checkpoint.save_resume_state
    calls = {"n": 0}

    def stopping(*args):
        calls["n"] += 1
        if calls["n"] == n and not after:
            raise _Outage
        save(*args)
        if calls["n"] == n:
            raise _Outage

    monkeypatch.setattr(checkpoint, "save_resume_state", stopping)


def _history(run_dir, sub="resume"):
    _, state = checkpoint.load_resume_state(os.path.join(run_dir, sub))
    return state


@pytest.mark.parametrize("extra", [[], ["--lr-cosine", "--weight-decay", "0.01"],
                                   ["--bf16"]])
def test_midphase_resume_repeats_the_uninterrupted_run(extra, tmp_path, monkeypatch, capsys):
    """40 steps with a checkpoint every 20, against a run stopped right
    after its step-21 checkpoint and resumed: the 40 losses, the logged
    scores and the final scores are equal, exactly (CPU, one thread)."""
    argv = RESUME + ["--only-unsupervised"] + extra
    whole = main_mlp.main(argv + ["--save-dir", str(tmp_path / "whole")], device="cpu")

    cut = str(tmp_path / "cut")
    _stop_at_save(monkeypatch, 1, after=True)
    with pytest.raises(_Outage):
        main_mlp.main(argv + ["--save-dir", cut], device="cpu")
    state = _history(cut)
    assert (state["phase"], state["step"]) == (0, 21)
    assert len(state["lane"]["losses"]) == 21
    monkeypatch.undo()

    resumed = main_mlp.main(argv + ["--save-dir", cut, "--resume"], device="cpu")
    assert "Resuming: phase 0 step 21" in capsys.readouterr().out
    want, got = _history(str(tmp_path / "whole")), _history(cut)
    assert (got["phase"], got["step"]) == (1, 0)
    assert len(want["lane"]["losses"]) == 40
    for key in ("losses", "linear_scores", "perm_scores"):
        assert got["lane"][key] == want["lane"][key], key
    assert resumed == whole


def test_phase_boundary_resume_repeats_the_uninterrupted_run(tmp_path, monkeypatch, capsys):
    """Supervised then unsupervised; the outage comes at the third
    checkpoint (phase 1's step 21), so LATEST is the phase-0 boundary:
    phase 0 is skipped, phase 1 starts fresh from the carried generators."""
    whole = main_mlp.main(RESUME + ["--save-dir", str(tmp_path / "whole")], device="cpu")

    cut = str(tmp_path / "cut")
    _stop_at_save(monkeypatch, 3)
    with pytest.raises(_Outage):
        main_mlp.main(RESUME + ["--save-dir", cut], device="cpu")
    state = _history(cut)
    assert (state["phase"], state["step"]) == (1, 0)
    monkeypatch.undo()
    capsys.readouterr()

    resumed = main_mlp.main(RESUME + ["--save-dir", cut, "--resume"], device="cpu")
    out = capsys.readouterr().out
    assert "completed before resume; skipping" in out
    want, got = _history(str(tmp_path / "whole")), _history(cut)
    assert (got["phase"], got["step"]) == (2, 0)
    assert got["lane"]["losses"] == want["lane"]["losses"]
    assert resumed == whole
    # the skipped phase's artifact is the first run's; the resumed run
    # wrote the second phase's
    assert os.path.exists(os.path.join(cut, "sup_f.pkl"))
    assert os.path.exists(os.path.join(cut, "unsup_f.pkl"))


def test_resume_of_a_completed_run_refuses(tmp_path, capsys):
    argv = RESUME + ["--only-unsupervised", "--save-dir", str(tmp_path)]
    main_mlp.main(argv, device="cpu")
    with pytest.raises(SystemExit, match="complete"):
        main_mlp.main(argv + ["--resume"], device="cpu")


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    argv = RESUME + ["--only-unsupervised"]
    want = main_mlp.main(argv + ["--save-dir", str(tmp_path / "a")], device="cpu")
    capsys.readouterr()
    got = main_mlp.main(argv + ["--save-dir", str(tmp_path / "b"), "--resume"],
                        device="cpu")
    assert "no checkpoint found; starting fresh" in capsys.readouterr().out
    assert got == want


def test_checkpoint_written_half_way_leaves_latest_valid(tmp_path, monkeypatch, capsys):
    """An outage inside the second checkpoint's write leaves a stray
    temporary file; LATEST still names the first, complete artifact, the
    resume starts from it, and the next save clears the stray file."""
    argv = RESUME + ["--only-unsupervised"]
    whole = main_mlp.main(argv + ["--save-dir", str(tmp_path / "whole")], device="cpu")
    cut = str(tmp_path / "cut")
    real_save = torch.save
    calls = {"n": 0}

    def dying_save(obj, path, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            with open(path, "wb") as fh:
                fh.write(b"half a checkpoint")
            raise _Outage
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(_Outage):
        main_mlp.main(argv + ["--save-dir", cut], device="cpu")
    monkeypatch.undo()
    entries = sorted(os.listdir(os.path.join(cut, "resume")))
    assert any(".tmp" in e for e in entries), entries
    state = _history(cut)
    assert (state["phase"], state["step"]) == (0, 21)

    resumed = main_mlp.main(argv + ["--save-dir", cut, "--resume"], device="cpu")
    assert resumed == whole
    entries = sorted(os.listdir(os.path.join(cut, "resume")))
    assert entries == ["LATEST", "state_001000000000.pt"], entries


SEEDS = ("--space-type sphere --c-p 0 --c-param 20 --p 0 --n 3 --batch-size 64 "
         "--n-steps 12 --more-unsupervised 1 --n-log-steps 5 "
         "--num-eval-batches 2 --seed 5").split()


@pytest.mark.parametrize("phases", [["--only-unsupervised"], []])
def test_ensemble_lanes_equal_serial_runs(phases, tmp_path, capsys):
    """--seeds 2: lane i reproduces a serial run with --seed base+i,
    exactly, and the artifacts carry the seed in their names as in the JAX
    package; log.csv rows carry a seed column."""
    ens = tmp_path / "ens"
    lins, perms = main_mlp.main(
        SEEDS + phases + ["--seeds", "2", "--save-dir", str(ens)], device="cpu")
    out = capsys.readouterr().out
    assert "Ensemble over seeds: [5, 6]" in out
    assert "[seed 6] perm mean:" in out
    tags = ["unsup"] if phases else ["sup", "unsup"]
    assert sorted(os.listdir(ens)) == sorted(
        ["args.json", "log.csv", "g_s5.npz", "g_s6.npz"]
        + [f"{t}_f_s{s}.pkl" for t in tags for s in (5, 6)])
    with open(ens / "log.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert {float(r["seed"]) for r in rows} == {5.0, 6.0}

    for i, seed in enumerate((5, 6)):
        serial = tmp_path / f"serial{seed}"
        argv = SEEDS[:-1] + [str(seed)]  # --seed is SEEDS' last flag
        lin, perm = main_mlp.main(argv + phases + ["--save-dir", str(serial)],
                                  device="cpu")
        assert (lins[i], perms[i]) == (lin, perm)
        with open(serial / "log.csv") as fh:
            want_rows = list(csv.DictReader(fh))
        got_rows = [r for r in rows if float(r["seed"]) == seed]
        assert len(got_rows) == len(want_rows)
        for g, w in zip(got_rows, want_rows):
            for key in ("step", "loss", "mean_loss", "linear_disentanglement",
                        "perm_disentanglement", "supervised"):
                assert g[key] == w[key], (seed, key)
        with np.load(ens / f"g_s{seed}.npz") as a, np.load(serial / "g.npz") as b:
            assert all(np.array_equal(a[k], b[k]) for k in b.files)
        for t in tags:
            with open(ens / f"{t}_f_s{seed}.pkl", "rb") as fa, \
                    open(serial / f"{t}_f.pkl", "rb") as fb:
                ta, tb = pickle.load(fa), pickle.load(fb)
            jax.tree.map(np.testing.assert_array_equal, ta, tb)


def test_ensemble_midphase_resume_repeats_the_uninterrupted_ensemble(
        tmp_path, monkeypatch, capsys):
    """--seeds with --save-every: saves at steps 11 and 12 (the forced one
    at the phase's end); the outage is at the second, so LATEST is step 11
    under resume_ens/ and the last step is replayed."""
    argv = SEEDS + ["--only-unsupervised", "--seeds", "2", "--save-every", "10"]
    whole = main_mlp.main(argv + ["--save-dir", str(tmp_path / "whole")], device="cpu")
    cut = str(tmp_path / "cut")
    _stop_at_save(monkeypatch, 2)
    with pytest.raises(_Outage):
        main_mlp.main(argv + ["--save-dir", cut], device="cpu")
    monkeypatch.undo()
    state = _history(cut, "resume_ens")
    assert state["step"] == 11 and len(state["lanes"]) == 2
    capsys.readouterr()

    resumed = main_mlp.main(argv + ["--save-dir", cut, "--resume"], device="cpu")
    assert "Resuming ensemble at step 11" in capsys.readouterr().out
    assert resumed == whole
    want, got = _history(str(tmp_path / "whole"), "resume_ens"), _history(cut, "resume_ens")
    assert got["step"] == want["step"] == 12
    for g, w in zip(got["lanes"], want["lanes"]):
        assert g["losses"] == w["losses"]


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


# ---------------------------------------------------------------------------
# --profile-dir and the CL_ICA_TPU_DEBUG=1 guards
# ---------------------------------------------------------------------------

AUX = ("--space-type sphere --n 3 --batch-size 64 --n-steps 12 --n-log-steps 6 "
       "--only-unsupervised --more-unsupervised 1 --c-p 0 --c-param 20 --p 2 "
       "--seed 0 --num-eval-batches 2 --save-every 12").split()


def _traces(prof_dir):
    """The parsed *.pt.trace.json files under ``prof_dir``."""
    out = []
    for path in sorted(glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))):
        with open(path) as fh:
            out.append(json.load(fh))
    return out


def test_main_mlp_aux_subsystems(tmp_path, monkeypatch, capsys):
    """The port's tests/test_cli_integration.py::test_main_mlp_aux_subsystems:
    --save-dir, --profile-dir and CL_ICA_TPU_DEBUG=1 in one small run. Its
    artifacts, one parseable trace of the training loop, and the losses and
    scores of the same seed's run without the profiler or the flag."""
    plain = main_mlp.main(AUX + ["--save-dir", str(tmp_path / "plain")], device="cpu")
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "1")
    save, prof = tmp_path / "run", tmp_path / "prof"
    got = main_mlp.main(AUX + ["--save-dir", str(save), "--profile-dir", str(prof)],
                        device="cpu")
    assert got == plain
    for name in ("log.csv", "args.json", "g.npz", "unsup_f.pkl"):
        assert (save / name).exists(), name
    with open(save / "log.csv") as fh:
        assert "perm_disentanglement" in fh.readline()
    assert (_history(str(save))["lane"]["losses"]
            == _history(str(tmp_path / "plain"))["lane"]["losses"])
    (trace,) = _traces(prof)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::addmm" in names or "aten::mm" in names


def test_profile_dir_traces_each_phase(tmp_path, capsys):
    """Supervised then unsupervised: one trace a phase, as the JAX driver
    wraps each phase's loop."""
    argv = [a for a in AUX if a != "--only-unsupervised"]
    main_mlp.main(argv + ["--save-dir", str(tmp_path / "s"), "--profile-dir",
                          str(tmp_path / "prof")], device="cpu")
    assert len(_traces(tmp_path / "prof")) == 2


def _nan_at_step(monkeypatch, step):
    """Every encoder get_mlp builds gets its first weight set to NaN just
    before the forward of its ``step``-th training step (the evaluations
    run under no_grad and are not counted); returns the per-encoder counts
    of training forwards (two a step)."""
    counts = []
    build = main_mlp.get_mlp

    def get_mlp_with_nan(*args, **kw):
        f = build(*args, **kw)
        seen = [0]
        counts.append(seen)

        def pre_hook(module, inputs):
            if torch.is_grad_enabled():
                seen[0] += 1
                if seen[0] == 2 * step - 1:
                    with torch.no_grad():
                        module.linears[0].weight.fill_(float("nan"))

        f.register_forward_pre_hook(pre_hook)
        return f

    monkeypatch.setattr(main_mlp, "get_mlp", get_mlp_with_nan)
    return counts


@pytest.mark.parametrize("extra", [[], ["--seeds", "2"]])
def test_nan_weight_raises_at_the_window_boundary(extra, monkeypatch, capsys):
    """Under CL_ICA_TPU_DEBUG=1 a non-finite loss raises ValueError where the
    window's losses reach the host: the encoder turns NaN in step 3, inside
    the window of steps 2-7, and the run stops after step 7 (the JAX
    package's checked scan raises when its window returns), before any
    evaluation of that window; the serial lane and the ensemble's alike."""
    counts = _nan_at_step(monkeypatch, 3)
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "1")
    argv = AUX[:-2]  # no --save-every: there is no --save-dir
    assert argv[-1] == "2"
    with pytest.raises(ValueError, match="non-finite values in loss"):
        main_mlp.main(argv + extra, device="cpu")
    assert [c[0] for c in counts] == [14] * (2 if extra else 1)
    out = capsys.readouterr().out
    assert "Step: 1 " in out and "Step: 7 " not in out
