"""cl_ica_tpu_torch.cli.main_3dident against the JAX package: the parser,
the latent-space and latent-column tables for every flag combination, the
encoder with converted weights per head, one whole unsupervised step (loss
and every parameter gradient), and small end-to-end CPU runs of the three
modes with --fused-stem, a saved and reloaded model, and an exact resume."""

import argparse
import functools
import glob
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cl_ica_tpu.cli import main_3dident as jax_main
from cl_ica_tpu.data import normalize_3dident as jax_normalize
from cl_ica_tpu_torch.cli import main_3dident
from cl_ica_tpu_torch.data import normalize_3dident
from cl_ica_tpu_torch.data import threedident as data
from cl_ica_tpu_torch.models import (
    MinResBN2d,
    threedident_params_from_flax,
    threedident_params_to_flax,
)
from cl_ica_tpu_torch.ops import launch_counts, reset_launch_counts
from cl_ica_tpu_torch.tools import make_synthetic_3dident as tool
from cl_ica_tpu_torch.train import checkpoint, make_optimizer

torch.set_num_threads(1)

N_POINTS, SIZE = 48, 32


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """{periodic: folder} of 48-point 32×32 fixtures, 11 and 10 columns."""
    out = {}
    for periodic in (True, False):
        root = tmp_path_factory.mktemp("p" if periodic else "np")
        tool.main(["--output-folder", str(root), "--n-points", str(N_POINTS),
                   "--image-size", str(SIZE), "--seed", "0"]
                  + ([] if periodic else ["--non-periodic-rotation-and-color"]))
        out[periodic] = str(root)
    return out


def _argv(root, *extra):
    return ["--offline-dataset", root, "--batch-size", "8", "--n-eval-samples",
            "32", "--n-log-steps", "2", "--seed", "0", *extra]


# ---------------------------------------------------------------------------
# the parser and the tables
# ---------------------------------------------------------------------------


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
    got = _spec(_parser_of(main_3dident.parse_args, monkeypatch))
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--save-every", "5"],
    ["--save-every", "0", "--save-model", "m"],
    ["--resume"],
    ["--position-only", "--rotation-and-color-only"],
    ["--position-only", "--no-spotlight"],
    ["--box-constraint", "fix", "--sphere-constraint", "fix"],
    ["--mesh-model", "2"],
    ["--mesh", "4", "--mesh-model", "3"],
    ["--scan"],
    ["--scan", "--mode", "unsupervised", "--identity-mixing-and-solution"],
    ["--scan", "--mode", "unsupervised", "--mesh", "2"],
    ["--fused-stem", "--norm-kind", "batch"],
    ["--fused-stem", "--norm-kind", "minres8"],
    ["--save-model", "no/such/folder/m"],
    ["--encoder", "rn34"],
])
def test_parser_checks_match(argv, capsys):
    argv = ["--offline-dataset", "x"] + argv
    with pytest.raises((SystemExit, AssertionError)) as want:
        jax_main.parse_args(argv)
    with pytest.raises((SystemExit, AssertionError)) as got:
        main_3dident.parse_args(argv)
    assert got.type is want.type
    if got.type is SystemExit:  # argparse's code, or a message of the same kind
        if isinstance(want.value.code, str):
            assert got.value.code[:40] == want.value.code[:40]
        else:
            assert got.value.code == want.value.code


_SUBSETS = (None, "--position-only", "--rotation-and-color-only",
            "--rotation-only", "--color-only")
_FLAG_GRID = [
    [f for f in combo if f]
    for combo in itertools.product(
        _SUBSETS, (None, "--non-periodic-rotation-and-color"),
        (None, "--no-spotlight-position"), (None, "--no-spotlight-color"))
]


def _outcome(fn):
    try:
        return "ok", fn()
    except (ValueError, NotImplementedError, AssertionError, SystemExit) as err:
        return type(err).__name__, None


def _space_signature(space):
    """Topology and width of a latent space and of its factors."""
    parts = getattr(space, "spaces", [space])
    return [(type(p.space).__name__, p.dim) for p in parts]


@pytest.mark.parametrize("flags", _FLAG_GRID, ids=lambda f: " ".join(f) or "default")
def test_latent_space_and_column_tables_match_jax(flags, capsys):
    argv = ["--offline-dataset", "x"] + flags
    kind, jargs = _outcome(lambda: jax_main.parse_args(argv))
    got_kind, args = _outcome(lambda: main_3dident.parse_args(argv))
    assert got_kind == kind
    if kind != "ok":
        return
    assert vars(args) == vars(jargs)
    kind, want = _outcome(lambda: jax_main.setup_latent_space(jargs))
    got_kind, got = _outcome(lambda: main_3dident.setup_latent_space(args))
    assert got_kind == kind
    if kind == "ok":
        assert got[1:] == want[1:]
        assert _space_signature(got[0]) == _space_signature(want[0])
        z, zt = got[0].sample_pair(torch.Generator().manual_seed(0), 5)
        assert z.shape == zt.shape == (5, got[1] + got[2])
    kind, want = _outcome(lambda: jax_main.latent_dims_to_use(jargs))
    got_kind, got = _outcome(lambda: main_3dident.latent_dims_to_use(args))
    assert (got_kind, got) == (kind, want)


@pytest.mark.parametrize("conditional", ["l1", "l2", "l3"])
def test_conditionals_sample_at_the_requested_width(conditional):
    """--non-periodical-conditional picks Laplace, normal or the generalised
    normal of order 3 at scale --sigma: the mean |z̃ − z| of a box coordinate
    is σ, σ·√(2/π) and σ·Γ(2/3)/Γ(1/3) of them."""
    args = main_3dident.parse_args(
        ["--offline-dataset", "x", "--position-only", "--sigma", "0.05",
         "--non-periodical-conditional", conditional])
    space, _, _ = main_3dident.setup_latent_space(args)
    z, zt = space.sample_pair(torch.Generator().manual_seed(0), 20000)
    inner = (z.abs() < 0.7).all(dim=1)  # away from the walls' rejection
    want = {"l1": 1.0, "l2": (2 / np.pi) ** 0.5, "l3": 0.50546}[conditional] * 0.05
    assert abs(float((zt - z)[inner].abs().mean()) / want - 1) < 0.05


@pytest.mark.parametrize("argv, says", [
    # --mesh is ported (A13): two gloo ranks on the CPU run to the end
    (["--mesh", "2", "--mode", "unsupervised", "--iterations", "2"], None),
    # and --mesh-model (A13b); the test keeps its name, and no flag of the
    # driver exits naming a ROADMAP item any more
    (["--mesh", "2", "--mesh-model", "2", "--mode", "unsupervised",
      "--iterations", "2"], None),
    # --norm-kind minres8 is ported; the JAX driver's exit for it under the
    # fused stem (which would ignore it) stays
    (["--fused-stem", "--norm-kind", "minres8"], "float8 residuals"),
])
def test_unported_flags_exit_naming_the_roadmap_item(argv, says, fixtures, capsys):
    if says is None:
        out = main_3dident.main(_argv(fixtures[True], *argv), device="cpu")
        assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
        return
    with pytest.raises(SystemExit, match=says):
        main_3dident.main(_argv(fixtures[True], *argv), device="cpu")


def test_minres8_trains_eager_and_scan_alike(fixtures, monkeypatch, capsys):
    """--norm-kind minres8 puts the float8-residual MinResBN2d in all
    twenty norms; its first loss is the default minres path's (the forward
    is bit for bit the same), and --scan (on the CPU the captured body run
    eagerly) repeats the eager run loss for loss."""
    built = []
    build = main_3dident.build_encoder
    monkeypatch.setattr(main_3dident, "build_encoder",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    argv = _argv(fixtures[True], "--mode", "unsupervised", "--iterations", "4")
    minres = main_3dident.main(argv, device="cpu")
    runs = [main_3dident.main(argv + ["--norm-kind", "minres8"] + extra, device="cpu")
            for extra in ([], ["--scan"])]
    f8 = [sum(isinstance(m, MinResBN2d) and m.residuals_f8 for m in model.modules())
          for model in built]
    assert f8 == [0, 20, 20]
    eager, scan = runs[0]["losses"], runs[1]["losses"]
    assert len(eager) == 4 and np.isfinite(eager).all()
    assert eager[0] == minres["losses"][0] and eager != minres["losses"]
    assert scan == eager


def test_scan_matches_eager_and_resumes_exactly(fixtures, tmp_path, monkeypatch,
                                                capsys):
    """--scan (the step captured once and replayed; on the CPU the same
    body runs eagerly) trains the same model as the eager loop, loss for
    loss, between the same log and save boundaries; a --scan run stopped
    at its step-2 checkpoint and resumed repeats it."""
    argv = _argv(fixtures[True], "--mode", "unsupervised", "--fused-stem",
                 "--iterations", "5", "--save-every", "2")
    runs = {}
    for name, extra in (("eager", []), ("scan", ["--scan"])):
        path = str(tmp_path / f"{name}.pt")
        runs[name] = (main_3dident.main(argv + extra + ["--save-model", path],
                                        device="cpu"),
                      torch.load(path, weights_only=True))
    (eager, a), (scan, b) = runs["eager"], runs["scan"]
    assert len(scan["losses"]) == 5 and scan["losses"] == eager["losses"]
    assert (scan["mcc"], scan["lin"]) == (eager["mcc"], eager["lin"])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    save = checkpoint.save_resume_state

    def save_then_stop(*args):
        save(*args)
        raise _Outage

    cut = argv + ["--scan", "--save-model", str(tmp_path / "cut.pt")]
    monkeypatch.setattr(checkpoint, "save_resume_state", save_then_stop)
    with pytest.raises(_Outage):
        main_3dident.main(cut, device="cpu")
    monkeypatch.setattr(checkpoint, "save_resume_state", save)
    resumed = main_3dident.main(cut + ["--resume"], device="cpu")
    assert "Resumed full train state at step 2" in capsys.readouterr().out
    assert resumed["losses"] == scan["losses"]


@pytest.mark.parametrize("argv, env, says", [
    (["--scan"], {}, "--mode unsupervised"),
    (["--scan", "--mode", "unsupervised", "--identity-mixing-and-solution"], {},
     "--identity-mixing-and-solution"),
    (["--scan", "--mode", "unsupervised", "--mesh", "2"], {}, "--mesh"),
    (["--scan", "--mode", "unsupervised"], {"CL_ICA_TPU_DEBUG": "1"},
     "CL_ICA_TPU_DEBUG"),
])
def test_scan_exits_where_the_jax_driver_does(argv, env, says, monkeypatch, capsys):
    """The JAX driver's --scan exits (cl_ica_tpu/cli/main_3dident.py:216-235),
    in parse_args in both packages; with CL_ICA_TPU_DEBUG=0 debug is off."""
    argv = ["--offline-dataset", "x"] + argv
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="scan"):
        jax_main.parse_args(argv)
    with pytest.raises(SystemExit, match="--scan") as err:
        main_3dident.parse_args(argv)
    assert says in str(err.value)
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "0")
    main_3dident.parse_args(["--offline-dataset", "x", "--scan", "--mode",
                             "unsupervised"])


def test_scan_runs_sgd_under_a_schedule_as_eager_steps(fixtures, tmp_path, capsys):
    """--scan --optimizer sgd --lr-cosine, as the JAX driver runs it (C8):
    the fused SGD update reads the schedule's lr tensor on the device, so
    the step is captured; on the CPU the same body runs eagerly, loss for
    loss and weight for weight with the eager loop."""
    argv = _argv(fixtures[True], "--mode", "unsupervised", "--iterations", "5",
                 "--optimizer", "sgd", "--lr-cosine", "--lr", "0.05",
                 "--weight-decay", "0.01")
    runs = {}
    for name, extra in (("eager", []), ("scan", ["--scan"])):
        path = str(tmp_path / f"{name}.pt")
        runs[name] = (main_3dident.main(argv + extra + ["--save-model", path],
                                        device="cpu"),
                      torch.load(path, weights_only=True))
    (eager, a), (scan, b) = runs["eager"], runs["scan"]
    assert len(scan["losses"]) == 5 and scan["losses"] == eager["losses"]
    assert len(set(eager["losses"])) > 1
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_sgd_under_a_cosine_schedule_matches_optax(weight_decay):
    """make_optimizer(kind='sgd', cosine_steps=T) against the JAX driver's
    optax.sgd(cosine_decay_schedule(lr, T)), chained after
    add_decayed_weights under --weight-decay (cl_ica_tpu/cli/
    main_3dident.py:583-599), past T: float32 parameters to 1e-6 relative
    (the two round lr·(g + wd·p) in another order)."""
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = rng.normal(size=(7, 5, 3)).astype(np.float32)
    schedule = optax.cosine_decay_schedule(0.1, 5)
    tx = optax.sgd(schedule) if not weight_decay else optax.chain(
        optax.add_decayed_weights(weight_decay), optax.sgd(schedule))
    params = jnp.asarray(w0)
    state = tx.init(params)
    w = torch.nn.Parameter(torch.tensor(w0))
    opt, sched = make_optimizer([w], 0.1, weight_decay, cosine_steps=5, kind="sgd")
    assert opt.param_groups[0]["fused"]
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.tensor(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-7)


def test_scan_with_a_store_over_the_device_budget_exits(fixtures, monkeypatch, capsys):
    """As the JAX driver's host-prefetch guard: a store left on the host
    cannot feed a captured step."""
    monkeypatch.setenv(data.BUDGET_ENV, "1000")
    with pytest.raises(SystemExit, match="--scan: the image store exceeds") as err:
        main_3dident.main(_argv(fixtures[True], "--mode", "unsupervised", "--scan"),
                          device="cpu")
    assert data.BUDGET_ENV in str(err.value)


def test_store_over_the_device_budget_trains_on_the_host_path(
        fixtures, monkeypatch, capsys):
    """A store beyond the budget stays on the host and the prefetch loader
    serves it: with one worker the run is the device store's of the same
    seed, loss for loss and in its evaluation; with three it trains."""
    argv = _argv(fixtures[True], "--mode", "unsupervised", "--iterations", "4")
    on_device = main_3dident.main(argv, device="cpu")
    monkeypatch.setenv(data.BUDGET_ENV, "1000")
    on_host = main_3dident.main(argv + ["--workers", "1"], device="cpu")
    assert (on_device["data_path"], on_host["data_path"]) == ("device-store",
                                                              "host-prefetch")
    assert on_device["loader"] is None
    assert on_host["loader"]["workers"] == 1 and on_host["loader"]["slots"] == 3
    assert len(on_host["losses"]) == 4 and on_host["losses"] == on_device["losses"]
    assert (on_host["mcc"], on_host["lin"]) == (on_device["mcc"], on_device["lin"])
    several = main_3dident.main(argv + ["--workers", "3"], device="cpu")
    assert several["loader"]["workers"] == 3
    assert len(several["losses"]) == 4 and np.all(np.isfinite(several["losses"]))
    assert "host-prefetch: 3 workers, 5 pinned slots" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["supervised", "test"])
def test_supervised_and_test_modes_run_over_the_device_budget(
        mode, fixtures, monkeypatch, capsys):
    """Their rows are gathered on the host as they are needed (the native
    gather), the same renders as the device store's."""
    argv = _argv(fixtures[True], "--mode", mode, "--iterations", "3")
    on_device = main_3dident.main(argv, device="cpu")
    monkeypatch.setenv(data.BUDGET_ENV, "1000")
    on_host = main_3dident.main(argv, device="cpu")
    assert on_host["data_path"] == "host-gather"
    assert on_device["data_path"] == ("device-store" if mode == "supervised"
                                      else "host-gather")
    assert on_host["losses"] == on_device["losses"]
    assert on_host["lin"] == on_device["lin"] and np.isfinite(on_host["lin"])


def test_main_needs_cuda_unless_told_otherwise(fixtures, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main_3dident.main(_argv(fixtures[True]))


# ---------------------------------------------------------------------------
# the encoder, per head, with converted weights
# ---------------------------------------------------------------------------

_MLP = dict(dummy_mixing=True)  # the heads do not depend on the backbone
HEADS = {
    "split": dict(n_latents=11, n_non_angular=3),
    "split-box-fix": dict(n_latents=11, n_non_angular=3, box_constraint="fix", **_MLP),
    "split-box-learnable": dict(n_latents=11, n_non_angular=3,
                                box_constraint="learnable", **_MLP),
    "split-sphere-fix": dict(n_latents=11, n_non_angular=3,
                             sphere_constraint="fix", **_MLP),
    "split-sphere-learnable": dict(n_latents=11, n_non_angular=3,
                                   sphere_constraint="learnable", **_MLP),
    "non-periodic": dict(n_latents=10, n_non_angular=10, non_periodic=True),
    "non-periodic-box": dict(n_latents=10, n_non_angular=10, non_periodic=True,
                             box_constraint="learnable", **_MLP),
    "position-only-sphere": dict(n_latents=3, n_non_angular=3, position_only=True,
                                 sphere_constraint="learnable", **_MLP),
    "subset-periodic": dict(n_latents=8, n_non_angular=0, subset_only=True, **_MLP),
    "subset-non-periodic-box": dict(n_latents=7, n_non_angular=7, subset_only=True,
                                    non_periodic=True, box_constraint="fix", **_MLP),
    "dummy-mixing": dict(n_latents=11, n_non_angular=3, **_MLP),
    "fused-stem": dict(n_latents=11, n_non_angular=3, fused_stem=True,
                       sphere_constraint="learnable"),
    "norm-batch": dict(n_latents=11, n_non_angular=3, norm_kind="batch",
                       box_constraint="learnable"),
}
_NORM_NAME = {"minres": "MinResBN", "fast": "FastBatchNorm", "batch": "BatchNorm"}


def _zero_block_final_scales(tree):
    """Flax initialises the last norm scale of every residual block to 0."""
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if name.startswith(("BasicBlock", "Bottleneck")):
            norms = sorted((k for k in sub if "scale" in sub[k] and k != "norm_proj"),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            sub[norms[-1]]["scale"][:] = 0.0
        else:
            _zero_block_final_scales(sub)


def _pair(kwargs, seed=0):
    """(Flax module, numpy variables with the heads moved off their initial
    1, the port's module loaded from them)."""
    jmodel = jax_main.ThreeDIdentEncoder(**kwargs)
    n = kwargs["n_latents"]
    example = jnp.zeros((1, n)) if kwargs.get("dummy_mixing") else jnp.zeros(
        (1, SIZE, SIZE, 3))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt((2.0 if len(leaf.shape) == 4 else 1.0)
                          / np.prod(leaf.shape[:-1]))
            return (std * rng.normal(size=leaf.shape)).astype(np.float32)
        if name in ("scale", "var", "r", "max_abs_bound"):
            return np.ones(leaf.shape, np.float32)
        if name == "bias" and "Dense" in path[-2].key:
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)

    # the tree and shapes of Flax's init, the values from numpy: on a CPU
    # the initialisers themselves take longer than every check of a test
    variables = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.PRNGKey(0),
        example))
    _zero_block_final_scales(variables["params"])
    params = dict(variables["params"])
    for name in list(params):
        if name.startswith(("RescaleLayer", "SoftclipLayer")):
            params[name] = {k: (v + rng.uniform(0.2, 0.8, v.shape)).astype(np.float32)
                            for k, v in params[name].items()}
    variables = {**variables, "params": params}
    model = main_3dident.ThreeDIdentEncoder(**kwargs)
    sd = threedident_params_from_flax(variables, model.flax_head_names())
    loaded = model.load_state_dict(sd)
    assert not loaded.missing_keys and not loaded.unexpected_keys
    return jmodel, variables, model


def _inputs(kwargs, seed, n=4):
    rng = np.random.default_rng(seed)
    if kwargs.get("dummy_mixing"):
        x = rng.normal(size=(n, kwargs["n_latents"])).astype(np.float32)
        return x, torch.tensor(x)
    x = rng.normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)
    return x, torch.tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("head", HEADS)
def test_encoder_heads_match_flax(head):
    kwargs = HEADS[head]
    jmodel, variables, model = _pair(kwargs)
    x, xt = _inputs(kwargs, 1)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    got = model.eval()(xt)
    assert got.shape == (4, kwargs["n_latents"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)
    if "batch_stats" in variables:
        want, _ = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        np.testing.assert_allclose(model.train()(xt).detach().numpy(),
                                   np.asarray(want), atol=2e-5, rtol=1e-4)
    # and back: the converter restores the Flax tree leaf for leaf
    norm_name = _NORM_NAME["fast" if kwargs.get("fused_stem")
                           else kwargs.get("norm_kind", "minres")]
    back = threedident_params_to_flax(model.state_dict(), model.flax_head_names(),
                                      norm_name)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    want_flat = flat(variables)
    got_flat = flat(back)
    if "batch_stats" in variables:  # training mode above moved the port's
        want_flat = {k: v for k, v in want_flat.items() if "batch_stats" not in k}
        got_flat = {k: v for k, v in got_flat.items() if "batch_stats" not in k}
    assert got_flat.keys() == want_flat.keys()
    assert all(np.array_equal(got_flat[k], w) for k, w in want_flat.items())


def test_identity_solution_flattens_in_the_jax_order():
    kwargs = dict(n_latents=11, n_non_angular=3, identity_solution=True)
    jmodel = jax_main.ThreeDIdentEncoder(**kwargs)
    model = main_3dident.ThreeDIdentEncoder(**kwargs)
    assert not list(model.parameters())
    x, xt = _inputs(kwargs, 2)
    want = jmodel.apply({}, jnp.asarray(x))
    np.testing.assert_array_equal(model(xt).numpy(), np.asarray(want))
    z = torch.randn(4, 11)
    assert torch.equal(model(z), z)


def test_unknown_encoder_leaf_raises():
    _, variables, model = _pair(HEADS["dummy-mixing"])
    params = {**variables["params"], "Extra_0": {"kernel": np.zeros((1, 1))}}
    with pytest.raises(KeyError, match="Extra_0"):
        threedident_params_from_flax({"params": params}, model.flax_head_names())
    with pytest.raises(KeyError, match="other.weight"):
        threedident_params_to_flax({"other.weight": torch.zeros(1)}, {})


# ---------------------------------------------------------------------------
# one whole unsupervised step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags, seed", [
    (["--fused-stem"], 3), ([], 3),
    (["--fused-stem", "--unsupervised-loss", "l1",
      "--non-periodic-rotation-and-color"], 5)],
    ids=["fused-stem", "unfused", "fused-stem-l1-box"])
def test_unsupervised_step_matches_the_jax_step(flags, seed, fixtures, capsys):
    """Converted weights and the same image batch through the port's
    objective and the JAX main_3dident's (_unsup_body: both views in one forward
    of 2B images in training mode, z3 = roll(z1), the split loss). The
    block-final norm scales are moved off zero so that every layer has a
    gradient. Loss to 1e-4 relative; gradients at the ResNet test's bars.
    (The seeds are chosen: the relu and the L1 loss have kinks, and with
    some weights a value lies within float32 rounding of one, the two
    packages' forwards put it on opposite sides and that channel's
    gradients then differ by a tenth. With these seeds the worst gradient
    error is 2% of its bar.)"""
    periodic = "--non-periodic-rotation-and-color" not in flags
    argv = _argv(fixtures[periodic], "--mode", "unsupervised", *flags)
    args, jargs = main_3dident.parse_args(argv), jax_main.parse_args(argv)
    _, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    n = n_non_ang + n_ang
    kwargs = dict(n_latents=n, n_non_angular=n_non_ang,
                  non_periodic=not periodic, fused_stem=args.fused_stem)
    jmodel, variables, model = _pair(kwargs, seed=seed)
    rng = np.random.default_rng(5)

    def off_zero(path, leaf):
        if path[-1].key == "scale" and not leaf.any():
            return rng.uniform(0.5, 1.0, leaf.shape).astype(np.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(off_zero, variables)
    model.load_state_dict(
        threedident_params_from_flax(variables, model.flax_head_names()))

    latents = np.load(fixtures[periodic] + "/raw_latents.npy")
    i1, i2 = rng.choice(N_POINTS, 8, replace=False), rng.choice(N_POINTS, 8, replace=False)
    u1, u2 = (tool.render_batch(latents[i], size=SIZE) for i in (i1, i2))

    jloss = jax_main.build_split_loss(jargs, n_non_ang, use_fused=False)

    def objective(params):
        x = jnp.concatenate([jax_normalize(jnp.asarray(u1)),
                             jax_normalize(jnp.asarray(u2))], 0)
        z, _ = jmodel.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            x, train=True, mutable=["batch_stats"])
        z1r, z2r = z[:8], z[8:]
        return jloss(z1r, z2r, jnp.roll(z1r, 1, axis=0))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(objective))(
        variables["params"])

    loss = main_3dident.build_split_loss(args, n_non_ang)
    x1, x2 = (normalize_3dident(torch.from_numpy(u)) for u in (u1, u2))
    total, per_item = main_3dident.unsupervised_objective(model.train(), loss, x1, x2)
    assert per_item.shape == (8,)
    total.backward()
    np.testing.assert_allclose(float(total), float(want_loss), rtol=1e-4)

    grads = {k: p.grad for k, p in model.named_parameters()}
    norm_name = "FastBatchNorm" if args.fused_stem else "MinResBN"
    got = threedident_params_to_flax(grads, model.flax_head_names(), norm_name)["params"]
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    got, want = flat(got), flat(want_grads)
    assert got.keys() == want.keys() and len(want) >= 64
    assert max(np.abs(w).max() for w in want.values()) > 1e-3
    worst = 0.0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=3e-3, rtol=1e-3, err_msg=k)
        worst = max(worst, float((np.abs(got[k] - w) / (3e-3 + 1e-3 * np.abs(w))).max()))
    print("worst gradient error over its bar", worst)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_sgd_matches_optax(weight_decay):
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = rng.normal(size=(4, 5, 3)).astype(np.float32)
    tx = optax.sgd(0.1) if not weight_decay else optax.chain(
        optax.add_decayed_weights(weight_decay), optax.sgd(0.1))
    params, state = jnp.asarray(w0), None
    state = tx.init(params)
    w = torch.nn.Parameter(torch.tensor(w0))
    opt, sched = make_optimizer([w], 0.1, weight_decay, kind="sgd")
    assert sched is None
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="adam"):
        make_optimizer([w], 0.1, kind="lion")


# ---------------------------------------------------------------------------
# main_3dident, end to end on the CPU
# ---------------------------------------------------------------------------


class _Outage(Exception):
    pass


@pytest.mark.parametrize("mode", ["unsupervised", "supervised"])
def test_main_trains_with_the_fused_stem_and_resumes_exactly(
        mode, fixtures, tmp_path, monkeypatch, capsys):
    """4 steps with --fused-stem print an MCC; the model it saves serves
    --mode test; the same run stopped at its step-2 checkpoint and resumed
    repeats the uninterrupted one loss for loss, weight for weight."""
    argv = _argv(fixtures[True], "--mode", mode, "--fused-stem", "--iterations",
                 "4", "--save-every", "2")
    whole_path = str(tmp_path / "whole.pt")
    reset_launch_counts()
    whole = main_3dident.main(argv + ["--save-model", whole_path,
                                      "--log-dir", str(tmp_path / "log")],
                              device="cpu")
    out = capsys.readouterr().out
    assert len(whole["losses"]) == 4 and np.all(np.isfinite(whole["losses"]))
    assert "Lin. Disentanglement" in out
    assert np.isfinite(whole["lin"]) and whole["mean_znorm"] > 0
    if mode == "unsupervised":
        assert "Perm. Disentanglement (MCC)" in out and np.isfinite(whole["mcc"])
    assert (tmp_path / "log" / "log.csv").exists()
    # on CPU tensors every wrapper takes its plain version: nothing launched
    assert not any(launch_counts().values())

    test = main_3dident.main(
        _argv(fixtures[True], "--mode", "test", "--fused-stem", "--load-model",
              whole_path), device="cpu")
    assert "MCC:" in capsys.readouterr().out
    assert np.isfinite(test["mcc"]) and np.isfinite(test["lin"])
    assert test["losses"] == []

    cut_path = str(tmp_path / "cut.pt")
    save = checkpoint.save_resume_state

    def save_then_stop(*args):
        save(*args)
        raise _Outage

    monkeypatch.setattr(checkpoint, "save_resume_state", save_then_stop)
    with pytest.raises(_Outage):
        main_3dident.main(argv + ["--save-model", cut_path], device="cpu")
    monkeypatch.setattr(checkpoint, "save_resume_state", save)
    resumed = main_3dident.main(argv + ["--save-model", cut_path, "--resume"],
                                device="cpu")
    assert "Resumed full train state at step 2" in capsys.readouterr().out
    assert resumed["losses"] == whole["losses"]
    a = torch.load(whole_path, weights_only=True)
    b = torch.load(cut_path, weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # the fused and the unfused stem share one state dict
    unfused = main_3dident.main(
        _argv(fixtures[True], "--mode", "test", "--load-model", whole_path),
        device="cpu")
    assert abs(unfused["lin"] - test["lin"]) < 1e-3


def test_resume_without_a_train_state_starts_fresh(fixtures, tmp_path, capsys):
    out = main_3dident.main(
        _argv(fixtures[True], "--mode", "unsupervised", "--dummy-mixing",
              "--iterations", "2", "--resume", "--save-model",
              str(tmp_path / "m.pt")), device="cpu")
    assert "no train state found" in capsys.readouterr().out
    assert len(out["losses"]) == 2


@pytest.mark.parametrize("flags, periodic", [
    (["--dummy-mixing"], True),
    (["--dummy-mixing", "--optimizer", "sgd", "--lr-cosine", "--weight-decay",
      "0.01", "--no-fused-loss"], True),
    (["--dummy-mixing", "--box-constraint", "learnable", "--unsupervised-loss",
      "vmf"], True),
    (["--dummy-mixing", "--non-periodic-rotation-and-color", "--no-spotlight",
      "--sphere-constraint", "fix", "--unsupervised-loss", "l3"], False),
    (["--dummy-mixing", "--rotation-and-color-only"], True),
    (["--identity-solution", "--dummy-mixing", "--position-only"], True),
    (["--identity-mixing-and-solution"], True),
    (["--bf16", "--fused-stem"], True),
    (["--bf16"], True),
    (["--encoder", "rn50", "--non-periodic-rotation-and-color",
      "--non-periodical-conditional", "l1", "--unsupervised-loss", "l1",
      "--sigma", "0.2"], False),
    (["--no-cuda", "--workers", "2", "--faiss-omp-threads", "4",
      "--approximate-dataset-nn-search", "--dummy-mixing"], True),
], ids=lambda v: " ".join(v) if isinstance(v, list) else "")
def test_unsupervised_options_run_on_cpu(flags, periodic, fixtures, capsys):
    out = main_3dident.main(
        _argv(fixtures[periodic], "--mode", "unsupervised", "--iterations", "3",
              *flags), device="cpu")
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert np.isfinite(out["lin"])


@pytest.mark.parametrize("mode", ["unsupervised", "supervised"])
def test_default_norm_kind_builds_minres_and_matches_fast(mode, fixtures, monkeypatch,
                                                          capsys):
    """The default --norm-kind minres puts MinResBN2d in all twenty norms of
    the ResNet18 (the CPU runs their plain versions); --norm-kind fast and
    --fused-stem put it nowhere. The same mathematics: the first loss as
    --norm-kind fast's to 1e-5, the next two (after Adam steps on
    gradients that differ by rounding) to 1e-3."""
    built = []
    build = main_3dident.build_encoder
    monkeypatch.setattr(main_3dident, "build_encoder",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    argv = _argv(fixtures[True], "--mode", mode, "--iterations", "3")
    runs = [main_3dident.main(argv + extra, device="cpu")
            for extra in ([], ["--norm-kind", "fast"], ["--fused-stem"])]
    minres = [sum(isinstance(m, MinResBN2d) for m in model.modules())
              for model in built]
    assert minres == [20, 0, 0]
    losses, fast = runs[0]["losses"], runs[1]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, fast)]
    assert len(rel) == 3 and rel[0] <= 1e-5 and max(rel) <= 1e-3


def test_fused_loss_on_the_cpu_raises_instead_of_falling_back(fixtures, capsys):
    with pytest.raises((ValueError, RuntimeError)):
        main_3dident.main(
            _argv(fixtures[True], "--mode", "unsupervised", "--dummy-mixing",
                  "--iterations", "1", "--fused-loss"), device="cpu")


def test_test_mode_sweeps_without_replacement(fixtures, monkeypatch, capsys):
    """Test mode draws one permutation of the rendered set and consumes it
    in batch-size slices: 48 points in 6 batches of 8, each seen once."""
    seen = []
    batch = main_3dident.SequentialThreeDIdent.batch

    def spy(self, indices):
        seen.append(np.asarray(indices))
        return batch(self, indices)

    monkeypatch.setattr(main_3dident.SequentialThreeDIdent, "batch", spy)
    main_3dident.main(
        ["--offline-dataset", fixtures[True], "--mode", "test", "--batch-size",
         "8", "--n-eval-samples", "48", "--seed", "1"], device="cpu")
    assert len(seen) == 6
    assert sorted(np.concatenate(seen).tolist()) == list(range(N_POINTS))
    # the JAX main_3dident's sweep from the same seed is the same permutation
    np.testing.assert_array_equal(
        np.concatenate(seen), np.random.default_rng(1).permutation(N_POINTS))


def test_score_matches_the_jax_drivers_evaluation_mathematics():
    from cl_ica_tpu.evaluation import (
        linear_disentanglement as jax_linear,
        permutation_disentanglement as jax_perm,
    )

    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, (64, 5)).astype(np.float32)
    hz = (z[:, ::-1] * 0.7 + 0.05 * rng.normal(size=z.shape)).astype(np.float32)
    mcc, lin, mse, lin_mse = main_3dident.score(z, hz)
    (want_lin, _), (z_test, hz_lin) = jax_linear(z, hz, mode="r2",
                                                 train_test_split=True)
    (want_mcc, _), _ = jax_perm(z, hz, mode="pearson", solver="munkres",
                                rescaling=True)
    assert abs(mcc - float(want_mcc)) < 1e-6 and abs(lin - float(want_lin)) < 1e-6
    np.testing.assert_allclose(mse, ((z - hz) ** 2).mean(0))
    np.testing.assert_allclose(lin_mse, ((z_test - hz_lin) ** 2).mean(0), rtol=1e-5)
    assert main_3dident.score(z, hz, eval_perm=False)[0] == np.inf


def test_float32_convolutions_stay_out_of_tf32_for_the_run(fixtures, monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(main_3dident, "_run", lambda args, device: seen.append(
        torch.backends.cudnn.allow_tf32))
    was = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        main_3dident.main(_argv(fixtures[True]), device="cpu")
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = was


def test_test_mode_without_an_image_store_fails_as_in_jax(fixtures, capsys):
    """--mode test with --dummy-mixing has no render to encode: the JAX
    package hands its encoder None (ROADMAP C5), and the port, which adds
    no behaviour of its own, fails at the same place."""
    argv = _argv(fixtures[True], "--mode", "test", "--dummy-mixing")
    with pytest.raises(AttributeError, match="NoneType"):
        jax_main.main(argv)
    with pytest.raises(TypeError, match="NoneType"):
        main_3dident.main(argv, device="cpu")


# ---------------------------------------------------------------------------
# --profile-dir and the CL_ICA_TPU_DEBUG=1 guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["unsupervised", "supervised", "test"])
def test_profile_dir_traces_the_training_modes(mode, fixtures, tmp_path, capsys):
    """--profile-dir traces the training loop of --mode unsupervised and
    supervised (one parseable trace, the losses of the same seed's run
    without it) and, as the JAX driver, nothing in --mode test."""
    argv = _argv(fixtures[True], "--mode", mode, "--iterations", "3")
    plain = main_3dident.main(argv, device="cpu")
    prof = tmp_path / "prof"
    traced = main_3dident.main(argv + ["--profile-dir", str(prof)], device="cpu")
    assert traced["losses"] == plain["losses"]
    assert traced["mcc"] == plain["mcc"] or np.isnan(plain["mcc"])
    paths = glob.glob(str(prof / "*.pt.trace.json"))
    if mode == "test":
        assert paths == []
        return
    (path,) = paths
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::convolution" in names


@pytest.mark.parametrize("mode, name", [("unsupervised", "unsupervised loss"),
                                        ("supervised", "supervised loss")])
def test_nan_weight_raises_at_the_step(mode, name, fixtures, monkeypatch, capsys):
    """An encoder whose weight turns NaN at its first training forward
    (after --mode supervised's evaluation at step 0): under
    CL_ICA_TPU_DEBUG=1 that step raises ValueError naming the JAX driver's
    guard, where its checked step returns; the eager steps read each
    loss."""
    forwards = [0]
    build = main_3dident.build_encoder

    def nan_encoder(*a, **kw):
        model = build(*a, **kw)

        def count(module, inputs):
            if torch.is_grad_enabled():
                forwards[0] += 1
                with torch.no_grad():
                    module.dense.weight.fill_(float("nan"))

        model.register_forward_pre_hook(count)
        return model

    monkeypatch.setattr(main_3dident, "build_encoder", nan_encoder)
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "1")
    with pytest.raises(ValueError, match=f"non-finite values in {name}"):
        main_3dident.main(_argv(fixtures[True], "--mode", mode, "--iterations", "3"),
                          device="cpu")
    assert forwards[0] == 1
