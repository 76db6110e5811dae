"""cl_ica_tpu_torch's KITTI Masks slice against the JAX package: the conv
encoder (values, gradients, converter, initialisation), the solver's step
from the same parameters on the same batch, the evaluation's MCC from the
same weights, the driver's flags, files and exits, and the exact resume
and lane-equals-serial of the port's own solvers on the CPU."""

import functools
import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.cli import kitti_evaluate as jax_evaluate
from cl_ica_tpu.cli import kitti_solver as jax_solver
from cl_ica_tpu.cli import main_kitti as jax_main
from cl_ica_tpu.data import kitti as jax_kitti
from cl_ica_tpu.models import conv as jax_conv
from cl_ica_tpu.ops import infonce_pallas
from cl_ica_tpu_torch.cli import kitti_evaluate, kitti_solver, main_kitti
from cl_ica_tpu_torch.data import kitti
from cl_ica_tpu_torch.models import (
    ConvDecoder64,
    ConvEncoder64,
    conv_encoder_params_from_flax,
    conv_encoder_params_to_flax,
)
from cl_ica_tpu_torch.tools import make_synthetic_kitti as tool

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The synthetic corpus at 4 sequences of 10 frames (36 pairs)."""
    path = str(tmp_path_factory.mktemp("kitti"))
    tool.main(["--output-dir", path, "--n-sequences", "4", "--frames", "10",
               "--seed", "0"])
    return path


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


_JITTED = {}


def _flax(z_dim, box_norm):
    return jax_conv.ConvEncoder64(z_dim=z_dim, nc=1, box_norm=box_norm)


def _jitted(net, what):
    """net.apply, or the gradient of sum(apply * ct), under jit: one XLA
    program a model instead of one per primitive."""
    key = (repr(net), what)
    if key not in _JITTED:
        if what == "apply":
            _JITTED[key] = jax.jit(net.apply)
        else:
            _JITTED[key] = jax.jit(jax.grad(
                lambda v, x, ct: jnp.sum(net.apply(v, x) * ct)))
    return _JITTED[key]


def _variables(net, seed):
    """Flax variables as numpy without Flax's initialisers: the tree and
    shapes of ``net.init`` (``jax.eval_shape``), He-normal kernels, biases
    and Softclip bounds moved off their initial values."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return (std * rng.normal(size=leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (1.0 + 0.3 * rng.uniform(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(variables, z_dim, box_norm):
    model = ConvEncoder64(z_dim=z_dim, nc=1, box_norm=box_norm)
    model.load_state_dict(conv_encoder_params_from_flax(variables))
    return model


def _images(seed, n=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (n, 64, 64, 1)) * (rng.uniform(size=(n, 1, 1, 1))
                                                 + 0.2)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_dim", [3, 10])
@pytest.mark.parametrize("box_norm", [False, True])
def test_encoder_values_and_gradients_match_flax(z_dim, box_norm):
    net = _flax(z_dim, box_norm)
    variables = _variables(net, seed=z_dim + 10 * box_norm)
    x = _images(z_dim)
    ct = np.random.default_rng(1).uniform(0.5, 1.5, (len(x), z_dim)).astype(np.float32)
    want = np.asarray(_jitted(net, "apply")(variables, jnp.asarray(x)))
    want_grads = _jitted(net, "grad")(variables, jnp.asarray(x), jnp.asarray(ct))

    model = _port(variables, z_dim, box_norm)
    got = model(_nchw(x))
    assert got.shape == (len(x), z_dim)
    assert rel_err(got.detach(), want) <= 1e-5
    (got * torch.from_numpy(ct)).sum().backward()
    got_grads = conv_encoder_params_to_flax(
        {k: p.grad for k, p in model.named_parameters()})
    flat_want = jax.tree_util.tree_leaves_with_path(want_grads["params"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_grads["params"]))
    assert len(flat_want) == len(flat_got) == 12 + box_norm
    for path, w in flat_want:
        assert rel_err(flat_got[path], w) <= 1e-4, jax.tree_util.keystr(path)


@pytest.mark.parametrize("box_norm", [False, True])
def test_converter_round_trip_is_exact(box_norm):
    variables = _variables(_flax(10, box_norm), seed=3)
    back = conv_encoder_params_to_flax(_port(variables, 10, box_norm).state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    for path, value in flat.items():
        assert flat_back[path].dtype == np.float32
        np.testing.assert_array_equal(flat_back[path], value)
    with pytest.raises(KeyError):
        conv_encoder_params_from_flax({"params": {"Conv_0": {"scale": 0}}})
    with pytest.raises(KeyError):
        conv_encoder_params_to_flax({"convs.0.scale": torch.zeros(1)})


def test_initialisation_is_the_truncated_he_normal_of_flax():
    """Flax's kaiming_normal: a normal truncated at ±2 standard deviations,
    rescaled to std sqrt(2 / fan_in); zero biases, unit Softclip bounds.
    Each layer's std over four seeds lies within 5% of it."""
    models = [ConvEncoder64(z_dim=10, nc=1, box_norm=True,
                            generator=torch.Generator().manual_seed(s)) for s in range(4)]
    again = ConvEncoder64(z_dim=10, nc=1, box_norm=True,
                          generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(models[0].parameters(),
                                                 again.parameters()))
    for i, layer in enumerate([*models[0].convs, models[0].fc]):
        fan_in = layer.weight[0].numel()
        std = np.sqrt(2.0 / fan_in)
        weights = torch.cat([[*m.convs, m.fc][i].weight.flatten() for m in models])
        assert abs(float(weights.std()) / std - 1.0) < 0.05, i
        assert float(weights.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert float(layer.bias.abs().max()) == 0.0
    assert torch.equal(models[0].head.max_abs_bound, torch.ones(10))
    with pytest.raises(ValueError, match="64"):
        models[0](torch.zeros(1, 1, 80, 80))


def test_the_jax_decoder_gives_34_by_34_c7():
    """ROADMAP C7: the JAX package's ConvDecoder64 claims 64×64×nc but
    returns (B, 34, 34, nc): Flax's ConvTranspose with padding ((1, 1),
    (1, 1)) gives 2·in − 2 a stride-2 layer, not torch's 2·in. The port
    follows it (C7 followed): its decoder returns (B, nc, 34, 34)
    (tests/test_torch_slowvae.py holds the values)."""
    dec = jax_conv.ConvDecoder64(z_dim=10, nc=1)
    z = jnp.zeros((2, 10))
    out = jax.eval_shape(lambda: dec.apply(dec.init(jax.random.PRNGKey(0), z), z))
    assert out.shape == (2, 34, 34, 1)
    assert ConvDecoder64(z_dim=10, nc=1)(torch.zeros(2, 10)).shape == (2, 1, 34, 34)


# ---------------------------------------------------------------------------
# one solver step, and three, from the same parameters on the same batches
# ---------------------------------------------------------------------------


def _args(parse, root, *extra):
    # the driver's default lr, 1e-4: Adam moves a parameter by
    # lr·g/(|g| + 1e-8), so where |g| is near 1e-8 the gradients' rounding
    # (1e-6 of the largest) reaches the parameter scaled by lr
    args = parse(["--dset-dir", root, "--batch-size", "8", "--z-dim", "10",
                  "--max-iter", "3", "--fused-loss", *extra])
    args.num_channel = 1
    return args


@pytest.mark.parametrize("extra, steps", [
    ((), 1), (("--box-norm", "1"), 1), (("--box-norm", "1", "--lr-cosine"), 3),
    (("--box-norm", "1", "--weight-decay", "0.1"), 3)])
def test_solver_steps_match_jax(root, tmp_path, monkeypatch, extra, steps):
    # the JAX loss takes its Pallas kernel in interpret mode, as the JAX
    # package's tests run it on a CPU: both packages then take sgn(0) = 0
    # at the exact zeros the rolled negatives put in every row (ROADMAP C1)
    monkeypatch.setattr(infonce_pallas, "fused_neg_lse", functools.partial(
        infonce_pallas.fused_neg_lse, block=8, interpret=True))
    jargs = _args(jax_main.build_parser().parse_args, root, *extra)
    jargs.output_dir = jargs.ckpt_dir = str(tmp_path)
    jds = jax_kitti.KittiMasks(path=root, max_delta_t=1, download=False)
    theirs = jax_solver.Solver(jargs, jds, device_sampling=False)
    box_norm = jargs.box_norm == 1
    variables = _variables(theirs.net, seed=7)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    opt_state = theirs.optim.init(params)

    args = _args(main_kitti.build_parser().parse_args, root, "--no-fused-loss", *extra)
    lane = kitti_solver.KittiLane(args, 0, "cpu", int(args.max_iter))
    lane.net.load_state_dict(conv_encoder_params_from_flax(variables))
    ds = kitti.KittiMasks(path=root, max_delta_t=1)
    rng = np.random.default_rng(5)
    held = {}
    for step in range(steps):
        x1, x2, _, _ = ds.sample_pair_batch(4, rng)
        params, opt_state, _, total, znorm = theirs._step(
            params, opt_state, theirs.key, jnp.asarray(x1), jnp.asarray(x2))
        got_total, got_znorm = kitti_solver.train_step(
            lane.net, lane.loss, lane.optimizer, lane.scheduler,
            torch.from_numpy(x1).float() / 255.0, torch.from_numpy(x2).float() / 255.0)
        assert rel_err(got_total, total) <= 1e-5, step
        assert rel_err(got_znorm, znorm) <= 1e-5, step
        got = dict(jax.tree_util.tree_leaves_with_path(
            conv_encoder_params_to_flax(lane.net.state_dict())))
        for path, mask in _small_gradients(lane, box_norm).items():
            held[path] = held.get(path, False) | mask
        for path, want in jax.tree_util.tree_leaves_with_path(params):
            name = jax.tree_util.keystr(path)
            want, keep = np.asarray(want), ~held[path]
            if keep.any():
                assert rel_err(got[path][keep], want[keep]) <= 1e-5, (step, name)
            # each package moves a held parameter by about lr a step at most
            apart = np.abs(got[path] - want)[held[path]]
            assert (apart <= 2.2 * jargs.lr * (step + 1)).all(), (step, name)


def _small_gradients(lane, box_norm):
    """{Flax path: mask} of the parameters whose gradient is at most 1e-6
    of the largest. Adam moves a parameter by lr·m̂/(√v̂ + 1e-8),
    lr·g/(|g| + 1e-8) on its first step, so where |g| is near 1e-8 the
    gradients' rounding (of order 1e-7 of the largest, in either package)
    can move it by up to lr, and the difference stays in later steps: such
    a parameter is held to Adam's step size instead of to the other
    package. Without a head the Lp loss is invariant to translating z, so
    the last bias's gradient is 0 in exact arithmetic, rounding noise in
    both packages, and always among them. They are a small share of the
    parameters; all others are held to 1e-5."""
    grads = {k: p.grad.abs() for k, p in lane.net.named_parameters()}
    largest = max(float(g.max()) for g in grads.values())
    masks = {k: g <= 1e-6 * largest for k, g in grads.items()}
    if not box_norm:
        assert bool(masks["fc.bias"].all())
    tiny = sum(int((m & (grads[k] > 0)).sum()) for k, m in masks.items())
    assert tiny <= 1e-3 * sum(g.numel() for g in grads.values())
    flat = conv_encoder_params_to_flax({k: m.float() for k, m in masks.items()})
    return {path: np.asarray(m) > 0
            for path, m in jax.tree_util.tree_leaves_with_path(flat)}


# ---------------------------------------------------------------------------
# the evaluation from the same weights
# ---------------------------------------------------------------------------


def test_evaluation_mcc_matches_jax(root):
    net = _flax(10, False)
    variables = _variables(net, seed=11)
    model = _port(variables, 10, False)
    args = types.SimpleNamespace(dataset="kittimasks", specify="", verbose=False,
                                 output_dir=None, ckpt_name="last")
    results = {}
    for name, module, ds, rep in (
            ("jax", jax_evaluate,
             jax_kitti.KittiMasks(path=root, max_delta_t=1, download=False),
             lambda x: np.asarray(_jitted(net, "apply")(
                 variables, jnp.asarray(x.transpose(0, 2, 3, 1))))),
            ("torch", kitti_evaluate, kitti.KittiMasks(path=root, max_delta_t=1),
             lambda x: model(torch.from_numpy(x)).detach().numpy())):
        args.output_dir = os.path.join(root, name)
        results[name] = module.evaluate_disentanglement(args, ds, rep, num_train=64)
    got, want = results["torch"][("mean", "mcc")], results["jax"][("mean", "mcc")]
    assert abs(got["meanabscorr"] - want["meanabscorr"]) <= 1e-6
    assert 0.0 < got["meanabscorr"] < 1.0
    with open(os.path.join(root, "torch", "evaluation", "last", "mean", "mcc",
                           "evaluation_results.json")) as fh:
        assert json.load(fh)["meanabscorr"] == pytest.approx(got["meanabscorr"])


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _spec(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.type, type(a).__name__)
            for a in parser._actions}


def test_parser_has_the_same_flags():
    assert _spec(main_kitti.build_parser()) == _spec(jax_main.build_parser())


@pytest.fixture
def quick_eval(monkeypatch):
    """The automatic evaluation at 64 points instead of 10000."""
    monkeypatch.setattr(kitti_evaluate, "evaluate_disentanglement", functools.partial(
        kitti_evaluate.evaluate_disentanglement, num_train=64))


def _run(root, out, *extra, device="cpu"):
    main_kitti.main(["--dset-dir", root, "--batch-size", "8", "--max-iter", "4",
                     "--log-step", "2", "--save-step", "3", "--seed", "0",
                     "--output-dir", os.path.join(out, "out"),
                     "--ckpt-dir", os.path.join(out, "ck"), *extra], device=device)


def test_driver_writes_the_jax_layout(root, tmp_path, quick_eval):
    _run(root, str(tmp_path), "--use-writer", "--log-dir", str(tmp_path / "logs"))
    run = tmp_path / "out" / "kittimasks_1" / "1_0" / "0"
    with open(run / "args") as fh:
        saved = json.load(fh)
    dests = {a.dest for a in jax_main.build_parser()._actions} - {"help"}
    assert set(saved) == dests | {"num_channel"} and saved["num_channel"] == 1
    log = (run / "log.csv").read_text().splitlines()
    norms = (run / "norms.csv").read_text().splitlines()
    assert log[0] == "Total Loss" and norms[0] == "Mean zNorm"
    assert len(log) == len(norms) == 3  # steps 2 and 4
    assert all(np.isfinite(float(v)) for v in log[1:] + norms[1:])
    ckpt = kitti_solver.load_checkpoint_file(
        str(tmp_path / "ck" / "kittimasks_1" / "1_0" / "0" / "last"))
    assert ckpt["iter"] == 4 and set(ckpt) == {"iter", "model_states", "optim_states",
                                               "rng"}
    results = run / "evaluation" / "last" / "mean" / "mcc" / "evaluation_results.json"
    with open(results) as fh:
        mcc = json.load(fh)["meanabscorr"]
    assert 0.0 < mcc <= 1.0
    assert (tmp_path / "logs" / "kittimasks_1" / "1_0" / "0" / "args.json").exists()
    # --evaluate: the same checkpoint evaluated again, nothing trained
    results.unlink()
    _run(root, str(tmp_path), "--evaluate")
    with open(results) as fh:
        assert json.load(fh)["meanabscorr"] == mcc
    assert len((run / "log.csv").read_text().splitlines()) == 3


def test_driver_runs_on_cuda_unless_told_otherwise(root, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_kitti.main(["--dset-dir", root], device=None)
    # --mesh is ported (A13); CUDA ranks need a GPU each, and none falls
    # back to the CPU
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(SystemExit, match=f"--mesh 2 needs 2 GPUs, one a rank; "
                                         f"{visible} visible"):
        main_kitti.main(["--dset-dir", root, "--mesh", "2"])
    with pytest.raises(FileNotFoundError, match="make_synthetic_kitti"):
        main_kitti.main(["--dset-dir", str(tmp_path / "none")], device="cpu")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main_kitti.main(["--dset-dir", root, "--seeds", "2", "--random-seeds"],
                        device="cpu")


def _solver_args(root, out, seed, *extra):
    args = main_kitti.build_parser().parse_args(
        ["--dset-dir", root, "--batch-size", "8", "--log-step", "2", "--save-step", "3",
         "--seed", str(seed), *extra])
    args.num_channel = 1
    args.output_dir = os.path.join(out, "out", str(seed))
    args.ckpt_dir = os.path.join(out, "ck", str(seed))
    for d in (args.output_dir, args.ckpt_dir):
        os.makedirs(d, exist_ok=True)
    return args


def _outcome(args, net):
    with open(os.path.join(args.output_dir, "log.csv")) as fh:
        return fh.read(), [p.detach().clone() for p in net.parameters()]


class _Stopped(Exception):
    pass


@pytest.mark.parametrize("extra", [(), ("--augment", "--lr-cosine")])
def test_resume_repeats_the_uninterrupted_run(root, tmp_path, monkeypatch, extra):
    extra = ("--max-iter", "6", "--save-step", "4", *extra)
    ds = kitti.return_data(_solver_args(root, str(tmp_path), 0, *extra))[0]
    whole = _solver_args(root, str(tmp_path / "whole"), 0, *extra)
    solver = kitti_solver.Solver(whole, ds, "cpu")
    solver.train()
    want = _outcome(whole, solver.net)
    # stopped right after its checkpoint at step 4, a log boundary (as in
    # the JAX package, a resumed run starts a fresh running window)
    cut = _solver_args(root, str(tmp_path / "cut"), 0, *extra)
    save = kitti_solver.EnsembleSolver.save_checkpoint

    def save_then_stop(self, filename):
        save(self, filename)
        raise _Stopped

    with monkeypatch.context() as m:
        m.setattr(kitti_solver.EnsembleSolver, "save_checkpoint", save_then_stop)
        with pytest.raises(_Stopped):
            kitti_solver.Solver(cut, ds, "cpu").train()
    cut.resume = True
    resumed = kitti_solver.Solver(cut, ds, "cpu")
    assert resumed.global_iter == 4
    resumed.train()
    got = _outcome(cut, resumed.net)
    assert got[0] == want[0] and len(want[0].splitlines()) == 4
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_lanes_repeat_serial_runs(root, tmp_path):
    extra = ("--max-iter", "4", "--augment")
    ds = kitti.return_data(_solver_args(root, str(tmp_path), 0, *extra))[0]
    lanes = [_solver_args(root, str(tmp_path / "lanes"), s, *extra) for s in (0, 1)]
    ensemble = kitti_solver.EnsembleSolver(
        lanes[0], ds, [0, 1], [a.output_dir for a in lanes],
        [a.ckpt_dir for a in lanes], "cpu")
    ensemble.train()
    for i, seed in enumerate((0, 1)):
        serial_args = _solver_args(root, str(tmp_path / "serial"), seed, *extra)
        serial = kitti_solver.Solver(serial_args, ds, "cpu")
        serial.train()
        got = _outcome(lanes[i], ensemble.lanes[i].net)
        want = _outcome(serial_args, serial.net)
        assert got[0] == want[0]
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    # a resume of lanes whose checkpoints disagree is refused
    torch.save({**kitti_solver.load_checkpoint_file(
        os.path.join(lanes[1].ckpt_dir, "last")), "iter": 3},
        os.path.join(lanes[1].ckpt_dir, "last"))
    lanes[0].resume = True
    with pytest.raises(SystemExit, match="disagree"):
        kitti_solver.EnsembleSolver(lanes[0], ds, [0, 1], [a.output_dir for a in lanes],
                                    [a.ckpt_dir for a in lanes], "cpu")


def test_seeds_run_writes_each_lane_and_evaluates_it(root, tmp_path, quick_eval):
    _run(root, str(tmp_path), "--seeds", "2")
    for seed in (0, 1):
        run = tmp_path / "out" / "kittimasks_1" / "1_0" / str(seed)
        with open(run / "args") as fh:
            assert json.load(fh)["seed"] == seed
        assert len((run / "log.csv").read_text().splitlines()) == 3
        assert (run / "evaluation" / "last" / "mean" / "mcc" /
                "evaluation_results.json").exists()
        assert (tmp_path / "ck" / "kittimasks_1" / "1_0" / str(seed) / "last").exists()


def test_host_fed_steps_and_a_non_finite_loss(root, tmp_path, monkeypatch):
    # every step samples from the corpus on the device (here the CPU's
    # tensors) and augments there; the host only encodes observations
    args = _solver_args(root, str(tmp_path), 0, "--max-iter", "4", "--augment")
    ds = kitti.return_data(args)[0]
    solver = kitti_solver.Solver(args, ds, "cpu")
    assert isinstance(solver.sampler, kitti.KittiDeviceSampler)
    assert solver.sampler.frames.device.type == "cpu"
    solver.train()
    assert len((tmp_path / "out" / "0" / "log.csv").read_text().splitlines()) == 3
    x = ds.sample_observations(4, np.random.RandomState(0))
    np.testing.assert_array_equal(solver.encode(x),
                                  solver.net(torch.from_numpy(x)).detach().numpy())

    step = kitti_solver.train_step

    def poisoned(*a):
        total, znorm = step(*a)
        return total * float("nan"), znorm

    monkeypatch.setattr(kitti_solver, "train_step", poisoned)
    args = _solver_args(root, str(tmp_path / "nan"), 0, "--max-iter", "4")
    with pytest.raises(FloatingPointError, match="step 1 of seed 0"):
        kitti_solver.Solver(args, ds, "cpu").train()


# ---------------------------------------------------------------------------
# --profile-dir and the CL_ICA_TPU_DEBUG=1 guard
# ---------------------------------------------------------------------------


def test_profile_dir_traces_the_training_loop(root, tmp_path, quick_eval):
    """--profile-dir writes one parseable trace of solver.train(), and the
    run's logged losses and norms are the same seed's without it."""
    _run(root, str(tmp_path / "plain"))
    _run(root, str(tmp_path / "traced"), "--profile-dir", str(tmp_path / "prof"))
    run = os.path.join("out", "kittimasks_1", "1_0", "0")
    for name in ("log.csv", "norms.csv"):
        assert ((tmp_path / "traced" / run / name).read_text()
                == (tmp_path / "plain" / run / name).read_text())
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::convolution" in names


@pytest.mark.parametrize("seeds", [(0,), (0, 1)])
def test_nan_weight_raises_at_the_window_boundary(root, tmp_path, monkeypatch, seeds):
    """An encoder with a NaN weight: under CL_ICA_TPU_DEBUG=1 ValueError at
    the first log boundary (step 2 of --log-step 2), where the window's
    losses reach the host and the JAX package's checked chunk returns, with
    nothing logged; without the flag the solver's own FloatingPointError
    there, as before."""
    build = kitti_solver.ConvEncoder64

    def nan_encoder(*a, **kw):
        net = build(*a, **kw)
        with torch.no_grad():
            net.convs[0].weight.fill_(float("nan"))
        return net

    steps = [0]
    step = kitti_solver.train_step

    def counted(*a):
        steps[0] += 1
        return step(*a)

    monkeypatch.setattr(kitti_solver, "ConvEncoder64", nan_encoder)
    monkeypatch.setattr(kitti_solver, "train_step", counted)
    for flag, error, match in (("1", ValueError, "non-finite values in loss"),
                               ("0", FloatingPointError, "step 1 of seed 0")):
        monkeypatch.setenv("CL_ICA_TPU_DEBUG", flag)
        lanes = [_solver_args(root, str(tmp_path / flag), s, "--max-iter", "4")
                 for s in seeds]
        ds = kitti.return_data(lanes[0])[0]
        steps[0] = 0
        with pytest.raises(error, match=match):
            kitti_solver.EnsembleSolver(
                lanes[0], ds, list(seeds), [a.output_dir for a in lanes],
                [a.ckpt_dir for a in lanes], "cpu").train()
        assert steps[0] == 2 * len(seeds)
        for a in lanes:
            with open(os.path.join(a.output_dir, "log.csv")) as fh:
                assert fh.read() == "Total Loss\n"
