"""The captured training step (train/capture.py) and what makes a step
body capturable, on the CPU.

A CUDA graph can only be captured on the card; here ``CapturedStep``'s
bookkeeping runs against a stand-in graph (warm-up, one capture, replays,
the launch counters scaled by replays, the generators registered, reset),
the device-resident cosine schedule is held to the closed form, and every
step body the drivers capture runs once with the host reads that would
wait for the device made to raise.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from cl_ica_tpu_torch.cli import kitti_solver, main_3dident, main_kitti, main_mlp
from cl_ica_tpu_torch.data import ThreeDIdentBatchSampler, kitti
from cl_ica_tpu_torch.ops import add_launch_counts, launch_counts, reset_launch_counts
from cl_ica_tpu_torch.tools import make_synthetic_3dident, make_synthetic_kitti
from cl_ica_tpu_torch.train import CapturedStep, CosineLR, capture, make_optimizer
from cl_ica_tpu_torch.utils import profiling

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# CapturedStep against a stand-in graph
# ---------------------------------------------------------------------------


class _Graph:
    """Records what a torch.cuda.CUDAGraph is asked to do."""

    made = []
    capturing = False

    def __init__(self):
        self.generators, self.replays, self.captures = [], 0, 0
        self.marks, self.pool_of = None, None
        _Graph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def pool(self):
        return id(self)

    def replay(self):
        self.replays += 1


class _Stream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _capturing(graph, pool=None):
    graph.captures += 1
    graph.pool_of = pool
    _Graph.capturing = True
    try:
        yield
    finally:
        _Graph.capturing = False
        graph.marks = profiling._capture


class _HostRing(profiling._Ring):
    """The stamps' ring of the stand-in card, kept on the host."""

    def __init__(self, device):
        super().__init__(torch.device("cpu"))


@pytest.fixture
def fake_cuda(monkeypatch):
    _Graph.made = []
    profiling.clear()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: _Graph.capturing)
    monkeypatch.setattr(profiling, "_Ring", _HostRing)
    monkeypatch.setattr(torch.cuda, "graph", _capturing)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    yield _Graph.made
    profiling.clear()


def test_warm_up_then_one_capture_then_replays_counted_per_launch(fake_cuda):
    """Two eager warm-up steps (their launches are real), one capture (its
    recorded launches are taken back), then every call one replay that adds
    one step's launches; each call returns a tensor of its own."""
    runs = []

    def body():
        runs.append(1)
        add_launch_counts({"fwd": 1, "dz1": 1, "dz3": 1})
        return torch.tensor(1.5), torch.tensor(2.5)

    gen = torch.Generator()
    reset_launch_counts()
    step = CapturedStep(body, [gen], "cuda")
    outs = [step() for _ in range(2 + 5)]
    assert len(runs) == capture.WARMUP_STEPS + 1  # the replays run no Python
    (graph,) = fake_cuda
    assert graph.captures == 1 and graph.replays == 5 and graph.generators == [gen]
    assert step.per_replay == {**{k: 0 for k in launch_counts()},
                               "fwd": 1, "dz1": 1, "dz3": 1}
    counts = launch_counts()
    assert counts["fwd"] == counts["dz1"] == counts["dz3"] == 2 + 5
    assert sum(counts.values()) == 3 * 7
    assert all(torch.equal(o, torch.tensor([1.5, 2.5])) for o in outs)
    assert all(o is not step.out for o in outs[2:])
    step.reset()  # e.g. after a restore that replaced the optimizer's state
    step()
    assert len(runs) == capture.WARMUP_STEPS + 2 and not step.captured
    reset_launch_counts()


def test_a_failed_capture_raises_and_nothing_runs_eagerly(fake_cuda, monkeypatch):
    def broken(graph, pool=None):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "graph", broken)
    step = CapturedStep(lambda: (torch.tensor(0.0),), [], "cuda")
    step(), step()
    with pytest.raises(RuntimeError, match="capturing"):
        step()
    with pytest.raises(RuntimeError, match="capturing"):
        step()  # and again: no eager step in its place


def test_on_the_cpu_every_call_runs_the_body(fake_cuda):
    runs = []
    step = CapturedStep(lambda: runs.append(1) or (torch.tensor(3.0),), [], "cpu")
    assert [float(step()[0]) for _ in range(4)] == [3.0] * 4
    assert len(runs) == 4 and not fake_cuda


def test_a_marked_body_is_captured_with_and_without_its_marks(fake_cuda):
    """A body with layer marks is captured twice, into the first graph's
    memory pool: once without its marks (named only), once with them as
    graph nodes. Replays outside the
    profiler run the graph without them; replays while it records, the
    graph with them, and only those are stamped steps in the host's count.
    The launches of one capture are one replay's."""

    def body():
        with profiling.step("cuda"):
            add_launch_counts({"fwd": 1})
            profiling.mark("a")
            profiling.mark("b")
        return (torch.tensor(1.0),)

    reset_launch_counts()
    step = CapturedStep(body, [], "cuda")
    step(), step()  # the warm-up: eager, no profiler, no stamps
    assert not any(r.records for r in profiling._rings.values())
    step()  # two captures, one replay
    plain, marked = fake_cuda
    assert plain.marks == (["a", "b"], False) and marked.marks == (["a", "b"], True)
    assert marked.pool_of == plain.pool() and plain.pool_of is None
    assert (step.graph, step.marked) == (plain, marked) and step.marks.names == ("a", "b")
    step()
    with torch.profiler.profile() as prof:
        step(), step()
    step(), step()
    assert (plain.replays, marked.replays) == (4, 2)
    assert [e.name for e in prof.events()].count("clica.step") == 2
    assert launch_counts()["fwd"] == 2 + 6  # warm-up steps, then one a replay
    ring = profiling.ring("cuda")
    assert ring.count == 2 and list(ring.records) == [(1, ("a", "b"), False),
                                                      (2, ("a", "b"), True)]
    reset_launch_counts()


def test_a_body_without_marks_is_captured_once(fake_cuda):
    step = CapturedStep(lambda: (torch.tensor(1.0),), [], "cuda")
    for _ in range(3):
        step()
    with torch.profiler.profile() as prof:
        step()
    (graph,) = fake_cuda
    assert graph.replays == 2 and step.marked is None and step.marks.names == ()
    assert [e.name for e in prof.events()].count("clica.step") == 1


# ---------------------------------------------------------------------------
# the cosine schedule on the device
# ---------------------------------------------------------------------------


def test_cosine_schedule_is_lambdalr_on_a_device_tensor():
    """The lr after t updates is base·0.5·(1 + cos(π·min(t, T)/T)), as
    the LambdaLR it replaced, held in one float32 tensor the optimizer
    reads; the state round-trips through the optimizer's own restore."""
    w = torch.nn.Parameter(torch.ones(3))
    opt, sched = make_optimizer([w], 1e-3, cosine_steps=5)
    assert isinstance(sched, CosineLR) and not opt.param_groups[0]["capturable"]
    lr = opt.param_groups[0]["lr"]
    seen = []
    for _ in range(8):
        seen.append(float(lr))
        w.grad = torch.ones(3)
        opt.step()
        sched.step()
        assert opt.param_groups[0]["lr"] is lr
    want = [1e-3 * 0.5 * (1 + math.cos(math.pi * min(t, 5) / 5)) for t in range(8)]
    np.testing.assert_allclose(seen, np.float32(want), rtol=0, atol=0)
    state = (opt.state_dict(), sched.state_dict())
    assert state[1] == {"last_epoch": 8}
    w2 = torch.nn.Parameter(torch.ones(3))
    opt2, sched2 = make_optimizer([w2], 1e-3, cosine_steps=5)
    lr2, t2 = opt2.param_groups[0]["lr"], sched2.t
    opt2.load_state_dict(state[0])
    sched2.load_state_dict(state[1])
    assert opt2.param_groups[0]["lr"] is lr2 and sched2.t is t2
    assert float(lr2) == float(lr) and float(t2) == 8


# ---------------------------------------------------------------------------
# no host wait inside a step body
# ---------------------------------------------------------------------------

# Tensor methods that bring a device value to the host (and wait for it)
_HOST_READS = ("__bool__", "__float__", "__int__", "__index__", "item", "tolist",
               "cpu", "numpy")


@contextlib.contextmanager
def _no_host_reads(allowed=()):
    """Make every host read of a tensor raise, except of ``allowed``: on
    the CPU, Adam and SGD without ``capturable`` read their step count
    and a tensor lr with .item(), which on CUDA (capturable) they do on
    the device instead."""
    keep = {id(t) for t in allowed}
    with pytest.MonkeyPatch.context() as mp:
        for name in _HOST_READS:
            orig = getattr(torch.Tensor, name)

            def guard(self, *args, _orig=orig, _name=name, **kw):
                if id(self) in keep:
                    return _orig(self, *args, **kw)
                raise AssertionError(f"a step body read a tensor on the host: {_name}")

            mp.setattr(torch.Tensor, name, guard)
        yield


def _optimizer_scalars(opt):
    out = [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]
    return out + [s["step"] for s in opt.state.values() if "step" in s]


def _one_guarded_step(step, opt):
    """One step outside the guard (the optimizer makes its state), then
    one inside it."""
    first = step()
    with _no_host_reads(_optimizer_scalars(opt)):
        second = step()
    assert torch.isfinite(first).all() and torch.isfinite(second).all()


_MLP = "--n 4 --batch-size 64 --only-unsupervised --seed 0".split()
MLP_CONFIGS = {
    "sphere vmf p=2": "--space-type sphere --c-p 0 --c-param 20 --p 2",
    "box laplace p=1": "--space-type box --c-p 1 --p 1 --box-norm",
    "sphere vmf p=0": "--space-type sphere --c-p 0 --c-param 20 --p 0",
    "unbounded normal/laplace": "--space-type unbounded --m-p 2 --c-p 1 --p 1",
    "box gennormal rej-mult cosine adamw": (
        "--space-type box --m-p 3 --c-p 3 --rej-mult 2 --lr-cosine "
        "--weight-decay 0.01 --p 2"),
    "sphere normal, laplace marginal": "--space-type sphere --m-p 1 --c-p 2 --p 1",
    "box normal rej-mult 3": "--space-type box --c-p 2 --rej-mult 3 --p 2",
}


@pytest.mark.parametrize("supervised", [False, True], ids=["unsup", "sup"])
@pytest.mark.parametrize("config", sorted(MLP_CONFIGS))
def test_main_mlp_step_body_reads_nothing_on_the_host(config, supervised, capsys):
    args = main_mlp.parse_args(MLP_CONFIGS[config].split() + _MLP)
    lane = main_mlp.Lane(args, 0, torch.device("cpu"),
                         main_mlp.build_latent_space(args, torch.device("cpu")),
                         main_mlp.make_loss(args))
    lane.start_phase(supervised, 10)
    _one_guarded_step(lane.step, lane.optimizer)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kitti"))
    make_synthetic_kitti.main(["--output-dir", path, "--n-sequences", "4",
                               "--frames", "10", "--seed", "0"])
    return path


@pytest.mark.parametrize("extra", [(), ("--augment",), ("--augment", "--lr-cosine")])
def test_kitti_step_body_reads_nothing_on_the_host(extra, kitti_root, tmp_path):
    args = main_kitti.build_parser().parse_args(
        ["--dset-dir", kitti_root, "--batch-size", "8", "--seed", "0",
         "--output-dir", str(tmp_path), "--ckpt-dir", str(tmp_path), *extra])
    args.num_channel = 1
    solver = kitti_solver.Solver(args, kitti.return_data(args)[0], "cpu")
    _one_guarded_step(solver.steps[0], solver.lanes[0].optimizer)


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("3dident"))
    make_synthetic_3dident.main(["--output-folder", root, "--n-points", "48",
                                 "--image-size", "32", "--seed", "0"])
    return root


@pytest.mark.parametrize("flags", [
    ["--fused-stem"], [], ["--dummy-mixing", "--lr-cosine"],
    ["--non-periodic-rotation-and-color", "--non-periodical-conditional", "l3"],
    ["--optimizer", "sgd", "--lr-cosine", "--weight-decay", "0.01"],
], ids=lambda f: " ".join(f) or "default")
def test_3dident_step_body_reads_nothing_on_the_host(flags, store_root, capsys):
    """main_3dident's unsupervised step on the device-store fixture:
    latent sampling, the k-NN match, the store gather, the encoder, the
    split loss and the update."""
    args = main_3dident.parse_args(
        ["--offline-dataset", store_root, "--mode", "unsupervised", "--batch-size",
         "8", "--scan", *flags])
    latent_space, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    sampler = ThreeDIdentBatchSampler(
        store_root, latent_space, 8, main_3dident.latent_dims_to_use(args),
        load_images=not args.dummy_mixing, device="cpu")
    model = main_3dident.build_encoder(args, n_non_ang + n_ang, n_non_ang,
                                       torch.Generator().manual_seed(0))
    opt, sched = make_optimizer(model.parameters(), args.lr, args.weight_decay,
                                cosine_steps=10 if args.lr_cosine else None,
                                kind=args.optimizer)
    mixing = None
    if args.dummy_mixing:
        mixing = main_mlp.construct_invertible_mlp(
            n_non_ang + n_ang, n_layers=3, act_fct="leaky_relu", cond_thresh_ratio=0.0,
            n_iter_cond_thresh=25000, rng=np.random.default_rng(0))
    loss = main_3dident.build_split_loss(args, n_non_ang)
    gen = torch.Generator().manual_seed(0)
    step = CapturedStep(
        lambda: main_3dident.train_step(model, loss, opt, sched, sampler, gen, mixing),
        [gen], "cpu")
    _one_guarded_step(step, opt)


def test_a_restore_keeps_what_a_graph_reads_in_place(capsys):
    """A mid-phase restore copies the encoder into its own parameters and
    the schedule into its own tensors (a captured graph reads them by
    address), and drops the graph: the optimizer's state tensors are new."""
    args = main_mlp.parse_args(
        MLP_CONFIGS["box gennormal rej-mult cosine adamw"].split() + _MLP)
    lane = main_mlp.Lane(args, 0, torch.device("cpu"),
                         main_mlp.build_latent_space(args, torch.device("cpu")),
                         main_mlp.make_loss(args))
    lane.start_phase(False, 10)
    for _ in range(3):
        lane.step()
    state = lane.state_dict()
    lane.step()
    ptrs = [p.data_ptr() for p in lane.f.parameters()]
    t, lr = lane.scheduler.t, lane.optimizer.param_groups[0]["lr"]
    lane.step.warm = capture.WARMUP_STEPS
    lane.load_state_dict(state, mid_phase=True)
    assert [p.data_ptr() for p in lane.f.parameters()] == ptrs
    assert lane.scheduler.t is t and lane.optimizer.param_groups[0]["lr"] is lr
    assert float(t) == 3 and lane.step.warm == 0 and not lane.step.captured
