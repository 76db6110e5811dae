"""The training step's layer marks, the host spans and their readings
(utils/profiling.py), and the benchmark's readers of them.

On the CPU: both marked step bodies under ``torch.profiler`` give their
five layers in order; outside the profiler nothing is stamped or kept;
the ring's arithmetic on made-up stamps (its wrap, the gaps between
consecutive steps only, a counter at zero); the host spans; the readers
in portbench/metrics/ on made-up readings and on a program without any;
the readers' entries in BENCHMARK.json against the harness's contract.
The tests marked ``chip`` need the card (a real capture with its stamps);
this file imports nothing of JAX, so that they run there:

    python -m pytest --noconftest tests/test_torch_marks.py -m chip
"""

import json
import math
import re
import statistics

import numpy as np
import pytest
import torch

from cl_ica_tpu_torch.cli import main_3dident, main_mlp
from cl_ica_tpu_torch.data import ThreeDIdentBatchSampler
from cl_ica_tpu_torch.tools import make_synthetic_3dident
from cl_ica_tpu_torch.train import CapturedStep, make_optimizer
from cl_ica_tpu_torch.utils import profiling
from portbench.lib import cell as cells
from portbench.lib import stamps

torch.set_num_threads(1)

MLP_LAYERS = ["sample", "encoder_fwd", "loss", "backward", "optimizer"]
THREEDIDENT_LAYERS = ["data", "backbone_fwd.stem", "backbone_fwd.stage1",
                      "backbone_fwd.stage2", "backbone_fwd.stage3",
                      "backbone_fwd.stage4", "backbone_fwd", "loss", "backward",
                      "optimizer"]


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _mlp_lane(device="cpu", argv=(), seed=0):
    args = main_mlp.parse_args(
        ["--space-type", "box", "--c-p", "1", "--p", "1", "--box-norm", "--n", "4",
         "--batch-size", "32", "--only-unsupervised", "--seed", "0", *argv])
    device = torch.device(device)
    lane = main_mlp.Lane(args, seed, device, main_mlp.build_latent_space(args, device),
                         main_mlp.make_loss(args))
    lane.start_phase(False, 10)
    return lane


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("3dident"))
    make_synthetic_3dident.main(["--output-folder", root, "--n-points", "32",
                                 "--image-size", "32", "--seed", "0"])
    return root


def _threedident_step(root):
    args = main_3dident.parse_args(["--offline-dataset", root, "--mode", "unsupervised",
                                    "--batch-size", "8", "--scan"])
    latent, n_pos, n_ang = main_3dident.setup_latent_space(args)
    sampler = ThreeDIdentBatchSampler(root, latent, 8, main_3dident.latent_dims_to_use(args),
                                      device="cpu")
    model = main_3dident.build_encoder(args, n_pos + n_ang, n_pos,
                                       torch.Generator().manual_seed(0))
    opt, sched = make_optimizer(model.parameters(), args.lr, args.weight_decay)
    loss = main_3dident.build_split_loss(args, n_pos)
    gen = torch.Generator().manual_seed(0)
    return CapturedStep(
        lambda: main_3dident.train_step(model, loss, opt, sched, sampler, gen), [gen], "cpu")


def _steps(kind, root):
    if kind == "mlp":
        lane = _mlp_lane()
        return lambda n: main_mlp.train_steps([lane], n), MLP_LAYERS
    step = _threedident_step(root)
    return lambda n: [step() for _ in range(n)], THREEDIDENT_LAYERS


# ---------------------------------------------------------------------------
# the step bodies, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlp", "3dident"])
def test_step_bodies_under_the_profiler_give_their_layers_in_order(kind, store_root, capsys):
    run, layers = _steps(kind, store_root)
    run(2)
    with torch.profiler.profile() as prof:
        run(4)
    run(1)
    read = profiling.readings()
    assert list(read["layers"]) == layers
    for name in layers:
        assert len(read["layers"][name]) == 4
        assert all(ms >= 0 for ms in read["layers"][name])
    assert len(read["replay_gap_us"]) == 3 and min(read["replay_gap_us"]) >= 0
    assert [e.name for e in prof.events()].count("clica.step") == 4


@pytest.mark.parametrize("kind", ["mlp", "3dident"])
def test_marks_are_off_outside_the_profiler(kind, store_root, monkeypatch, capsys):
    def stamped(self, k):
        raise AssertionError("a mark was stamped outside the profiler")

    monkeypatch.setattr(profiling._Ring, "stamp", stamped)
    run, _ = _steps(kind, store_root)
    run(3)
    assert not any(r.records for r in profiling._rings.values())
    read = profiling.readings()
    assert read["layers"] == {} and read["replay_gap_us"] == []


def test_a_gap_is_read_only_between_steps_stamped_one_after_the_other(capsys):
    lane = _mlp_lane()
    for _ in range(2):
        with torch.profiler.profile():
            main_mlp.train_steps([lane], 3)
        main_mlp.train_steps([lane], 1)  # unstamped: the next step starts anew
    read = profiling.readings()
    assert [len(v) for v in read["layers"].values()] == [6] * 5
    assert len(read["replay_gap_us"]) == 4
    assert [follows for _, _, follows in profiling.ring("cpu").records] == \
        [False, True, True, False, True, True]


def test_a_mark_outside_a_step_does_nothing_and_a_step_holds_seven():
    profiling.mark("stray")
    with torch.profiler.profile():
        profiling.mark("stray")
        with profiling.step("cpu"):
            with profiling.step("cpu"):  # a step inside another is part of it
                profiling.mark("inner")
            for k in range(profiling.RING_SLOTS - 2):
                profiling.mark(f"m{k}")
            with pytest.raises(ValueError,
                               match=f"at most {profiling.RING_SLOTS - 1} marks"):
                profiling.mark("one too many")
    assert list(profiling.readings()["layers"]) == ["inner"] + [
        f"m{k}" for k in range(profiling.RING_SLOTS - 2)]


def test_resnet_parts_are_marked_once_in_training_and_never_in_eval():
    """The stem and stage marks of a training forward, once each whatever
    the backward recomputes (remat's blocks hold no mark); an eval forward
    inside a step marks nothing."""
    from cl_ica_tpu_torch.models import ResNet18

    parts = [n for n in THREEDIDENT_LAYERS if n.startswith("backbone_fwd.")]
    x = torch.randn(2, 3, 32, 32)
    for remat in (False, True):
        profiling.clear()
        model = ResNet18(num_classes=4, norm_kind="minres", remat=remat)
        with torch.profiler.profile():
            with profiling.step("cpu"):
                model(x).sum().backward()
            with profiling.step("cpu"):
                model.eval()
                with torch.no_grad():
                    model(x)
        assert [r[1] for r in profiling.ring("cpu").records] == [parts, []]


def test_the_readings_refuse_a_ring_the_host_did_not_count():
    with torch.profiler.profile():
        with profiling.step("cpu"):
            profiling.mark("a")
    profiling.ring("cpu").counter += 1
    with pytest.raises(RuntimeError, match="stamped 2 steps, the host counted 1"):
        profiling.readings()


# ---------------------------------------------------------------------------
# the ring's arithmetic on made-up stamps
# ---------------------------------------------------------------------------


def _ring(rows, steps):
    """A (rows, 3) ring that stamped steps 1..steps one after the other:
    mark 0 at n·10 µs, a 1 µs later, b 3 µs later; the host's records."""
    table = np.zeros((rows, 3), dtype=np.int64)
    records = []
    for n in range(1, steps + 1):
        t0 = n * 10_000
        table[n % rows] = (t0, t0 + 1000, t0 + 3000)
        records.append((n, ("a", "b"), n > 1))
    return table, steps, records


@pytest.mark.parametrize("rows, steps", [(8, 3), (8, 8), (8, 13), (4, 100)])
def test_read_ring_keeps_the_last_rows_steps(rows, steps):
    table, counter, records = _ring(rows, steps)
    layers, gaps = profiling.read_ring(table, counter, records)
    held = min(rows, steps)
    assert layers == {"a": [1e-3] * held, "b": [2e-3] * held}
    assert gaps == [7.0] * (held - 1)  # 10 µs a step less the 3 µs stamped


def test_read_ring_reads_gaps_between_consecutive_steps_only():
    table, counter, records = _ring(16, 6)
    records[3] = (4, ("a", "b"), False)  # step 4 came after an unstamped one
    layers, gaps = profiling.read_ring(table, counter, records)
    assert len(layers["a"]) == 6 and gaps == [7.0] * 4  # not 3 → 4
    del records[1]  # and step 2 left no record: 1 → 3 is no gap
    layers, gaps = profiling.read_ring(table, counter, records)
    assert len(layers["a"]) == 5 and gaps == [7.0] * 2  # 4 → 5, 5 → 6


def test_read_ring_with_the_counter_at_zero_or_a_row_missing_a_stamp():
    table, _, records = _ring(8, 4)
    assert profiling.read_ring(table, 0, records) == ({}, [])
    table, counter, records = _ring(8, 4)
    table[2 % 8, 2] = 0  # step 2's last mark never ran
    layers, gaps = profiling.read_ring(table, counter, records)
    assert len(layers["a"]) == 3 and gaps == [7.0]  # only 3 → 4


def test_read_ring_reads_a_layer_across_its_parts():
    """A dotted name is a part of the layer whose mark follows: a part reads
    from the mark before it, the layer from the layer's mark before it."""
    # mark 0 at 0, data at 2 µs, stem 3, stage1 7, stage2 8, backbone_fwd
    # 12, loss 13; the next step's mark 0 at 20 µs
    names = ("data", "backbone_fwd.stem", "backbone_fwd.stage1",
             "backbone_fwd.stage2", "backbone_fwd", "loss")
    marks = np.array([0, 2, 3, 7, 8, 12, 13], dtype=np.int64) * 1000
    table = np.zeros((8, len(marks)), dtype=np.int64)
    table[1] = marks + 1000
    table[2] = marks + 21000
    records = [(1, names, False), (2, names, True)]
    layers, gaps = profiling.read_ring(table, 2, records)
    want = {"data": 2e-3, "backbone_fwd.stem": 1e-3, "backbone_fwd.stage1": 4e-3,
            "backbone_fwd.stage2": 1e-3, "backbone_fwd": 10e-3, "loss": 1e-3}
    assert list(layers) == list(names)
    assert layers == {k: [pytest.approx(v)] * 2 for k, v in want.items()}
    assert gaps == [7.0]
    # without its parts the layer reads the same interval
    plain = ("data", "backbone_fwd", "loss")
    flat = np.zeros((8, 4), dtype=np.int64)
    flat[1] = marks[[0, 1, 5, 6]] + 1000
    layers, _ = profiling.read_ring(flat, 1, [(1, plain, False)])
    assert layers == {"data": [pytest.approx(2e-3)], "backbone_fwd": [pytest.approx(10e-3)],
                      "loss": [pytest.approx(1e-3)]}


def test_summary_of_readings():
    read = {"layers": {"a": [float(v) for v in range(1, 101)]},
            "replay_gap_us": [5.0, 7.0], "spans": {"clica.evaluate": []}}
    out = profiling.summary(read)
    assert out["layers_ms"]["a"] == {"median": 50.5, "p95": 95.0, "n": 100}
    assert out["replay_gap_us"] == {"median": 6.0, "p95": 7.0, "n": 2}
    assert out["spans_ms"] == {"clica.evaluate": None}


# ---------------------------------------------------------------------------
# host spans
# ---------------------------------------------------------------------------


def test_spans_are_kept_always_and_are_ranges_under_the_profiler(capsys):
    lane = _mlp_lane()
    main_mlp.train_steps([lane], 2)
    lane.evaluate()
    with torch.profiler.profile() as prof:
        main_mlp.train_steps([lane], 2)
        lane.evaluate()
    spans = profiling.readings()["spans"]
    assert len(spans["clica.readback"]) == 2 and len(spans["clica.evaluate"]) == 2
    assert all(ms >= 0 for ms in spans["clica.evaluate"])
    names = [e.name for e in prof.events()]
    assert names.count("clica.readback") == 1 and names.count("clica.evaluate") == 1


def test_spans_keep_the_last_calls_only():
    for _ in range(profiling.SPAN_KEEP + 5):
        with profiling.span("s"):
            pass
    assert len(profiling.readings()["spans"]["s"]) == profiling.SPAN_KEEP


def test_trace_context_writes_the_layers_beside_the_trace(tmp_path, capsys):
    lane = _mlp_lane()
    with profiling.trace_context(str(tmp_path), device="cpu"):
        main_mlp.train_steps([lane], 3)
    with open(tmp_path / "layers.json") as fh:
        out = json.load(fh)
    assert list(out["layers_ms"]) == MLP_LAYERS
    assert out["layers_ms"]["loss"]["n"] == 3 and out["replay_gap_us"]["n"] == 2
    assert out["spans_ms"]["clica.readback"]["n"] == 1


# ---------------------------------------------------------------------------
# the benchmark's readers and their entries
# ---------------------------------------------------------------------------

NEW_METRICS = {
    "graph_sample_ms.mlp": ("layers", "sample"),
    "graph_encoder_fwd_ms.mlp": ("layers", "encoder_fwd"),
    "graph_data_ms.3dident": ("layers", "data"),
    "graph_backbone_fwd_ms.3dident": ("layers", "backbone_fwd"),
    "graph_loss_ms": ("layers", "loss"),
    "graph_backward_ms": ("layers", "backward"),
    "graph_optimizer_ms": ("layers", "optimizer"),
    "replay_gap_us": ("replay_gap_us", None),
    "evaluate_span_ms": ("spans", "clica.evaluate"),
    **{f"graph_stage{k}_fwd_ms.3dident": ("layers", f"backbone_fwd.stage{k}")
       for k in range(1, 5)},
}


def _made_up(where, name, values):
    read = {"layers": {}, "replay_gap_us": [], "spans": {}}
    if name is None:
        read[where] = values
    else:
        read[where][name] = values
    return read


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_reader_gives_the_median_of_its_readings(metric, monkeypatch):
    where, name = NEW_METRICS[metric]
    monkeypatch.setattr(stamps, "readings", lambda: _made_up(where, name, [3.0, 1.0, 2.5]))
    assert cells.load_module("metrics", metric).read({}) == 2.5


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_reader_gives_none_without_readings(metric, monkeypatch):
    reader = cells.load_module("metrics", metric)
    assert reader.read({}) is None  # the program stamped nothing
    monkeypatch.delattr(profiling, "readings")  # a program older than its stamps
    assert reader.read({}) is None


BENCH = cells.benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}
LAYERS = {m["layer"] for m in BENCH["per_layer"] if m["name"] not in NEW_METRICS} | {"loss"}


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_entry_keeps_the_contract(metric):
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert names.count(metric) == 1
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == metric]
    assert list(m) == ["name", "unit", "better", "source", "layer", "moves", "workloads"]
    assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$", metric)
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert m["unit"] == ("us" if metric == "replay_gap_us" else "ms")
    assert (m["better"], m["source"], m["moves"]) == ("lower", "program_span", "pairs_per_s")
    assert m["layer"] in LAYERS and "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
    suffix = metric.rsplit(".", 1)[1] if "." in metric else None
    family = {"mlp": {"mlp_n10"},
              "3dident": {"resnet18_3dident", "resnet50_3dident"}}.get(suffix)
    if family:
        assert {CELLS[c]["config"] for c in m["workloads"]} == family
    assert callable(cells.load_module("metrics", metric).read)
    # the readers sit together, after every metric the harness read itself
    names = [e["name"] for e in BENCH["per_layer"]]
    block = sorted(names.index(n) for n in NEW_METRICS)
    assert block == list(range(block[0], block[0] + len(NEW_METRICS)))
    assert all(e["source"] != "program_span" for e in BENCH["per_layer"][:block[0]])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda")


def _box_lane(card):
    # the box cell's lane (portbench/workloads/mlp-box-p1-b6144.json); the
    # mixing's condition search is short from seed 1
    torch.backends.cuda.matmul.allow_tf32 = False
    return _mlp_lane(card, ["--n", "10", "--batch-size", "6144"], seed=1)


@pytest.mark.chip
def test_a_capture_holds_its_stamps_and_they_run_only_under_the_profiler(card, capsys):
    lane = _box_lane(card)
    main_mlp.train_steps([lane], 5)  # two warm-up steps, the capture, replays
    ring = profiling.ring(card)
    assert lane.step.captured and lane.step.marks.names == tuple(MLP_LAYERS)
    assert lane.step.marked is not None
    before = ring.table.clone(), int(ring.counter.item())
    main_mlp.train_steps([lane], 20)
    torch.cuda.synchronize()
    assert torch.equal(ring.table, before[0]) and int(ring.counter.item()) == before[1] == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        main_mlp.train_steps([lane], 10)
    after = ring.table.clone()
    main_mlp.train_steps([lane], 20)
    torch.cuda.synchronize()
    assert int(ring.counter.item()) == 10
    assert torch.equal(ring.table, after)
    read = profiling.readings()
    assert list(read["layers"]) == MLP_LAYERS
    assert all(len(v) == 10 and min(v) > 0 for v in read["layers"].values())
    assert len(read["replay_gap_us"]) == 9 and min(read["replay_gap_us"]) > 0
    kernels = {e.name for e in prof.events() if "clica_mark" in e.name}
    assert {f"clica_mark<{k}>" for k in range(6)} <= {
        re.search(r"clica_mark<\d>", k).group(0) for k in kernels}


@pytest.mark.chip
def test_the_layers_add_up_to_the_replay_between_events(card, capsys):
    lane = _box_lane(card)
    main_mlp.train_steps([lane], 5)
    events = []
    # marks on, and no device tracing to slow the host below the card; three
    # replays first fill the queue, so that no event waits on the host
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            lane.step()
        for _ in range(20):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            lane.step()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
    replay_ms = [a.elapsed_time(b) for a, b in events]
    read = profiling.readings()
    steps = [sum(ms) for ms in zip(*read["layers"].values())][3:]
    assert len(steps) == 20
    for inside, whole in zip(steps, replay_ms):
        # the marks cover the step's body; the graph's last nodes (the
        # outputs' stack) and the events' own edges lie outside them
        assert 0.9 * whole <= inside <= whole + 0.002, (inside, whole)
    assert math.isclose(statistics.median(steps), statistics.median(replay_ms), rel_tol=0.1)
