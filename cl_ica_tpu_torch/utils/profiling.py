"""Profiler traces, and the training step's layers timed where they run.

Port of cl_ica_tpu/utils/profiling.py. Where the JAX package writes a
jax.profiler trace for TensorBoard, ``trace_context`` records
``torch.profiler`` activity, the host's and on the card the device's
(kernels, copies and CUDA graph replays), and writes one Chrome/Perfetto
trace, ``<host>_<pid>.<ms>.pt.trace.json``, into the directory on exit,
and beside it ``layers.json``: each layer's median and p95 ms, the gap
between replays and the host spans (``readings``). Open the trace in
https://ui.perfetto.dev or chrome://tracing.

Layer marks. A step body runs inside ``step(device)``, which opens the step
with mark 0, and calls ``mark(name)`` at the end of each of its layers
(sample, encoder_fwd, loss, backward, optimizer in
train/trainer.py; data, backbone_fwd, loss, backward, optimizer in
cli/main_3dident.py). A dotted name ``layer.part`` ends a part of the layer
whose own mark follows its parts (models/resnet.py marks
backbone_fwd.stem and backbone_fwd.stage1 to .stage4 inside backbone_fwd):
a part is read from the mark before it, a layer from the layer's mark
before it, across its parts. On the card a mark is the one-thread kernel
``clica_mark<k>`` (ops/csrc/marks.cu), k its index in the step, which
writes the device clock into a ring of RING_ROWS steps × RING_SLOTS
stamps held by this module. ``CapturedStep`` (train/capture.py) captures
a marked body twice, with the marks as graph nodes and without them, and
replays the graph with the marks exactly while the profiler records. Eager
steps on the card launch the marks only while the profiler records; on
the CPU, while it records, the marks take ``time.perf_counter_ns()``. A
mark reads nothing back.

Host spans: ``span(name)`` keeps each call's ms (the last SPAN_KEEP of each
name), always: ``clica.capture`` (a captured step's warm-up and capture),
``clica.readback`` (the window's losses brought to the host) and
``clica.evaluate`` (an evaluation). While the profiler records, they and
``clica.step`` (each replay or marked eager step) are also
``record_function`` ranges, on the trace's clock beside the device's
``clica_mark<k>`` kernels.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch

RING_ROWS = 1024   # steps the ring holds
RING_SLOTS = 16    # marks a step: mark 0 and up to fifteen layers and parts
SPAN_KEEP = 4096   # calls kept of each host span


def _device_events(prof) -> int:
    """Events a finished ``torch.profiler.profile`` recorded on a CUDA
    device (kernels, copies, memsets), counted in its raw results."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str], device=None):
    """Profile the block into a trace under ``log_dir``, and write the
    readings beside it (``layers.json``); nothing when ``log_dir`` is None.
    ``device`` (default: CUDA when there is one) adds the CUDA activity. A
    CUDA trace that holds no device event raises RuntimeError on exit: the
    profiler could not see the card, and a host-only trace would pass for
    a profile of it."""
    if log_dir is None:
        yield
        return
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if device.type == "cuda" and not _device_events(prof):
        raise RuntimeError(
            f"the profiler recorded no CUDA activity on {device} (trace under "
            f"{log_dir}): it cannot see the card, and a host-only trace is no "
            f"profile of it")
    with open(os.path.join(log_dir, "layers.json"), "w") as fh:
        json.dump(summary(readings()), fh, indent=1)


def recording() -> bool:
    """Whether a torch profiler is recording (marks are on exactly then)."""
    return torch._C._autograd._profiler_enabled()


# ---------------------------------------------------------------------------
# the stamps' ring
# ---------------------------------------------------------------------------


class _Ring:
    """One device's stamps: ``table`` (RING_ROWS, RING_SLOTS) int64 and
    the step counter (on the card, device tensors the marks write; on the
    CPU, numpy and an int), and the host's record of the stamped steps:
    (step number, layer names, whether the step before it was stamped)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.table = torch.empty((RING_ROWS, RING_SLOTS), dtype=torch.int64,
                                     device=device)
            self.counter = torch.empty(1, dtype=torch.int64, device=device)
        else:
            self.table = np.empty((RING_ROWS, RING_SLOTS), dtype=np.int64)
        self.reset()

    def reset(self) -> None:
        """Forget every stamp, in place: a captured graph writes these
        tensors by address."""
        if self.cuda:
            self.table.zero_()
            self.counter.zero_()
        else:
            self.table[:] = 0
            self.counter = 0
        self.count = 0      # stamped steps, as the host counts them
        self.last = None    # the number of the step before, if it was stamped
        self.records = collections.deque(maxlen=RING_ROWS)

    def stamp(self, k: int) -> None:
        if self.cuda:
            from ..ops import marks
            marks.stamp(k, self.table, self.counter)
            return
        if k == 0:
            self.counter += 1
            self.table[self.counter % RING_ROWS] = 0
        self.table[self.counter % RING_ROWS, k] = time.perf_counter_ns()

    def stamped(self, names) -> None:
        """The host's record of one stamped step (eager or a replay); an
        eager step's names are filled in as its marks run."""
        self.count += 1
        self.records.append((self.count, names, self.last == self.count - 1))
        self.last = self.count

    def fetch(self):
        """(table, counter) on the host: one synchronisation on the card."""
        if self.cuda:
            return self.table.cpu().numpy(), int(self.counter.item())
        return self.table.copy(), self.counter


_rings = {}       # str(device) -> _Ring
_open = None      # the step being run or captured: _Step
_capture = None   # (names, stamped) of CapturedStep's capture (capturing())
_spans = collections.defaultdict(lambda: collections.deque(maxlen=SPAN_KEEP))


def _key(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def ring(device) -> _Ring:
    """The device's ring, made at its first use. A capture makes it before
    it starts: memory taken inside a capture belongs to the graph."""
    key = _key(device)
    if key not in _rings:
        _rings[key] = _Ring(torch.device(key))
    return _rings[key]


def clear() -> None:
    """Forget every stamp and span."""
    global _open, _capture
    for r in _rings.values():
        r.reset()
    _spans.clear()
    _open = _capture = None


# ---------------------------------------------------------------------------
# marks in a step body
# ---------------------------------------------------------------------------


class _Step:
    __slots__ = ("ring", "names")

    def __init__(self, ring_, names):
        self.ring, self.names = ring_, names


@contextlib.contextmanager
def step(device):
    """One training step on ``device``, its layers marked by ``mark``: in
    ``CapturedStep``'s capture with marks they are recorded as graph
    nodes, in an eager step they are stamped while the profiler records,
    else nothing happens. A step inside another is part of it."""
    global _open
    if _open is not None:
        yield
        return
    key = _key(device)
    capture = key.startswith("cuda") and torch.cuda.is_current_stream_capturing()
    if capture:
        on = _capture is not None  # another capture of the body records none
    else:
        on = recording()
    if not on:
        if key in _rings:
            _rings[key].last = None
        yield
        return
    if capture:
        names, stamped = _capture
        s = _Step(ring(key) if stamped else None, names)
    else:
        s = _Step(ring(key), [])
    ranged = (contextlib.nullcontext() if capture
              else torch.profiler.record_function("clica.step"))
    _open = s
    try:
        with ranged:
            if s.ring is not None:
                s.ring.stamp(0)
            if not capture:
                s.ring.stamped(s.names)
            yield
    finally:
        _open = None


def mark(name: str) -> None:
    """The end of layer ``name`` of the open step (nothing outside one)."""
    s = _open
    if s is None:
        return
    k = len(s.names) + 1
    if k >= RING_SLOTS:
        raise ValueError(f"a step holds at most {RING_SLOTS - 1} marks")
    s.names.append(name)
    if s.ring is not None:
        s.ring.stamp(k)


@contextlib.contextmanager
def capturing(device, stamped: bool):
    """Around ``CapturedStep``'s capture of a body: yields the list that
    receives the names of its marks; ``stamped``, the marks are recorded as
    graph nodes (the device's ring made before the capture), else only
    named."""
    global _capture
    if stamped:
        ring(device)
    names = []
    _capture = (names, stamped)
    try:
        yield names
    finally:
        _capture = None


class GraphMarks:
    """The marks a captured body holds (``capturing``); the host's record
    of the replays that stamp them."""

    def __init__(self, device, names):
        self.names = tuple(names)
        self.ring = ring(device) if self.names else None

    def traced(self) -> bool:
        """Whether the next replay is traced (the profiler records): it then
        runs the graph with the marks, and is counted as a stamped step."""
        on = recording()
        if self.ring is not None:
            if on:
                self.ring.stamped(self.names)
            else:
                self.ring.last = None
        return on


# ---------------------------------------------------------------------------
# host spans
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def span(name: str):
    """Keep the block's host ms under ``name``; a ``record_function``
    range too while the profiler records."""
    ranged = (torch.profiler.record_function(name) if recording()
              else contextlib.nullcontext())
    t0 = time.perf_counter_ns()
    try:
        with ranged:
            yield
    finally:
        _spans[name].append((time.perf_counter_ns() - t0) * 1e-6)


# ---------------------------------------------------------------------------
# readings
# ---------------------------------------------------------------------------


def read_ring(table: np.ndarray, counter: int, records) -> tuple:
    """({layer: [ms of each stamped step]}, [µs from a step's last mark to
    the next step's mark 0]) from a ring's (rows, slots) stamps in ns, its
    step counter, and the host's records (number, names, whether the step
    before was stamped). A part (a dotted name) is read from the mark
    before it, a layer from the last layer's mark (or mark 0), across the
    parts between. A step the ring no longer holds (more than rows ago) is
    skipped; a gap is read only between consecutive stamped steps that the
    ring holds both of."""
    rows = table.shape[0]
    layers, gaps, before = {}, [], None
    for n, names, follows in records:
        t = table[n % rows, :len(names) + 1] if counter - rows < n <= counter else None
        if t is None or not t.all():
            before = None
            continue
        layer_start = t[0]
        for name, a, b in zip(names, t[:-1], t[1:]):
            part = "." in name
            start = a if part else layer_start
            layers.setdefault(name, []).append(float(b - start) * 1e-6)
            if not part:
                layer_start = b
        if follows and before is not None and before[0] == n - 1:
            gaps.append(float(t[0] - before[1]) * 1e-3)
        before = (n, t[-1])
    return layers, gaps


def readings() -> dict:
    """{"layers": {name: [ms]}, "replay_gap_us": [µs], "spans": {name:
    [ms]}}: the rings copied to the host (one synchronisation a device;
    never call it on the hot path)."""
    layers, gaps = {}, []
    for r in _rings.values():
        table, counter = r.fetch()
        if counter != r.count:
            raise RuntimeError(f"{r.device} stamped {counter} steps, the host "
                               f"counted {r.count}")
        lay, gap = read_ring(table, counter, r.records)
        for name, ms in lay.items():
            layers.setdefault(name, []).extend(ms)
        gaps.extend(gap)
    return {"layers": layers, "replay_gap_us": gaps,
            "spans": {name: list(ms) for name, ms in _spans.items()}}


def _p95(values):
    """The 95th percentile, nearest rank."""
    return sorted(values)[math.ceil(0.95 * len(values)) - 1]


def summary(read: dict) -> dict:
    """``layers.json``: each layer's and span's median and p95 ms and
    count, and the replay gap's in µs."""
    def stats(values):
        return ({"median": statistics.median(values), "p95": _p95(values),
                 "n": len(values)} if values else None)

    return {"layers_ms": {k: stats(v) for k, v in read["layers"].items()},
            "replay_gap_us": stats(read["replay_gap_us"]),
            "spans_ms": {k: stats(v) for k, v in read["spans"].items()}}
