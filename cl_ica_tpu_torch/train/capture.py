"""A training step captured once as a CUDA graph and replayed.

The port's counterpart of the JAX package's scanned steps
(cl_ica_tpu/train/trainer.py:36-189 ``make_chunked_steps`` and
``make_scanned_synthetic_train_steps``, cl_ica_tpu/cli/kitti_solver.py:185,
cl_ica_tpu/cli/main_3dident.py:691-744 ``make_scanned_unsup``). Where JAX
scans a jitted step, the step body here is recorded once into a
``torch.cuda.CUDAGraph`` and each call replays it: one launch from the host
for the whole step, the sampling, the forward, the backward and the
optimizer update, with nothing read back.

What makes a body capturable: it reads no device value on the host (the
samplers draw fixed rounds, the optimizer is ``capturable``, the cosine
schedule lives on the device: train/trainer.py); its random numbers come
from the ``torch.Generator``s registered here, so that each replay advances
them as the eager step does and ``get_state``/``set_state`` still save and
resume the stream; and the tensors it updates in place (parameters,
optimizer state, running statistics) keep their addresses. A restore that
replaces tensors (``Optimizer.load_state_dict``) must come before the
first call, or be followed by ``reset``.

The first WARMUP_STEPS calls run the body eagerly on a side stream (they
are real steps: they build the kernels, the optimizer's state and the
libraries' handles outside the capture); the next call captures and
replays. A capture that fails raises; the step never falls back to eager
launches on the card. On the CPU every call runs the body eagerly.

The kernels' launch counters (ops.launch_counts) count in Python, so a
capture would count its launches once; ``CapturedStep`` takes them back
after the capture and adds the launches of one step at each replay.

A body with layer marks (utils/profiling.py) is captured twice, into one
memory pool: without its marks, and with them as graph nodes. A replay
runs the graph with the marks while the torch profiler records (a
``clica.step`` range), the graph without them otherwise: a mark node
costs each replay its hop in the graph's chain of nodes, enabled or
disabled (about 1.5 µs). The warm-up and the capture are the host span
``clica.capture``.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Sequence

import torch

from ..ops import add_launch_counts, launch_counts
from ..utils import profiling

WARMUP_STEPS = 2


class CapturedStep:
    """``step()`` -> the (k,) float32 stack of the body's k 0-d outputs,
    a tensor of its own (the graph's output buffer is copied)."""

    def __init__(self, body: Callable[[], Sequence[torch.Tensor]],
                 generators: Sequence[torch.Generator], device):
        self.body = body
        self.generators = list(generators)
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        """Drop the graphs: the next calls warm up and capture anew."""
        self.graph = self.out = self.marked = self.marked_out = self.marks = None
        self.warm = 0
        self.per_replay: Dict[str, int] = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _run(self) -> torch.Tensor:
        return torch.stack([t.float() for t in self.body()])

    def _warm_step(self) -> torch.Tensor:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._run()
        main.wait_stream(side)
        out.record_stream(main)
        return out

    def _record(self, stamped: bool, pool=None) -> tuple:
        """One capture of the body, its layer marks as graph nodes or not:
        (the graph, its output, the marks' names). Its launches are taken
        back from the counters and kept as one replay's."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        with profiling.capturing(self.device, stamped) as names, \
                torch.cuda.device(self.device), torch.cuda.graph(graph, pool=pool):
            out = self._run()
        after = launch_counts()
        self.per_replay = {k: after[k] - before[k] for k in after}
        add_launch_counts({k: -v for k, v in self.per_replay.items()})
        return graph, out, names

    def _capture(self) -> None:
        # A graph that is garbage (a lane of an earlier phase or run, kept
        # by a reference cycle) must go before the capture: the collector,
        # run inside it, would tear that graph down, an operation a capture
        # does not permit, and the capture would fail.
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            self.graph, self.out, names = self._record(stamped=False)
            if names:  # the marks' own graph, in the first one's memory
                self.marked, self.marked_out, _ = self._record(
                    stamped=True, pool=self.graph.pool())
        finally:
            if collecting:
                gc.enable()
        self.marks = profiling.GraphMarks(self.device, names)

    def __call__(self) -> torch.Tensor:
        if self.device.type != "cuda":
            return self._run()
        if self.graph is None:
            with profiling.span("clica.capture"):
                if self.warm < WARMUP_STEPS:
                    self.warm += 1
                    return self._warm_step()
                self._capture()
        graph, out = self.graph, self.out
        if self.marks.traced():
            if self.marked is not None:
                graph, out = self.marked, self.marked_out
            with torch.profiler.record_function("clica.step"):
                graph.replay()
        else:
            graph.replay()
        add_launch_counts(self.per_replay)
        return out.clone()
