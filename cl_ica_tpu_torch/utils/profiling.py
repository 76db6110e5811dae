"""Profiler traces and step timing.

Port of cl_ica_tpu/utils/profiling.py. Where the JAX package writes a
jax.profiler trace for TensorBoard, ``trace_context`` records
``torch.profiler`` activity, the host's and on the card the device's
(kernels, copies and CUDA graph replays), and writes one Chrome/Perfetto
trace, ``<host>_<pid>.<ms>.pt.trace.json``, into the directory on exit.
Open it in https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _device_events(prof) -> int:
    """Events a finished ``torch.profiler.profile`` recorded on a CUDA
    device (kernels, copies, memsets), counted in its raw results."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str], device=None):
    """Profile the block into a trace under ``log_dir``; nothing when
    ``log_dir`` is None. ``device`` (default: CUDA when there is one) adds
    the CUDA activity. A CUDA trace that holds no device event raises
    RuntimeError on exit: the profiler could not see the card, and a
    host-only trace would pass for a profile of it."""
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


class StepTimer:
    """Rolling per-step wall time; call tick() once per step."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_seconds(self) -> Optional[float]:
        if not self._times:
            return None
        return sum(self._times) / len(self._times)
