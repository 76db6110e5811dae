"""The traced window: a torch.profiler trace of a run of captured steps,
reduced to what the per-layer readers take.

Copied in spirit from tools/profile_torch_step.py ``trace()``, with its
busy share corrected: that tool summed each kernel's device time, which
counts twice the kernels that overlap on two streams. Here the device is
busy where the union of the device intervals (kernels, copies, sets)
covers the window, and the window is the host range ``portbench.window``
around the steps and their final synchronisation.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd import DeviceType

WINDOW = "portbench.window"


def traced(run, device) -> dict:
    """Run ``run()`` (the steps, which end in a synchronisation) under the
    profiler and reduce the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run()
    return reduce_events(prof.events())


def _is_device(e) -> bool:
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """{"window_s", "busy_s", "kernels": [(name, seconds)], "device_ops",
    "idle_gaps"} from the profiler's events (microsecond time ranges on
    one clock for host and device)."""
    windows = [e for e in events if e.name == WINDOW
               and e.device_type == DeviceType.CPU]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    kernels = []
    for e in events:
        if not _is_device(e):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            kernels.append((e.name, s, t))
    busy = _union([(s, t) for _, s, t in kernels])
    busy_us = sum(t - s for s, t in busy)
    by_name = collections.Counter()
    for name, s, t in kernels:
        by_name[name[:120]] += (t - s) * 1e-6
    # idle gaps, each named by the innermost host range around its middle
    # (a sweep over the gaps in time order with the host ranges open there)
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name != WINDOW))
    edges = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    gaps = collections.Counter()
    open_, nxt = [], 0
    for s, t in zip(edges[::2], edges[1::2]):
        if t <= s:
            continue
        mid = (s + t) / 2
        while nxt < len(host) and host[nxt][0] <= mid:
            open_.append(host[nxt])
            nxt += 1
        open_ = [h for h in open_ if h[1] >= mid]
        name = (min(open_, key=lambda h: h[1] - h[0])[2] if open_
                else "host: outside any range")
        gaps[name[:120]] += (t - s) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": [(name, (t - s) * 1e-6) for name, s, t in kernels],
        "device_ops": [[k, v] for k, v in by_name.most_common(10)],
        "idle_gaps": [[k, v] for k, v in gaps.most_common(10)],
    }


def kernel_seconds(trace: dict, patterns) -> tuple:
    """(seconds, launches) of the trace's kernels whose name holds any of
    ``patterns``."""
    hits = [s for name, s in trace["kernels"] if any(p in name for p in patterns)]
    return sum(hits), len(hits)
