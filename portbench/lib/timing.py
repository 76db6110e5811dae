"""Clocks of a run: the process's age, and the device time of each step.

``process_age()`` reads the process's start from /proc (ticks since boot),
so that ``setup_s`` counts the interpreter's start and every import.

``StepEvents`` records a CUDA event on the step's stream after each step
and reads the gaps between consecutive events after the window, so the
window adds no synchronisation: a step's time is the device time from the
end of the step before it to its own end, waits included.
"""

from __future__ import annotations

import os
import sys
import time

import torch


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as fh:
        # the command name may hold spaces: fields after its closing ')'
        fields = fh.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22, starttime
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def mark(label: str) -> None:
    """A set-up milestone on standard error: the process's age there."""
    print(f"setup {label} {process_age():.2f}", file=sys.stderr, flush=True)


class StepEvents:
    """Events after each step of a window, on the current CUDA stream.
    ``device`` 'cpu' (the CPU tests) takes host times after each step."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        """ms between consecutive marks (after the window has synchronised)."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Synchronised spans around the calls into a layer, from outside the
    program (tools/profile_torch_step.py's phases): each ``mark(name)``
    ends the span that began at the last mark, after a device
    synchronisation."""

    def __init__(self, device):
        self.device = device
        self.ms = {}
        self.t = None

    def start(self) -> None:
        sync(self.device)
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        sync(self.device)
        t = time.perf_counter()
        self.ms.setdefault(name, []).append((t - self.t) * 1e3)
        self.t = t
