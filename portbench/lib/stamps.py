"""The program's own layer readings, in the run's process.

``cl_ica_tpu_torch.utils.profiling.readings()`` holds the device ms of each
marked layer of every step stamped while the profiler recorded (in a run,
the traced window's replays), the device µs between consecutive replays,
and the host ms of each ``clica.*`` span. A program without readings (one
older than its stamps) gives none, and every reader here gives ``None``.
"""

from __future__ import annotations

import statistics


def readings():
    """The program's readings, or None where it keeps none."""
    from cl_ica_tpu_torch.utils import profiling

    read = getattr(profiling, "readings", None)
    return read() if read is not None else None


def _median(values):
    return statistics.median(values) if values else None


def layer_ms(name: str):
    """The median device ms of the stamped steps' layer ``name``."""
    r = readings()
    return _median(r["layers"].get(name)) if r else None


def replay_gap_us():
    """The median device µs from a replay's last mark to the next one's
    mark 0."""
    r = readings()
    return _median(r["replay_gap_us"]) if r else None


def span_ms(name: str):
    """The median host ms of the program's span ``name``."""
    r = readings()
    return _median(r["spans"].get(name)) if r else None
