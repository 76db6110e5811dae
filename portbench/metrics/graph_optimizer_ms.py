"""The median device ms of the captured step's Adam update and schedule
("backward" to "optimizer") over the traced window's replays, from the
program's stamps (portbench/lib/stamps.py)."""

from portbench.lib import stamps


def read(record):
    return stamps.layer_ms("optimizer")
