"""The median device us from one replay's last mark to the next replay's
mark 0 (the step's output copies, the graph launch and any wait for the
host) over the traced window, from the program's stamps
(portbench/lib/stamps.py)."""

from portbench.lib import stamps


def read(record):
    return stamps.replay_gap_us()
