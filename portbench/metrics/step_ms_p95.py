"""The 95th percentile (nearest rank) of every step time of the window:
the device time between the CUDA events after consecutive steps. Needs
200 steps, so that ten lie beyond it."""

import math


def read(record):
    ms = sorted(record["window"]["step_ms"])
    if len(ms) < 200:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
