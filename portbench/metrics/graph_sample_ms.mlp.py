"""The median device ms of the captured step's sampling (mark 0 to "sample":
latent_space.sample_pair) over the traced window's replays, from the
program's stamps (portbench/lib/stamps.py)."""

from portbench.lib import stamps


def read(record):
    return stamps.layer_ms("sample")
