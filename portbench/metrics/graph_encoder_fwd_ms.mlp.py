"""The median device ms of the captured step's frozen mixing and encoder
forward of both views ("sample" to "encoder_fwd") over the traced
window's replays, from the program's stamps (portbench/lib/stamps.py)."""

from portbench.lib import stamps


def read(record):
    return stamps.layer_ms("encoder_fwd")
