"""The median device ms of the captured step's encoder forward of 2B images
("data" to "backbone_fwd") over the traced window's replays, from the
program's stamps (portbench/lib/stamps.py)."""

from portbench.lib import stamps


def read(record):
    return stamps.layer_ms("backbone_fwd")
