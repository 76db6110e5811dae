"""The median device ms of the captured step's ResNet stage 2 forward of 2B
images (the mark before it to "backbone_fwd.stage2": the stage's blocks)
over the traced window's replays, from the program's stamps
(portbench/lib/stamps.py)."""

from portbench.lib import stamps


def read(record):
    return stamps.layer_ms("backbone_fwd.stage2")
