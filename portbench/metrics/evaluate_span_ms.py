"""The median host ms of the program's span clica.evaluate (Lane.evaluate:
4096 fresh samples encoded and scored), over every evaluation of the run
(portbench/lib/stamps.py)."""

from portbench.lib import stamps


def read(record):
    return stamps.span_ms("clica.evaluate")
