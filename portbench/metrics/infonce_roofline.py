"""The loss kernels' share of their roofline: Σ least time (the frozen
``_bounds`` at the step's shapes, portbench/counts/infonce.py) over Σ
measured time of their launches in the traced window, in %."""

from portbench.counts import infonce
from portbench.lib.trace import kernel_seconds


def read(record):
    t = record.get("trace")
    if not t:
        return None
    measured, launches = kernel_seconds(t, infonce.KERNELS)
    if not launches:
        return None
    return 100.0 * record["counts"]["loss_bound_s"] * t["steps"] / measured
