"""The minres norm kernels' share of their roofline: Σ least time (the
frozen ``_bn_bounds`` at each norm's shape, portbench/counts/bn_minres.py)
over Σ measured time of the bn kernels and their reduce in the traced
window, in %."""

from portbench.counts import bn_minres
from portbench.lib.trace import kernel_seconds


def read(record):
    t = record.get("trace")
    if not t or "bn_bound_s" not in record["counts"]:
        return None
    measured, launches = kernel_seconds(t, bn_minres.KERNELS)
    if not launches:
        return None
    return 100.0 * record["counts"]["bn_bound_s"] * t["steps"] / measured
