"""1 − the union of device intervals / the traced window of captured
steps (portbench/lib/trace.py), in %."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
