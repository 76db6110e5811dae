"""The median synchronised span (ms) around Lane.evaluate(), 4096 fresh samples encoded and scored on the host."""

import statistics


def read(record):
    ms = record.get("spans", {}).get("eval")
    return statistics.median(ms) if ms else None
