"""The median synchronised span (ms) around the Adam update in an eager step."""

import statistics


def read(record):
    ms = record.get("spans", {}).get("optimizer")
    return statistics.median(ms) if ms else None
