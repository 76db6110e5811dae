"""The median synchronised span (ms) around the frozen mixing and the encoder's forward of both views in an eager step."""

import statistics


def read(record):
    ms = record.get("spans", {}).get("encoder_fwd")
    return statistics.median(ms) if ms else None
