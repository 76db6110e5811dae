"""The median synchronised span (ms) around the encoder's forward of 2B images (stem, blocks, heads) in an eager step."""

import statistics


def read(record):
    ms = record.get("spans", {}).get("backbone_fwd")
    return statistics.median(ms) if ms else None
