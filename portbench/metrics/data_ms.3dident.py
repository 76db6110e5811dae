"""The median synchronised span (ms) around sample, match, gather and normalise (sampler.sample_with_images) in an eager step."""

import statistics


def read(record):
    ms = record.get("spans", {}).get("data")
    return statistics.median(ms) if ms else None
