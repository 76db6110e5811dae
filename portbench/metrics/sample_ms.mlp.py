"""The median synchronised span (ms) around latent_space.sample_pair in an eager step."""

import statistics


def read(record):
    ms = record.get("spans", {}).get("sample")
    return statistics.median(ms) if ms else None
