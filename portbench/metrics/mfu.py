"""The whole step's share of the chip's peak: model operations a step
(portbench/counts/, no recomputation) × the window's steps / its seconds /
the peak of the cell's precision (portbench/counts/peaks.py), in %."""


def read(record):
    w, c = record["window"], record["counts"]
    return 100.0 * c["flops_per_step"] * w["steps"] / w["seconds"] / c["peak_flops"]
