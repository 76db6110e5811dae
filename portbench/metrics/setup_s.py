"""Seconds from the process's start to the first timed step: imports,
kernel libraries (built in a checkout's first run), data, weights, the
captured step's warm-up and capture, the first evaluation."""


def read(record):
    return record["setup_s"]
