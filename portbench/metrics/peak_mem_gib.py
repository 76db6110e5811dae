"""torch.cuda.max_memory_allocated() over the run up to the window's end,
in a fresh process, the image store included."""


def read(record):
    return record["peak_bytes"] / 2 ** 30 if record["peak_bytes"] else None
