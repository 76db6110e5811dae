"""The run's guards: a card for each chip the cell asks for, and no JAX.

The JAX package (``cl_ica_tpu``) is the port's reference on the CPU and is
never measured. The port's name begins with its name, so modules are
compared by their whole top-level name, the part before the first dot.
"""

from __future__ import annotations

import contextlib
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "cl_ica_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``modules`` (default ``sys.modules``) that the
    benchmark may not load."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


# the program's own prints go to standard error: the result is the last line
# of standard output
program_prints = contextlib.redirect_stdout(sys.stderr)


class NoCard(SystemExit):
    pass


def need_cards(chips: int) -> None:
    """Raise ``NoCard`` (a non-zero exit) unless CUDA has ``chips`` devices: a
    measurement without the card fails, never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("portbench: torch.cuda.is_available() is False; "
                     "the benchmark measures the card and has no CPU path")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"portbench: the cell asks for {chips} chips, "
                     f"torch.cuda.device_count() is {torch.cuda.device_count()}")
