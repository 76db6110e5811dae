"""Observability and debugging helpers of the port.

Port of cl_ica_tpu/utils:

- profiling: a ``torch.profiler`` trace context (a Chrome/Perfetto
  ``*.pt.trace.json`` and ``layers.json``), the training step's layer
  marks timed on the device, and host spans,
- debug: the ``CL_ICA_TPU_DEBUG=1`` NaN/Inf guards,
- seeding: one helper for (numpy Generator, torch Generator) pairs.

The JAX package's ``checkify_wrap`` has no counterpart: eager torch has
nothing to functionalize, so a guard raises where it runs.
"""

from .debug import debug_enabled, nan_check
from .profiling import trace_context
from .seeding import seed_everything

__all__ = [
    "trace_context",
    "nan_check",
    "debug_enabled",
    "seed_everything",
]
