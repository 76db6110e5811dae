"""The port's native (C++) library, bound with ctypes.

The port's own copy of the JAX package's native components, built from
the sources here into ``_build/`` at first use (native/build.py):

  hungarian.cpp     — the O(n³) assignment solver that
                      evaluation.munkres.hungarian takes for n >= 20
  packed_loader.cpp — the threaded row gather over the packed image store
                      (data/threedident.py: PackedImageStore and the
                      host-prefetch loader)

A build or a store that fails to open raises; nothing falls back.
"""

from .bindings import PackedGather, hungarian_solve_native
from .build import build_library, load_native_library

__all__ = ["PackedGather", "build_library", "hungarian_solve_native",
           "load_native_library"]
