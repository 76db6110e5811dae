"""Build the port's native library with g++, at first use.

``hungarian.cpp`` and ``packed_loader.cpp`` are compiled into one shared
library with a plain C interface, loaded with ctypes. The library lands in
``_build/`` next to this file (never beside the sources), under a name
keyed by a hash of the sources and flags; a file lock keeps concurrent
processes from building it twice, and the build goes through a temporary
name, so a reader never loads half a library. A failed build raises with
the compiler's output: no caller falls back to numpy.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCES = ("hungarian.cpp", "packed_loader.cpp")
HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
COMPILER = "g++"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join((COMPILER,) + FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libclica_torch_native-{_digest()}.so"


def build_library() -> Path:
    """The library for the current sources, built here if missing; raises
    RuntimeError with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [COMPILER, *FLAGS, "-o", str(tmp),
               *(str(HERE / s) for s in SOURCES), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as err:
            raise RuntimeError(f"the native library's compiler did not run: "
                               f"{' '.join(cmd)}: {err}") from err
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{COMPILER} failed to build the native library (exit "
                f"{proc.returncode}):\n{(proc.stdout + proc.stderr)[-6000:]}")
        os.replace(tmp, out)
    return out


def load_native_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every function's
    argument and result types declared."""
    path = build_library()
    with _lock:
        lib = _loaded.get(path)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(path))
        lib.hungarian_solve.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.hungarian_solve.restype = None
        lib.pl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        lib.pl_open.restype = ctypes.c_int64
        lib.pl_gather.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_int]
        lib.pl_gather.restype = ctypes.c_int
        lib.pl_close.argtypes = [ctypes.c_int64]
        lib.pl_close.restype = None
        _loaded[path] = lib
        return lib
