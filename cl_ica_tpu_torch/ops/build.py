"""Build the port's CUDA kernels with nvcc, at first use.

Each ``csrc/<name>.cu`` is compiled by hand into a shared library with a
plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds). The library lands in ``_build/`` next to this file, under
a name keyed by a hash of the sources and flags; a file lock keeps
concurrent processes from building the same library twice, and
``build_libraries`` compiles several sources at once: the first
``load_library`` of one of the port's libraries (``LIBRARIES``) builds
every one of them that is missing, one nvcc each, started together. The
compiler's register/spill report (``-Xptxas -v``) is kept beside each as
a ``.log``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# one library per source: the loss kernels (ops/infonce.py, infonce_dot.py),
# the stem tail's (ops/stem.py), the blocks' batch norm (ops/bn_minres.py)
# and the layer stamps (ops/marks.py)
LIBRARIES = ("infonce_lp", "infonce_dot", "stem_pool", "bn_minres", "marks")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No --use_fast_math: __expf/__powf would spend the 1e-4 gradient bar.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA toolkit is needed to build the port's kernels"
    )


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_digest()}.so"


def build_log(name: str) -> str:
    """The compiler output of the library's build ('' if not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_libraries(names) -> None:
    """Build every ``csrc/<name>.cu`` of ``names`` that has no library for
    its current sources: one nvcc per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        running = []
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            src = CSRC / f"{name}.cu"
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            running.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in running:
            stdout, stderr = proc.communicate()
            out.with_suffix(".log").write_text(stdout + stderr)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(
                    f"nvcc failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{stderr[-6000:]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if no library for its current sources
    exists (with it every other of ``LIBRARIES`` that is missing), then
    load it."""
    build_libraries(LIBRARIES if name in LIBRARIES else [name])
    return ctypes.CDLL(str(library_path(name)))
