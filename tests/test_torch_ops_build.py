"""cl_ica_tpu_torch.ops.build and the kernel wrapper's guards, on the CPU.

The kernels themselves build and run only on a CUDA machine
(chip_smoke.py); what is checked here is the part around them: where
nvcc is found, what keys a built library, how a failed build reports,
and that a tensor off the CPU never takes the plain version.
"""

import os
import stat
from pathlib import Path

import pytest
import torch

from cl_ica_tpu_torch.ops import build, fused_neg_lse

torch.set_num_threads(1)


def _executable(path: Path, body: str) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return path


def test_find_nvcc_prefers_cuda_home(tmp_path, monkeypatch):
    nvcc = _executable(tmp_path / "cuda" / "bin" / "nvcc", "exit 0")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert build.find_nvcc() == str(nvcc)


def test_find_nvcc_raises_when_there_is_none(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    real_is_file = Path.is_file
    monkeypatch.setattr(Path, "is_file",
                        lambda self: False if "nvcc" in self.name else real_is_file(self))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_library_name_is_keyed_by_sources_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    src.write_text("// two\n")
    second = build.library_path("k")
    assert second != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") not in (first, second)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("broken\n")
    nvcc = _executable(tmp_path / "bin" / "nvcc",
                       "echo 'k.cu(1): error: broken' >&2; exit 2")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError, match=r"exit 2\):\nk.cu\(1\): error: broken"):
        build.load_library("k")
    assert "error: broken" in build.build_log("k")
    assert not any(p.suffix == ".so" or ".so.tmp" in p.name
                   for p in (tmp_path / "_build").iterdir())
    assert os.path.exists(tmp_path / "_build" / "lock")


@pytest.mark.parametrize("where", ["z1", "z3"])
def test_off_cpu_tensor_never_takes_the_plain_version(where):
    # a tensor on another device goes to the kernel's checks, which raise
    # for anything but CUDA; only two CPU tensors run neg_lse_reference
    z = {k: torch.zeros(4, 3) for k in ("z1", "z3")}
    z[where] = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor|is on"):
        fused_neg_lse(z["z1"], z["z3"], 2.0, 1.0)


@pytest.mark.parametrize("p, shape, match", [
    (0.5, (4, 3), "p >= 1"),
    (2.0, (4, 65), "n <= 64"),
    (2.0, (0, 3), "at least one row"),
])
def test_kernel_arguments_out_of_range_raise(p, shape, match):
    z1 = torch.zeros(shape, device="meta")
    with pytest.raises(ValueError, match=match):
        fused_neg_lse(z1, torch.zeros(4, shape[1], device="meta"), p, 1.0)
