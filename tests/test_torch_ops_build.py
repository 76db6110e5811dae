"""cl_ica_tpu_torch.ops.build and the kernel wrapper's guards, on the CPU.

The kernels themselves build and run only on a CUDA machine
(chip_smoke.py); what is checked here is the part around them: where
nvcc is found, what keys a built library, how a failed build reports,
and that a tensor off the CPU never takes the plain version.
"""

import contextlib
import os
import re
import stat
from pathlib import Path

import pytest
import torch

from cl_ica_tpu_torch.ops import build, fused_neg_lse, infonce, infonce_dot

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


# own rows, other rows, own rows per block, resident blocks -> (splits, chunk)
@pytest.mark.parametrize("own, other, block_rows, slots, want", [
    (6144, 6144, 128, 264, (11, 559)),   # main_mlp: 48 x 11 = two full waves
    (512, 512, 128, 264, (8, 64)),       # main_3dident: chunks of MIN_CHUNK
    (33, 6144, 128, 264, (96, 64)),      # one row block
    (6144, 700, 128, 264, (10, 70)),     # few other rows
    (700, 6144, 128, 264, (88, 70)),     # dz3 of the same
    (6144, 50, 128, 264, (1, 50)),       # under one chunk: no split
    (100000, 6144, 128, 264, (1, 6144)),  # many row blocks: no split
])
def test_split_plan(own, other, block_rows, slots, want):
    splits, chunk = infonce.split_plan(own, other, block_rows, slots)
    assert (splits, chunk) == want
    # every other row in exactly one chunk, none empty
    assert (splits - 1) * chunk < other <= splits * chunk
    assert chunk >= min(infonce.MIN_CHUNK, other)
    row_blocks = -(-own // block_rows)
    if splits > 1:
        assert row_blocks * splits >= 2 * slots or chunk < 2 * infonce.MIN_CHUNK


class _FakeLib:
    """The kernels' library, recording each gradient call's arguments. Like
    csrc/infonce_lp.cu it has a tiled kernel for n = 3, 8 and 10 only: two
    blocks of 128 own rows per SM there, none for any other n."""

    def __init__(self):
        self.calls = []

        def entry(*args):
            self.calls.append(args)
            return 0

        def blocks_per_sm(dz3, n, pmode, blocks):
            blocks._obj.value = 2 if n in (3, 8, 10) else 0
            return 0

        self.clica_neg_lse_dz1 = self.clica_neg_lse_dz3 = entry
        self.clica_neg_lse_grad_blocks_per_sm = blocks_per_sm
        self.clica_neg_lse_grad_block_rows = lambda: 128


@pytest.mark.parametrize("which, n, m, nn, want", [
    ("dz1", 10, 6144, 6144, (11, 559)),
    ("dz3", 3, 6144, 700, (88, 70)),
    ("dz1", 8, 512, 512, (8, 64)),
    ("dz1", 10, 6144, 50, (1, 50)),
    ("dz3", 10, 6144, 50, (96, 64)),
    ("dz1", 6, 300, 700, (1, 700)),     # a width the first version serves
])
def test_gradient_launch_takes_the_split_plan(monkeypatch, which, n, m, nn, want):
    lib = _FakeLib()
    monkeypatch.setattr(infonce, "load_kernels", lambda: lib)
    monkeypatch.setattr(  # 132 SMs x 2 blocks = 264 resident blocks
        torch.cuda, "get_device_properties",
        lambda d: type("Props", (), {"multi_processor_count": 132}))
    infonce._grad_slots.cache_clear()
    monkeypatch.setattr(infonce, "_grad_slots", infonce._grad_slots.__wrapped__)
    monkeypatch.setattr(infonce, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    empty = torch.empty
    made = []

    def record(shape, **kw):
        made.append(tuple(shape))
        return empty(shape, **kw)

    z1, z3 = torch.zeros(m, n, device="meta"), torch.zeros(nn, n, device="meta")
    lse = ct = torch.zeros(m, device="meta")
    before = infonce.launch_counts()[which]
    monkeypatch.setattr(torch, "empty", record)
    out = infonce._launch_bwd(which, z1, z3, lse, ct, 2.0, 0.7)
    rows = m if which == "dz1" else nn
    splits, chunk = want
    assert out.shape == (rows, n)
    assert made == [(rows, n)] + ([(splits, rows, n)] if splits > 1 else [])
    (args,) = lib.calls
    assert args[6:10] == (chunk, m, nn, n)
    assert (args[5] is None) == (splits == 1)
    assert infonce.launch_counts()[which] == before + 1


class _FakeDotLib:
    """csrc/infonce_dot.cu's library, recording each gradient call's
    arguments. Like the library it has a tiled kernel for n <= 16: two
    blocks of 128 own rows per SM there, none past it."""

    def __init__(self):
        self.calls = []

        def entry(*args):
            self.calls.append(args)
            return 0

        def blocks_per_sm(dz3, n, blocks):
            blocks._obj.value = 2 if n <= 16 else 0
            return 0

        self.clica_dot_lse_dz1 = self.clica_dot_lse_dz3 = entry
        self.clica_dot_lse_grad_blocks_per_sm = blocks_per_sm
        self.clica_dot_lse_grad_block_rows = lambda: 128


@pytest.mark.parametrize("which, n, m, nn, want", [
    ("dz1", 10, 6144, 6144, (11, 559)),  # main_mlp --p 0: 48 x 11 blocks
    ("dz3", 10, 6144, 6144, (11, 559)),
    ("dz1", 8, 512, 512, (8, 64)),       # main_3dident's angular slice: 4 x 8
    ("dz3", 8, 512, 512, (8, 64)),
    ("dz1", 10, 6144, 700, (10, 70)),    # uneven chunks (chip_smoke phase 2)
    ("dz3", 10, 6144, 700, (88, 70)),
    ("dz1", 16, 33, 6144, (96, 64)),
    ("dz1", 17, 6144, 6144, (1, 6144)),  # past 16: the first version, one chunk
    ("dz3", 40, 70, 45, (1, 70)),
])
def test_dot_gradient_launch_takes_the_split_plan(monkeypatch, which, n, m, nn, want):
    lib = _FakeDotLib()
    monkeypatch.setattr(infonce_dot, "load_kernels", lambda: lib)
    monkeypatch.setattr(  # 132 SMs x 2 blocks = 264 resident blocks
        torch.cuda, "get_device_properties",
        lambda d: type("Props", (), {"multi_processor_count": 132}))
    infonce_dot._grad_slots.cache_clear()
    monkeypatch.setattr(infonce_dot, "_grad_slots", infonce_dot._grad_slots.__wrapped__)
    monkeypatch.setattr(infonce_dot, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    empty = torch.empty
    made = []

    def record(shape, **kw):
        made.append(tuple(shape))
        return empty(shape, **kw)

    z1, z3 = torch.zeros(m, n, device="meta"), torch.zeros(nn, n, device="meta")
    lse = ct = torch.zeros(m, device="meta")
    before = infonce.launch_counts()
    monkeypatch.setattr(torch, "empty", record)
    out = infonce_dot._launch_bwd(which, z1, z3, lse, ct, 0.7)
    rows, others = (m, nn) if which == "dz1" else (nn, m)
    splits, chunk = want
    assert out.shape == (rows, n)
    assert made == [(rows, n)] + ([(splits, rows, n)] if splits > 1 else [])
    if n > 16:
        assert (splits, chunk) == (1, others)
    (args,) = lib.calls
    assert args[6:11] == (chunk, m, nn, n, 0.7)
    assert (args[5] is None) == (splits == 1)
    # one count for the gradient kernel and its reduce, no other counter
    before[f"dot_{which}"] += 1
    assert infonce.launch_counts() == before


def _c_entry_points(source: str) -> dict:
    """{name: number of arguments} of every function defined in the
    extern "C" block of a csrc file."""
    text = (build.CSRC / source).read_text()
    block = text[text.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"^\w[\w\s\*]*?\b(clica_\w+)\(([^)]*)\)\s*\{",
                                   block, flags=re.M):
        params = " ".join(params.split())
        out[name] = 0 if params in ("", "void") else params.count(",") + 1
    return out


class _Declared:
    """A stand-in library on which declare() sets argtypes and restype;
    each entry point it is asked for is recorded."""

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        setattr(self, name, fn)
        return fn


_LIBRARIES = {"infonce_lp.cu": infonce.declare, "infonce_dot.cu": infonce_dot.declare}


@pytest.mark.parametrize("source, name", [
    (source, name) for source in _LIBRARIES for name in _c_entry_points(source)])
def test_declared_argtypes_match_the_c_definition(source, name):
    # ctypes passes whatever it is given: an argtypes list one short or
    # one long shifts every later argument (a pointer read as an int)
    lib = _Declared()
    _LIBRARIES[source](lib)
    assert len(getattr(lib, name).argtypes) == _c_entry_points(source)[name]


@pytest.mark.parametrize("source", sorted(_LIBRARIES))
def test_every_c_entry_point_is_declared(source):
    lib = _Declared()
    _LIBRARIES[source](lib)
    assert set(vars(lib)) == set(_c_entry_points(source))
