"""cl_ica_tpu_torch.ops.build and the kernel wrapper's guards, on the CPU.

The kernels themselves build and run only on a CUDA machine
(chip_smoke.py); what is checked here is the part around them: where
nvcc is found, what keys a built library, how a failed build reports,
and that a tensor off the CPU never takes the plain version.
"""

import ast
import os
import re
import stat
from pathlib import Path

import numpy as np
import pytest
import torch

from cl_ica_tpu_torch.ops import (
    bn_minres,
    build,
    fused_neg_lse,
    infonce,
    infonce_dot,
    marks,
    runtime,
    stem,
)
from torch_fake_card import on_fake_card

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


def test_first_load_builds_every_registered_library(tmp_path, monkeypatch):
    # one nvcc per missing library of the port, all started together, at
    # the first load of any of them; a later load builds nothing
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "csrc").mkdir()
    for name in build.LIBRARIES:
        (tmp_path / "csrc" / f"{name}.cu").write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    nvcc = _executable(tmp_path / "bin" / "nvcc",
                       f'echo "$@" >> {log}; while [ $# -gt 0 ]; do '
                       'if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done')
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    assert build.load_library("bn_minres") == str(build.library_path("bn_minres"))
    assert all(build.library_path(n).exists() for n in build.LIBRARIES)
    assert len(log.read_text().splitlines()) == len(build.LIBRARIES)
    build.load_library("stem_pool")
    assert len(log.read_text().splitlines()) == len(build.LIBRARIES)


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
    (6144, 6144, 128, 396, (16, 384)),   # three blocks an SM: 768 of 792
])
def test_split_plan(own, other, block_rows, slots, want):
    splits, chunk = infonce.split_plan(own, other, block_rows, slots)
    assert (splits, chunk) == want
    # every other row in exactly one chunk, none empty
    assert (splits - 1) * chunk < other <= splits * chunk
    assert chunk >= min(infonce.MIN_CHUNK, other)
    # at most two waves of blocks, and one more chunk would pass them
    # unless the chunks are at their least
    row_blocks = -(-own // block_rows)
    if splits > 1:
        assert row_blocks * splits <= 2 * slots
        assert row_blocks * (splits + 1) > 2 * slots or chunk < 2 * infonce.MIN_CHUNK


class _FakeLib:
    """The kernels' library, recording each call's arguments. Like
    csrc/infonce_lp.cu it has a tiled gradient for n = 3, 8 and 10 only and
    a tiled forward for n <= 16: two blocks of 128 own rows per SM there,
    none for any other n."""

    def __init__(self):
        self.calls = []

        def entry(*args):
            self.calls.append(args)
            return 0

        def grad_blocks_per_sm(dz3, n, pmode, blocks):
            blocks._obj.value = 2 if n in (3, 8, 10) else 0
            return 0

        def fwd_blocks_per_sm(n, pmode, blocks):
            blocks._obj.value = 2 if n <= 16 else 0
            return 0

        self.clica_neg_lse_fwd = self.clica_neg_lse_dz1 = self.clica_neg_lse_dz3 = entry
        self.clica_neg_lse_grad_blocks_per_sm = grad_blocks_per_sm
        self.clica_neg_lse_fwd_blocks_per_sm = fwd_blocks_per_sm
        self.clica_neg_lse_grad_block_rows = self.clica_neg_lse_fwd_block_rows = lambda: 128


def _on_fake_card(monkeypatch, lib) -> list:
    """Route the launches to ``lib`` on the fake card of 132 SMs (x 2
    blocks = 264 resident blocks), and record the shape and dtype of every
    torch.empty from then on; the record is returned."""
    on_fake_card(monkeypatch, lib)
    empty = torch.empty
    made = []

    def record(shape, **kw):
        made.append((torch.Size([shape] if isinstance(shape, int) else shape),
                     kw.get("dtype")))
        return empty(shape, **kw)

    monkeypatch.setattr(torch, "empty", record)
    return made


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
    z1, z3 = torch.zeros(m, n, device="meta"), torch.zeros(nn, n, device="meta")
    lse = ct = torch.zeros(m, device="meta")
    before = runtime.launch_counts()[which]
    made = _on_fake_card(monkeypatch, lib)
    out = infonce._launch_bwd(which, z1, z3, lse, ct, 2.0, 0.7)
    rows = m if which == "dz1" else nn
    splits, chunk = want
    assert out.shape == (rows, n)
    assert [shape for shape, _ in made] == [(rows, n)] + (
        [(splits, rows, n)] if splits > 1 else [])
    (args,) = lib.calls
    assert args[6:10] == (chunk, m, nn, n)
    assert (args[5] is None) == (splits == 1)
    assert runtime.launch_counts()[which] == before + 1


class _FakeDotLib:
    """csrc/infonce_dot.cu's library, recording each call's arguments. Like
    the library it has a tiled forward and tiled gradients for n <= 16: two
    blocks of 128 own rows per SM there, none past it."""

    def __init__(self):
        self.calls = []

        def entry(*args):
            self.calls.append(args)
            return 0

        def grad_blocks_per_sm(dz3, n, blocks):
            blocks._obj.value = 2 if n <= 16 else 0
            return 0

        def fwd_blocks_per_sm(n, blocks):
            return grad_blocks_per_sm(0, n, blocks)

        self.clica_dot_lse_fwd = self.clica_dot_lse_dz1 = self.clica_dot_lse_dz3 = entry
        self.clica_dot_lse_grad_blocks_per_sm = grad_blocks_per_sm
        self.clica_dot_lse_fwd_blocks_per_sm = fwd_blocks_per_sm
        self.clica_dot_lse_grad_block_rows = self.clica_dot_lse_fwd_block_rows = lambda: 128


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
    z1, z3 = torch.zeros(m, n, device="meta"), torch.zeros(nn, n, device="meta")
    lse = ct = torch.zeros(m, device="meta")
    before = runtime.launch_counts()
    made = _on_fake_card(monkeypatch, lib)
    out = infonce_dot._launch_bwd(which, z1, z3, lse, ct, 0.7)
    rows, others = (m, nn) if which == "dz1" else (nn, m)
    splits, chunk = want
    assert out.shape == (rows, n)
    assert [shape for shape, _ in made] == [(rows, n)] + (
        [(splits, rows, n)] if splits > 1 else [])
    if n > 16:
        assert (splits, chunk) == (1, others)
    (args,) = lib.calls
    assert args[6:11] == (chunk, m, nn, n, 0.7)
    assert (args[5] is None) == (splits == 1)
    # one count for the gradient kernel and its reduce, no other counter
    before[f"dot_{which}"] += 1
    assert runtime.launch_counts() == before


# loss -> (fake library, launch counter, forward of (z1, z3, tau), the
# arguments after lse: part_m, part_s, chunk, M, N, n, ..., tau, stream)
_FORWARDS = {
    "lp": (_FakeLib, "fwd",
           lambda z1, z3, tau: infonce._launch_fwd(z1, z3, 2.0, tau)),
    "dot": (_FakeDotLib, "dot_fwd",
            lambda z1, z3, tau: infonce_dot._launch_fwd(z1, z3, tau)),
}


@pytest.mark.parametrize("loss", sorted(_FORWARDS))
@pytest.mark.parametrize("n, m, nn, want", [
    (10, 6144, 6144, (11, 559)),  # main_mlp: 48 x 11 blocks
    (3, 512, 512, (8, 64)),       # main_3dident's position slice: 4 x 8
    (8, 512, 512, (8, 64)),       # and its angular slice
    (10, 6144, 700, (10, 70)),    # uneven chunks (chip_smoke phase 2)
    (10, 33, 6144, (96, 64)),     # one row block
    (17, 6144, 6144, (1, 6144)),  # past 16: the first version, one chunk
])
def test_forward_launch_takes_the_split_plan(monkeypatch, loss, n, m, nn, want):
    # _launch_fwd asks the library's forward occupancy, allocates the
    # chunks' partial (max, sum), float and double, only for more than one
    # chunk, passes the chunk, and counts one launch for the forward and
    # its reduce
    fake, counter, forward = _FORWARDS[loss]
    lib = fake()
    z1, z3 = torch.zeros(m, n, device="meta"), torch.zeros(nn, n, device="meta")
    before = runtime.launch_counts()
    made = _on_fake_card(monkeypatch, lib)
    lse = forward(z1, z3, 0.7)
    splits, chunk = want
    assert lse.shape == (m,)
    assert made == [((m,), torch.float32)] + (
        [((splits, m), torch.float32), ((splits, m), torch.float64)]
        if splits > 1 else [])
    (args,) = lib.calls
    assert (args[3] is None, args[4] is None) == (splits == 1, splits == 1)
    assert args[5:9] == (chunk, m, nn, n)
    before[counter] += 1
    assert runtime.launch_counts() == before


@pytest.mark.parametrize("loss", sorted(_FORWARDS))
@pytest.mark.parametrize("tau", [1e38, 1e-3])
def test_wrappers_hand_tau_to_the_library(monkeypatch, loss, tau):
    # 1 / 1e38 is not a normal float: the library, not the wrapper, sends
    # that tau to the first versions (ROADMAP C6), so forward and both
    # gradients reach it with tau unchanged and nothing refused
    fake, _, forward = _FORWARDS[loss]
    lib = fake()
    z1, z3 = torch.zeros(64, 10, device="meta"), torch.zeros(80, 10, device="meta")
    ct = torch.zeros(64, device="meta")
    _on_fake_card(monkeypatch, lib)
    lse = forward(z1, z3, tau)
    for which in ("dz1", "dz3"):
        if loss == "lp":
            infonce._launch_bwd(which, z1, z3, lse, ct, 2.0, tau)
        else:
            infonce_dot._launch_bwd(which, z1, z3, lse, ct, tau)
    assert len(lib.calls) == 3
    # tau is the argument before the stream in every entry point
    assert [args[-2] for args in lib.calls] == [tau] * 3


def _chunk_partials(x: torch.Tensor, chunk: int):
    """Each chunk's partial (m_c, s_c) of every row of the logits x, as the
    tiled forwards leave them: m_c the chunk's largest logit, s_c the sum of
    exp(x - m_c) over the chunk less the max's own term, 1."""
    parts = [(c.max(1).values, torch.exp(c - c.max(1, keepdim=True).values).sum(1) - 1)
             for c in x.split(chunk, dim=1)]
    return torch.stack([m for m, _ in parts]), torch.stack([s for _, s in parts])


def _merged(part_m: torch.Tensor, part_s: torch.Tensor) -> torch.Tensor:
    """lse_reduce_kernel's arithmetic: m the largest m_c, the first chunk
    that holds it giving s_c and every other (1 + s_c) exp(m_c - m), added
    in the order of the chunks, lse = m + log1p(sum)."""
    top = part_m.argmax(0)  # the first chunk of the largest max
    m = part_m.max(0).values
    s = torch.zeros_like(part_s[0])
    for c in range(part_m.shape[0]):
        e = torch.exp(part_m[c] - m)
        s = s + part_s[c] * e + torch.where(top == c, 0.0, e)
    return m + torch.log1p(s)


@pytest.mark.parametrize("loss", ["p=1", "p=2", "dot"])
@pytest.mark.parametrize("chunk", [64, 97, 300])
def test_chunk_partials_merge_to_the_plain_version(loss, chunk):
    # per-chunk (max, sum) pairs of float32 logits, merged in the chunks'
    # order in double, equal the plain version to 1e-6 of its largest lse
    rng = np.random.default_rng(chunk)
    z1 = (0.5 * rng.normal(size=(48, 10))).astype(np.float32)
    z3 = (0.5 * rng.normal(size=(300, 10))).astype(np.float32)
    z3[1:49] = z1  # rolled: every row has one exact match
    a, b = torch.tensor(z1), torch.tensor(z3)
    if loss == "dot":
        x = (a[:, None, :] * b[None, :, :]).sum(-1) / 0.7
        want = infonce_dot.dot_lse_reference(a, b, 0.7)
    else:
        p = float(loss[2:])
        x = -(torch.abs(a[:, None, :] - b[None, :, :]) ** p).sum(-1) / 0.7
        want = infonce.neg_lse_reference(a, b, p, 0.7)
    part_m, part_s = _chunk_partials(x.double(), chunk)
    got = _merged(part_m.float(), part_s)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


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
    """A stand-in library on which runtime.bind (clica_error_string) and a
    module's declare() set argtypes and restype; each entry point it is
    asked for is recorded."""

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        setattr(self, name, fn)
        return fn


_LIBRARIES = {"infonce_lp.cu": infonce.declare, "infonce_dot.cu": infonce_dot.declare,
              "stem_pool.cu": stem.declare, "bn_minres.cu": bn_minres.declare,
              "marks.cu": marks.declare}


@pytest.mark.parametrize("source, name", [
    (source, name) for source in _LIBRARIES for name in _c_entry_points(source)])
def test_declared_argtypes_match_the_c_definition(source, name):
    # ctypes passes whatever it is given: an argtypes list one short or
    # one long shifts every later argument (a pointer read as an int)
    lib = _Declared()
    runtime.bind(lib, _LIBRARIES[source])
    assert len(getattr(lib, name).argtypes) == _c_entry_points(source)[name]


@pytest.mark.parametrize("source", sorted(_LIBRARIES))
def test_every_c_entry_point_is_declared(source):
    lib = _Declared()
    runtime.bind(lib, _LIBRARIES[source])
    assert set(vars(lib)) == set(_c_entry_points(source))


def _private_imports(path: Path) -> list:
    """Every name with a leading underscore that ``path`` imports from
    another module of its package (a relative import)."""
    tree = ast.parse(path.read_text())
    return [f"{path.name}: from {'.' * node.level}{node.module or ''} import {alias.name}"
            for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level
            for alias in node.names if alias.name.startswith("_")]


def test_no_ops_module_imports_another_modules_private_names():
    # what the kernel wrappers share is a public name of ops/runtime.py or
    # of the module that owns it, so moving a private helper breaks nothing
    # outside its own module
    ops_dir = build.CSRC.parent
    assert [imp for path in sorted(ops_dir.glob("*.py"))
            for imp in _private_imports(path)] == []
