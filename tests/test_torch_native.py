"""cl_ica_tpu_torch.native against the JAX package's native library, scipy
and numpy: the port's own copy of the C++ sources, built into the port's
``native/_build/`` at first use. The solver's optimum against scipy and
its assignment against the JAX library's; the packed store's gather
against the JAX gather and numpy's fancy index, into a fresh array and
into a caller's buffer; an index out of range, a store that cannot be
mapped and a compiler that fails all raise (nothing falls back)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from cl_ica_tpu import native as jax_native
from cl_ica_tpu_torch import native
from cl_ica_tpu_torch.native import build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [3, 10, 32, 64])
def test_solver_is_optimal_and_the_jax_librarys_assignment(n):
    rng = np.random.default_rng(n)
    for _ in range(10):
        cost = rng.normal(size=(n, n))
        r2c = native.hungarian_solve_native(cost)
        assert sorted(r2c) == list(range(n))
        ri, ci = linear_sum_assignment(cost)
        np.testing.assert_allclose(cost[np.arange(n), r2c].sum(), cost[ri, ci].sum(),
                                   rtol=1e-12)
        np.testing.assert_array_equal(r2c, jax_native.hungarian_solve_native(cost))


def test_solver_breaks_ties_as_the_jax_library():
    cost = np.random.default_rng(0).integers(0, 3, size=(40, 40)).astype(float)
    np.testing.assert_array_equal(native.hungarian_solve_native(cost),
                                  jax_native.hungarian_solve_native(cost))
    with pytest.raises(ValueError, match="square"):
        native.hungarian_solve_native(cost[:, :5])


@pytest.fixture
def store(tmp_path):
    """{name: (path, array)} of two packed .npy stores."""
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in (("renders", (50, 7, 9, 3)), ("planes", (200, 32, 32))):
        arr = rng.integers(0, 255, shape, dtype=np.uint8)
        path = str(tmp_path / f"{name}.npy")
        np.save(path, arr)
        out[name] = (path, arr)
    return out


@pytest.mark.parametrize("name, idx", [
    ("renders", [0, 17, 49, 3, 3]),
    ("planes", np.random.default_rng(1).integers(0, 200, 512)),
])
def test_gather_equals_the_jax_gather_and_numpy(store, name, idx):
    path, arr = store[name]
    idx = np.asarray(idx)
    got = native.PackedGather(path, arr.shape[1:], len(arr))
    want = jax_native.PackedGather(path, arr.shape[1:], len(arr))
    assert want.ok
    out = got.gather(idx)
    np.testing.assert_array_equal(out, arr[idx])
    np.testing.assert_array_equal(out, want.gather(idx))
    for threads in (1, 3):
        np.testing.assert_array_equal(got.gather(idx, threads=threads), arr[idx])
    got.close()
    want.close()


def test_gather_into_a_callers_buffer(store):
    path, arr = store["renders"]
    gather = native.PackedGather(path, arr.shape[1:], len(arr))
    idx = np.array([4, 0, 4, 49])
    buf = torch.zeros((4, 7, 9, 3), dtype=torch.uint8)
    assert gather.gather(idx, out=buf) is buf
    np.testing.assert_array_equal(buf.numpy(), arr[idx])
    host = np.zeros((4, 7, 9, 3), dtype=np.uint8)
    gather.gather(idx, out=host)
    np.testing.assert_array_equal(host, arr[idx])
    for bad in (torch.zeros((4, 7, 9, 3), dtype=torch.int32),
                torch.zeros((3, 7, 9, 3), dtype=torch.uint8),
                torch.zeros((4, 9, 7, 3), dtype=torch.uint8).transpose(1, 2),
                np.zeros((4, 7, 9, 3), dtype=np.float32)):
        with pytest.raises(ValueError, match="C-contiguous uint8"):
            gather.gather(idx, out=bad)
    gather.close()
    with pytest.raises(ValueError, match="closed"):
        gather.gather(idx)


@pytest.mark.parametrize("idx", [[50], [-1], [3, 50, 4]])
def test_an_index_out_of_range_raises(store, idx):
    path, arr = store["renders"]
    gather = native.PackedGather(path, arr.shape[1:], len(arr))
    with pytest.raises(IndexError):
        gather.gather(np.array(idx))
    gather.close()


def test_a_store_that_cannot_be_mapped_raises(store, tmp_path):
    path, arr = store["renders"]
    with pytest.raises(OSError, match="could not map"):
        native.PackedGather(str(tmp_path / "missing.npy"), arr.shape[1:], len(arr))
    with pytest.raises(OSError, match="could not map"):  # more rows than the file
        native.PackedGather(path, arr.shape[1:], len(arr) + 1)


def test_the_library_is_the_ports_build_and_never_the_jax_library():
    """Built under cl_ica_tpu_torch/native/_build/ and keyed by the sources'
    hash; a process that solves with it maps no library of the JAX
    package."""
    path = build.build_library()
    assert path.parent == build.BUILD_DIR and path.exists()
    assert build.BUILD_DIR == build.HERE / "_build"
    assert build.build_library() == path
    assert build._digest() in path.name
    code = (
        "import numpy as np\n"
        "from cl_ica_tpu_torch import native\n"
        "native.hungarian_solve_native(np.eye(25))\n"
        "libs = [ln.split()[-1] for ln in open('/proc/self/maps') if '.so' in ln]\n"
        "print(sorted({p for p in libs if 'clica' in p}))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mapped = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert mapped == [str(path)]


def test_a_broken_compiler_raises_with_its_output(tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'error: this compiler is broken' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(build, "COMPILER", str(cxx))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="this compiler is broken"):
        build.load_native_library()
    assert not list((tmp_path / "_build").glob("*.so*"))
    monkeypatch.setattr(build, "COMPILER", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not run"):
        native.hungarian_solve_native(np.eye(3))
