"""Nothing the benchmark runs imports JAX, Flax or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their whole top-level name: ``cl_ica_tpu_torch`` begins with
``cl_ica_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lib.guard import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path):
    """(top-level name, level) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".", 1)[0], node.level


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["cl_ica_tpu_torch", "cl_ica_tpu_torch.ops"]) == []
    assert forbidden_modules(["cl_ica_tpu.ops", "jaxtyping", "jax.numpy"]) == [
        "cl_ica_tpu", "jax"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_harness_module_imports_jax(path):
    names = {name for name, level in _imports(path) if level == 0}
    assert not names & set(FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in _imports(path):
        if level == 0:
            assert name in {"__future__", "contextlib", "os", "math", "numpy",
                            "torch"}, (path, name)
        else:
            assert level == 1, (path, name)  # only its own modules


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a tiny size, in a process of its own: the
    port loads nothing of JAX either."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.tiny import tiny_run\n"
        "from portbench.lib.guard import forbidden_modules\n"
        "tiny_run('mlp-box-p1-b6144', 5, trace=True)\n"
        "print('FORBIDDEN', forbidden_modules())\n" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
