"""Whole runs on the CPU at a tiny size: a measurement without a card
fails; a checkout without the program fails; a new cell and a new metric
are found as new files alone; and a run with its timed path broken comes
out not correct."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.tests.tiny import tiny_run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mlp-box-p1-b6144",
         "--seed", "2147483701", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_fails_and_prints_no_result():
    out = _cli(ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench.tests.tiny import tiny_run\n"
            "tiny_run('mlp-box-p1-b6144', 1)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "{" not in out.stdout
    assert "cl_ica_tpu_torch" in out.stderr


def test_a_new_cell_and_metric_are_new_files(tmp_path):
    """Add a cell, a traffic mix and a per-layer metric as files and
    entries, edit nothing, and see a run find and report them."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    cell = json.loads((pb / "workloads" / "mlp-box-p1-b6144.json").read_text())
    cell["traffic"] = "dummy-mix"
    cell["mix"]["span_evals"] = 2
    (pb / "workloads" / "dummy-cell.json").write_text(json.dumps(cell))
    (pb / "metrics" / "dummy_steps.py").write_text(
        "def read(record):\n    return float(record['window']['steps'])\n")
    bench["workloads"].append({"name": "dummy-cell", "config": "mlp_n10",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "driver",
                               "moves": "pairs_per_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, '.')\n"
            "from portbench.tests.tiny import tiny_run\n"
            "print(json.dumps(tiny_run('dummy-cell', 3, trace=True)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["dummy_steps"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _sound_and_broken(name, patch, monkeypatch):
    sound = tiny_run(name, 7)["compared"]
    with monkeypatch.context() as m:
        patch(m)
        broken = tiny_run(name, 7)
    return sound, broken


def _state_unchanged(m):
    m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(m):
    from cl_ica_tpu_torch.losses import infonce

    for cls in (infonce.LpSimCLRLoss, infonce.SimCLRLoss):
        orig = cls.loss

        def half(self, z1, z2, z3, a, b, c, _orig=orig):
            h = a.shape[0] // 2
            return _orig(self, z1, z2, z3, a[:h], b[:h], c[:h])
        m.setattr(cls, "loss", half)


@pytest.mark.parametrize("name", ["mlp-box-p1-b6144", "rn18-3dident-bf16-b512"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    sound, broken = _sound_and_broken(name, fault, monkeypatch)
    assert broken["correct"] is False
    worst = max(broken["compared"].values(), key=lambda c: c["value"] / max(c["limit"], 1e-30))
    name_ = [k for k, c in broken["compared"].items() if c is worst][0]
    assert worst["value"] > worst["limit"]
    assert worst["value"] >= 10 * sound[name_]["value"]
