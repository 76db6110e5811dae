"""BENCHMARK.json against the contract's limits, and every name in it
found as a file of the harness."""

import json
import re

import pytest

from portbench.lib import cell as cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    entries = BENCH[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)


def test_metric_names_unique_across_kinds():
    assert len(METRICS) == len(set(METRICS))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"pairs_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_every_cell_reports_what_the_contract_asks():
    for c in CELLS:
        e2e = [m["name"] for m in cells.metrics_of(c, "end_to_end", BENCH)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.metrics_of(c, "per_layer", BENCH)


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = cells.load_json("configs", c["name"])
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name_and_agree(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    cell = cells.load_cell(name)
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == w[key], key
    assert w["chips"] == 1
    assert cells.load_module("drivers", cell["traffic_data"]["driver"]).Session
    assert cell["limits"]


def test_pairs_appear_once_and_four_chip_cells_are_few():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(cells.load_module("metrics", name).read)
