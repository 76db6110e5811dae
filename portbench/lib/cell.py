"""Finding a cell's files by name.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and holds its traffic mix (``mix``, named by
``traffic``); the mix names the driver family (``drivers/<driver>.py``)
that runs it.
Every metric, end-to-end or per layer, is a reader ``metrics/<metric>.py``
whose cells are the ones ``BENCHMARK.json`` lists for it. Nothing here
knows a cell, a configuration or a metric by name: a later cell, mix or
metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
KINDS = ("configs", "workloads")


def load_json(kind: str, name: str) -> dict:
    """The data file ``<kind>/<name>.json``."""
    if kind not in KINDS:
        raise ValueError(f"no kind {kind!r}")
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str) -> dict:
    """The cell with its configuration resolved:
    {"name", "config", "traffic", "chips", "why", "mix", "limits",
     "config_data": {...}, "traffic_data": the mix}."""
    cell = dict(load_json("workloads", name))
    cell["name"] = name
    cell["config_data"] = load_json("configs", cell["config"])
    cell["traffic_data"] = cell["mix"]
    return cell


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def metrics_of(cell: str, kind: str, bench: dict) -> list:
    """The entries of ``bench[kind]`` ('end_to_end' or 'per_layer') that
    the cell reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
