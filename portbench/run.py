#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads ``portbench/workloads/<cell>.json`` (with its traffic mix) and the
configuration it names, builds the mix's driver family
(``portbench/drivers/``) from the seed, warms up, measures for
``--seconds`` seconds, and prints as the last line of standard output one
JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, each read by ``portbench/metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number that decided ``correct`` beside its limit (also the last lines of
standard error).

Exits non-zero without printing a result when there is no card (or fewer
than the cell asks for), and when the process holds JAX, Flax or the JAX
package once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# every build and kernel cache in the checkout, at fixed paths
CACHE = ROOT / "runs" / "portbench" / "cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str,
             bench: dict) -> tuple:
    """One run of ``cell`` on ``device``: (the result's object, the
    set-up's and the window's seconds and steps), without the guards of
    ``main``; the CPU tests call it with device='cpu'."""
    import torch

    from portbench.lib import cell as cells
    from portbench.lib.check import readings, verdict
    from portbench.lib.timing import process_age

    driver = cells.load_module("drivers", cell["traffic_data"]["driver"])
    session = driver.Session(cell, seed, device)
    session.setup()
    record = {"cell": cell, "setup_s": process_age()}
    record["window"] = session.window(seconds)
    cuda = torch.device(device).type == "cuda"
    record["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    record["counts"] = session.counts()
    if trace:
        record["trace"] = session.traced()
        record["spans"] = session.spans()
    session.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = readings(session)["program"]
    correct, rows = verdict(values, cell["limits"])

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cells.metrics_of(cell["name"], kind, bench):
        value = cells.load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": record["peak_bytes"]}
    out = {"correct": bool(correct), "attempted": record["window"]["steps"],
           "failed": record["window"]["failed"], "metrics": metrics, "device": dev}
    if trace:
        t = record["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out, {"setup_s": record["setup_s"], "seconds": record["window"]["seconds"],
                 "steps": record["window"]["steps"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import cell as cells
    from portbench.lib import guard

    bench = cells.benchmark()
    cell = cells.load_cell(args.workload)
    guard.need_cards(int(cell["chips"]))
    out, w = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", bench)
    bad = guard.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}: the benchmark may not load "
              "JAX, Flax or the JAX package", file=sys.stderr)
        return 3
    print(f"setup_s {w['setup_s']!r} window_s {w['seconds']!r} steps {w['steps']}",
          file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
