"""A cell cut to a CPU test's size: the same files, the batch, the cadence
and (3DIdent) the data set made small."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(name: str) -> dict:
    from portbench.lib import cell as cells

    cell = cells.load_cell(name)
    tr = cell["traffic_data"]
    argv = list(tr["argv"])
    small = "64" if tr["driver"] == "mlp_lane" else "8"
    argv[argv.index("--batch-size") + 1] = small
    argv += ["--n-log-steps", "4"]
    if tr["driver"] != "mlp_lane":
        cell["config_data"]["data"] = {"n_points": 64, "image_size": 32, "seed": 0}
    tr.update(argv=argv, trace_steps=2, span_steps=2, span_evals=1)
    return cell


def tiny_run(name: str, seed: int, trace: bool = False, seconds: float = 0.2) -> dict:
    """run.run_cell on the CPU (its look for a card skipped)."""
    import importlib.util

    from portbench.lib import cell as cells

    spec = importlib.util.spec_from_file_location("portbench_run", ROOT / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return run.run_cell(tiny_cell(name), seed, seconds, trace, "cpu", cells.benchmark())[0]


if __name__ == "__main__":
    print(tiny_run(sys.argv[1], int(sys.argv[2])))
