#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--variants program,control,half]

For each seed: the cell's set-up as a run makes it (the program's step
captured, then its first three replays from the benchmark's weights), then
the reference and, per variant, the numbers of ``lib/check.py``:
``program`` (the lower readings), ``control`` (the reference put in the
program's place one precision below the configuration's: TF32 for
float32, fp8 for bfloat16), ``half`` (the reference on half of each batch:
the fault "half of the batch left out") and ``sampler`` (``sample_z`` of
the same draws with the conditional's scale off by half: a fault planted
in the sampler). A step that leaves its state unchanged reads 1 on
``grad1`` and ``change3`` by their definition and needs no run. One JSON
line a seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench import run  # noqa: E402,F401  (the caches' environment)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,control,half")
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import cell as cells
    from portbench.lib import guard
    from portbench.lib.check import readings

    cell = cells.load_cell(args.workload)
    guard.need_cards(int(cell["chips"]))
    driver = cells.load_module("drivers", cell["traffic_data"]["driver"])
    variants = tuple(args.variants.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        session = driver.Session(cell, seed, "cuda")
        session.setup()
        session.free()
        gc.collect()
        torch.cuda.empty_cache()
        out = readings(session, variants)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        del session
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
