"""On the card: the control (the reference put in the program's place one
precision below the configuration's: TF32 for float32, fp8 for bfloat16)
comes out not correct under each cell's limits, and the program at the same
size comes out correct, each cell at its own size, on three seeds."""

import pytest

from portbench.lib import cell as cells
from portbench.lib.check import readings, verdict

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card):
    cell = cells.load_cell(name)
    driver = cells.load_module("drivers", cell["traffic_data"]["driver"])
    for seed in (101, 102, 103):
        session = driver.Session(cell, seed, card)
        session.setup()
        session.free()
        out = readings(session, ("program", "control"))
        limits = cell["limits"]
        assert verdict(out["program"], limits)[0], out["program"]
        assert not verdict({**out["program"], **out["control"]},
                           {k: v for k, v in limits.items() if k in out["control"]})[0], \
            out["control"]
