"""On the card: the control (the reference itself in float32 with TF32
matrix products, the precision below the configurations' float32 with TF32
off) fails each cell's limits, and the program passes them, at 1024 lanes.
Run there with

    python -m pytest portbench/tests/test_portbench_control.py -m card -n 0
"""

import pytest

from portbench import calibrate
from portbench.harness import compare, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card):
    rec, _ = calibrate.readings(name, 2**31 + 101, True, device=card,
                                overrides={"B": 1024, "ref_lanes": 2048})
    lim = spec.limits(name)["numbers"]
    ok_program, _ = compare.judge({k: rec["program"][k] for k in lim}, lim)
    ok_control, _ = compare.judge({k: rec["control"][k] for k in lim}, lim)
    assert ok_program, rec["program"]
    assert not ok_control, rec["control"]
