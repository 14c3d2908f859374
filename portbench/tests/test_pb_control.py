"""Each cell's control, at a size a test run holds: the reference in the
program's place with a guarantee broken (control.py) comes out not
correct by the cell's own check, on three seeds."""

import json
import pathlib

import pytest

from portbench import control

SMALL = {"pool_bytes": 5 << 16, "call_bytes": 3 << 16,
         "stride_bytes": 1 << 16, "slices": 3}
CELLS = [w["name"] for w in json.loads(
    (pathlib.Path(__file__).resolve().parents[2]
     / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("seed", [2**31 + 1, 5, 6])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell, seed):
    got = control.control_reading(cell, seed, device="cpu", sizes=SMALL)
    value, limit, op = got["mismatched_bytes"]
    assert op == "<=" and value > limit
