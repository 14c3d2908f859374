"""The command on the card: each cell for two seconds, untraced and
traced, comes out correct with its metrics (run on the card with
`python -m pytest portbench/tests -m gpu`)."""

import json
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 41), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    spec = harness.cell_spec(cell)
    want = spec["per_layer" if trace else "end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if name.endswith("roofline") or "_roofline." in name:
                assert 0 < m["value"] <= 105, (name, m)
    else:
        assert set(result["metrics"]) == {m["name"] for m in want}
