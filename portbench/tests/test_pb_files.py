"""BENCHMARK.json and the files it names: every cell, configuration,
traffic, generator, entry and metric file loads, its names and units keep
to the allowed characters, and a cell added as new files in a copy is
found and runs without an edit to a file that was there."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys_and_names():
    bench = BENCH
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["per_layer"]]
    names = ([c["name"] for c in bench["configs"]] + cells
             + [m["name"] for m in bench["end_to_end"]] + metrics)
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for entry in bench["configs"] + bench["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_and_reports(cell):
    spec = harness.cell_spec(cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e, m
    for kind, key in (("generators", "generator"), ("entries", "entry")):
        assert (harness.HERE / kind
                / f"{spec['traffic'][key]}.py").exists(), key
    assert spec["cell"]["chips"] == 1


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    from tpu_snappy_torch import config as presets
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"]
    assert body["source"] == config["source"]
    preset = getattr(presets, body["preset"].split(":")[0].split(".")[-1])
    assert presets.CodecConfig(**body["codec"]) == preset


@pytest.mark.parametrize("metric", METRICS)
def test_metric_file_is_a_reader(metric):
    """A metric's file holds its reader and the spans it needs; its unit,
    layer, direction and the metric it moves are BENCHMARK.json's alone."""
    reader = harness.load_metric(metric)
    assert callable(reader.read)
    for name in ("LAYER", "UNIT", "BETTER", "MOVES", "SOURCE"):
        assert not hasattr(reader, name), name
    for target in getattr(reader, "SPANS", {}):
        assert re.match(r"^tpu_snappy_torch(\.\w+)*:\w+$", target), target


def test_every_metric_file_is_held():
    """Each reader under metrics/ is a metric of BENCHMARK.json."""
    files = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == set(METRICS)


def test_every_traffic_generator_and_entry_file_is_used():
    used = {w["traffic"] for w in BENCH["workloads"]}
    traffic = {p.stem for p in (harness.HERE / "traffic").glob("*.json")}
    assert traffic == used
    specs = [harness.cell_spec(c)["traffic"] for c in CELLS]
    for kind, key in (("generators", "generator"), ("entries", "entry")):
        files = {p.stem for p in (harness.HERE / kind).glob("*.py")}
        assert files - {"__init__"} == {t[key] for t in specs}, kind


def test_every_file_is_named_from_name_characters():
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


GENERATOR = '''"""Inputs of one repeated phrase (a test's generator)."""


def inputs(traffic, seed):
    phrase = b"the quick brown fox %d " % (seed % 97)
    body = (phrase * (traffic["call_bytes"] // len(phrase) + 1))
    return [body[k:k + traffic["call_bytes"]]
            for k in range(traffic["slices"])]
'''


def test_new_cell_is_found_by_its_files(tmp_path):
    """A cell of new traffic, added in a copy as a traffic file, the
    generator it names and an entry of BENCHMARK.json, runs there (on the
    CPU, small) with no other file touched."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "raw-turbo.phrase",
                               "config": "raw-turbo", "traffic": "phrase",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "raw-turbo.write" in m.get("workloads", []):
            m["workloads"].append("raw-turbo.phrase")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    traffic = {"generator": "phrase", "entry": "compress",
               "call_bytes": 2 << 16, "slices": 2}
    (tmp_path / "portbench" / "traffic" / "phrase.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench" / "generators" / "phrase.py").write_text(
        GENERATOR)
    code = ("import json, sys; from portbench import harness; "
            "r = harness.run_cell('raw-turbo.phrase', 5, 0.1, False, "
            "device='cpu'); print(json.dumps(r))")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert set(result["metrics"]) == {"compress_GBps", "stored_per_byte",
                                      "setup_s"}
    assert result["metrics"]["stored_per_byte"]["value"] < 0.1
    assert all(p.read_bytes() == body for p, body in before.items())
