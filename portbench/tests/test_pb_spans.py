"""The program's spans in a traced run (spans.py): device operations go to
the innermost program span open at their launch, idle gaps take the
program span's name or, where none is open, the benchmark span's; the
harvest hands on each span once; the api readers read it, and a traced
run on the CPU reports them."""

import json
import pathlib

import pytest

from portbench import harness, probe, spans
from tpu_snappy_torch.utils import profiling
from test_pb_probe import CPU, CUDA, EVENTS, Ev

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
API = ["api_prepare_ms.write", "api_h2d_ms.write", "api_fetch_ms.write",
       "api_join_ms.write"]

#: A call [0, 1000] of api.compress [10, 990]: a wave [100, 900] holding
#: a commit [150, 350] and the benchmark's encode_blocks span [120, 880];
#: the fetch [920, 980] after it; one launch before api.compress.
PROGRAM = [
    Ev("pb.call", CPU, 0, 1000),
    Ev("cudaLaunchKernel", CPU, 3, 4, corr=12),
    Ev("snappy.api.compress", CPU, 10, 990),
    Ev("snappy.encode.wave", CPU, 100, 900),
    Ev("pb.span.encode_blocks", CPU, 120, 880),
    Ev("snappy.encode.commit", CPU, 150, 350),
    Ev("cudaLaunchKernel", CPU, 210, 220, corr=7),
    Ev("cudaLaunchKernel", CPU, 260, 270, corr=8),
    Ev("cudaLaunchKernel", CPU, 410, 415, corr=9),
    Ev("snappy.api.fetch", CPU, 920, 980),
    Ev("cudaMemcpyAsync", CPU, 930, 935, corr=10),
    Ev("cudaLaunchKernel", CPU, 985, 988, corr=11),
    Ev("early_kernel", CUDA, 4, 8, corr=12),
    Ev("scan_kernel", CUDA, 230, 300, corr=7),
    Ev("scan_kernel", CUDA, 300, 320, corr=8),
    Ev("emit_kernel", CUDA, 500, 600, corr=9),
    Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 940, 970, corr=10),
    Ev("late_kernel", CUDA, 998, 999, corr=11),
    Ev("unlinked_kernel", CUDA, 700, 720, corr=99),
    # The card's mirrors of the host ranges: no device work of their own.
    Ev("snappy.encode.wave", CUDA, 230, 600),
    Ev("pb.span.encode_blocks", CUDA, 230, 600),
]


def test_device_operations_go_to_the_innermost_program_span():
    red = spans.reduce_program(PROGRAM)
    assert red["program_device_s"] == pytest.approx(
        {"encode.commit": 90e-9, "encode.wave": 100e-9,
         "api.fetch": 30e-9, "api.compress": 1e-9})
    assert red["program_ops"] == {"encode.commit": 2, "encode.wave": 1,
                                  "api.fetch": 1, "api.compress": 1}
    assert red["program_spans"] == {"api.compress": 1, "encode.wave": 1,
                                    "encode.commit": 1, "api.fetch": 1}
    assert red["linked_s"] == pytest.approx(225e-9)
    assert red["attributed_s"] == pytest.approx(221e-9)


def test_idle_gaps_take_the_program_span_else_the_benchmark_span():
    red = spans.reduce_program(PROGRAM)
    # busy [4, 8], [230, 320], [500, 600], [700, 720], [940, 970], [998,
    # 999]: gaps [0, 4) mid 2 and [999, 1000) in the benchmark's call
    # alone; [8, 230), [320, 500), [600, 700), [720, 940) with their
    # middles in encode.wave; [970, 998) mid 984 in api.compress, after
    # the fetch.
    assert red["idle_gaps"] == pytest.approx(
        {"encode.wave": (222 + 180 + 100 + 220) * 1e-9,
         "api.compress": 28e-9, "call": 5e-9})
    assert red["idle_s"] == pytest.approx(755e-9)
    assert red["idle_outside_s"] == pytest.approx(5e-9)


def test_a_trace_with_no_call_gives_nothing():
    assert spans.reduce_program(PROGRAM[1:]) == {}


def test_reduce_trace_reads_as_without_the_program():
    """The program's host ranges leave probe.reduce_trace's reading as it
    was (test_pb_probe's expectations); their device mirrors are taken
    out of what it is handed (spantrace.py)."""
    program = [Ev("snappy.encode.wave", CPU, 150, 950),
               Ev("snappy.encode.wave", CUDA, 250, 700)]
    want = probe.reduce_trace(EVENTS, kernel_calls=2)
    assert probe.reduce_trace(EVENTS + program[:1], 2) == want
    assert probe.reduce_trace(spans.without_program(EVENTS + program),
                              2) == want
    assert want["idle_gaps"] == pytest.approx({"span.encode_blocks": 500e-9})


@pytest.fixture
def harvested():
    spans.harvest.stop()
    yield
    spans.harvest.stop()


def _closed(*names):
    for name in names:
        with profiling.span(name):
            pass


def test_harvest_hands_on_each_span_once(harvested):
    with profiling.tracing() as rec:
        _closed("api.prepare", "api.h2d")
        got = spans.harvest(None)
        assert {k: n for k, (n, _) in got.items()} == {
            "snappy.api.prepare": 1, "snappy.api.h2d": 1}
        assert got["snappy.api.h2d"][1] == rec.spans[1].t1 - rec.spans[1].t0
        _closed("api.fetch", "api.fetch")
        assert {k: n for k, (n, _) in spans.harvest(None).items()} == {
            "snappy.api.fetch": 2}
        assert spans.harvest(None) == {}


def test_harvest_turns_recording_on_without_ranges(harvested):
    assert profiling.recorder() is None
    assert spans.harvest(None) == {}
    rec = profiling.recorder()
    assert rec is not None and not rec.ranges
    _closed("api.join")
    assert list(spans.harvest(None)) == ["snappy.api.join"]
    spans.harvest.stop()
    assert profiling.recorder() is None


def test_harvest_of_a_program_without_the_recorder(harvested, monkeypatch):
    monkeypatch.delattr(profiling, "recorder")
    assert spans.harvest(None) == {}


@pytest.mark.parametrize("metric", API)
def test_api_reader(metric):
    reader = harness.load_metric(metric)
    assert reader.SPANS == {spans.HARVEST: spans.harvest}
    name = "snappy.api." + metric.split("_")[1]
    obs = {"counters": {name: [(0, (1, 2_000_000)), (1, (2, 3_000_000))],
                        "snappy.encode.wave": [(0, (8, 1))]}}
    assert reader.read(obs) == pytest.approx(5 / 3)
    del obs["counters"][name]
    assert reader.read(obs) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_harvest_survives_the_readers_merge(cell):
    """The harness merges the readers' SPANS in BENCHMARK.json's order: a
    reader that names the same span with no counter comes first."""
    targets = {}
    for m in harness.cell_spec(cell)["per_layer"]:
        targets.update(getattr(harness.load_metric(m["name"]), "SPANS", {}))
    assert targets[spans.HARVEST] is spans.harvest


def test_traced_run_on_the_cpu_reports_the_api_spans(harvested):
    small = {"pool_bytes": 5 << 16, "call_bytes": 2 << 16,
             "stride_bytes": 1 << 16, "slices": 4}
    result = harness.run_cell("raw-turbo.write", 2**31 + 91, 0.05, True,
                              device="cpu", sizes=small)
    assert result["correct"], result["compared"]
    for metric in API:
        assert result["metrics"][metric]["value"] > 0, metric
        assert result["metrics"][metric]["unit"] == "ms"
