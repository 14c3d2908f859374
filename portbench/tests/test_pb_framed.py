"""The framed cell (framed-default.write): it loads and reports through
harness.cell_spec, its entry and traffic agree with its configuration
and with the write mix, it refuses to run without the native library,
its reference's CRC is the spec's, the sidecar counter reads a
hand-built stream right, and a small run on the CPU is correct and
reports the framing spans."""

import json
import pathlib

import numpy as np
import pytest

from portbench import harness, reference_framed, spans
from portbench.entries import framed
from tpu_snappy_torch import framing
from tpu_snappy_torch.ops import decode

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "framed-default.write"
SPAN_METRICS = ["framed_encode_ms.write", "framed_crc_ms.write",
                "framed_sidecar_ms.write", "framed_assemble_ms.write"]
SMALL = {"pool_bytes": 5 << 16, "call_bytes": 3 << 16,
         "stride_bytes": 1 << 16, "slices": 3}


def _config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def test_cell_loads_and_reports():
    spec = harness.cell_spec(CELL)
    assert spec["cell"]["chips"] == 1
    assert spec["traffic"]["entry"] == "framed"
    assert {m["name"] for m in spec["end_to_end"]} == {
        "compress_GBps", "stored_per_byte", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == set(SPAN_METRICS) | {
        "sidecar_bytes_share.write"}
    for m in spec["per_layer"]:
        assert m["layer"] == "framing" and m["workloads"] == [CELL]


def test_entry_and_configuration_agree_with_the_program():
    body = _config("framed-default")
    box = body["container"]
    assert framed.Entry(None, [b""], "cpu").container == box
    assert box["sidecar"] == "auto"
    assert box["sidecar_auto_frac"] == framing.SIDECAR_AUTO_FRAC
    assert box["chunk_bytes"] == framing.MAX_CHUNK
    assert box["depth_hints"] == {"tail_cap": decode.TAIL_CAP,
                                  "tile": decode.HINT_TILE}
    assert body["codec"] == _config("raw-default")["codec"]


def test_traffic_is_the_write_mix_into_the_framed_entry():
    traffic = harness.HERE / "traffic"
    mine = json.loads((traffic / "framed-write.json").read_text())
    write = json.loads((traffic / "write.json").read_text())
    assert mine.pop("entry") == "framed" and write.pop("entry") == "compress"
    assert mine == write


def test_reference_crc_is_the_spec_s():
    assert int(reference_framed.crc32c([b"123456789"])[0]) == 0xE3069283
    rng = np.random.default_rng(11)
    pieces = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 3, 4, 5, 4095, 4096, 4097, 65535, 65536)]
    got = reference_framed.crc32c(pieces).tolist()
    assert got == [framing.crc32c(p) for p in pieces]
    assert reference_framed.mask(got).tolist() == [framing.mask(c)
                                                   for c in got]


def _chunk(kind: int, n: int) -> bytes:
    return bytes([kind]) + n.to_bytes(3, "little") + bytes(n)


def test_sidecar_counter_reads_a_hand_built_stream():
    reader = harness.load_metric("sidecar_bytes_share.write")
    assert list(reader.SPANS) == ["tpu_snappy_torch.framing:compress"]
    count = reader.SPANS["tpu_snappy_torch.framing:compress"]
    stream = (framing.STREAM_ID + _chunk(0x80, 20) + _chunk(0x00, 100)
              + _chunk(0x81, 76) + _chunk(0x00, 50) + _chunk(0x01, 30)
              + _chunk(0xFE, 5) + _chunk(0x90, 7))
    got = count(stream)
    assert got == {"framing.sidecar_bytes": 24 + 80,
                   "framing.stream_bytes": len(stream)}
    bare = framing.STREAM_ID + _chunk(0x01, 30)
    obs = {"counters": {k: [(0, v), (1, count(bare)[k])]
                        for k, v in got.items()}}
    assert reader.read(obs) == pytest.approx(
        100 * 104 / (len(stream) + len(bare)))
    assert reader.read({"counters": {}}) is None


def test_entry_refuses_to_run_without_the_native_library(monkeypatch):
    """Without it "auto" writes no depth hints: another stream."""
    monkeypatch.setattr(decode, "native_golden", lambda: None)
    with pytest.raises(RuntimeError, match="native library"):
        framed.Entry(None, [b""], "cpu")


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_reader(metric):
    reader = harness.load_metric(metric)
    assert reader.SPANS == {spans.HARVEST: spans.harvest}
    name = "snappy.framing." + metric.split("_")[1]
    obs = {"counters": {name: [(0, (1, 4_000_000)), (1, (1, 2_000_000))]}}
    assert reader.read(obs) == pytest.approx(3.0)
    assert reader.read({"counters": {}}) is None


@pytest.fixture
def harvested():
    spans.harvest.stop()
    yield
    spans.harvest.stop()


def test_small_traced_run_on_the_cpu_is_correct(harvested):
    result = harness.run_cell(CELL, 2**33 + 5, 0.05, True, device="cpu",
                              sizes=SMALL)
    assert result["correct"], result["compared"]
    assert result["compared"]["bad_sidecars"]["value"] == 0
    assert result["compared"]["missing_sidecars"]["value"] == 0
    for metric in SPAN_METRICS:
        assert result["metrics"][metric]["value"] > 0, metric
    assert 0 < result["metrics"]["sidecar_bytes_share.write"]["value"] < 3
