"""The port stands alone: it imports nothing of JAX or of the JAX package.

A fresh interpreter imports every module of tpu_snappy_torch and must find
no `jax` and no `tpu_snappy` module loaded. The port's own copies of the
framework-free modules must equal the JAX package's: every `format`
constant and helper, every field of the four `config` presets, the
`reference_codec` bytes on seeded inputs, the framing CRC tables and the
decoder and sidecar constants the framed container's sidecars are built
for, `utils.corpus.synth` for every kind and `utils.metrics` on a row set.
The C++ golden binding builds
into the port's own directory, its command-line harness
(`swcompression_path`) and the depth hints' simulation
(`depth_hints_sim`) included. `utils.profiling` times and traces torch
work. The API runs on the card by default and,
with no CUDA device visible, raises instead of running on the CPU.
"""

import dataclasses
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_snappy import config as jax_config
from tpu_snappy import format as jax_fmt
from tpu_snappy import framing as jax_framing
from tpu_snappy import reference_codec as jax_codec
from tpu_snappy import sidecar as jax_sidecar
from tpu_snappy.native import golden as jax_golden
from tpu_snappy.ops import decode as jax_decode
from tpu_snappy.utils import corpus
from tpu_snappy.utils import metrics as jax_metrics

from tpu_snappy_torch import api
from tpu_snappy_torch import config
from tpu_snappy_torch import format as fmt
from tpu_snappy_torch import framing
from tpu_snappy_torch import reference_codec
from tpu_snappy_torch import sidecar
from tpu_snappy_torch.native import golden, realsnappy
from tpu_snappy_torch.ops import decode
from tpu_snappy_torch.utils import corpus as port_corpus
from tpu_snappy_torch.utils import metrics, profiling

from torch_threads import share_cores

share_cores()

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_and_no_jax_package():
    mods = sorted("tpu_snappy_torch." + str(p.relative_to(
        ROOT / "tpu_snappy_torch").with_suffix("")).replace("/", ".")
        for p in (ROOT / "tpu_snappy_torch").rglob("*.py")
        if p.name != "__init__.py" and "_build" not in p.parts)
    # The golden's extras run too, where cmake and Ninja are there: the
    # CLI harness's build and the depth hints' simulation.
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from tpu_snappy_torch.native import golden\n"
            "from tpu_snappy_torch import format as fmt\n"
            "if golden.available():\n"
            "    assert golden.swcompression_path().exists()\n"
            "    comp = golden.compress(b'snappy ' * 3000)\n"
            "    total, start = fmt.varint_decode(comp)\n"
            "    golden.depth_hints_sim(comp[start:], total, 0, 1024)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'jaxlib', 'tpu_snappy'))\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    for m in ("ops.kernels.matcher", "ops.kernels.gather", "framing",
              "sidecar", "parallel.mesh", "parallel.shard",
              "parallel.streaming", "parallel.multihost", "compat",
              "hadoop", "__main__", "serving", "utils.corpus",
              "utils.metrics", "utils.profiling"):
        assert "tpu_snappy_torch." + m in mods


def _public(mod) -> dict:
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, type(sys))
            and k != "annotations"}


def test_format_constants_match_jax():
    mine, theirs = _public(fmt), _public(jax_fmt)
    assert mine.keys() == theirs.keys()
    for name, value in mine.items():
        if callable(value):
            continue
        assert value == theirs[name], name
    for n in (0, 1, 127, 128, 65536, 1 << 31):
        assert fmt.varint_encode(n) == jax_fmt.varint_encode(n)
        assert fmt.max_compressed_size(n) == jax_fmt.max_compressed_size(n)
    for length in (1, 60, 61, 256, 257, 65536):
        assert fmt.literal_header(length) == jax_fmt.literal_header(length)
    for off, length in ((1, 4), (2047, 11), (2048, 64), (65535, 12)):
        assert (fmt.copy_element(off, length)
                == jax_fmt.copy_element(off, length))


def test_framing_and_sidecar_copies_match_jax():
    """The framed container's copies: CRC tables, chunk types and the
    policy cut; the decoder constants the 0x81 hints are computed for; the
    sidecar constants."""
    assert (framing._T == jax_framing._T).all()
    for k in ("CHUNK_STREAM_ID", "CHUNK_COMPRESSED", "CHUNK_UNCOMPRESSED",
              "CHUNK_PADDING", "CHUNK_SIDECAR", "CHUNK_DEPTH", "STREAM_ID",
              "SIDECAR_AUTO_FRAC", "MAX_CHUNK"):
        assert getattr(framing, k) == getattr(jax_framing, k), k
    for k in ("TAIL_CAP", "TAIL_TILE", "HINT_TILE", "FRAG_CAP", "OUT",
              "PARA_CAP", "PARA_TILE"):
        assert getattr(decode, k) == getattr(jax_decode, k), k
    for k in ("MAGIC", "CHUNK_TYPE", "DEPTH_CHUNK_TYPE", "DEPTH_MAGIC",
              "SPLIT_LEN", "PARENT_WROWS", "MAX_PIECES", "OUT"):
        assert getattr(sidecar, k) == getattr(jax_sidecar, k), k


@pytest.mark.parametrize("preset", ["DEFAULT_CONFIG", "FAST_CONFIG",
                                    "TURBO_CONFIG", "ULTRA_CONFIG"])
def test_config_presets_match_jax(preset):
    mine, theirs = getattr(config, preset), getattr(jax_config, preset)
    assert ([f.name for f in dataclasses.fields(mine)]
            == [f.name for f in dataclasses.fields(theirs)])
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_reference_codec_bytes_match_jax():
    rng = np.random.default_rng(41)
    datas = [b"", b"a", b"abcd" * 5000, bytes(rng.integers(0, 256, 3000,
                                                            "u1")),
             corpus.synth("random", 20000),
             b"The quick brown fox jumps over the lazy dog. " * 2000]
    for data in datas:
        comp = reference_codec.compress(data)
        assert comp == jax_codec.compress(data)
        assert reference_codec.decompress(comp) == data
        assert (reference_codec.compress(data, dense_table=False)
                == jax_codec.compress(data, dense_table=False))


def test_golden_builds_in_its_own_directory():
    assert golden.BUILD_DIR.parent == ROOT / "tpu_snappy_torch" / "native"
    assert golden.BUILD_DIR != jax_golden._BUILD
    if not golden.available():
        pytest.skip("cmake / Ninja missing: the golden cannot build here")
    # (The JAX package's golden is not called: it would build native/build
    # beside the JAX tests that build it in other test processes.)
    data = b"snappy " * 3000
    comp = golden.compress(data)
    assert golden.uncompress(comp) == data
    cli = golden.swcompression_path()
    assert cli.parent == golden.BUILD_DIR and cli.exists()
    total, start = fmt.varint_decode(comp)
    hints = golden.depth_hints_sim(comp[start:], total, 0, 1024)
    assert np.array_equal(hints, golden.depth_hints(comp[start:], total, 0,
                                                    1024))
    assert reference_codec.decompress(comp) == data
    if realsnappy.available():
        assert realsnappy.uncompress(golden.compress(data)) == data


def test_api_defaults_to_the_card_and_never_falls_back(monkeypatch):
    """With no CUDA device visible, the default device raises, for small
    and large inputs alike, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = b"x" * 100
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compress(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compress(data * 1000, small_fastpath=False)
    comp = api.compress(data, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.decompress(comp)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.decompress_with_stats(comp)
    assert api.decompress(comp, device="cpu") == data


@pytest.mark.parametrize("kind", ["random", "real", "repeating"])
def test_corpus_synth_matches_jax(kind, monkeypatch):
    """Both copies read one corpus directory (the JAX package's), so "real"
    takes the same branch in both; every kind at two sizes."""
    for name in ("REFERENCE_ROOT", "BENCH_DATA", "DATA"):
        monkeypatch.setattr(port_corpus, name, getattr(corpus, name))
    for size in (1000, 50000):
        assert port_corpus.synth(kind, size) == corpus.synth(kind, size)
    assert port_corpus.synth(kind, 700, seed=7) == corpus.synth(kind, 700,
                                                                seed=7)
    assert port_corpus.SIZES == corpus.SIZES
    assert port_corpus.TYPES == corpus.TYPES
    assert port_corpus.has_reference_corpus() == corpus.has_reference_corpus()
    assert port_corpus.corpus_files() == corpus.corpus_files()
    with pytest.raises(ValueError):
        port_corpus.synth("zipf", 10)


def test_metrics_match_jax():
    rows = [("random", 1000, 4045, 1020), ("real", 50000, 175145, 32683),
            ("repeat", 50000, 99382, 2351), ("real", 10, 0, 13)]
    mine = [metrics.Row(*r) for r in rows]
    theirs = [jax_metrics.Row(*r) for r in rows]
    assert metrics.HEADER == jax_metrics.HEADER
    assert [r.csv() for r in mine] == [r.csv() for r in theirs]
    a, b = io.StringIO(), io.StringIO()
    metrics.write_csv(mine, a)
    jax_metrics.write_csv(theirs, b)
    assert a.getvalue() == b.getvalue()
    assert (metrics.parse_reference_csv(a.getvalue())
            == [metrics.Row(*r) for r in rows])
    assert metrics.summary_table(mine) == jax_metrics.summary_table(theirs)
    assert (metrics.compare(mine, mine[:2])
            == jax_metrics.compare(theirs, theirs[:2]))


def test_profiling_times_and_traces_torch_work(tmp_path):
    x = torch.ones((128, 128))
    with profiling.tracing() as rec:
        with profiling.span("mul"):
            y = x * 2
        with profiling.span("sum"):
            y.sum()
    assert [s.name for s in rec.spans] == ["mul", "sum"]
    assert all(s.t1 >= s.t0 and s.parent == -1 for s in rec.spans)
    assert profiling.device_bench(torch.add, x, 1, iters=3, trials=2) > 0
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)) as p, profiling.tracing():
        with profiling.span("matmul"):
            (x @ x).sum()
    assert p == str(path) and path.stat().st_size > 0
    assert '"snappy.matmul"' in path.read_text()
