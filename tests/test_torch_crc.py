"""crc32c_rows (tpu_snappy_torch/ops/kernels/crc.py, csrc/crc32c.cu), the
CRC-32C of each row's first n bytes, and the framed encoder's use of it
through parallel.shard.

On the CPU the plain version is held to framing.crc32c (the native
slice-by-8 where it builds) and to the JAX package's crc32c_batch at
lengths on both sides of every word, step and segment edge, with bytes
of every kind past each length; to the CRC-32C check value; and to its
own argument checks. The kernel's layout constants are read from
csrc/crc32c.cu. shard.encode_rows(crcs=True) gives each block's CRC on
one and two shards, a short last block included, and without the keyword
returns what it always has. The framed encoders compute no CRC on the
host (crc32c_batch and crc32c patched to raise) and give the same stream
on one and two shards at every sidecar policy; the server's framed
requests take theirs from their encode waves, and a wave of raw requests
alone runs no CRC. The `gpu` tests hold the
kernel to the plain version at (1024, 65536), on short and empty rows,
with one launch a call, and a 64 MiB framed compress on the card to the
stream with the host's CRCs, with one launch a shard.
"""

import io
import re

import numpy as np
import pytest
import torch

from tpu_snappy import framing as JF

from tpu_snappy_torch import api, serving
from tpu_snappy_torch import framing as TF
from tpu_snappy_torch.ops.kernels import _build
from tpu_snappy_torch.ops.kernels import crc as K
from tpu_snappy_torch.parallel import mesh as meshlib
from tpu_snappy_torch.parallel import shard

from torch_threads import share_cores

share_cores()

N = 1 << 16
#: Lengths on both sides of a byte, a word, an 8- and 16-byte step, a
#: 64-byte plain segment, a 256-byte kernel segment, a 4 KB page and the
#: row.
LENGTHS = (0, 1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 255, 256, 257, 4095,
           4096, 65535, 65536)
POLICIES = ("off", "auto", "always")
#: Seconds a server request may take on the CPU.
TIMEOUT = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(seed: int, count: int, fill: str = "random") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if fill == "random":
        return rng.integers(0, 256, (count, N), dtype=np.uint8)
    return np.full((count, N), 0xFF if fill == "ones" else 0, np.uint8)


def _with_prefix(rows: np.ndarray, lengths, seed: int) -> np.ndarray:
    """Random bytes in each row's first lengths[i] bytes; what lies past
    them stays as `rows` had it."""
    rng = np.random.default_rng(seed)
    rows = rows.copy()
    for i, n in enumerate(lengths):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows


def _plain(rows: np.ndarray, lengths) -> list:
    out = K.crc32c_rows(torch.from_numpy(rows),
                        torch.tensor(lengths, dtype=torch.int32))
    assert out.dtype == torch.int64 and out.shape == (len(rows),)
    return out.tolist()


@pytest.mark.parametrize("fill", ["random", "ones", "zeros"])
def test_plain_matches_framing_crc32c(fill):
    """Whatever lies past a row's length, only its first n bytes count."""
    rows = _with_prefix(_rows(1, len(LENGTHS), fill), LENGTHS, 2)
    want = [TF.crc32c(rows[i, :n].tobytes()) for i, n in enumerate(LENGTHS)]
    assert _plain(rows, LENGTHS) == want


def test_plain_matches_jax_crc32c_batch():
    rows = _rows(3, len(LENGTHS))
    got = _plain(rows, LENGTHS)
    for i, n in enumerate(LENGTHS):
        assert got[i] == int(JF.crc32c_batch(rows[i:i + 1, :n])[0]), n
    full = _plain(rows, [N] * len(LENGTHS))
    assert full == [int(c) for c in JF.crc32c_batch(rows)]


def test_check_value():
    rows = _rows(4, 2)
    rows[:, :9] = np.frombuffer(b"123456789", np.uint8)
    rows[1, 9:] = 0
    assert _plain(rows, [9, 9]) == [0xE3069283, 0xE3069283]


def test_plain_on_many_rows_of_any_length():
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, N + 1, 130).tolist()
    rows = _rows(6, len(lengths))
    want = [TF.crc32c(rows[i, :n].tobytes()) for i, n in enumerate(lengths)]
    assert _plain(rows, lengths) == want


def test_lengths_are_clamped_and_the_empty_batch():
    rows = _rows(7, 2)
    assert _plain(rows, [-5, N + 9]) == [0, TF.crc32c(rows[1].tobytes())]
    empty = K.crc32c_rows(torch.zeros((0, N), dtype=torch.uint8),
                          torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0,) and empty.dtype == torch.int64


@pytest.mark.parametrize("bad", ["blocks_dtype", "width", "lengths_dtype",
                                 "lengths_shape", "strided", "device"])
def test_rejects_bad_arguments(bad):
    blocks = torch.zeros((2, N), dtype=torch.uint8)
    lengths = torch.zeros(2, dtype=torch.int32)
    if bad == "blocks_dtype":
        blocks = blocks.to(torch.int32)
    elif bad == "width":
        blocks = torch.zeros((2, N // 2), dtype=torch.uint8)
    elif bad == "lengths_dtype":
        lengths = lengths.to(torch.int64)
    elif bad == "lengths_shape":
        lengths = torch.zeros(3, dtype=torch.int32)
    elif bad == "strided":
        blocks = torch.zeros((2, 2 * N), dtype=torch.uint8)[:, ::2]
    else:
        lengths = lengths.to("meta")
    with pytest.raises(ValueError):
        K.crc32c_rows(blocks, lengths)


def test_layout_and_constants_match_the_kernel_source():
    src = (_build.CSRC / "crc32c.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kThreads") == K.THREADS and K.SEG * K.THREADS == N
    assert const("kTables") == K.TABLES
    assert const("kInverses") == K.INVERSES
    assert f"0x{K.POLY:08X}u" in src
    assert len(K.constants()) == K.TABLES * 256 + K.THREADS + 1 + K.INVERSES
    assert "snk_crc32c_rows" in _build.SIGNATURES
    # The algebra: x^-1 is the inverse of x, the tables are framing's.
    assert K.gf_mul(K.X_INV, K.x_pow(1)) == K.ONE
    assert K.gf_mul(K.x_pow(8 * 300), K.x_inv_pow(8 * 300)) == K.ONE
    assert (np.asarray(K.tables()[:8], np.uint32) == TF._T).all()


def _mix() -> bytes:
    """Word-like text, a run, random bytes and a short last block."""
    rng = np.random.default_rng(8)
    words = b" ".join(b"w%d" % v for v in rng.zipf(1.4, 30000))[:N]
    return (words + b"q" * N + rng.integers(0, 256, N, np.uint8).tobytes()
            + words[:5000])


@pytest.mark.parametrize("shards", [1, 2])
def test_encode_rows_returns_each_blocks_crc(shards):
    data = _mix()
    blocks, lengths = api._to_blocks(data)
    mesh = meshlib.make_mesh(shards, device="cpu")
    payload, lens, crcs = shard.encode_rows(blocks, lengths, mesh,
                                            crcs=True)
    want = [TF.crc32c(data[i * N:(i + 1) * N]) for i in range(len(lengths))]
    assert lengths[-1] == 5000 and crcs.tolist() == want
    plain = shard.encode_rows(blocks, lengths, mesh)
    assert len(plain) == 2
    assert plain[0] == payload and (plain[1] == lens).all()


def test_encode_rows_without_the_keyword_runs_no_crc(monkeypatch):
    data = _mix()
    blocks, lengths = api._to_blocks(data)
    mesh = meshlib.make_mesh(2, device="cpu")

    def refuse(*_a, **_k):
        raise AssertionError("crc32c_rows ran")

    monkeypatch.setattr(K, "crc32c_rows", refuse)
    payload, lens = shard.encode_rows(blocks, lengths, mesh)
    assert len(lens) == len(lengths)
    shards, sums = shard.encode_local(mesh, blocks, lengths,
                                      TF.DEFAULT_CONFIG, 2)
    assert len(shards) == 2 and sums == []


@pytest.fixture(scope="module")
def host_free_streams():
    """Per policy: framing.compress on one and two CPU shards and
    compress_stream on one, with the host's CRC forms refusing to run."""
    data = _mix()
    mp = pytest.MonkeyPatch()

    def refuse(*_a, **_k):
        raise AssertionError("a host CRC ran in the framed encoder")

    mp.setattr(TF, "crc32c_batch", refuse)
    mp.setattr(TF, "crc32c", refuse)
    try:
        out = {}
        for policy in POLICIES:
            one = TF.compress(data, sidecar=policy, device="cpu")
            two = TF.compress(data, TF.DEFAULT_CONFIG,
                              meshlib.make_mesh(2, device="cpu"), policy)
            dst = io.BytesIO()
            TF.compress_stream(io.BytesIO(data), dst, len(data),
                               blocks_per_wave=3, sidecar=policy,
                               device="cpu")
            out[policy] = (one, two, dst.getvalue())
    finally:
        mp.undo()
    return data, out


@pytest.mark.parametrize("policy", POLICIES)
def test_framed_encoders_compute_no_host_crc(host_free_streams, policy):
    data, out = host_free_streams
    one, two, streamed = out[policy]
    assert one == two == streamed
    assert TF.decompress(one, device="cpu") == data  # every CRC checked
    assert JF.decompress(one) == data


@pytest.mark.parametrize("policy", POLICIES)
def test_server_framed_encoder_computes_no_host_crc(monkeypatch, policy):
    """The server's framed request takes each block's CRC from its encode
    wave, also from a wave it shares with a raw request (waves of 3: the
    framed request's 4 blocks, then a raw request's 2)."""
    data = _mix()
    raw = data[:N + 77]
    want = TF.compress(data, sidecar=policy, device="cpu")
    raw_want = api.compress(raw, device="cpu")

    def refuse(*_a, **_k):
        raise AssertionError("a host CRC ran in the server's encoder")

    monkeypatch.setattr(TF, "crc32c_batch", refuse)
    monkeypatch.setattr(TF, "crc32c", refuse)
    with serving.CodecServer(wave=3, max_wait_ms=2000, device="cpu") as srv:
        framed = srv.compress_framed(data, policy)
        plain = srv.compress(raw)
        assert framed.result(timeout=TIMEOUT) == want
        assert plain.result(timeout=TIMEOUT) == raw_want
        waves = srv.stats.waves_by_kind
    assert waves == {"enc": 2}


def test_server_raw_waves_run_no_crc(monkeypatch):
    """A wave of raw requests alone asks for no CRC."""
    raw = _mix()

    def refuse(*_a, **_k):
        raise AssertionError("crc32c_rows ran")

    monkeypatch.setattr(K, "crc32c_rows", refuse)
    with serving.CodecServer(wave=2, max_wait_ms=2000, device="cpu") as srv:
        got = srv.compress(raw).result(timeout=TIMEOUT)
    assert got == api.compress(raw, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["full", "short", "empty", "one_row"])
def test_kernel_matches_plain(cuda, case):
    if case == "full":
        rows, lengths = _rows(9, 1024), [N] * 1024
    elif case == "short":
        lengths = list(LENGTHS) * 3
        rows = _with_prefix(_rows(10, len(lengths)), lengths, 11)
    elif case == "empty":
        rows, lengths = _rows(12, 5), [0] * 5
    else:
        rows, lengths = _rows(13, 1), [N - 3]
    blocks = torch.from_numpy(rows)
    lens = torch.tensor(lengths, dtype=torch.int32)
    before = K.crc32c_rows.launches
    got = K.crc32c_rows(blocks.to(cuda), lens.to(cuda))
    assert K.crc32c_rows.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert got.cpu().tolist() == K.crc32c_rows(blocks, lens).tolist()
    if case != "full":
        assert got.cpu().tolist() == [TF.crc32c(rows[i, :n].tobytes())
                                      for i, n in enumerate(lengths)]


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_framed_compress_on_the_card(cuda, monkeypatch, shards):
    """64 MiB framed on the card: one crc32c_rows launch a shard, and the
    stream the host's CRCs give (crc32c_rows replaced by crc32c_batch of
    the rows on the host, the encoder's bytes the same)."""
    rng = np.random.default_rng(14)
    data = np.repeat(rng.integers(0, 256, N * 64, dtype=np.uint8),
                     16).tobytes()
    mesh = meshlib.make_mesh(device=("cuda:0",) * shards)
    before = K.crc32c_rows.launches
    got = TF.compress(data, TF.DEFAULT_CONFIG, mesh, "auto")
    assert K.crc32c_rows.launches == before + shards
    monkeypatch.setattr(K, "crc32c_rows", lambda b, n: torch.from_numpy(
        TF.crc32c_batch(b.cpu().numpy()).astype(np.int64)))
    assert got == TF.compress(data, TF.DEFAULT_CONFIG, mesh, "auto")
