"""The port's framed container (tpu_snappy_torch/framing.py) against
tpu_snappy/framing.py and the C++ golden.

framing.compress must give the JAX package's bytes under every sidecar
policy ("off", "auto", "always"); each package decodes the other's stream,
and the golden's independent framed decoder (which skips the sidecars by
spec) decodes the port's. The input mixes Zipf word text (0x81 depth hints
under "auto"), a one-byte run (a 0x80 root map), random bytes (a stored
chunk) and a partial last chunk. The hinted chunks need no re-decode
after a CRC miss. Corrupt or truncated sidecars and under-declared depth
hints fall back to the normal path and still give the input; a corrupt
data chunk raises; the streaming forms give the same bytes. These mirror
tests/test_sidecar.py:340-463 with synthetic inputs. The `gpu` test runs
the framed round trip on the card.
"""

import io

import numpy as np
import pytest
import torch

from tpu_snappy import framing as JF

from tpu_snappy_torch import framing as TF
from tpu_snappy_torch.native import golden

from torch_threads import share_cores

share_cores()

POLICIES = ("off", "auto", "always")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, n: int) -> bytes:
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 11)).astype(np.uint8))
             for _ in range(3000)]
    out = b" ".join(vocab[i % len(vocab)] for i in rng.zipf(1.3, n // 3))
    return out[:n]


def _mix() -> bytes:
    rng = np.random.default_rng(17)
    return (_words(rng, 65536) + b"z" * 65536
            + rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
            + _words(rng, 30000))


@pytest.fixture(scope="module")
def streams():
    """The mix and the port's framed stream under each policy."""
    data = _mix()
    return data, {p: TF.compress(data, sidecar=p, device="cpu")
                  for p in POLICIES}


def _chunks(fr: bytes):
    """(type, start, length) of every chunk after the stream identifier."""
    out, ip = [], len(TF.STREAM_ID)
    while ip < len(fr):
        ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
        out.append((fr[ip], ip, ln))
        ip += 4 + ln
    return out


def test_crc_matches_jax():
    assert (TF._T == JF._T).all()
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (5, 1000), dtype=np.uint8)
    assert (TF.crc32c_batch(rows) == JF.crc32c_batch(rows)).all()
    for n in (0, 1, 7, 8, 9, 1000, 65536):
        buf = rows.reshape(-1)[:n].tobytes() if n <= 5000 else bytes(n)
        assert TF.crc32c(buf) == JF.crc32c(buf)
    assert TF.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    for c in (0, 1, 0xE3069283, 0xFFFFFFFF):
        assert TF.mask(c) == JF.mask(c) and TF.unmask(TF.mask(c)) == c


@pytest.mark.parametrize("policy", POLICIES)
def test_compress_matches_jax(streams, policy):
    data, fr = streams
    assert fr[policy] == JF.compress(data, sidecar=policy)
    assert TF.compress(b"", sidecar=policy, device="cpu") == TF.STREAM_ID


@pytest.mark.parametrize("policy", POLICIES)
def test_streams_decode_everywhere(streams, policy):
    data, fr = streams
    types = [t for t, _, _ in _chunks(fr[policy])]
    got, stats = TF.decompress_with_stats(fr[policy], device="cpu")
    assert got == data
    assert TF.decompress(fr[policy], use_sidecar=False, device="cpu") == data
    assert JF.decompress(fr[policy]) == data
    if golden.available():
        assert golden.uncompress_framed(fr[policy],
                                        max_out=len(data) + 16) == data
        assert TF.decompress(golden.compress_framed(data),
                             device="cpu") == data
    assert stats.uncompressed == 1 and stats.host == 0
    assert stats.redecoded_hinted == 0 and stats.redecoded_root_map == 0
    assert stats.root_map == types.count(TF.CHUNK_SIDECAR)
    assert stats.hinted == types.count(TF.CHUNK_DEPTH)
    assert stats.root_map + stats.hinted + stats.normal == 3
    if policy == "auto" and golden.available():
        # Word text takes the 0x81 hints, the run its 0x80 root map.
        assert stats.hinted == 2 and stats.root_map == 1
        assert len(stats.dense_rounds) == 1  # the hinted wave
    if policy == "always":
        assert stats.root_map >= 1


def test_under_declared_hints_fall_back(streams):
    """Depth hints lowered by 3 give wrong bytes in the text chunks; the
    CRC sends them to the normal path and the output is still exact. Hints
    raised by 2 only cost rounds."""
    if not golden.available():
        pytest.skip("cmake / Ninja missing: no depth hints here")
    data, fr = streams
    for delta, misses in ((-3, True), (+2, False)):
        buf = bytearray(fr["auto"])
        for typ, ip, ln in _chunks(fr["auto"]):
            if typ == TF.CHUNK_DEPTH:
                for off in range(ip + 4 + 12, ip + 4 + ln):
                    buf[off] = min(255, max(0, buf[off] + delta))
        got, stats = TF.decompress_with_stats(bytes(buf), device="cpu")
        assert got == data
        assert (stats.redecoded_hinted > 0) == misses, delta


def test_corrupt_or_truncated_sidecars_are_only_hints(streams):
    data, fr = streams
    flipped = bytearray(fr["always"])
    junked = bytearray(fr["always"])
    for typ, ip, ln in _chunks(fr["always"]):
        if typ == TF.CHUNK_SIDECAR:
            flipped[ip + 4 + 10] ^= 0xFF  # a piece entry
            junked[ip + 4: ip + 4 + ln] = b"\xaa" * ln
    got, stats = TF.decompress_with_stats(bytes(flipped), device="cpu")
    assert got == data and stats.redecoded_root_map >= 1
    got, stats = TF.decompress_with_stats(bytes(junked), device="cpu")
    assert got == data and stats.root_map == 0
    assert stats.redecoded_root_map == 0  # unparsable: never tried


def test_adversarial_sidecar_payloads_never_corrupt():
    rng = np.random.default_rng(99)
    data = b"the quick brown fox " * 600
    body = TF.compress(data, sidecar="off", device="cpu")[len(TF.STREAM_ID):]
    evil = []
    for n in (0, 1, 7, 8, 37, 1000):
        junk = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        evil.append(bytes([TF.CHUNK_SIDECAR]) + n.to_bytes(3, "little")
                    + junk)
        evil.append(bytes([TF.CHUNK_DEPTH]) + n.to_bytes(3, "little") + junk)
    for p in (1, 5, 200):
        starts = np.sort(rng.choice(10000, p, replace=False)).astype("<u2")
        starts[0] = 0
        roots = rng.integers(0, 65536, p).astype("<u2")
        slopes = np.packbits(rng.integers(0, 2, p).astype(bool)).tobytes()
        payload = (b"tpS1" + np.uint32(p).tobytes() + starts.tobytes()
                   + roots.tobytes() + slopes)
        evil.append(bytes([TF.CHUNK_SIDECAR])
                    + len(payload).to_bytes(3, "little") + payload)
    for chunk in evil:
        assert TF.decompress(TF.STREAM_ID + chunk + body,
                             device="cpu") == data


def test_corrupt_data_chunk_raises(streams):
    _data, fr = streams
    for policy in ("always", "off"):
        buf = bytearray(fr[policy])
        for typ, ip, _ln in _chunks(fr[policy]):
            if typ == TF.CHUNK_COMPRESSED:
                buf[ip + 4 + 9] ^= 0xFF
                break
        with pytest.raises(ValueError):
            TF.decompress(bytes(buf), device="cpu")
    with pytest.raises(ValueError, match="stream identifier"):
        TF.decompress(b"not framed", device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        TF.decompress(fr["off"][:-3], device="cpu")


def test_streaming_forms(streams):
    data, fr = streams
    for wave in (1, 2):
        dst = io.BytesIO()
        n = TF.decompress_stream(io.BytesIO(fr["always"]), dst,
                                 device="cpu", chunks_per_wave=wave)
        assert dst.getvalue() == data and n == len(data)
    dst = io.BytesIO()
    n = TF.compress_stream(io.BytesIO(data), dst, len(data), sidecar="auto",
                           device="cpu", blocks_per_wave=2)
    assert dst.getvalue() == fr["auto"] and n == len(fr["auto"])


def test_framing_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.compress(b"x" * 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.decompress(TF.STREAM_ID)
    with pytest.raises(ValueError, match="sidecar"):
        TF.compress(b"x", sidecar="sometimes", device="cpu")


@pytest.mark.gpu
def test_framed_round_trip_on_the_card(streams, cuda):
    data, fr = streams
    for policy in POLICIES:
        assert TF.compress(data, sidecar=policy, device=cuda) == fr[policy]
        for use in (True, False):
            got, stats = TF.decompress_with_stats(fr[policy], use_sidecar=use,
                                                  device=cuda)
            assert got == data and stats.redecoded_hinted == 0
