"""The port's python-snappy surface (tpu_snappy_torch/compat.py) and Hadoop
container (tpu_snappy_torch/hadoop.py) against the JAX package's.

The cases of tests/test_compat.py on seeded inputs (tests/torch_edges.py
block_mix: word text, a one-byte run, random ASCII and random bytes) in
place of the reference corpus, on the CPU: raw and framed bytes equal to
tpu_snappy.compat's, str encodings, UncompressError, isValidCompressed,
whole and dribbled StreamDecompressor input, CRC corruption, skippable
and reserved chunks, copy(), the file helpers; the Hadoop layout equal to
tpu_snappy.hadoop's, block size and tail, multi-subblock decode,
truncation errors and empty input. Without a card the default device
raises. The `gpu` test repeats the round trips on the card.
"""

import io

import numpy as np
import pytest
import torch

from tpu_snappy import compat as jcompat, hadoop as jhadoop

from tpu_snappy_torch import compat, framing, hadoop, reference_codec
from tpu_snappy_torch.native import golden

from torch_edges import block_mix
from torch_threads import share_cores

share_cores()

CPU = dict(device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _text(n: int) -> bytes:
    return block_mix(n)


def _rand(n: int, seed=11) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _raw_decode(comp: bytes) -> bytes:
    if golden.available():
        return golden.uncompress(comp)
    return reference_codec.decompress(comp)


# ---- raw-stream API ----

def test_compress_uncompress_round_trip():
    data = _text(150_000)
    comp = compat.compress(data, **CPU)
    assert comp == jcompat.compress(data)
    assert compat.uncompress(comp, **CPU) == data
    assert _raw_decode(comp) == data


def test_str_encoding_paths():
    s = "snappy héllo " * 40
    comp = compat.compress(s, **CPU)  # utf-8 per python-snappy default
    assert comp == jcompat.compress(s)
    assert compat.uncompress(comp, decoding="utf-8", **CPU) == s
    assert compat.compress(s, "latin-1", **CPU) == jcompat.compress(
        s, "latin-1")
    with pytest.raises(TypeError, match="encoding"):
        compat.compress(s, None, **CPU)


def test_decompress_alias():
    assert compat.decompress is compat.uncompress


def test_uncompress_error_type():
    with pytest.raises(compat.UncompressError):
        compat.uncompress(b"\xff\xff\xff\xff\xff\xff", **CPU)


def test_is_valid_compressed():
    data = _text(1000)
    assert compat.isValidCompressed(compat.compress(data, **CPU), **CPU)
    assert not compat.isValidCompressed(b"\x05\x00garbage!", **CPU)
    assert not jcompat.isValidCompressed(b"\x05\x00garbage!")


# ---- framing stream classes ----

def test_stream_compressor_matches_framing_module():
    data = _text(200_000)
    c = compat.StreamCompressor(**CPU)
    out = c.add_chunk(data)
    assert c.flush() == b""
    assert out == jcompat.StreamCompressor().add_chunk(data)
    assert out == framing.compress(data, **CPU)
    assert framing.decompress(out, **CPU) == data
    if golden.available():
        assert golden.uncompress_framed(out) == data


def test_stream_compressor_multi_call_header_once():
    a, b = _text(70_000), _rand(1000)
    c = compat.StreamCompressor(**CPU)
    out = c.add_chunk(a) + c.compress(b)
    assert out.count(framing.STREAM_ID) == 1
    assert framing.decompress(out, **CPU) == a + b


def test_stream_decompressor_whole_and_dribbled():
    data = _text(180_000)
    framed = framing.compress(data, **CPU)
    d = compat.StreamDecompressor(**CPU)
    assert d.decompress(framed) == data
    assert d.flush() == b""
    # Byte-dribble: awkward slice sizes; the output concatenates exactly.
    d2 = compat.StreamDecompressor(**CPU)
    got, pos = b"", 0
    for step in (1, 3, 9, 100, 7777, 65536, len(framed)):
        got += d2.decompress(framed[pos: pos + step])
        pos += step
        if pos >= len(framed):
            break
    got += d2.decompress(framed[pos:])
    d2.flush()
    assert got == data


def test_stream_decompressor_reads_sidecars_and_foreign_streams():
    data = _text(130_000) + _rand(20_000)
    fr = framing.compress(data, sidecar="always", **CPU)
    assert compat.StreamDecompressor(**CPU).decompress(fr) == data
    if golden.available():
        native = golden.compress_framed(data)
        d = compat.StreamDecompressor(**CPU)
        assert d.decompress(native) + d.decompress(b"") == data


def test_stream_decompressor_truncated_flush_raises():
    framed = framing.compress(b"x" * 100, **CPU)
    d = compat.StreamDecompressor(**CPU)
    d.decompress(framed[:-3])
    with pytest.raises(compat.UncompressError):
        d.flush()


def test_stream_decompressor_crc_corruption():
    framed = bytearray(framing.compress(_text(50_000), **CPU))
    framed[len(framing.STREAM_ID) + 10] ^= 0xFF  # flip a payload byte
    d = compat.StreamDecompressor(**CPU)
    with pytest.raises(compat.UncompressError):
        d.decompress(bytes(framed))


def test_stream_decompressor_missing_stream_id_raises():
    d = compat.StreamDecompressor(**CPU)
    with pytest.raises(compat.UncompressError, match="identifier"):
        d.decompress(b"\x00" * 20)


def test_stream_classes_copy():
    c = compat.StreamCompressor(**CPU)
    first = c.add_chunk(b"abc" * 100)
    c2 = c.copy()
    # The copy continues the stream: no second header.
    assert framing.STREAM_ID not in c2.add_chunk(b"def")
    d = compat.StreamDecompressor(**CPU)
    d.decompress(first[:11])
    assert d.copy().decompress(first[11:]) == b"abc" * 100


def test_stream_file_helpers():
    data = _text(300_000)
    comp_f = io.BytesIO()
    compat.stream_compress(io.BytesIO(data), comp_f, **CPU)
    theirs = io.BytesIO()
    jcompat.stream_compress(io.BytesIO(data), theirs)
    assert comp_f.getvalue() == theirs.getvalue()
    out_f = io.BytesIO()
    compat.stream_decompress(io.BytesIO(comp_f.getvalue()), out_f, **CPU)
    assert out_f.getvalue() == data
    if golden.available():
        assert golden.uncompress_framed(comp_f.getvalue()) == data


def test_stream_decompressor_skippable_chunks():
    # Padding (0xFE) and reserved-skippable (>= 0x80) chunks may appear
    # anywhere after the stream id; the decompressor skips them.
    data = _text(70_000)
    framed = framing.compress(data, **CPU)
    head = len(framing.STREAM_ID)
    pad = bytes([framing.CHUNK_PADDING]) + (5).to_bytes(3, "little") + b"\0" * 5
    skp = bytes([0x93]) + (2).to_bytes(3, "little") + b"zz"
    spliced = framed[:head] + pad + framed[head:] + skp
    d = compat.StreamDecompressor(**CPU)
    assert d.decompress(spliced) == data
    assert d.flush() == b""


def test_stream_decompressor_reserved_unskippable_raises():
    framed = framing.compress(b"y" * 200, **CPU)
    head = len(framing.STREAM_ID)
    bad = (framed[:head]
           + bytes([0x40]) + (1).to_bytes(3, "little") + b"\0"
           + framed[head:])
    d = compat.StreamDecompressor(**CPU)
    with pytest.raises(compat.UncompressError):
        d.decompress(bad)


# ---- Hadoop container ----

def test_hadoop_round_trip_and_layout():
    data = _text(600_000)
    blob = hadoop.compress(data, **CPU)
    assert blob == jhadoop.compress(data)
    assert hadoop.decompress(blob, **CPU) == data
    # First block header: the big-endian uncompressed length of the block.
    assert int.from_bytes(blob[:4], "big") == hadoop.SNAPPY_BUFFER_SIZE_DEFAULT
    # Each subblock is a standard raw Snappy stream.
    clen = int.from_bytes(blob[4:8], "big")
    assert _raw_decode(blob[8: 8 + clen]) == \
        data[: hadoop.SNAPPY_BUFFER_SIZE_DEFAULT]


def test_hadoop_blocksize_and_tail():
    data = _rand(100_000) + _text(30_000)
    blob = hadoop.compress(data, blocksize=65536, **CPU)
    assert blob == jhadoop.compress(data, blocksize=65536)
    assert hadoop.decompress(blob, **CPU) == data


def test_hadoop_multi_subblock_decode():
    # General form: one block, two subblocks (as a differently configured
    # Hadoop writer could emit).
    a, b = _text(40_000), _rand(10_000)
    sub_a, sub_b = reference_codec.compress(a), reference_codec.compress(b)
    blob = (len(a + b).to_bytes(4, "big")
            + len(sub_a).to_bytes(4, "big") + sub_a
            + len(sub_b).to_bytes(4, "big") + sub_b)
    assert hadoop.decompress(blob, **CPU) == a + b


def test_hadoop_truncation_errors():
    blob = hadoop.compress(b"q" * 1000, **CPU)
    with pytest.raises(ValueError):
        hadoop.decompress(blob[:-1], **CPU)
    with pytest.raises(ValueError):
        hadoop.decompress(blob[:6], **CPU)
    bad = (2).to_bytes(4, "big") + hadoop.pack_block(b"abc", **CPU)[4:]
    with pytest.raises(ValueError, match="header said"):
        hadoop.decompress(bad, **CPU)


def test_hadoop_empty_input():
    assert hadoop.compress(b"", **CPU) == b""
    assert hadoop.decompress(b"", **CPU) == b""


def test_hadoop_exposed_via_compat():
    assert compat.hadoop_snappy is hadoop


def test_surfaces_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: compat.compress(b"x" * 100),
                 lambda: compat.uncompress(b"\x00"),
                 lambda: compat.isValidCompressed(b"\x00"),
                 compat.StreamCompressor, compat.StreamDecompressor,
                 lambda: hadoop.compress(b""),
                 lambda: hadoop.decompress(b"")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.gpu
def test_surfaces_on_the_card(cuda):
    data = _text(300_000)
    comp = compat.compress(data, device=cuda)
    assert comp == compat.compress(data, **CPU)
    assert compat.uncompress(comp, device=cuda) == data
    out = compat.StreamCompressor(device=cuda).add_chunk(data)
    assert out == framing.compress(data, **CPU)
    assert compat.StreamDecompressor(device=cuda).decompress(out) == data
    blob = hadoop.compress(data, device=cuda)
    assert blob == hadoop.compress(data, **CPU)
    assert hadoop.decompress(blob, device=cuda) == data
