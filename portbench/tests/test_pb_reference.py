"""The plain reference codec: hand-made streams of every element form
(copies that overlap their output among them), streams of the port's
encoders, the errors of broken streams, and the control that must fail
the checks."""

import numpy as np
import pytest

from portbench import reference


def _stream(total: int, body: bytes) -> bytes:
    return reference.varint(total) + body


KNOWN = [
    # literal "abcd", copy1 offset 4 length 4
    (_stream(8, b"\x0cabcd" + bytes([0x01, 0x04])), b"abcdabcd"),
    # literal "a", copy1 offset 1 length 11: the run overlaps itself
    (_stream(12, b"\x00a" + bytes([0x01 | 7 << 2, 0x01])), b"a" * 12),
    # literal "xyz", copy2 offset 3 length 10: period-3 overlap
    (_stream(13, b"\x08xyz" + bytes([0x02 | 9 << 2, 3, 0])),
     b"xyz" * 4 + b"x"),
    # copy4 offset 2 length 5 after "ab"
    (_stream(7, b"\x04ab" + bytes([0x03 | 4 << 2, 2, 0, 0, 0])),
     b"ababab" + b"a"),
    # a 100-byte literal (one length byte), a 300-byte one (two)
    (_stream(400, bytes([60 << 2, 99]) + bytes(range(100))
             + bytes([61 << 2, 43, 1]) + bytes(300)),
     bytes(range(100)) + bytes(300)),
    # copy1 with an offset above 255 (high bits in the tag)
    (_stream(304, bytes([61 << 2, 43, 1]) + bytes(range(256)) + bytes(44)
             + bytes([0x01 | 0 << 2 | 1 << 5, 0x2C])),
     bytes(range(256)) + bytes(44) + bytes(range(4))),
]


@pytest.mark.parametrize("stream,want", KNOWN)
def test_known_streams(stream, want):
    assert reference.decompress(stream) == want


@pytest.mark.parametrize("stream", [
    _stream(8, b"\x0cabc"),                        # literal past the end
    _stream(8, b"\x0cabcd" + bytes([0x01, 0x05])),  # offset past the start
    _stream(8, b"\x0cabcd" + bytes([0x01, 0x00])),  # offset 0
    _stream(9, b"\x0cabcd" + bytes([0x01, 0x04])),  # length mismatch
    _stream(8, b"\x0cabcd" + bytes([0x02, 0x04])),  # truncated copy2
])
def test_broken_streams_raise(stream):
    with pytest.raises(ValueError):
        reference.decompress(stream)


def _data(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(
        np.uint8)) for _ in range(300)]
    text = b" ".join(words[i % 300] for i in rng.zipf(1.3, n // 4))
    return (text[:n // 2] + b"z" * (n // 4)
            + rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes())


def test_port_streams_decode():
    from tpu_snappy_torch import api, reference_codec
    from tpu_snappy_torch.config import TURBO_CONFIG
    data = _data(3 << 16, 3)
    for stream in (reference_codec.compress(data),
                   api.compress(data, device="cpu"),
                   api.compress(data, TURBO_CONFIG, device="cpu")):
        assert reference.decompress(stream) == data


def test_compress_is_the_port_golden():
    from tpu_snappy_torch import reference_codec
    data = _data(150000, 4)
    assert reference.compress(data) == reference_codec.compress(data)


def test_control_fails_the_comparison():
    data = _data(3 << 16, 5)
    unverified = reference.compress_unverified(data)
    assert reference.mismatched(reference.decompress(unverified), data) > 0


def test_mismatched_counts_length_too():
    assert reference.mismatched(b"abc", b"abd") == 1
    assert reference.mismatched(b"abc", b"abcde") == 2
