"""Plain Snappy codec that the benchmark checks the program against.

Written from google/snappy's format_description.txt: a stream is the
uncompressed length as a little-endian base-128 varint, then elements. A
literal's tag carries its length - 1 (below 60) or, at 60-63, the number
of little-endian length bytes that follow (1-4); a copy takes 1 (length
4-11, 11-bit offset), 2 (length 1-64, 16-bit offset) or 4 (length 1-64,
32-bit offset) bytes after its tag, and may overlap its own output (an
offset below its length repeats the last `offset` bytes).

This module imports numpy alone: nothing of the program it judges. Its
decoder serves the checks (`decompress`); `compress_unverified`, its
encoder with the match test cut to the hash, is the control that must
fail them; `compress`, its greedy encoder, serves the tests.
"""

from __future__ import annotations

import numpy as np

BLOCK_SIZE = 1 << 16
MAX_COPY_LEN = 64
HASH_MUL = 0x1E35A7BD
HASH_BITS = 14


def varint(value: int) -> bytes:
    """The little-endian base-128 varint of `value`."""
    out = bytearray()
    while True:
        low, value = value & 0x7F, value >> 7
        if not value:
            out.append(low)
            return bytes(out)
        out.append(low | 0x80)


def read_varint(buf: bytes, pos: int = 0) -> tuple[int, int]:
    """(value, next position) of the varint at `pos` (at most 5 bytes)."""
    value = 0
    for i in range(5):
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    raise ValueError("varint longer than 5 bytes")


def decompress(stream) -> bytes:
    """Decode a raw Snappy stream, element after element. Raises
    ValueError on a stream that breaks the format: an element past the
    end, a copy from before the output's start or of offset 0, or an
    output whose length differs from the preamble."""
    buf = bytes(stream)
    total, pos = read_varint(buf)
    n = len(buf)
    out = bytearray()
    while pos < n:
        tag = buf[pos]
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length <= 60:
                pos += 1
            else:
                extra = length - 60
                length = int.from_bytes(buf[pos + 1:pos + 1 + extra],
                                        "little") + 1
                pos += 1 + extra
            if pos + length > n:
                raise ValueError("truncated literal")
            out += buf[pos:pos + length]
            pos += length
            continue
        width = (0, 2, 3, 5)[kind]
        if pos + width > n:
            raise ValueError("truncated copy")
        if kind == 1:
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | buf[pos + 1]
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos + 1:pos + width], "little")
        pos += width
        start = len(out) - offset
        if offset == 0 or start < 0:
            raise ValueError(f"copy offset {offset} at output {len(out)}")
        if offset >= length:
            out += out[start:start + length]
        else:  # overlaps its own output: the last `offset` bytes repeat
            out += (out[start:] * (length // offset + 1))[:length]
        if len(out) > total:
            raise ValueError("output longer than the preamble says")
    if len(out) != total:
        raise ValueError(f"preamble says {total} bytes, decoded {len(out)}")
    return bytes(out)


def _literal(out: bytearray, data, start: int, end: int) -> None:
    n = end - start - 1
    if n < 60:
        out.append(n << 2)
    else:
        size = (n.bit_length() + 7) // 8
        out.append((59 + size) << 2)
        out += n.to_bytes(size, "little")
    out += data[start:end]


def _copy(out: bytearray, offset: int, length: int) -> None:
    """Copy elements of `length` bytes at `offset` < 65536: 64-byte
    pieces while 68 or more remain, then 60 if more than 64 remain, so no
    piece is under 4 bytes (software Snappy's split)."""
    while length > 0:
        if length >= MAX_COPY_LEN + 4:
            piece = MAX_COPY_LEN
        elif length > MAX_COPY_LEN:
            piece = 60
        else:
            piece = length
        if piece <= 11 and offset < 2048:
            out += bytes((1 | (piece - 4) << 2 | (offset >> 8) << 5,
                          offset & 0xFF))
        else:
            out += bytes((2 | (piece - 1) << 2, offset & 0xFF, offset >> 8))
        length -= piece


def _compress(data, verify: bool) -> bytes:
    data = bytes(data)
    out = bytearray(varint(len(data)))
    shift = 32 - HASH_BITS
    for base in range(0, len(data), BLOCK_SIZE):
        block = data[base:base + BLOCK_SIZE]
        n = len(block)
        if n < 4:
            if n:
                _literal(out, block, 0, n)
            continue
        arr = np.frombuffer(block, dtype=np.uint8).astype(np.uint32)
        words = (arr[:-3] | arr[1:-2] << 8 | arr[2:-1] << 16
                 | arr[3:] << 24)
        hashes = ((words.astype(np.uint64) * HASH_MUL) & 0xFFFFFFFF) >> shift
        words, hashes = words.tolist(), hashes.tolist()
        table = [-1] * (1 << HASH_BITS)
        pos = lit = 0
        while pos <= n - 4:
            h = hashes[pos]
            cand = table[h]
            table[h] = pos
            if cand < 0 or (verify and words[cand] != words[pos]):
                pos += 1
                continue
            length = 4
            while (pos + length < n and length < 65536
                   and block[cand + length] == block[pos + length]):
                length += 1
            if pos > lit:
                _literal(out, block, lit, pos)
            _copy(out, pos - cand, length)
            pos += length
            lit = pos
        if lit < n:
            _literal(out, block, lit, n)
    return bytes(out)


def compress(data) -> bytes:
    """Greedy Snappy encoder: 64 KiB blocks, a 2^14-entry table of the
    last position of each hashed 4-byte word, a match taken where the
    word at that position equals the current one."""
    return _compress(data, verify=True)


def compress_unverified(data) -> bytes:
    """`compress` with the match test cut to the hash: a match is taken
    wherever the table holds an earlier position of the same hash, whether
    or not its bytes agree. It breaks the guarantee that a stream decodes
    to its input (the control of the compress cells)."""
    return _compress(data, verify=False)


def mismatched(got, want) -> int:
    """Bytes in which `got` differs from `want`: the positions both have
    that differ, and every byte one has beyond the other."""
    a = np.frombuffer(bytes(got), dtype=np.uint8)
    b = np.frombuffer(bytes(want), dtype=np.uint8)
    m = min(a.size, b.size)
    return int(np.count_nonzero(a[:m] != b[:m])) + abs(a.size - b.size)
