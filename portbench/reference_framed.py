"""Plain Snappy framing-format codec that the benchmark checks the
program's framed streams against.

Written from google/snappy's framing_format.txt. A stream is the stream
identifier chunk (type 0xff, length 6, "sNaPpY"), then chunks of a type
byte and a 3-byte little-endian length. A compressed data chunk (0x00)
holds the masked CRC-32C of its uncompressed bytes, then a raw Snappy
stream of them (format_description.txt, decoded by reference.py); an
uncompressed one (0x01) the masked CRC, then the bytes; neither holds
more than 65536 uncompressed bytes. Types 0x02-0x7f are reserved and
unskippable: a decoder refuses them. 0x80-0xfd are reserved and
skippable, 0xfe is padding: a decoder skips them. The CRC is CRC-32C,
the reflected Castagnoli polynomial 0x82F63B78, masked as section 3
says: rotated right by 15 bits, plus 0xa282ead8.

The program writes its decode sidecars into two of the skippable types,
each right before the compressed chunk it describes. A 0x80 root map
(magic "tpS1", a u32 piece count P, u16 starts, u16 roots, the slopes as
a bitset, most significant bit first) says out[i] = elems[root[p] +
slope[p] * (i - start[p])] for i from start[p] to the next start, over
the chunk's element bytes; `check` holds every output byte of the chunk
to it. A 0x81 payload holds depth hints (magic "tpD1", u32 tail_cap, u16
tile, the tile count, a flags byte of 1, one byte a tile); `check` holds
its structure to the configuration's tail_cap and tile, and not its
depths. That is a departure: a wrong hint costs the program a re-decode
on its normal path and no wrong byte (the chunk's CRC gates every
decoded byte), and checking the depths would mean restating the
program's decoder here.

The configuration's sidecar policy is part of the stream: under "auto"
(and "always") a root map goes where it costs at most the configured
fraction of its chunk, else depth hints where they do, and depth hints
always can for a well-formed chunk. So every compressed chunk long
enough for a depth-hint chunk to fit the fraction has one of the two
right before it, and `check` counts each that has none.

This module imports numpy and reference.py alone: nothing of the program
it judges. `check` serves the framed cells' checks; `compress`, its
framed encoder, serves the tests, and with its CRCs written unmasked is
the control that must fail them.
"""

from __future__ import annotations

import numpy as np

from . import reference

STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
COMPRESSED, UNCOMPRESSED = 0x00, 0x01
ROOT_MAP, DEPTH_HINTS = 0x80, 0x81
#: Most uncompressed bytes of a data chunk.
MAX_CHUNK = 65536
POLY = 0x82F63B78
MASK_DELTA = 0xA282EAD8
ROOT_MAGIC, DEPTH_MAGIC = b"tpS1", b"tpD1"

#: Bytes of a piece that the CRC's first pass runs through in one lane.
SEGMENT = 4096


def _tables() -> np.ndarray:
    """(4, 256) slice-by-4 tables. Row 0: the register after one byte, for
    each value of its low byte XOR the input byte (eight shifts of the
    reflected polynomial); row k: after that byte and k zero bytes."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(POLY), t >> 1)
    rows = [t.astype(np.uint32)]
    for _ in range(3):
        rows.append((rows[-1] >> 8) ^ rows[0][rows[-1] & 0xFF])
    return np.stack(rows)


TABLES = _tables()


def _words(reg: np.ndarray, words: np.ndarray) -> np.ndarray:
    """The registers after one little-endian 4-byte word each."""
    x = reg ^ words
    return (TABLES[3][x & 0xFF] ^ TABLES[2][(x >> 8) & 0xFF]
            ^ TABLES[1][(x >> 16) & 0xFF] ^ TABLES[0][x >> 24])


def _zeros_tables(n: int) -> np.ndarray:
    """(4, 256): the register after `n` zero bytes (a multiple of 4) from
    a register that holds value v in byte k and zeros elsewhere. Zero
    bytes act on the register linearly, so the four lookups of its bytes,
    XORed, give any register's."""
    c = (np.arange(256, dtype=np.uint32)[None, :]
         << (8 * np.arange(4, dtype=np.uint32))[:, None])
    zero = np.zeros_like(c)
    for _ in range(n // 4):
        c = _words(c, zero)
    return c


ZEROS = _zeros_tables(SEGMENT)


def crc32c(pieces: list) -> np.ndarray:
    """CRC-32C of each piece (at most MAX_CHUNK bytes), all at once.

    The pieces sit right-aligned in rows of whole segments: zero bytes
    before a piece leave a register of 0 at 0. The initial register
    0xFFFFFFFF is the same as a register of 0 with the piece's first four
    bytes complemented (its excess for a piece under four bytes is put
    back at the end). A first pass runs every segment of every row in its
    own lane, a word at a time through the tables; a second carries each
    row's register across its segments: the register after a segment's
    zero bytes (ZEROS) XOR the segment's own."""
    if not len(pieces):
        return np.zeros(0, np.uint32)
    lengths = np.array([len(p) for p in pieces], dtype=np.int64)
    width = SEGMENT * max(1, -(-int(lengths.max()) // SEGMENT))
    rows = np.zeros((len(pieces), width), np.uint8)
    for row, piece in zip(rows, pieces):
        if len(piece):
            row[width - len(piece):] = np.frombuffer(bytes(piece), np.uint8)
    for k in range(4):
        at = np.flatnonzero(lengths > k)
        rows[at, width - lengths[at] + k] ^= 0xFF
    lanes = np.ascontiguousarray(
        rows.view("<u4").reshape(-1, SEGMENT // 4).T)
    reg = np.zeros(lanes.shape[1], np.uint32)
    for words in lanes:
        reg = _words(reg, words)
    reg = reg.reshape(len(pieces), -1)
    acc = reg[:, 0]
    for s in range(1, reg.shape[1]):
        acc = (ZEROS[0][acc & 0xFF] ^ ZEROS[1][(acc >> 8) & 0xFF]
               ^ ZEROS[2][(acc >> 16) & 0xFF] ^ ZEROS[3][acc >> 24]
               ^ reg[:, s])
    short = np.minimum(lengths, 4)
    acc ^= (np.uint64(0xFFFFFFFF) >> (8 * short).astype(np.uint64)).astype(
        np.uint32)
    return acc ^ np.uint32(0xFFFFFFFF)


def mask(crc: np.ndarray) -> np.ndarray:
    """Section 3's masking of each CRC."""
    crc = np.asarray(crc, dtype=np.uint32)
    return ((crc >> 15) | (crc << 17)) + np.uint32(MASK_DELTA)


def parse(stream) -> list:
    """(type, body) of every data chunk and every 0x80 or 0x81 chunk, in
    order. Raises ValueError where the stream breaks the format: no
    stream identifier first, a truncated chunk, a repeated identifier
    unlike the first, a data chunk shorter than its CRC or an
    uncompressed one over MAX_CHUNK bytes, or a reserved unskippable
    type."""
    buf = bytes(stream)
    if not buf.startswith(STREAM_ID):
        raise ValueError("the stream does not open with its identifier")
    chunks, pos = [], len(STREAM_ID)
    while pos < len(buf):
        if pos + 4 > len(buf):
            raise ValueError(f"truncated chunk header at {pos}")
        kind = buf[pos]
        end = pos + 4 + int.from_bytes(buf[pos + 1:pos + 4], "little")
        if end > len(buf):
            raise ValueError(f"truncated chunk at {pos}")
        body = buf[pos + 4:end]
        if kind == STREAM_ID[0]:
            if buf[pos:end] != STREAM_ID:
                raise ValueError(f"bad repeated stream identifier at {pos}")
        elif kind in (COMPRESSED, UNCOMPRESSED):
            if len(body) < 4:
                raise ValueError(f"data chunk without its CRC at {pos}")
            if kind == UNCOMPRESSED and len(body) - 4 > MAX_CHUNK:
                raise ValueError(f"uncompressed chunk over 65536 at {pos}")
            chunks.append((kind, body))
        elif kind < 0x80:
            raise ValueError(f"reserved unskippable chunk type {kind:#x}")
        elif kind in (ROOT_MAP, DEPTH_HINTS):
            chunks.append((kind, body))
        pos = end
    return chunks


def _elements(body: bytes):
    """(uncompressed length, element bytes) of a compressed chunk's body,
    or None where its length varint does not read."""
    try:
        ulen, at = reference.read_varint(body, 4)
    except ValueError:
        return None
    return ulen, body[at:]


def _decode(kind: int, body: bytes):
    """A data chunk's uncompressed bytes, or None where it does not
    decode or holds more than MAX_CHUNK bytes."""
    if kind == UNCOMPRESSED:
        return body[4:]
    try:
        piece = reference.decompress(body[4:])
    except ValueError:
        return None
    return piece if len(piece) <= MAX_CHUNK else None


def root_map_holds(payload: bytes, elems: bytes, out: bytes) -> bool:
    """Whether a 0x80 payload is well formed and gives every byte of the
    chunk's output `out` from its element bytes `elems`."""
    if len(payload) < 8 or payload[:4] != ROOT_MAGIC:
        return False
    count = int.from_bytes(payload[4:8], "little")
    if count == 0 or len(payload) != 8 + 4 * count + -(-count // 8):
        return False
    starts = np.frombuffer(payload, "<u2", count, 8).astype(np.int64)
    roots = np.frombuffer(payload, "<u2", count, 8 + 2 * count).astype(
        np.int64)
    slopes = np.unpackbits(np.frombuffer(payload, np.uint8,
                                         offset=8 + 4 * count))[:count]
    if (starts[0] != 0 or (np.diff(starts) <= 0).any()
            or starts[-1] >= max(len(out), 1)):
        return False
    i = np.arange(len(out))
    p = np.searchsorted(starts, i, side="right") - 1
    src = roots[p] + slopes[p] * (i - starts[p])
    if (src >= len(elems)).any():
        return False
    return bool((np.frombuffer(elems, np.uint8)[src]
                 == np.frombuffer(out, np.uint8)).all())


def depth_hints_hold(payload: bytes, tail_cap: int, tile: int) -> bool:
    """Whether a 0x81 payload is well formed for the configuration's
    `tail_cap` and `tile` (its depths are not checked: module
    docstring)."""
    tiles = MAX_CHUNK // tile
    return (len(payload) == 12 + tiles and payload[:4] == DEPTH_MAGIC
            and int.from_bytes(payload[4:8], "little") == tail_cap
            and int.from_bytes(payload[8:10], "little") == tile
            and payload[10] == tiles & 0xFF and payload[11] == 1)


def sidecar_floor(container: dict):
    """The fewest uncompressed bytes of a compressed chunk that the
    configuration's `container` block promises a sidecar before: where a
    depth-hint chunk (4 + 12 bytes and one a tile) is at most
    `sidecar_auto_frac` of the chunk. None under policy "off"."""
    if container["sidecar"] == "off":
        return None
    frac = container["sidecar_auto_frac"]
    hints = 16 + MAX_CHUNK // container["depth_hints"]["tile"]
    n = int(hints / frac)
    while hints > frac * n:
        n += 1
    return n


def check(stream, want: bytes, container: dict) -> tuple:
    """(mismatched bytes, bad sidecars, missing sidecars) of a framed
    stream of `want` under the configuration's `container` block.

    A data chunk that does not decode or whose CRC is not the masked
    CRC-32C of its bytes counts every byte it stands for as wrong (its
    decoded length, or its length varint's where it does not decode);
    the others count the bytes unlike `want` at their place, and bytes
    `want` has beyond the last chunk count too. A stream that does not
    parse counts the whole of `want`. A 0x80 or 0x81 chunk is bad where
    the next data chunk is not a compressed one that decodes, or where
    root_map_holds or depth_hints_hold (at the container's tail_cap and
    tile) fails. A sidecar is missing where a compressed chunk of at
    least sidecar_floor bytes has no 0x80 or 0x81 chunk right before
    it."""
    hints = container["depth_hints"]
    tail_cap, tile = hints["tail_cap"], hints["tile"]
    floor = sidecar_floor(container)
    try:
        chunks = parse(stream)
    except ValueError:
        return len(want), 0, 0
    out = {j: _decode(kind, body) for j, (kind, body) in enumerate(chunks)
           if kind in (COMPRESSED, UNCOMPRESSED)}
    done = [j for j in out if out[j] is not None]
    sums = dict(zip(done, mask(crc32c([out[j] for j in done])).tolist()))
    wrong, missing, pos = 0, 0, 0
    for j in out:
        kind, body = chunks[j]
        if out[j] is None:
            head = _elements(body)
            size = head[0] if head and head[0] <= MAX_CHUNK else 0
            wrong += size
        else:
            size = len(out[j])
            if sums[j] != int.from_bytes(body[:4], "little"):
                wrong += size
            else:
                wrong += reference.mismatched(out[j], want[pos:pos + size])
        missing += (kind == COMPRESSED and floor is not None
                    and size >= floor
                    and (j == 0 or chunks[j - 1][0] not in (ROOT_MAP,
                                                            DEPTH_HINTS)))
        pos += size
    wrong += max(0, len(want) - pos)

    bad = 0
    for j, (kind, body) in enumerate(chunks):
        if kind not in (ROOT_MAP, DEPTH_HINTS):
            continue
        nxt = next((i for i in range(j + 1, len(chunks)) if i in out),
                   None)
        if (nxt is None or chunks[nxt][0] != COMPRESSED
                or out[nxt] is None):
            bad += 1
        elif kind == ROOT_MAP:
            bad += not root_map_holds(body, _elements(chunks[nxt][1])[1],
                                      out[nxt])
        else:
            bad += not depth_hints_hold(body, tail_cap, tile)
    return wrong, bad, missing


def compress(data, masked: bool = True) -> bytes:
    """A framed stream of `data`: one data chunk a 64 KiB block, each
    compressed by reference.compress where that is shorter, else stored,
    with no sidecars. masked=False writes each chunk's CRC unmasked,
    which breaks section 3 (the control of the framed cells)."""
    data = bytes(data)
    blocks = [data[i:i + MAX_CHUNK] for i in range(0, len(data), MAX_CHUNK)]
    crcs = crc32c(blocks)
    if masked:
        crcs = mask(crcs)
    parts = [STREAM_ID]
    for block, crc in zip(blocks, crcs.tolist()):
        comp = reference.compress(block)
        kind, payload = ((COMPRESSED, comp) if len(comp) < len(block)
                         else (UNCOMPRESSED, block))
        body = crc.to_bytes(4, "little") + payload
        parts.append(bytes([kind]) + len(body).to_bytes(3, "little") + body)
    return b"".join(parts)
