"""Sequential golden Snappy codec in pure Python.

The port's own copy of tpu_snappy/reference_codec.py (the port imports
nothing of the JAX package). It is the specification implementation:
simple, obviously correct and slow. The port uses it as the host codec
below one block, for fragments that fail device validation, and as a
golden that decodes the port's streams. The greedy parse inserts every
position into its hash table and splits copies as software Snappy does.
"""

from __future__ import annotations

from . import format as fmt


def compress(data: bytes, *, dense_table: bool = True) -> bytes:
    """Greedy Snappy compression, fragment by fragment.

    dense_table=True inserts every scanned position into the hash table
    (better ratio; what our TPU kernels do). dense_table=False emulates
    software Snappy's skip acceleration on incompressible data (insertions
    get sparser as misses accumulate), useful for ratio comparisons.
    """
    out = bytearray(fmt.varint_encode(len(data)))
    for start in range(0, len(data), fmt.BLOCK_SIZE):
        _compress_block(data[start:start + fmt.BLOCK_SIZE], out, dense_table)
    return bytes(out)


def _compress_block(block: bytes, out: bytearray, dense_table: bool) -> None:
    n = len(block)
    if n < fmt.MIN_MATCH:
        if n:
            out += fmt.literal_header(n)
            out += block
        return

    bits = fmt.hash_table_bits(n)
    shift = 32 - bits
    table = [-1] * (1 << bits)

    def u32(i: int) -> int:
        return int.from_bytes(block[i:i + 4], "little")

    pos = 0
    literal_start = 0
    skip = 32  # skip accelerator state (software Snappy heuristic)
    limit = n - fmt.MIN_MATCH  # last position where a 4-byte load is valid
    while pos <= limit:
        cur = u32(pos)
        h = fmt.snappy_hash(cur, shift)
        cand = table[h]
        table[h] = pos
        if cand >= 0 and u32(cand) == cur:
            # Emit pending literal run.
            if pos > literal_start:
                out += fmt.literal_header(pos - literal_start)
                out += block[literal_start:pos]
            # Extend the match.
            length = 4
            while pos + length < n and block[cand + length] == block[pos + length]:
                length += 1
            offset = pos - cand
            for frag in fmt.copy_fragment_lengths(length):
                out += fmt.copy_element(offset, frag)
            pos += length
            literal_start = pos
            skip = 32
        else:
            if dense_table:
                pos += 1
            else:
                pos += skip >> 5
                skip += 1
    if literal_start < n:
        out += fmt.literal_header(n - literal_start)
        out += block[literal_start:]


def decompress(buf: bytes) -> bytes:
    """Strict sequential Snappy decoder (validates the stream)."""
    expected, pos = fmt.varint_decode(buf)
    out = bytearray()
    decompress_elements(buf, pos, len(buf), out)
    if len(out) != expected:
        raise ValueError(f"length mismatch: preamble {expected}, decoded {len(out)}")
    return bytes(out)


def decompress_elements(buf: bytes, pos: int, end: int,
                        out: bytearray) -> None:
    """Decode raw Snappy elements buf[pos:end] (no preamble), appending to
    `out`. Copies may reference bytes already in `out` — this is the
    fragment-granular host fallback: a single failed fragment re-decodes
    with the already-decoded prefix as context instead of re-decoding the
    whole stream. Raises ValueError on malformed input."""
    n = end
    while pos < n:
        tag = buf[pos]
        kind = tag & 3
        if kind == fmt.TAG_LITERAL:
            code = tag >> 2
            if code < 60:
                length = code + 1
                pos += 1
            else:
                extra = code - 59  # 1..4 extra length bytes
                if pos + 1 + extra > n:
                    raise ValueError("truncated literal length")
                length = int.from_bytes(buf[pos + 1:pos + 1 + extra], "little") + 1
                pos += 1 + extra
            if pos + length > n:
                raise ValueError("truncated literal payload")
            out += buf[pos:pos + length]
            pos += length
        else:
            if kind == fmt.TAG_COPY1:
                if pos + 2 > n:
                    raise ValueError("truncated copy1")
                length = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | buf[pos + 1]
                pos += 2
            elif kind == fmt.TAG_COPY2:
                if pos + 3 > n:
                    raise ValueError("truncated copy2")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos + 1:pos + 3], "little")
                pos += 3
            else:
                if pos + 5 > n:
                    raise ValueError("truncated copy4")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[pos + 1:pos + 5], "little")
                pos += 5
            if offset == 0 or offset > len(out):
                raise ValueError(f"invalid copy offset {offset} at output {len(out)}")
            # Byte-by-byte to honor overlapping (offset < length) RLE semantics.
            src = len(out) - offset
            for i in range(length):
                out.append(out[src + i])
