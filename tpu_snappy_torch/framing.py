"""Snappy framing format, the official streaming container (port of
tpu_snappy/framing.py).

Spec: google/snappy framing_format.txt — a stream identifier, then chunks
of at most 65536 uncompressed bytes, each data chunk carrying the masked
CRC-32C of its uncompressed bytes. One 64 KB block is one chunk, so the
port's block encoder and fragment decoder run the container with no
re-batching. The encoder may put a decode sidecar (sidecar.py) before each
compressed chunk: a 0x80 root map or 0x81 depth hints, both skippable by
spec.

Entry points, in the JAX package's argument order: `compress(data, cfg,
mesh, sidecar="off" | "auto" | "always")`, `decompress(framed, cfg, mesh,
use_sidecar=True)` (and `decompress_with_stats`), and the streaming forms
`compress_stream(src, dst, total_len, mesh, blocks_per_wave, cfg,
sidecar)` / `decompress_stream(src, dst, mesh, chunks_per_wave, cfg,
use_sidecar)`; `device` is keyword-only after them. They run on
the CUDA card unless the caller passes `device="cpu"`; with no CUDA device
visible, the default raises. The block encode and each of the three
decode paths (root map, hinted, normal) run through the sharded codec
(parallel.shard) over `mesh=` (parallel.mesh), whose devices take the
place of `device`; without one, over one shard on `device`. Any mesh
gives the same bytes and the same chunks on each path. The output bytes
are the JAX package's at
the same `cfg` (the encoder's knobs; chunks stay 64 KB blocks whatever
cfg.block_size says, as in the JAX package). The decoders take `cfg` for
the JAX signature; no decode depends on it.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import numpy as np

from . import api
from . import format as fmt
from . import reference_codec
from . import sidecar as sc
from .config import CodecConfig, DEFAULT_CONFIG
from .ops import decode as ops_decode
from .parallel import mesh as meshlib
from .parallel import shard
from .utils import profiling

#: Chunk types (framing_format.txt section 4).
CHUNK_STREAM_ID = 0xFF
CHUNK_COMPRESSED = 0x00
CHUNK_UNCOMPRESSED = 0x01
CHUNK_PADDING = 0xFE
#: Skippable chunks carrying the decode sidecars: 0x80 root map, 0x81
#: depth hints.
CHUNK_SIDECAR = sc.CHUNK_TYPE
CHUNK_DEPTH = sc.DEPTH_CHUNK_TYPE

STREAM_ID = b"\xff\x06\x00\x00sNaPpY"

#: "auto" sidecar policy: emit a sidecar only when it costs at most this
#: fraction of the chunk's uncompressed size (framing.py:46).
SIDECAR_AUTO_FRAC = 0.03

#: Most uncompressed bytes of a data chunk (spec-fixed; the block size).
MAX_CHUNK = 65536

POLICIES = ("off", "auto", "always")


# ---- CRC-32C (Castagnoli): numpy slice-by-8, batched across chunks ----
# (the decoder's checks; the encoder's run on the shards' devices,
# ops/kernels/crc.py)

def _make_tables() -> np.ndarray:
    t = np.zeros((8, 256), dtype=np.uint32)
    poly = np.uint32(0x82F63B78)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (poly if c & np.uint32(1)
                                       else np.uint32(0))
        t[0, i] = c
    for j in range(1, 8):
        t[j] = (t[j - 1] >> np.uint32(8)) ^ t[0, t[j - 1] & np.uint32(0xFF)]
    return t


_T = _make_tables()


def crc32c(data: bytes | np.ndarray) -> int:
    """CRC-32C of one buffer (unmasked): the native slice-by-8 C path where
    the golden library builds (the numpy form below pays its word loop
    once per call, slow for one row), else the numpy form."""
    golden = ops_decode.native_golden()
    if golden is not None:
        return golden.crc32c(bytes(data))
    arr = np.frombuffer(bytes(data), dtype=np.uint8).reshape(1, -1)
    return int(crc32c_batch(arr)[0])


def crc32c_batch(rows: np.ndarray) -> np.ndarray:
    """CRC-32C of every row of a (C, L) uint8 matrix in one vectorized
    pass (slice-by-8 over little-endian u32 words)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    c = np.full(rows.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    length = rows.shape[1]
    k8 = length // 8 * 8
    if k8:
        w = (rows[:, :k8].reshape(-1).view(np.dtype("<u4"))
             .reshape(rows.shape[0], -1))
        t0, t1, t2, t3, t4, t5, t6, t7 = _T
        m = np.uint32(0xFF)
        for j in range(0, w.shape[1], 2):
            lo = w[:, j] ^ c
            hi = w[:, j + 1]
            c = (t7[lo & m] ^ t6[(lo >> np.uint32(8)) & m]
                 ^ t5[(lo >> np.uint32(16)) & m] ^ t4[lo >> np.uint32(24)]
                 ^ t3[hi & m] ^ t2[(hi >> np.uint32(8)) & m]
                 ^ t1[(hi >> np.uint32(16)) & m] ^ t0[hi >> np.uint32(24)])
    for j in range(k8, length):
        c = (c >> np.uint32(8)) ^ _T[0, (c ^ rows[:, j]) & np.uint32(0xFF)]
    return c ^ np.uint32(0xFFFFFFFF)


def mask(crc: int) -> int:
    """The spec's CRC masking (rotate right by 15, add a constant)."""
    crc &= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def unmask(m: int) -> int:
    c = (m - 0xA282EAD8) & 0xFFFFFFFF
    return ((c >> 17) | (c << 15)) & 0xFFFFFFFF


# ---- encode ----

def _sidecar_chunk(elems: bytes, blen: int, policy: str) -> bytes:
    """Sidecar chunk bytes for one compressed chunk (b"" when the policy
    declines or the stream is unrepresentable): "always" emits the 0x80
    root map wherever representable; "auto" emits the root map where it
    costs at most SIDECAR_AUTO_FRAC of the chunk, else the 0x81 depth
    hints where they do (both fall through to the hints)."""
    if policy == "off":
        return b""
    payload = sc.build(elems, blen)
    if payload is not None and (
            policy == "always"
            or len(payload) + 4 <= SIDECAR_AUTO_FRAC * blen):
        return (bytes([CHUNK_SIDECAR]) + len(payload).to_bytes(3, "little")
                + payload)
    dp = sc.build_depth(elems, blen)
    if dp is not None and len(dp) + 4 <= SIDECAR_AUTO_FRAC * blen:
        return bytes([CHUNK_DEPTH]) + len(dp).to_bytes(3, "little") + dp
    return b""


def _split(buf: bytes, lens) -> list[bytes]:
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [buf[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


def _encode_blocks(blocks: np.ndarray, lengths: np.ndarray, mesh,
                   cfg: CodecConfig, *, crcs: bool = True):
    """Element bytes of every block, encoded at `cfg` sharded over `mesh`
    (shard.encode_rows: waves of api.API_WAVE blocks a shard, compacted on
    the device, so the host fetches dense payload), and every block's
    CRC-32C, computed on the shards' devices from the same rows (None
    where the caller needs no CRC: a server wave of raw requests only)."""
    out = shard.encode_rows(blocks, lengths, mesh, cfg, crcs=crcs)
    return _split(*out[:2]), (out[2] if crcs else None)


def _sidecars(lengths, elems_list, policy: str) -> list:
    """Every block's sidecar chunk bytes (b"" where the policy declines),
    or None for a block stored uncompressed: one whose compressed payload
    (varint length and elements) would not be shorter than the block."""
    return [None if len(fmt.varint_encode(blen)) + len(elems) >= blen
            else _sidecar_chunk(elems, blen, policy)
            for elems, blen in zip(elems_list, (int(n) for n in lengths))]


def _assemble(raw: bytes, lengths, elems_list, crcs, sidecars) -> bytes:
    """The data chunks of consecutive blocks, each compressed one after
    its sidecar: headers, masked CRCs and the join."""
    parts = []
    pos = 0
    for blen, elems, crc, side in zip((int(n) for n in lengths),
                                      elems_list, crcs, sidecars):
        if side is None:
            body = mask(crc).to_bytes(4, "little") + raw[pos:pos + blen]
            parts.append(bytes([CHUNK_UNCOMPRESSED])
                         + len(body).to_bytes(3, "little") + body)
        else:
            parts.append(side)
            body = (mask(crc).to_bytes(4, "little")
                    + fmt.varint_encode(blen) + elems)
            parts.append(bytes([CHUNK_COMPRESSED])
                         + len(body).to_bytes(3, "little") + body)
        pos += blen
    return b"".join(parts)


def _chunks(raw: bytes, lengths, elems_list, crcs, policy: str) -> bytes:
    """The data chunks (each with its sidecar) of consecutive blocks, in
    three stages, each in its span: the CRCs (what is left of them on the
    host: `crcs`, every block's CRC-32C, taken as ints), the sidecars, the
    assembly."""
    with profiling.span("framing.crc"):
        crcs = [int(c) for c in crcs]
    with profiling.span("framing.sidecar"):
        sides = _sidecars(lengths, elems_list, policy)
    with profiling.span("framing.assemble"):
        return _assemble(raw, lengths, elems_list, crcs, sides)


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"sidecar {policy!r}: one of {POLICIES}")


def _check_kinds(cfg, mesh, **flags) -> None:
    """Raise TypeError, naming the argument, for a value of the wrong kind
    in a positional slot of the JAX package's order (framing.py there):
    `cfg` a CodecConfig, `mesh` None or a Mesh, a flag a bool, a wave
    size an int (_check_policy vets the sidecar policy). A call in an
    older order (a policy, a flag or a mesh where `cfg` or `mesh` now
    stands) raises here instead of binding silently."""
    if not isinstance(cfg, CodecConfig):
        raise TypeError(f"cfg: expected a CodecConfig, got {cfg!r}")
    if mesh is not None and not isinstance(mesh, meshlib.Mesh):
        raise TypeError(f"mesh: expected None or a Mesh, got {mesh!r}")
    kinds = {"use_sidecar": bool, "blocks_per_wave": int,
             "chunks_per_wave": int}
    for name, value in flags.items():
        kind = kinds[name]
        if not isinstance(value, kind) or (kind is int
                                           and isinstance(value, bool)):
            raise TypeError(f"{name}: expected a {kind.__name__}, got "
                            f"{value!r}")


def _mesh(device, mesh):
    """The mesh to run on: `mesh`, or one shard on `device` (which raises
    for CUDA when no card is visible)."""
    return meshlib.make_mesh(1, device=device) if mesh is None else mesh


def compress(data: bytes, cfg: CodecConfig = DEFAULT_CONFIG, mesh=None,
             sidecar: str = "off", *, device="cuda") -> bytes:
    """Compress to a framed stream: one data chunk per 64 KB block, every
    block encoded at `cfg` sharded over `mesh` (default: one shard on
    `device`) in waves of api.API_WAVE blocks a shard; a chunk is stored
    uncompressed where compression would not shrink it. `sidecar` ("off",
    "auto" or "always") puts a decode sidecar before each compressed chunk
    (see _sidecar_chunk). The arguments take the JAX package's order."""
    _check_kinds(cfg, mesh)
    _check_policy(sidecar)
    with profiling.span("framing.compress"):
        mesh = _mesh(device, mesh)
        if not data:
            return STREAM_ID
        with profiling.span("framing.encode"):
            blocks, lengths = api._to_blocks(data)
            elems_list, crcs = _encode_blocks(blocks, lengths, mesh, cfg)
        return STREAM_ID + _chunks(data, lengths, elems_list, crcs, sidecar)


def compress_stream(src, dst, total_len: int, mesh=None,
                    blocks_per_wave: int = 64,
                    cfg: CodecConfig = DEFAULT_CONFIG, sidecar: str = "off",
                    *, device="cuda") -> int:
    """Stream `total_len` bytes from src into a framed stream on dst, in
    waves of `blocks_per_wave` blocks, each sharded over `mesh` (default:
    one shard on `device`); byte-identical to compress() on the whole
    input. The chunk assembly of one wave overlaps the next wave's encode
    on a worker thread. Returns the bytes written. The arguments take the
    JAX package's order."""
    _check_kinds(cfg, mesh, blocks_per_wave=blocks_per_wave)
    _check_policy(sidecar)
    mesh = _mesh(device, mesh)
    dst.write(STREAM_ID)
    written = len(STREAM_ID)
    remaining = total_len

    def assemble(raw, elems_list, crcs, lengths):
        blob = _chunks(raw, lengths, elems_list, crcs, sidecar)
        dst.write(blob)
        return len(blob)

    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        while remaining > 0:
            take = min(blocks_per_wave * MAX_CHUNK, remaining)
            raw = src.read(take)
            if len(raw) != take:
                raise IOError("short read from source")
            remaining -= take
            blocks, lengths = api._to_blocks(raw)
            elems_list, crcs = _encode_blocks(blocks, lengths, mesh, cfg)
            if fut is not None:
                written += fut.result()
            fut = pool.submit(assemble, raw, elems_list, crcs, lengths)
        if fut is not None:
            written += fut.result()
    return written


# ---- decode ----

@dataclasses.dataclass
class FramedStats:
    """What a framed decode did with its compressed chunks."""
    root_map: int = 0     # decoded from their 0x80 root map
    hinted: int = 0       # decoded with their 0x81 depth hints
    normal: int = 0       # decoded by the fragment decoder, no sidecar
    host: int = 0         # of those, settled by the host codec (ok=False)
    redecoded_root_map: int = 0  # 0x80 result failed ok or CRC: re-decoded
    redecoded_hinted: int = 0    # 0x81 result failed ok or CRC: re-decoded
    uncompressed: int = 0  # stored chunks
    #: Dense doubling rounds of each fragment-decoder wave (hinted waves
    #: first, then normal ones).
    dense_rounds: list = dataclasses.field(default_factory=list)


def _parse_chunks(framed: bytes):
    """Split a framed stream into (type, payload offset, payload length)
    entries, validating its structure."""
    if not framed.startswith(STREAM_ID):
        raise ValueError("missing stream identifier chunk")
    chunks = []
    ip, n = len(STREAM_ID), len(framed)
    while ip < n:
        if ip + 4 > n:
            raise ValueError("truncated chunk header")
        typ = framed[ip]
        ln = int.from_bytes(framed[ip + 1: ip + 4], "little")
        ip += 4
        if ip + ln > n:
            raise ValueError("truncated chunk payload")
        if typ == CHUNK_STREAM_ID:
            if framed[ip - 4: ip + ln] != STREAM_ID:
                raise ValueError("malformed repeated stream identifier")
        elif typ in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            if ln < 4:
                raise ValueError("data chunk shorter than its checksum")
            chunks.append((typ, ip, ln))
        elif typ in (CHUNK_SIDECAR, CHUNK_DEPTH):
            chunks.append((typ, ip, ln))  # paired with the next data chunk
        elif typ == CHUNK_PADDING or typ >= 0x80:
            pass  # skippable
        else:
            raise ValueError(f"reserved unskippable chunk type {typ:#x}")
        ip += ln
    return chunks


def _want_crc(body: bytes) -> int:
    return unmask(int.from_bytes(body[:4], "little"))


def _head(body: bytes):
    """(ulen, element bytes) of a compressed chunk body, or None when its
    length varint is malformed or out of range."""
    try:
        ulen, vstart = fmt.varint_decode(body[4:])
    except ValueError:
        return None
    if not 0 < ulen <= MAX_CHUNK:
        return None
    return ulen, body[4 + vstart:]


def _pad_rows(arrays, pad: int) -> list:
    return [np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
            for a in arrays]


def _decode_wave(n: int, arrays, mesh, sharded):
    """One wave of n chunks: sharded(mesh, *arrays(pad), wave) with the
    rows padded to the mesh's layout (shard.layout). arrays(pad) gives the
    wave's numpy arrays with `pad` padding rows. Returns numpy (out (n,
    65536), ok (n,)) and the list of dense rounds the decoder launched."""
    wave, padded = shard.layout(n, mesh.size)
    out, ok, rounds = sharded(mesh, *arrays(padded - n), wave)
    return out[:n], ok[:n], rounds


def _decode_sidecar_chunks(bodies, side_for, comp_idx, out_parts, mesh,
                           stats: FramedStats):
    """Root-map decode of the compressed chunks with a usable 0x80 sidecar,
    in waves of api.API_WAVE chunks (one wrows bucket a wave, the largest
    any of its chunks needs), each sharded over `mesh`.
    Fills out_parts for every chunk whose bytes pass ok and the chunk CRC;
    returns the indices still to decode (no or unusable sidecar, or a
    miss: the sidecar is only a hint)."""
    jobs, rest = [], []
    for i in comp_idx:
        job = None
        head = _head(bodies[i][1]) if i in side_for else None
        if head is not None and len(head[1]) < sc.OUT:
            parsed = sc.parse(side_for[i])
            if parsed is not None:
                prep = sc.prep_parent(*parsed, head[0])
                if prep is not None:
                    job = (i, head[1], head[0]) + prep
        if job is None:
            rest.append(i)
        else:
            jobs.append(job)
    for s in range(0, len(jobs), api.API_WAVE):
        wave = jobs[s:s + api.API_WAVE]
        wrows = max(j[5] for j in wave)
        units = [(elems, ulen, starts, vals)
                 for _i, elems, ulen, starts, vals, _w in wave]
        out, ok, _ = _decode_wave(
            len(wave), lambda pad: sc.pack_batch(units, pad_rows=pad), mesh,
            lambda m, e, st, v, u, w: shard.decode_sidecar_sharded(
                m, e, st, v, u, w, wrows))
        for j, (i, _e, ulen, _s, _v, _w) in enumerate(wave):
            piece = out[j, :ulen].tobytes()
            if ok[j] and crc32c(piece) == _want_crc(bodies[i][1]):
                out_parts[i] = piece
                stats.root_map += 1
            else:
                rest.append(i)  # settles on the normal path
                stats.redecoded_root_map += 1
    return sorted(rest)


def _decode_hinted_chunks(bodies, depth_for, comp_idx, out_parts, mesh,
                          stats: FramedStats):
    """Depth-hinted decode (decode.decode_fragments_depth) of the
    compressed chunks with a usable 0x81 sidecar, in waves of api.API_WAVE
    chunks, each sharded over `mesh`. The chunk CRC
    gates every byte, so a wrong hint costs only a re-decode on the normal
    path. Returns the indices still to decode."""
    jobs, rest = [], []
    for i in comp_idx:
        job = None
        head = _head(bodies[i][1]) if i in depth_for else None
        if head is not None and len(head[1]) <= ops_decode.FRAG_CAP:
            d = sc.parse_depth(depth_for[i])
            if d is not None:
                job = (i, head[1], head[0], d)
        if job is None:
            rest.append(i)
        else:
            jobs.append(job)
    for s in range(0, len(jobs), api.API_WAVE):
        wave = jobs[s:s + api.API_WAVE]
        clens = np.asarray([len(j[1]) for j in wave], np.int32)
        ulens = np.asarray([j[2] for j in wave], np.int32)
        frags = np.zeros((len(wave), ops_decode.frag_width(clens)), np.uint8)
        deps = np.stack([j[3] for j in wave]).astype(np.int32)
        for j, (_i, payload, _u, _d) in enumerate(wave):
            frags[j, : len(payload)] = np.frombuffer(payload, np.uint8)
        out, ok, rounds = _decode_wave(
            len(wave),
            lambda pad: _pad_rows((frags, clens, ulens, deps), pad), mesh,
            shard.decode_depth_sharded)
        stats.dense_rounds += rounds
        for j, (i, _p, ulen, _d) in enumerate(wave):
            piece = out[j, :ulen].tobytes()
            if ok[j] and crc32c(piece) == _want_crc(bodies[i][1]):
                out_parts[i] = piece
                stats.hinted += 1
            else:
                rest.append(i)  # settles on the normal path
                stats.redecoded_hinted += 1
    return sorted(rest)


def _decode_normal_chunks(bodies, comp_idx, out_parts, mesh,
                          stats: FramedStats) -> None:
    """The fragment decoder (decode.decode_fragments, "tiledtail") on the
    remaining compressed chunks, in waves of api.API_WAVE, each sharded
    over `mesh`; chunks over the device capacity or not ok settle on the
    host codec, which decodes a valid one and raises on a corrupt one.
    Raises ValueError on a CRC mismatch."""
    n = len(comp_idx)
    clens = np.zeros(n, np.int32)
    ulens = np.zeros(n, np.int32)
    payloads = []
    for j, i in enumerate(comp_idx):
        body = bodies[i][1]
        ulen, vstart = fmt.varint_decode(body[4:])
        if ulen > MAX_CHUNK:
            raise ValueError("chunk uncompressed size exceeds 65536")
        clens[j] = len(body) - 4 - vstart
        ulens[j] = ulen
        payloads.append(body[4 + vstart:])
    # Spec-valid chunks can exceed the fragment capacity; they decode on
    # the host, like a chunk that fails the device's checks.
    oversize = clens > ops_decode.FRAG_CAP
    clens = np.where(oversize, 0, clens).astype(np.int32)
    for s in range(0, n, api.API_WAVE):
        sl = slice(s, s + api.API_WAVE)
        frags = np.zeros((len(clens[sl]), ops_decode.frag_width(clens[sl])),
                         np.uint8)
        for j, p in enumerate(payloads[sl]):
            if not oversize[s + j]:
                frags[j, : clens[s + j]] = np.frombuffer(p, np.uint8)
        out, ok, rounds = _decode_wave(
            len(frags),
            lambda pad: _pad_rows((frags, clens[sl], ulens[sl]), pad), mesh,
            shard.decode_sharded)
        stats.dense_rounds += rounds
        for j, i in enumerate(comp_idx[sl]):
            body = bodies[i][1]
            stats.normal += 1
            if ok[j] and not oversize[s + j]:
                piece = out[j, : ulens[s + j]].tobytes()
            else:
                stats.host += 1
                piece = reference_codec.decompress(body[4:])
            if crc32c(piece) != _want_crc(body):
                raise ValueError(f"chunk {i}: CRC-32C mismatch")
            out_parts[i] = piece


def _decode_data_chunks(bodies: list, mesh, use_sidecar: bool,
                        stats: FramedStats) -> list[bytes]:
    """Decode and CRC-check a window of data chunks, in order. bodies:
    (type, body) pairs, body = 4-byte masked CRC + payload; a sidecar
    entry pairs with the compressed chunk that follows it. Root-map chunks
    go first, hinted ones next, the rest through the fragment decoder.
    Raises ValueError with the window-relative chunk index on corruption."""
    out_parts: list[bytes | None] = [None] * len(bodies)
    side_for: dict[int, bytes] = {}
    depth_for: dict[int, bytes] = {}
    pending_s = pending_d = None
    for i, (t, b) in enumerate(bodies):
        if t == CHUNK_SIDECAR:
            pending_s = b
        elif t == CHUNK_DEPTH:
            pending_d = b
        elif t == CHUNK_COMPRESSED:
            if pending_s is not None:
                side_for[i] = pending_s
            if pending_d is not None:
                depth_for[i] = pending_d
            pending_s = pending_d = None
        elif t == CHUNK_UNCOMPRESSED:
            pending_s = pending_d = None

    comp_idx = [i for i, (t, _) in enumerate(bodies)
                if t == CHUNK_COMPRESSED]
    if use_sidecar and side_for:
        comp_idx = _decode_sidecar_chunks(bodies, side_for, comp_idx,
                                          out_parts, mesh, stats)
    if use_sidecar and depth_for:
        comp_idx = _decode_hinted_chunks(bodies, depth_for, comp_idx,
                                         out_parts, mesh, stats)
    if comp_idx:
        _decode_normal_chunks(bodies, comp_idx, out_parts, mesh, stats)

    for i, (typ, body) in enumerate(bodies):
        if typ == CHUNK_UNCOMPRESSED:
            piece = body[4:]
            if len(piece) > MAX_CHUNK:
                raise ValueError("uncompressed chunk exceeds 65536")
            if crc32c(piece) != _want_crc(body):
                raise ValueError(f"chunk {i}: CRC-32C mismatch")
            out_parts[i] = piece
            stats.uncompressed += 1
    return [p for p in out_parts if p is not None]


def decompress(framed: bytes, cfg: CodecConfig = DEFAULT_CONFIG, mesh=None,
               use_sidecar: bool = True, *, device="cuda") -> bytes:
    """Decompress and validate a framed stream (structure and every CRC).
    use_sidecar=False ignores the decode sidecars (skippable by spec).
    Every decode path shards over `mesh` (default: one shard on
    `device`). The arguments take the JAX package's order; `cfg` is
    checked and, as there, the decode does not depend on it."""
    return decompress_with_stats(framed, cfg, mesh, use_sidecar,
                                 device=device)[0]


def decompress_with_stats(framed: bytes, cfg: CodecConfig = DEFAULT_CONFIG,
                          mesh=None, use_sidecar: bool = True, *,
                          device="cuda"):
    """decompress, also returning the FramedStats of the paths taken."""
    _check_kinds(cfg, mesh, use_sidecar=use_sidecar)
    mesh = _mesh(device, mesh)
    stats = FramedStats()
    bodies = [(t, framed[off: off + ln])
              for t, off, ln in _parse_chunks(framed)]
    return b"".join(_decode_data_chunks(bodies, mesh, use_sidecar,
                                        stats)), stats


def decompress_stream(src, dst, mesh=None, chunks_per_wave: int = 64,
                      cfg: CodecConfig = DEFAULT_CONFIG,
                      use_sidecar: bool = True, *, device="cuda") -> int:
    """Stream-decode a framed stream from src to dst in windows of
    `chunks_per_wave` data chunks, each sharded over `mesh` (default: one
    shard on `device`). Returns the bytes written. The arguments take the
    JAX package's order."""
    _check_kinds(cfg, mesh, use_sidecar=use_sidecar,
                 chunks_per_wave=chunks_per_wave)
    mesh = _mesh(device, mesh)
    if src.read(len(STREAM_ID)) != STREAM_ID:
        raise ValueError("missing stream identifier chunk")
    stats = FramedStats()
    written = 0
    window: list[tuple[int, bytes]] = []
    ndata = 0

    def flush():
        nonlocal written, ndata
        for piece in _decode_data_chunks(window, mesh, use_sidecar, stats):
            dst.write(piece)
            written += len(piece)
        window.clear()
        ndata = 0

    while True:
        hdr = src.read(4)
        if not hdr:
            break
        if len(hdr) != 4:
            raise ValueError("truncated chunk header")
        typ = hdr[0]
        ln = int.from_bytes(hdr[1:4], "little")
        body = src.read(ln)
        if len(body) != ln:
            raise ValueError("truncated chunk payload")
        if typ == CHUNK_STREAM_ID:
            if hdr + body != STREAM_ID:
                raise ValueError("malformed repeated stream identifier")
        elif typ in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            if ln < 4:
                raise ValueError("data chunk shorter than its checksum")
            window.append((typ, body))
            ndata += 1
            # Flush only after a data chunk, so a sidecar never ends up
            # in another window than the chunk it describes.
            if ndata >= chunks_per_wave:
                flush()
        elif typ in (CHUNK_SIDECAR, CHUNK_DEPTH):
            window.append((typ, body))
        elif typ == CHUNK_PADDING or typ >= 0x80:
            pass  # skippable
        else:
            raise ValueError(f"reserved unskippable chunk type {typ:#x}")
    flush()
    return written
