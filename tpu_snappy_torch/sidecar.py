"""Framed-stream decode sidecars (port of tpu_snappy/sidecar.py).

The framed encoder may put a spec-skippable chunk before a compressed data
chunk (framing_format.txt section 4.4: decoders that do not know a type in
0x80-0xfd skip it):

* 0x80, a ROOT MAP: the chunk's output as maximal affine pieces over its
  element bytes, out[i] = elems[root[p] + slope[p] * (i - start[p])] with
  slope 0 or 1. The decoder then skips parse, transport and resolve: one
  windowed scatter of the piece values, one forward fill, one byte gather
  (`decode_chunks`).
* 0x81, DEPTH HINTS: how many doubling rounds each HINT_TILE tile of the
  decoder's resolve needs after its dense rounds, computed by the C++
  simulator for exactly this pipeline (TAIL_CAP, HINT_TILE). The decoder
  runs decode.decode_fragments_depth with them.

The chunk CRC covers the decoded bytes, so a wrong, stale or foreign
sidecar costs a re-decode on the normal path and never corrupts output.

Root-map wire payload (little-endian): magic b"tpS1", npieces u32, starts
u16[P] (strictly ascending, starts[0] == 0), roots u16[P], slopes as a
bitset of ceil(P/8) bytes (np.packbits order). Depth-hint payload: magic
b"tpD1", tail_cap u32, tile u16, the tile count and a flags byte (1), one
u8 depth per tile.

The host halves are copies of the JAX module's; the device half runs on
the port's kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import decode as _decode
from .ops.kernels import ffill as _ffill
from .ops.kernels import gather as _gather
from .ops.kernels import scatter as _scatter

MAGIC = b"tpS1"
#: Skippable framing chunk type of the root map.
CHUNK_TYPE = 0x80
#: Skippable framing chunk type of the depth hints, and their magic.
DEPTH_CHUNK_TYPE = 0x81
DEPTH_MAGIC = b"tpD1"

#: Split mode's piece-length cap: pieces split to at most SPLIT_LEN bytes
#: bound any 1024 consecutive scatter sources to 8 * (SPLIT_LEN + 1)
#: window rows (sidecar.py:112).
SPLIT_LEN = 8
#: Most pieces a chunk's sidecar may have (after a split); beyond it the
#: sidecar is ignored and the normal decoder runs (sidecar.py:123).
MAX_PIECES = 40960
#: Window-row buckets of the parent-direct decode: the smallest that
#: covers every 1024-piece tile's destination span (sidecar.py:294).
PARENT_WROWS = (40, 72, 136, 512)

OUT = 1 << 16


def _wrows(split_len: int) -> int:
    """Windowed-scatter rows implied by the split bound."""
    return 8 * (split_len + 1)


# ---- encoder side ----

def build_depth(elems: bytes, ulen: int) -> bytes | None:
    """Depth-hint payload for one compressed chunk, or None when the
    native simulator is unavailable or the stream is malformed."""
    if ulen <= 0 or ulen > OUT or len(elems) > 0xFFFF:
        return None
    golden = _decode.native_golden()
    if golden is None:
        return None
    try:
        d = golden.depth_hints(elems, ulen, _decode.TAIL_CAP,
                               _decode.HINT_TILE)
    except RuntimeError:
        return None
    return (DEPTH_MAGIC + np.uint32(_decode.TAIL_CAP).tobytes()
            + np.uint16(_decode.HINT_TILE).tobytes()
            + bytes([len(d) & 0xFF, 1]) + d.tobytes())


def parse_depth(payload: bytes):
    """Unpack a depth-hint payload -> (64,) int32 numpy array, or None if
    malformed, foreign, or computed for another decode pipeline (a
    tail_cap, tile or flags mismatch: the chunk is skippable, so it is
    ignored)."""
    if len(payload) < 12 or payload[:4] != DEPTH_MAGIC:
        return None
    cap = int(np.frombuffer(payload[4:8], "<u4")[0])
    tile = int(np.frombuffer(payload[8:10], "<u2")[0])
    nt, flags = payload[10], payload[11]
    if (cap != _decode.TAIL_CAP or tile != _decode.HINT_TILE or flags != 1
            or nt != (OUT // tile) & 0xFF or len(payload) != 12 + nt):
        return None
    return np.frombuffer(payload[12:], np.uint8).astype(np.int32)


def build(elems: bytes, ulen: int) -> bytes | None:
    """Root-map payload for one compressed chunk's element stream, or None
    when the stream is not representable (elems >= 64 KB, malformed, or
    more than MAX_PIECES pieces)."""
    try:
        starts, roots, slopes = _root_pieces(elems, ulen)
    except (ValueError, RuntimeError):
        return None
    if len(starts) == 0 or len(starts) > MAX_PIECES:
        return None
    return (MAGIC + np.uint32(len(starts)).tobytes()
            + starts.astype("<u2").tobytes() + roots.astype("<u2").tobytes()
            + np.packbits(slopes.astype(bool)).tobytes())


def _root_pieces(elems: bytes, ulen: int):
    golden = _decode.native_golden()
    if golden is None:
        return _root_pieces_py(elems, ulen)
    return golden.root_map(elems, ulen)


def _root_pieces_py(elems: bytes, ulen: int):
    """Python form of the native sr_root_map: an element walk building the
    root array (chunked numpy copies honour RLE), then greedy maximal
    affine pieces."""
    if len(elems) > 0xFFFF or ulen > OUT:
        raise ValueError("sidecar capacity")
    buf = np.frombuffer(elems, np.uint8)
    root = np.zeros(ulen, np.int64)
    ip, op, n = 0, 0, len(buf)
    while ip < n:
        tag = int(buf[ip])
        kind = tag & 3
        if kind == 0:
            code = tag >> 2
            if code < 60:
                length, hdr = code + 1, 1
            else:
                extra = code - 59
                if ip + 1 + extra > n:
                    raise ValueError("truncated")
                length = int.from_bytes(
                    buf[ip + 1: ip + 1 + extra].tobytes(), "little") + 1
                hdr = 1 + extra
            if ip + hdr + length > n or op + length > ulen:
                raise ValueError("truncated/overlong literal")
            root[op: op + length] = np.arange(ip + hdr, ip + hdr + length)
            ip += hdr + length
        else:
            if kind == 1:
                if ip + 2 > n:
                    raise ValueError("truncated")
                length = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | int(buf[ip + 1])
                ip += 2
            elif kind == 2:
                if ip + 3 > n:
                    raise ValueError("truncated")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[ip + 1: ip + 3].tobytes(),
                                        "little")
                ip += 3
            else:
                if ip + 5 > n:
                    raise ValueError("truncated")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[ip + 1: ip + 5].tobytes(),
                                        "little")
                ip += 5
            if offset < 1 or offset > op or op + length > ulen:
                raise ValueError("bad copy")
            k = 0
            while k < length:  # chunked copy: RLE-safe
                m = min(offset, length - k)
                root[op + k: op + k + m] = root[op + k - offset:
                                                op + k - offset + m]
                k += m
        op += length
    if op != ulen:
        raise ValueError("length mismatch")
    starts, roots, slopes = [], [], []
    i = 0
    while i < ulen:
        starts.append(i)
        roots.append(int(root[i]))
        slope = 1
        j = i + 1
        if j < ulen:
            d = int(root[j]) - int(root[i])
            if d in (0, 1):
                slope = d
                while j < ulen and root[j] == root[j - 1] + slope:
                    j += 1
        slopes.append(slope)
        i = j
    return (np.asarray(starts, np.uint16), np.asarray(roots, np.uint16),
            np.asarray(slopes, np.uint8))


# ---- decoder side (host half) ----

def parse(payload: bytes):
    """Unpack a root-map payload -> (starts, roots, slopes) int32 numpy
    arrays, or None if malformed or foreign (the chunk is skippable, so
    malformed means ignored)."""
    if len(payload) < 8 or payload[:4] != MAGIC:
        return None
    p = int(np.frombuffer(payload[4:8], "<u4")[0])
    need = 8 + 4 * p + (p + 7) // 8
    if p == 0 or p > OUT or len(payload) != need:
        return None
    starts = np.frombuffer(payload[8: 8 + 2 * p], "<u2").astype(np.int32)
    roots = np.frombuffer(payload[8 + 2 * p: 8 + 4 * p],
                          "<u2").astype(np.int32)
    slopes = np.unpackbits(
        np.frombuffer(payload[8 + 4 * p:], np.uint8))[:p].astype(np.int32)
    if starts[0] != 0 or (np.diff(starts) <= 0).any():
        return None
    return starts, roots, slopes


def split_for_device(starts, roots, slopes, ulen: int,
                     split_len: int = SPLIT_LEN):
    """Split pieces longer than split_len (split mode's density contract;
    sub-pieces encode the same map). Returns (starts, scatter values)
    int32 arrays, or None when the sidecar is inconsistent with ulen or
    the split exceeds MAX_PIECES."""
    if int(starts[-1]) >= ulen:
        return None
    plens = np.diff(np.concatenate([starts, [np.int32(ulen)]]))
    nsub = -(-plens // split_len)
    total = int(nsub.sum())
    if total > MAX_PIECES:
        return None
    first = np.cumsum(nsub) - nsub
    sub = (np.arange(total) - np.repeat(first, nsub)) * split_len
    s2 = np.repeat(starts, nsub) + sub
    # Every sub-piece shares its parent's value (the affine value is
    # position-independent within a piece, see parent_vals).
    vals = np.repeat((slopes << 17) | (roots - slopes * starts + OUT), nsub)
    return s2.astype(np.int32), vals.astype(np.int32)


def parent_vals(starts: np.ndarray, roots: np.ndarray,
                slopes: np.ndarray) -> np.ndarray:
    """Scatter value per maximal piece: slope in bit 17,
    (root - slope*start + 2^16) below — position-independent within the
    piece, which is what makes parent-direct scatter + fill exact."""
    return ((slopes.astype(np.int32) << 17)
            | (roots.astype(np.int32) - slopes * starts + OUT))


def parent_wrows(starts: np.ndarray) -> int:
    """Smallest PARENT_WROWS bucket covering every 1024-piece source
    tile's destination span (the windowed scatter anchors each tile at its
    smallest destination rounded down to 1024 cells: 8 rows of slop)."""
    p = len(starts)
    if p == 0:
        return PARENT_WROWS[0]
    k = -(-p // 1024)
    pad = np.pad(starts, (0, k * 1024 - p), mode="edge")
    tiles = pad.reshape(k, 1024)
    rows = int((tiles[:, -1] - tiles[:, 0]).max()) // 128 + 9
    for w in PARENT_WROWS:
        if rows <= w:
            return w
    return PARENT_WROWS[-1]


def prep_parent(starts, roots, slopes, ulen: int):
    """Host prep of the parent-direct decode: validate the parsed sidecar
    against ulen and return (starts, scatter values, wrows bucket), or
    None when inconsistent or beyond MAX_PIECES."""
    if len(starts) > MAX_PIECES or int(starts[-1]) >= ulen:
        return None
    return starts, parent_vals(starts, roots, slopes), parent_wrows(starts)


def pieces_width(total: int) -> int:
    """Padded piece width: a 4096-multiple bucket, at most MAX_PIECES."""
    b = 4096
    return int(min(max(b, -(-total // b) * b), MAX_PIECES))


def elems_width(max_elems: int) -> int:
    """Padded element-bytes width (the gather table): an 8192-multiple
    bucket, at most 65536."""
    b = 8192
    return int(min(max(b, -(-max_elems // b) * b), OUT))


def pack_batch(jobs, pad_rows: int = 0):
    """Batch arrays from per-chunk jobs (elems bytes, ulen, starts, vals)
    at the shared bucketed widths. Returns numpy (E (R, EW) uint8,
    S (R, PW) int32, V (R, PW) int32, U (R,) int32) with len(jobs) +
    pad_rows rows; padding carries starts == OUT (dropped by the scatter)
    and ulen 0."""
    b = len(jobs)
    pw = pieces_width(max(len(j[2]) for j in jobs))
    ew = elems_width(max(len(j[0]) for j in jobs))
    e = np.zeros((b + pad_rows, ew), np.uint8)
    s = np.full((b + pad_rows, pw), OUT, np.int32)
    v = np.zeros((b + pad_rows, pw), np.int32)
    u = np.zeros(b + pad_rows, np.int32)
    for j, (elems, ulen, starts, vals) in enumerate(jobs):
        e[j, : len(elems)] = np.frombuffer(elems, np.uint8)
        s[j, : len(starts)] = starts
        v[j, : len(vals)] = vals
        u[j] = ulen
    return e, s, v, u


# ---- decoder side (device half) ----

def decode_chunks(elems: torch.Tensor, starts: torch.Tensor,
                  vals: torch.Tensor, ulens: torch.Tensor,
                  wrows: int | None = None, split_len: int = SPLIT_LEN):
    """Root-map decode of a batch of chunks (sidecar.py:376-435):
    out[i] = elems[g[i]], g expanded from the piece values scattered at
    the piece starts (scatter_windowed; padding starts == 65536 drop),
    forward-filled, and one 1-limb gather_block from the element table.

    elems (B, EW) uint8 (element bytes, zero-padded to an elems_width
    bucket); starts, vals (B, PW) int32; ulens (B,) int32. wrows=None is
    split mode (host-split pieces, fill gaps of at most split_len, window
    of _wrows(split_len) rows): the fill takes max_gap=split_len, as on the
    TPU (sidecar.py:404), so a position farther behind its piece start
    than that window reaches (ffill.fill_window) keeps its own value; on a
    sidecar that keeps the split contract no gap is that long.
    wrows=<a PARENT_WROWS bucket> is parent-direct mode (the maximal wire
    pieces), whose fill has no limit. As on the TPU, a piece start dropped
    by the window makes its chunk not-ok. Returns (out (B, 65536) uint8,
    zero past ulen; ok (B,) bool)."""
    ew = elems.shape[-1]
    scattered, ovf = _scatter.scatter_windowed(
        starts, vals, _wrows(split_len) if wrows is None else wrows)
    filled = _ffill.ffill(scattered != 0, (scattered,),
                          max_gap=split_len if wrows is None else None)[0]
    oiota = torch.arange(OUT, dtype=torch.int32, device=elems.device)
    slope = filled >> 17
    g = torch.clamp(slope * oiota + (filled & 0x1FFFF) - OUT, 0, ew - 1)
    out = _gather.gather_block(elems.to(torch.int32), g.to(torch.int32),
                               limbs=1)
    keep = oiota < ulens.to(torch.int32)[:, None]
    return torch.where(keep, out.to(torch.uint8), 0), ovf == 0


def decode_corpus_sidecar(elems: torch.Tensor, starts: torch.Tensor,
                          vals: torch.Tensor, ulens: torch.Tensor,
                          wave: int = 8, split_len: int = SPLIT_LEN,
                          wrows: int | None = None):
    """decode_chunks over waves of `wave` chunks (sidecar.py:439), the
    decode_corpus of the root maps: the chunk count must be a multiple of
    `wave` (pad it with rows of starts == OUT and ulen 0), else
    ValueError. Returns (out (B, 65536) uint8, ok (B,) bool)."""
    return _decode._in_waves(
        "decode_corpus_sidecar",
        lambda e, s, v, u: decode_chunks(e, s, v, u, wrows, split_len),
        (elems, starts, vals, ulens), wave)
