"""Fragment-parallel Snappy decoder in PyTorch (port of
tpu_snappy/ops/decode.py).

The JAX decoder at its TPU default, resolve="tiledtail": per fragment,
speculative element fields for every compressed byte, the tag-chain parse
(commit_general), forward fills, the windowed transport scatter, the
periodic-run collapse, dense pointer-doubling rounds while more than
TAIL_CAP lanes still move, and the tile-sequential resolve. The other
resolve modes give the same bytes: "tiled" (the resolve kernel alone),
"flagtail" (root flags steer the resolve), "paratail" (parallel in-tile
rounds, then absorbs only), "kernel" (the fused resolve_block), "stable"
(doubling rounds with per-tile stability) and "plain" / "xla" (dense
doubling to the fixed point, then a byte gather). decode_corpus runs a
batch in waves under any of them, and decode_fragments_depth is the framed
container's depth-hinted decode ("depthtail"). The forward fills, the
transport scatter, the gathers and every resolve run through the
hand-written kernels (ops/kernels/).

As on the TPU, a transport write outside its window marks the fragment
not-ok (the JAX CPU path scatters without a window and cannot see one);
api.decompress then re-decodes that fragment on the host.

The host helpers (fragment split, widths) are the port's own: it imports
nothing of the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import format as fmt
from . import scan
from .kernels import doubling as _doubling
from .kernels import gather as _gather
from .kernels import localround as _localround
from .kernels import resolve as _resolve
from .kernels import scatter as _scatter
from .kernels import tiledres as _tiledres

#: Per-fragment compressed capacity (decode.py:79); larger fragments take
#: the sequential host path.
FRAG_CAP = 68 * 1024
#: Output cells of one fragment (decode.py:86).
OUT = fmt.BLOCK_SIZE
#: resolve="tiledtail" dense-round exit (decode.py:109): dense rounds run
#: while more than this many lanes of a fragment moved in its last round.
TAIL_CAP = 57344
#: Tile of the resolve after the dense rounds (decode.py:114).
TAIL_TILE = _tiledres.TILE
#: Tile of the depth-hinted resolve (decode.py:126); the framed 0x81 hints
#: are computed for it.
HINT_TILE = _tiledres.DEPTH_TILE
#: Most dense rounds a fragment runs (decode.py:351).
MAX_DENSE_ROUNDS = 16
#: resolve="paratail" dense-round exit (decode.py:132). Meant as "no dense
#: rounds", but the count starts at OUT + 1 > PARA_CAP, so every fragment
#: runs exactly one dense round, in JAX and here.
PARA_CAP = 65536
#: Tile of "paratail"'s local rounds and absorb-only resolve
#: (decode.py:133).
PARA_TILE = _localround.TILE
#: "paratail"'s most local rounds a fragment runs (decode.py:453).
MAX_LOCAL_ROUNDS = 14
#: Every resolve mode decode_fragments takes; "xla" is "plain".
RESOLVES = ("tiledtail", "tiled", "flagtail", "paratail", "kernel", "stable",
            "plain", "xla")


def _elem_fields(c: torch.Tensor):
    """Speculative per-byte element decode, as if every byte were a tag.
    c: (B, M) uint8. Returns (size, outbytes, is_lit, hdr, offset), each
    (B, M) int32 (is_lit bool); int32 arithmetic wraps as in JAX (whose
    `length` output equals `outbytes`)."""
    t = c.to(torch.int32)
    b1, b2, b3, b4 = (torch.roll(t, -s, dims=-1) for s in (1, 2, 3, 4))
    kind = t & 3
    code = t >> 2

    extra = torch.clamp(code - 59, 0, 4)
    ext_val = torch.where(
        extra == 0, code,
        torch.where(extra == 1, b1,
                    torch.where(extra == 2, b1 | (b2 << 8),
                                torch.where(extra == 3,
                                            b1 | (b2 << 8) | (b3 << 16),
                                            b1 | (b2 << 8) | (b3 << 16)
                                            | (b4 << 24)))))
    lit_len = ext_val + 1
    lit_hdr = 1 + extra
    lit_size = lit_hdr + lit_len

    copy_len = torch.where(kind == 1, ((t >> 2) & 7) + 4, code + 1)
    copy_size = torch.where(kind == 1, 2, torch.where(kind == 2, 3, 5))
    copy_off = torch.where(
        kind == 1, ((t >> 5) << 8) | b1,
        torch.where(kind == 2, b1 | (b2 << 8),
                    b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)))

    is_lit = kind == 0
    size = torch.where(is_lit, lit_size, copy_size).to(torch.int32)
    outbytes = torch.where(is_lit, lit_len, copy_len)
    hdr = torch.where(is_lit, lit_hdr, copy_size).to(torch.int32)
    return size, outbytes, is_lit, hdr, copy_off


def transport_cells(c: torch.Tensor, clen: torch.Tensor, ulen: torch.Tensor):
    """PARSE, and the transport's scatter inputs (decode.py:183-244), for
    (B, M) uint8 fragments. Returns (dest (B, M) int32 output cell or OUT
    to drop, value (B, M) int32, ok (B,) bool): payload bytes ride bits
    0-7, the element descriptor (1 for a literal, offset + 1 for a copy)
    bits 8-24 at the element's output start."""
    b, m = c.shape
    dev = c.device
    iota = torch.arange(m, dtype=torch.int32, device=dev)
    clen = clen.to(torch.int32)[:, None]
    size, outbytes, is_lit, hdr, off = _elem_fields(c)

    # --- PARSE: the true tag chain ---
    jump = torch.clamp(size, min=1)
    tags = scan.commit_general(jump) & (iota < clen)
    emitted = torch.where(tags, outbytes, 0)
    opos = scan.exclusive_cumsum(emitted)
    total_out = emitted.sum(dim=-1, dtype=torch.int32)
    last_end = torch.where(tags, iota + size, -1).amax(dim=-1)
    ok = (total_out == ulen.to(torch.int32)) & (
        (last_end == clen[:, 0]) | (clen[:, 0] == 0))
    # Copies must stay inside the fragment and behind the write head.
    bad_copy = tags & ~is_lit & ((off < 1) | (off > opos))
    ok &= ~bad_copy.any(dim=-1)

    # --- TRANSPORT inputs: each element's fields spread over its bytes ---
    estart, eopos, ehdr, eislit = scan.ffill_many(
        tags, (iota.expand(b, m).contiguous(), opos, hdr,
               is_lit.to(torch.int32)))
    is_payload = (eislit == 1) & (iota >= estart + ehdr) & (iota < clen)
    out_q = eopos + iota - estart - ehdr
    desc = torch.where(is_lit, 1, torch.clamp(off, 0, OUT - 1) + 1)
    mdst = torch.where(tags, torch.clamp(opos, max=OUT),
                       torch.where(is_payload, torch.clamp(out_q, 0, OUT),
                                   OUT)).to(torch.int32)
    mval = torch.where(tags, desc << 8, c.to(torch.int32)).to(torch.int32)
    return mdst, mval, ok


def parse_transport(c: torch.Tensor, clen: torch.Tensor, ulen: torch.Tensor,
                    collapse_runs: bool = True):
    """PARSE + TRANSPORT + run collapse (decode.py:183) for (B, M) uint8
    fragments, M a multiple of 1024. collapse_runs=False leaves periodic
    runs as plain one-step copies (deeper chains, the same bytes). Returns
    (lit_out (B, 65536) int32 bytes, src (B, 65536) int32 one-step source
    map with src[p] <= p, ok (B,) bool)."""
    b = c.shape[0]
    dev = c.device
    mdst, mval, ok = transport_cells(c, clen, ulen)
    # One windowed scatter carries payload bytes and descriptors; they
    # share cells only in disjoint bit ranges, so the sums compose.
    merged, sovf = _scatter.scatter_windowed(mdst, mval)
    ok &= sovf == 0
    lit_out = merged & 0xFF
    o_desc = merged >> 8

    # --- copy chains over output space, with the periodic-run collapse ---
    oiota = torch.arange(OUT, dtype=torch.int32, device=dev)
    desc_f = scan.ffill(o_desc != 0, o_desc)
    lit_f = desc_f == 1
    off_f = torch.clamp(desc_f - 1, min=0)
    src_plain = oiota - off_f
    if collapse_runs:
        is_start = o_desc != 0
        off_prev = torch.roll(off_f, 1, dims=-1)
        lit_prev = torch.roll(lit_f, 1, dims=-1)
        run_head = is_start & ~lit_f & (lit_prev | (off_prev != off_f)
                                        | (oiota == 0))
        rs_f = scan.ffill(run_head, oiota.expand(b, OUT).contiguous())
        base = rs_f - off_f
        offc = torch.clamp(off_f, min=1)
        src_mod = torch.remainder(oiota - base, offc) + base
        src = torch.where(lit_f, oiota,
                          torch.where(src_plain >= rs_f, src_mod, src_plain))
    else:
        src = torch.where(lit_f, oiota, src_plain)
    return lit_out, torch.clamp(src, 0, OUT - 1).to(torch.int32), ok


def dense_rounds(src: torch.Tensor, cap: int = TAIL_CAP):
    """The dense pointer-doubling loop of resolve="tiledtail", "flagtail",
    "paratail" (cap PARA_CAP) and "depthtail" (decode.py:349-359), per
    fragment as the vmapped while_loop runs it: fragment b doubles its map
    (src = src[src], one gather_block) while its moved count cnt[b] > cap
    and it has run fewer than 16 rounds; cnt starts above 65536. A
    fragment whose condition fails is frozen: its map and its count stay.
    Returns (src (B, 65536) int32, cnt (B,) int32, rounds: the gather
    launches, which is the largest per-fragment round count)."""
    cnt = torch.full((src.shape[0],), OUT + 1, dtype=torch.int32,
                     device=src.device)
    rounds = 0
    while rounds < MAX_DENSE_ROUNDS:
        active = cnt > cap
        if not bool(active.any()):
            break
        s2 = _gather.gather_block(src, src, limbs=2)
        moved = (s2 != src).sum(dim=-1, dtype=torch.int32)
        src = torch.where(active[:, None], s2, src)
        cnt = torch.where(active, moved, cnt)
        rounds += 1
    return src, cnt, rounds


def _finish(out: torch.Tensor, ulens: torch.Tensor) -> torch.Tensor:
    """Bytes as uint8, zero past each fragment's length."""
    oiota = torch.arange(OUT, dtype=torch.int32, device=out.device)
    keep = oiota < ulens.to(torch.int32)[:, None]
    return torch.where(keep, out.to(torch.uint8), 0)


def _resolve_copies(lit: torch.Tensor, src: torch.Tensor, resolve: str):
    """The copy-chain resolve of decode_fragment (decode.py:329-615) for
    one mode. Returns (bytes (B, 65536) int32, rounds: the dense, local or
    stability rounds launched, 0 for "tiled" and "kernel")."""
    if resolve == "tiledtail":
        src, cnt, rounds = dense_rounds(src)
        return _tiledres.resolve_tiled(lit, src, resolved=cnt == 0), rounds
    if resolve == "tiled":
        return _tiledres.resolve_tiled(lit, src), 0
    if resolve == "flagtail":
        # Root flags from the one-step map (decode.py:402), gathered at the
        # map the dense rounds leave (decode.py:421; the TPU packs 16 flags
        # a word only to cheapen its one-hot gather: the same bits).
        oiota = torch.arange(OUT, dtype=torch.int32, device=src.device)
        litv = (src == oiota).to(torch.int32)
        src, _cnt, rounds = dense_rounds(src)
        flags = _gather.gather_block(litv, src, limbs=1)
        return _tiledres.resolve_tiled_flag(lit, src, flags), rounds
    if resolve == "paratail":
        # decode.py:439-464: one dense round (see PARA_CAP), in-tile local
        # rounds per fragment while its map moved, then absorbs only.
        src, cnt, rounds = dense_rounds(src, PARA_CAP)
        moving = cnt != 0
        for _ in range(MAX_LOCAL_ROUNDS):
            if not bool(moving.any()):
                break
            s2 = _localround.local_round(src, PARA_TILE)
            moving &= (s2 != src).any(dim=-1)
            src = torch.where(moving[:, None], s2, src)
            rounds += 1
        done = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
        return _tiledres.resolve_tiled(lit, src, resolved=done), rounds
    if resolve == "kernel":
        return _resolve.resolve_block(lit, src), 0
    if resolve == "stable":
        # decode.py:468-483, per fragment while a tile is not stable; a row
        # whose tiles are all stable passes through the kernel unchanged,
        # so the whole batch runs every round.
        stable = torch.zeros((src.shape[0], _doubling.TILES),
                             dtype=torch.int32, device=src.device)
        rounds = 0
        while rounds < MAX_DENSE_ROUNDS and not bool((stable == 1).all()):
            src, stable = _doubling.doubling_round(src, stable)
            rounds += 1
        return _gather.gather_block(lit, src, limbs=1), rounds
    # "plain" / "xla", decode.py:604-615: doubling until the map stops
    # moving; a row at its fixed point no longer changes, so the batch runs
    # together.
    rounds = 0
    while rounds < MAX_DENSE_ROUNDS:
        s2 = _gather.gather_block(src, src, limbs=2)
        rounds += 1
        if torch.equal(s2, src):
            break
        src = s2
    return _gather.gather_block(lit, src, limbs=1), rounds


def _check_modes(resolve: str, fields: str) -> None:
    """Raise ValueError for a resolve or fields mode the port does not run
    (yet)."""
    if resolve not in RESOLVES:
        raise ValueError(f"resolve {resolve!r}: one of {', '.join(RESOLVES)}"
                         ' ("windowed" and "hybrid" come with a later port '
                         "slice)")
    if fields == "kernel":
        raise ValueError('fields="kernel" (the Pallas elem_fields_block) '
                         'comes with a later port slice; use "auto"')
    if fields not in ("auto", "xla"):
        raise ValueError(f'fields {fields!r}: "auto" or "xla"')


def decode_fragments(frags: torch.Tensor, clens: torch.Tensor,
                     ulens: torch.Tensor, resolve: str = "tiledtail",
                     fields: str = "auto", collapse_runs: bool = True):
    """Decode a batch of fragments (decode.py:292). frags (B, M) uint8
    zero-padded, M a multiple of 1024 (frag_width gives one); clens, ulens
    (B,) int32. resolve: one of RESOLVES, all giving the same bytes;
    "tiledtail" (dense rounds, then the resolve kernel with each
    fragment's `resolved` flag: cnt == 0) is the TPU default. fields:
    "auto" or "xla" (the same arithmetic). collapse_runs: the periodic-run
    collapse before the resolve. Returns (out (B, 65536) uint8, zero past
    ulen; ok (B,) bool; the rounds the resolve launched: dense, local or
    stability rounds, 0 for "tiled" and "kernel")."""
    _check_modes(resolve, fields)
    lit_out, src, ok = parse_transport(frags, clens, ulens, collapse_runs)
    out, rounds = _resolve_copies(lit_out, src, resolve)
    return _finish(out, ulens), ok, rounds


def decode_corpus(frags: torch.Tensor, clens: torch.Tensor,
                  ulens: torch.Tensor, resolve: str = "tiledtail",
                  fields: str = "auto", collapse_runs: bool = True,
                  wave: int = 8):
    """Whole-corpus decode (decode.py:755): decode_fragments over waves of
    `wave` fragments. The fragment count must be a multiple of `wave` (pad
    it), else ValueError. Returns (out (F, 65536) uint8, ok (F,) bool),
    what decode_fragments gives for the whole batch."""
    nf = frags.shape[0]
    if wave < 1 or nf % wave:
        raise ValueError(f"decode_corpus: {nf} fragments is not a multiple "
                         f"of the wave {wave}; pad the fragment count")
    outs, oks = [], []
    for s in range(0, nf, wave):
        out, ok, _rounds = decode_fragments(
            frags[s:s + wave], clens[s:s + wave], ulens[s:s + wave],
            resolve, fields, collapse_runs)
        outs.append(out)
        oks.append(ok)
    if not outs:
        return (torch.zeros((0, OUT), dtype=torch.uint8, device=frags.device),
                torch.zeros((0,), dtype=torch.bool, device=frags.device))
    return torch.cat(outs), torch.cat(oks)


def decode_fragments_depth(frags: torch.Tensor, clens: torch.Tensor,
                           ulens: torch.Tensor, depths: torch.Tensor):
    """Depth-hinted decode (decode.py:363-387, 632): the "tiledtail" dense
    rounds, then exactly depths[b, t] doubling rounds in each HINT_TILE
    tile (the framed 0x81 hints; an under-declared depth gives wrong
    bytes, which the frame's CRC catches). depths: (B, 64) int32. Same
    arguments and results as decode_fragments."""
    lit_out, src, ok = parse_transport(frags, clens, ulens)
    src, _cnt, rounds = dense_rounds(src)
    out = _tiledres.resolve_tiled_depth(lit_out, src,
                                        depths.to(torch.int32).contiguous())
    return _finish(out, ulens), ok, rounds


class FragmentFallback(Exception):
    """Stream is valid but not fragment-parallel decodable; use host path."""


@functools.cache
def native_golden():
    """The clean-room C++ codec (the port's native.golden binding) if it
    builds and loads here, else None. It builds with cmake at first use; a
    machine without cmake or Ninja gets None, and callers use the Python
    codec."""
    from ..native import golden
    return golden if golden.available() else None


def fragment_table(comp: bytes, start: int, total: int):
    """Host-side fragment split (decode.py:665): native scan when the
    golden library loads, else the Python walk. Returns (frags (F,
    FRAG_CAP) uint8, clens (F,) int32, ulens (F,) int32). Raises
    ValueError for malformed streams and FragmentFallback for valid but
    exotic ones."""
    buf = np.frombuffer(comp, dtype=np.uint8)
    max_frags = total // fmt.BLOCK_SIZE + 2
    golden = native_golden()
    try:
        if golden is None:
            raise RuntimeError("native codec unavailable")
        offs, ulens, nfrag = golden.scan_index(comp, start, total, max_frags)
    except RuntimeError:
        offs, ulens, nfrag = _scan_index_py(buf, start, total, max_frags)
    offs = np.concatenate([offs[:nfrag], [len(comp)]]).astype(np.int64)
    clens = (offs[1:] - offs[:-1]).astype(np.int32)
    if nfrag == 0 or clens.max(initial=0) > FRAG_CAP:
        raise FragmentFallback("fragment exceeds parallel-decode capacity")
    frags = np.zeros((nfrag, FRAG_CAP), dtype=np.uint8)
    for i in range(nfrag):
        frags[i, : clens[i]] = buf[offs[i]: offs[i + 1]]
    return frags, clens, np.asarray(ulens[:nfrag], dtype=np.int32)


def _scan_index_py(buf: np.ndarray, start: int, total: int, max_frags: int):
    """Element walk in Python (decode.py:693): fragment starts and output
    lengths at every 64 KB output boundary."""
    ip, op = start, 0
    n = len(buf)
    offs, ulens = [], []
    frag_ip, frag_op = ip, 0
    while ip < n:
        tag = int(buf[ip])
        kind = tag & 3
        if kind == 0:
            code = tag >> 2
            if code < 60:
                outb = code + 1
                esize = 1 + outb
            else:
                extra = code - 59
                if ip + 1 + extra > n:
                    raise ValueError("truncated")
                outb = int.from_bytes(buf[ip + 1: ip + 1 + extra].tobytes(),
                                      "little") + 1
                esize = 1 + extra + outb
        else:
            esize = 2 if kind == 1 else 3 if kind == 2 else 5
            outb = (((tag >> 2) & 7) + 4) if kind == 1 else (tag >> 2) + 1
        if ip + esize > n:
            raise ValueError("truncated")
        ip += esize
        op += outb
        if op % fmt.BLOCK_SIZE == 0 or ip >= n:
            if op - frag_op > fmt.BLOCK_SIZE or len(offs) >= max_frags:
                raise FragmentFallback("exotic stream")
            offs.append(frag_ip)
            ulens.append(op - frag_op)
            frag_ip, frag_op = ip, op
        elif op // fmt.BLOCK_SIZE != (op - outb) // fmt.BLOCK_SIZE:
            raise FragmentFallback("element straddles fragment boundary")
    if op != total:
        raise ValueError("length mismatch vs preamble")
    return np.asarray(offs, np.int64), np.asarray(ulens, np.int64), len(offs)


def frag_width(clens) -> int:
    """Fragment width to decode at: the largest compressed length rounded
    up to 8 KB (decode.py:733), at most FRAG_CAP."""
    m = int(np.max(clens)) if len(clens) else 0
    b = 8192
    return int(min(max(b, -(-m // b) * b), FRAG_CAP))
