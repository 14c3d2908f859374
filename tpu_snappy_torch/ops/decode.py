"""Fragment-parallel Snappy decoder in PyTorch (port of
tpu_snappy/ops/decode.py).

The JAX decoder at its TPU default, resolve="tiledtail" (what "auto"
means here, on every device): per fragment, speculative element fields
for every compressed byte, the tag-chain parse (commit_general), forward
fills, the windowed transport scatter, the periodic-run collapse, dense
pointer-doubling rounds while more than TAIL_CAP lanes still move, and the
tile-sequential resolve. The other resolve modes give the same bytes:
"tiled" (the resolve kernel alone), "flagtail" (root flags steer the
resolve), "paratail" (parallel in-tile rounds, then absorbs only),
"kernel" (the fused resolve_block), "stable" (doubling rounds with
per-tile stability), "hybrid" (dense rounds while more than SPARSE_CAP
lanes move, then a sparse pointer chase of the moving lanes; JAX's "auto"
off the TPU), "windowed" (four windowed rounds, then dense doubling) and
"plain" / "xla" (dense doubling to the fixed point, then a byte gather).
fields="kernel" computes the element fields with elem_fields_block.
decode_corpus runs a batch in waves under any of them, and
decode_fragments_depth / decode_corpus_depth are the framed container's
depth-hinted decode ("depthtail"); decode_fragment decodes one fragment
under any of them, "depthtail" included. The forward fills, the transport
scatter, the gathers and every resolve run through the hand-written
kernels (ops/kernels/).

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
from ..config import CodecConfig, DEFAULT_CONFIG
from . import scan
from .kernels import doubling as _doubling
from .kernels import fields as _fields
from .kernels import gather as _gather
from .kernels import gatherw as _gatherw
from .kernels import gatherwin as _gatherwin
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
#: Variant of that resolve (decode.py:115); every one of
#: tiledres.VARIANTS gives the same bytes.
TAIL_VARIANT = "fori"
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
#: resolve="hybrid" sparse-chase width (decode.py:94): the dense rounds run
#: until at most this many lanes of a fragment still move, and the chase
#: takes the first SPARSE_CAP moving lanes by position.
SPARSE_CAP = 12288
#: Most steps of "hybrid"'s sparse chase (decode.py:561); a fragment whose
#: chase has not converged by then is not ok.
MAX_CHASE_STEPS = 8192
#: "hybrid" runs its first two rounds through gather_window_anchored
#: (decode.py:141, on the TPU only in JAX). Read at call time.
WINDOWED_OPENING = False
#: Levels of the halving tree of the parse's entry scan
#: (scan.entry_states_tree_general; decode.py:85): each level halves the
#: walk over the fragment's segments. Used on CUDA tensors only, as JAX
#: uses it on the TPU only; 0 (the walk over segments) is the default.
#: Read at call time.
PARSE_TREE_LEVELS = 0
#: The windows (in 2048-position chunks) of "windowed"'s four opening
#: rounds (decode.py:598).
WINDOW_KS = (8, 8, 16, 16)
#: Every resolve mode decode_fragments takes; "auto" is "tiledtail" and
#: "xla" is "plain".
RESOLVES = ("auto", "tiledtail", "tiled", "flagtail", "paratail", "kernel",
            "stable", "hybrid", "windowed", "plain", "xla")
#: Every fields mode: "auto" and "xla" are the same arithmetic, "kernel"
#: launches elem_fields_block at widths that are a multiple of 2048.
FIELDS = ("auto", "xla", "kernel")


def transport_cells(c: torch.Tensor, clen: torch.Tensor, ulen: torch.Tensor,
                    fields: str = "auto"):
    """PARSE, and the transport's scatter inputs (decode.py:183-244), for
    (B, M) uint8 fragments. fields="kernel" takes the element fields from
    elem_fields_block when M is a multiple of 2048, else (as JAX does, and
    for "auto" / "xla") from its plain arithmetic. Returns (dest (B, M)
    int32 output cell or OUT to drop, value (B, M) int32, ok (B,) bool):
    payload bytes ride bits 0-7, the element descriptor (1 for a literal,
    offset + 1 for a copy) bits 8-24 at the element's output start."""
    b, m = c.shape
    dev = c.device
    iota = torch.arange(m, dtype=torch.int32, device=dev)
    clen = clen.to(torch.int32)[:, None]
    if fields == "kernel" and m % _fields.WIDTH_STEP == 0:
        size, outbytes, is_lit, hdr, off = _fields.elem_fields_block(c)
    else:
        size, outbytes, is_lit, hdr, off = _fields.elem_fields_block_plain(c)
    is_lit = is_lit == 1

    # --- PARSE: the true tag chain ---
    jump = torch.clamp(size, min=1)
    levels = PARSE_TREE_LEVELS if jump.device.type == "cuda" else 0
    tags = scan.commit_general(jump, tree_levels=levels) & (iota < clen)
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
                    fields: str = "auto", collapse_runs: bool = True):
    """PARSE + TRANSPORT + run collapse (decode.py:183) for (B, M) uint8
    fragments, M a multiple of 1024. fields: one of FIELDS (the same
    values). collapse_runs=False leaves periodic runs as plain one-step
    copies (deeper chains, the same bytes). Returns (lit_out (B, 65536)
    int32 bytes, src (B, 65536) int32 one-step source map with src[p] <= p,
    ok (B,) bool)."""
    b = c.shape[0]
    dev = c.device
    mdst, mval, ok = transport_cells(c, clen, ulen, fields)
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


def hybrid_rounds(src: torch.Tensor):
    """The dense loop of resolve="hybrid" (decode.py:497-531), per fragment
    as the vmapped while_loop runs it: fragment b doubles its map (one
    gather_block) while cnt[b] > 0, it[b] < 16 and (it[b] < 2 or cnt[b] >
    SPARSE_CAP), carrying the mask of the lanes its last round moved; a
    fragment whose condition fails is frozen (map, mask and count stay).
    With WINDOWED_OPENING, two gather_window_anchored rounds come first:
    the mask is then "moved or out of the window" (a lane a window missed
    is no fixed-point proof), cnt its sum and it 2. Returns (src (B, 65536)
    int32, mask (B, 65536) bool, cnt (B,) int32, rounds: the gather_block
    launches)."""
    b = src.shape[0]
    dev = src.device
    if WINDOWED_OPENING:
        for _ in range(2):
            s2, inwin = _gatherwin.gather_window_anchored(src, src)
            mask = (s2 != src) | (inwin == 0)
            src = s2
        cnt = mask.sum(dim=-1, dtype=torch.int32)
        it = torch.full((b,), 2, dtype=torch.int32, device=dev)
    else:
        mask = torch.ones((b, OUT), dtype=torch.bool, device=dev)
        cnt = torch.full((b,), OUT, dtype=torch.int32, device=dev)
        it = torch.zeros((b,), dtype=torch.int32, device=dev)
    rounds = 0
    while True:
        active = ((cnt > 0) & (it < MAX_DENSE_ROUNDS)
                  & ((it < 2) | (cnt > SPARSE_CAP)))
        if not bool(active.any()):
            break
        s2 = _gather.gather_block(src, src, limbs=2)
        moved = s2 != src
        src = torch.where(active[:, None], s2, src)
        mask = torch.where(active[:, None], moved, mask)
        cnt = torch.where(active, moved.sum(dim=-1, dtype=torch.int32), cnt)
        it += active.to(torch.int32)
        rounds += 1
    return src, mask, cnt, rounds


def sparse_chase(src: torch.Tensor, mask: torch.Tensor, cnt: torch.Tensor):
    """The sparse phase of resolve="hybrid" (decode.py:533-583) for each
    fragment with cnt > 0: extract the first SPARSE_CAP lanes of the mask
    by position (then unmasked lanes, JAX's sort key), chase their
    pointers through the frozen map (one gather_block of SPARSE_CAP
    targets a step) until they stop moving or MAX_CHASE_STEPS, and put the
    chased values back by position. A row whose chase has converged is at
    a fixed point, so the batch steps together. Returns (src (B, 65536)
    int32, chase_ok (B,) bool: converged within the cap, True where no
    chase ran, steps (B,) int32: the chase steps each fragment ran)."""
    b = src.shape[0]
    dev = src.device
    chase_ok = torch.ones((b,), dtype=torch.bool, device=dev)
    steps = torch.zeros((b,), dtype=torch.int32, device=dev)
    enter = cnt > 0
    if not bool(enter.any()):
        return src, chase_ok, steps
    rows = enter.nonzero()[:, 0]
    s = src[rows]
    oiota = torch.arange(OUT, dtype=torch.int32, device=dev)
    key = torch.where(mask[rows], oiota, oiota + (1 << 17))
    pos = torch.sort(key, dim=-1).indices[:, :SPARSE_CAP]
    q = torch.gather(s, -1, pos)
    done = torch.zeros((len(rows),), dtype=torch.bool, device=dev)
    n = torch.zeros((len(rows),), dtype=torch.int32, device=dev)
    for _ in range(MAX_CHASE_STEPS):
        q2 = _gather.gather_block(s, q, limbs=2)
        n += (~done).to(torch.int32)
        done |= (q2 == q).all(dim=-1)
        q = q2
        if bool(done.all()):
            break
    src = src.clone()
    src[rows] = s.scatter(-1, pos, q)
    chase_ok[rows] = done
    steps[rows] = n
    return src, chase_ok, steps


def _doubling_loop(src: torch.Tensor, done: torch.Tensor):
    """Dense doubling rounds (one gather_block each) until every row is at
    its fixed point or MAX_DENSE_ROUNDS (decode.py:604-614); `done` (B,)
    bool: rows known to be there already. A row at its fixed point no
    longer changes, so the batch runs together. Returns (src, rounds)."""
    rounds = 0
    while rounds < MAX_DENSE_ROUNDS and not bool(done.all()):
        s2 = _gather.gather_block(src, src, limbs=2)
        rounds += 1
        done = (s2 == src).all(dim=-1)
        src = s2
    return src, rounds


def _finish(out: torch.Tensor, ulens: torch.Tensor) -> torch.Tensor:
    """Bytes as uint8, zero past each fragment's length."""
    oiota = torch.arange(OUT, dtype=torch.int32, device=out.device)
    keep = oiota < ulens.to(torch.int32)[:, None]
    return torch.where(keep, out.to(torch.uint8), 0)


def _resolve_copies(lit: torch.Tensor, src: torch.Tensor, ok: torch.Tensor,
                    resolve: str):
    """The copy-chain resolve of decode_fragment (decode.py:329-615) for
    one mode. Returns (bytes (B, 65536) int32, ok (B,) bool: `ok` and, for
    "hybrid", each fragment's chase_ok; rounds: the dense, windowed, local
    or stability rounds launched, 0 for "tiled" and "kernel")."""
    if resolve == "hybrid":
        src, mask, cnt, rounds = hybrid_rounds(src)
        src, chase_ok, _steps = sparse_chase(src, mask, cnt)
        return _gather.gather_block(lit, src, limbs=1), ok & chase_ok, rounds
    out, rounds = _resolve_mode(lit, src, resolve)
    return out, ok, rounds


def _resolve_mode(lit: torch.Tensor, src: torch.Tensor, resolve: str):
    """The resolve of every mode but "hybrid": (bytes, rounds)."""
    if resolve in ("auto", "tiledtail"):
        src, cnt, rounds = dense_rounds(src)
        return _tiledres.resolve_tiled(lit, src, resolved=cnt == 0,
                                       tile=TAIL_TILE,
                                       variant=TAIL_VARIANT), rounds
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
        return _tiledres.resolve_tiled_flag(lit, src, flags,
                                            tile=TAIL_TILE), rounds
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
        return _tiledres.resolve_tiled(lit, src, resolved=done,
                                       tile=PARA_TILE,
                                       variant=TAIL_VARIANT), rounds
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
    done = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
    rounds = 0
    if resolve == "windowed":
        # decode.py:587-602: four windowed rounds; a fragment whose lanes
        # were all in their window and unmoved in the last is at its fixed
        # point and skips the dense loop.
        tile = torch.arange(OUT, dtype=torch.int32, device=src.device) // 2048
        for k in WINDOW_KS:
            s2 = _gatherw.gather_window_block(src, src, k)
            in_win = src >= (tile - (k - 1)) * 2048
            done = (in_win & (s2 == src)).all(dim=-1)
            src = s2
        rounds = len(WINDOW_KS)
    # "windowed", "plain" / "xla", decode.py:604-615: doubling until the
    # map stops moving.
    src, dense = _doubling_loop(src, done)
    return _gather.gather_block(lit, src, limbs=1), rounds + dense


def _check_modes(resolve: str, fields: str) -> None:
    """Raise ValueError for an unknown resolve or fields mode."""
    if resolve not in RESOLVES:
        raise ValueError(f"resolve {resolve!r}: one of {', '.join(RESOLVES)}")
    if fields not in FIELDS:
        raise ValueError(f"fields {fields!r}: one of {', '.join(FIELDS)}")


def decode_fragments(frags: torch.Tensor, clens: torch.Tensor,
                     ulens: torch.Tensor, cfg: CodecConfig = DEFAULT_CONFIG,
                     *, resolve: str = "auto", fields: str = "auto",
                     collapse_runs: bool = True):
    """Decode a batch of fragments (decode.py:292). frags (B, M) uint8
    zero-padded, M a multiple of 1024 (frag_width gives one); clens, ulens
    (B,) int32. cfg: the JAX package's argument (decode.py:746), checked
    and, as there, unused: no decode depends on it. The port's options
    are keyword-only after it. resolve: one of RESOLVES, all giving the
    same bytes;
    "auto" is the TPU default "tiledtail" (dense rounds, then the resolve
    kernel with each fragment's `resolved` flag: cnt == 0). fields: one of
    FIELDS. collapse_runs: the periodic-run collapse before the resolve.
    Returns (out (B, 65536) uint8, zero past ulen; ok (B,) bool, which
    under "hybrid" includes the sparse chase's convergence; the rounds the
    resolve launched: dense, windowed, local or stability rounds, 0 for
    "tiled" and "kernel")."""
    if not isinstance(cfg, CodecConfig):
        raise TypeError(f"cfg: expected a CodecConfig, got {cfg!r}")
    _check_modes(resolve, fields)
    lit_out, src, ok = parse_transport(frags, clens, ulens, fields,
                                       collapse_runs)
    out, ok, rounds = _resolve_copies(lit_out, src, ok, resolve)
    return _finish(out, ulens), ok, rounds


def decode_fragment(c, clen, ulen, resolve: str = "auto",
                    fields: str = "auto", collapse_runs: bool = True,
                    depths=None, *, device="cuda"):
    """Decode one fragment (decode.py:292): c (M,) uint8 zero-padded, M a
    multiple of 1024 (FRAG_CAP is one), clen and ulen its lengths; arrays
    or tensors, moved to `device` (a CUDA device unless the caller asks
    for the CPU). resolve: one of RESOLVES, as decode_fragments takes it,
    or "depthtail", the depth-hinted decode of decode_fragments_depth with
    `depths` ((64,) int32, one per HINT_TILE tile), which only that mode
    reads, as in JAX. fields, collapse_runs: as decode_fragments. Returns
    (out (65536,) uint8, zero past ulen; ok, a bool 0-d tensor): row 0 of
    what the batched decode gives for the fragment alone."""
    c = torch.as_tensor(c, device=device).reshape(1, -1)
    clens = torch.as_tensor(clen, dtype=torch.int32,
                            device=device).reshape(1)
    ulens = torch.as_tensor(ulen, dtype=torch.int32,
                            device=device).reshape(1)
    if resolve == "depthtail":
        if depths is None:
            raise ValueError("decode_fragment: resolve 'depthtail' needs "
                             "depths")
        deps = torch.as_tensor(depths, dtype=torch.int32,
                               device=device).reshape(1, -1)
        out, ok, _ = decode_fragments_depth(c, clens, ulens, deps, fields,
                                            collapse_runs)
    else:
        out, ok, _ = decode_fragments(c, clens, ulens, resolve=resolve,
                                      fields=fields,
                                      collapse_runs=collapse_runs)
    return out[0], ok[0]


def _in_waves(name: str, decode, arrays: tuple, wave: int):
    """`decode` over waves of `wave` fragments of `arrays` (fragments on
    dim 0, a count that must be a multiple of `wave`, else ValueError).
    Returns (out (F, 65536) uint8, ok (F,) bool) for the whole batch."""
    frags = arrays[0]
    nf = frags.shape[0]
    if wave < 1 or nf % wave:
        raise ValueError(f"{name}: {nf} fragments is not a multiple of the "
                         f"wave {wave}; pad the fragment count")
    if not nf:
        return (torch.zeros((0, OUT), dtype=torch.uint8, device=frags.device),
                torch.zeros((0,), dtype=torch.bool, device=frags.device))
    res = [decode(*(a[s:s + wave] for a in arrays))
           for s in range(0, nf, wave)]
    return torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res])


def decode_corpus(frags: torch.Tensor, clens: torch.Tensor,
                  ulens: torch.Tensor, resolve: str = "auto",
                  fields: str = "auto", collapse_runs: bool = True,
                  wave: int = 8):
    """Whole-corpus decode (decode.py:755): decode_fragments over waves of
    `wave` fragments. The fragment count must be a multiple of `wave` (pad
    it), else ValueError. Returns (out (F, 65536) uint8, ok (F,) bool),
    what decode_fragments gives for the whole batch."""
    return _in_waves(
        "decode_corpus",
        lambda f, c, u: decode_fragments(f, c, u, resolve=resolve,
                                         fields=fields,
                                         collapse_runs=collapse_runs),
        (frags, clens, ulens), wave)


def decode_fragments_depth(frags: torch.Tensor, clens: torch.Tensor,
                           ulens: torch.Tensor, depths: torch.Tensor,
                           fields: str = "auto", collapse_runs: bool = True):
    """Depth-hinted decode (decode.py:363-387, 632): the "tiledtail" dense
    rounds, then exactly depths[b, t] doubling rounds in each HINT_TILE
    tile (the framed 0x81 hints, which describe the pipeline with the run
    collapse; an under-declared depth gives wrong bytes, as in JAX, which
    the frame's CRC catches). depths: (B, 64) int32. Same arguments and
    results as decode_fragments."""
    _check_modes("tiledtail", fields)
    lit_out, src, ok = parse_transport(frags, clens, ulens, fields,
                                       collapse_runs)
    src, _cnt, rounds = dense_rounds(src)
    out = _tiledres.resolve_tiled_depth(lit_out, src,
                                        depths.to(torch.int32).contiguous(),
                                        tile=HINT_TILE)
    return _finish(out, ulens), ok, rounds


def decode_corpus_depth(frags: torch.Tensor, clens: torch.Tensor,
                        ulens: torch.Tensor, depths: torch.Tensor,
                        fields: str = "auto", collapse_runs: bool = True,
                        wave: int = 8):
    """Depth-hinted whole-corpus decode (decode.py:646):
    decode_fragments_depth over waves of `wave` fragments, depths (F, 64)
    int32. The fragment count must be a multiple of `wave`, else
    ValueError. Returns (out (F, 65536) uint8, ok (F,) bool)."""
    return _in_waves(
        "decode_corpus_depth",
        lambda f, c, u, d: decode_fragments_depth(f, c, u, d, fields,
                                                  collapse_runs),
        (frags, clens, ulens, depths), wave)


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
