"""Batched Snappy block encoder in PyTorch (port of tpu_snappy/ops/encode.py).

This is the JAX encoder at any CodecConfig (candidates, probes, flatten,
lazy, sticky, stride, table, block capacity) on its TPU route
(encode.py:741-821). Every kernel runs through ops/kernels/ (hand-written
CUDA on the card, the plain version on the CPU); the rest is plain tensor
code. Every per-position array is (B, 65536), the strided candidate stage
(B, 65536 / stride).

Stages: window keys (strided keys at stride 2 and 4), pair sort of (key,
position), rank-space candidate table, restore to position space, matcher,
commit scan, emission, placement. The matcher route follows the table:

* points with a flattening slot (every preset): the packed candidate form
  feeds `matcher_block_packed` at every K, as on the TPU (on the CPU its
  plain version unpacks the table and runs `_matcher_xla`, the JAX
  package's route off the TPU; on the card K 2-24 run a kernel instance
  each and larger K the wide kernel);
* flatten "off": the unpacked (B, N, K) table feeds `matcher_block` at
  every K. The TPU runs the XLA-form matcher here; the two are
  bit-identical (tests/test_pallas.py:513-550), and the kernel keeps the
  plain body's membership compares off the card;
* table "intervals": `_matcher_xla` with the interval-aware sticky scan,
  which is XLA on the TPU too (no kernel takes the interval columns).

Placements (`PLACEMENTS`, encode.py:721-735), all giving the same bytes:
"auto" and "winplace" (single-lane emission, windowed placement and the
overflow scatter, the TPU default), "single" (single-lane emission and
the N + 2048 sort), "emit" (two-lane emission kernel and the 2N sort),
"sort" (XLA emission lanes and the 2N sort, the JAX package's CPU route)
and "kernel" (XLA lanes and the windowed placement over both lanes).
encode_block encodes one block (encode_blocks on a batch of one).
"""

from __future__ import annotations

import functools

import torch

from .. import format as fmt
from ..config import CodecConfig, DEFAULT_CONFIG
from ..utils import profiling
from . import scan
from .kernels import emit as _emit
from .kernels import matcher as _matcher
from .kernels import place as _place
from .kernels import scatter as _scatter
from .kernels import windows as _windows

N = fmt.BLOCK_SIZE  # 65536 lanes per block

#: Windowed sticky-composition depth (encode.py:60).
STICKY_LEVELS = 4

#: Placement sentinel destination: sorts after every real output byte
#: (pallas/place.py:38).
SENT = _emit.SENT

PLACEMENTS = ("auto", "winplace", "single", "emit", "sort", "kernel")

_C1 = fmt.COPY1_MAX_OFFSET

#: Knuth's golden-ratio multiplier of the signature hash (encode.py:432).
_SIG_MUL = 0x9E3779B1


def _iota(device, n: int = N) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _rollz(x: torch.Tensor, s: int) -> torch.Tensor:
    """Roll toward higher indices with zero fill (no wrap)."""
    y = torch.roll(x, s, dims=-1)
    y[..., :s] = 0
    return y


def _window_keys(blocks: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Pair-sort keys: the window at every i <= n-4, 0xFFFFFFFF past it."""
    return _windows.window_keys(blocks, n)


def _window_keys_strided(blocks: torch.Tensor, n: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """Keys of the stride-spaced positions only (encode.py:100): the window
    at position 2q is u16 words q and q+1 of the block (word q+1 wrapping
    at N/2), at position 4q it is u32 word q; 0xFFFFFFFF past n-4. Equal to
    _window_keys(...)[:, ::stride]. Returns (B, N // stride) int64."""
    b = blocks.to(torch.int64).reshape(blocks.shape[0], N // stride, stride)
    if stride == 2:
        v = b[..., 0] | b[..., 1] << 8
        w = v | torch.roll(v, -1, dims=-1) << 16
    elif stride == 4:
        w = b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
    else:
        raise ValueError(f"strided keys take stride 2 or 4, not {stride}")
    pos = torch.arange(0, N, stride, dtype=torch.int32, device=blocks.device)
    return torch.where(pos <= n.to(torch.int32)[:, None] - 4, w,
                       _windows.INVALID)


def _expand_stride(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Entry q of the last axis moves to position q * stride, the positions
    between get 0 (encode.py:122)."""
    if stride == 1:
        return x
    out = x.new_zeros(x.shape[:-1] + (x.shape[-1] * stride,))
    out[..., ::stride] = x
    return out


def _table(planes: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, K, N / stride) planes -> the (B, N, K) candidate table."""
    return _expand_stride(planes, stride).permute(0, 2, 1).contiguous()


def _candidate_offsets(key: torch.Tensor, n: torch.Tensor,
                       cfg: CodecConfig = DEFAULT_CONFIG,
                       packed: bool = True):
    """Rank-space candidate table (encode.py:134) of (B, M) keys, M = N /
    cfg.stride. Offsets to the nearest earlier positions with the same
    4-byte window (0 = none), probed `max(probes, K)` ranks deep, deduped
    to K-1 slots plus the flattening offset (or, for table "intervals",
    K-3 slots, the flattening offset and one verified offset interval).

    packed=True (table "points" with a flattening slot): returns (pref
    (B, N) int32, the gated flattening default; words (B, K//2, N) int32:
    word j holds slots 2j and 2j+1 as 16-bit halves, low first; at even K
    the last word's high half is the flattening offset, at odd K every
    half is a slot and the flattening offset rides the JAX restore key).
    packed=False: the (B, N, K) table, column 0 the sticky default."""
    k, stride, flatten = cfg.candidates, cfg.stride, cfg.flatten
    if flatten == "off" and (packed or k % 2):
        raise ValueError(f"K={k}, packed={packed}: odd K and the packed "
                         "form need the flattening slot (flatten != 'off')")
    if packed and cfg.table != "points":
        raise ValueError("the packed form takes table='points' only")
    dev = key.device
    m = key.shape[-1]
    rank = _iota(dev, m)
    nn = n.to(torch.int32)[:, None]
    # (key, position) pairs sort as one int64: keys are < 2^32 and
    # positions unique and < 2^16, so this is lax.sort(num_keys=2)'s order.
    pairs, _ = torch.sort((key << 16) | (rank * stride).to(torch.int64),
                          dim=-1)
    w_s = pairs >> 16
    pos_s = (pairs & 0xFFFF).to(torch.int32)

    r = k if flatten == "off" else max(cfg.probes, k)
    offs = []
    for shift in range(1, r + 1):
        prev_w = torch.roll(w_s, shift, dims=-1)
        prev_pos = torch.roll(pos_s, shift, dims=-1)
        same = ((w_s == prev_w) & (rank >= shift) & (prev_pos <= nn - 4)
                & (pos_s <= nn - 4))
        offs.append(torch.where(same, pos_s - prev_pos, 0))

    if flatten != "off":
        flat = _flat_candidate(w_s, pos_s, rank, offs, flatten)
        if cfg.table == "intervals":
            *points, ilo, ihi = _interval_slots(offs, k)
            offs = points + [flat, ilo, ihi]
        elif r > k:
            offs = _dedup_slots(offs, k - 1) + [flat]
        else:
            offs = offs[:k - 1] + [flat]

    if packed:
        # Two 16-bit slots per int32 word (the u32 bit pattern; unpack with
        # >> 16 then & 0xFFFF) before the restore, which then moves half
        # the planes; at odd K the flattening offset is a plane of its own.
        h = k // 2 * 2
        ranked = torch.stack([offs[j] | (offs[j + 1] << 16)
                              for j in range(0, h, 2)] + offs[h:], dim=1)
    else:
        ranked = torch.stack(offs, dim=1)  # (B, planes, M)
    # Back to position space: rank j holds position pos_s[j], a permutation
    # of the anchors, so the JAX restore sort is an inverse-permutation
    # scatter.
    anchor = pos_s if stride == 1 else pos_s // stride
    back = torch.empty_like(ranked)
    back.scatter_(2, anchor.to(torch.int64)[:, None].expand_as(ranked),
                  ranked)
    # The gates run on the strided arrays (a roll by 4 is 4 anchors).
    if packed:
        words = back[:, :k // 2].contiguous()
        flat = back[:, k // 2] if k % 2 else (words[:, -1] >> 16) & 0xFFFF
        pref = _flat_gate(flat, words[:, 0] & 0xFFFF)
        return _expand_stride(pref, stride), _expand_stride(words, stride)
    if flatten == "off":
        return _table(back, stride)  # nearest first
    if cfg.table == "intervals":
        # [pref, K-3 point slots, interval lo, hi] (encode.py:384-392).
        pref = _flat_gate(back[:, k - 3], back[:, 0])
        return _table(torch.cat([pref[:, None], back[:, :k - 3],
                                 back[:, k - 2:]], dim=1), stride)
    pref = _flat_gate(back[:, k - 1], back[:, 0])
    return _table(torch.cat([pref[:, None], back[:, :k - 1]], dim=1), stride)


def _flat_candidate(w_s, pos_s, rank, offs, flatten: str) -> torch.Tensor:
    """The chain-flattening offset in rank space (encode.py:188-258):
    "full" the run head (oldest occurrence); "class" the oldest occurrence
    where it keeps the nearest candidate's tag class, else the oldest of
    the probes in that class; "lift" the same gate with the base-16 digit-
    lift ancestor in the oldest occurrence's role."""
    run_start = (w_s != torch.roll(w_s, 1, dims=-1)) | (rank == 0)
    valid = w_s != _windows.INVALID
    if flatten == "lift":
        # Occurrence index q = rank - run head's rank; the latest
        # 16^j-aligned occurrence fills forward from the q % 16^j == 0
        # marks (q == 0 marks every run head, so no fill crosses a run).
        first_pos, head_rank = scan.ffill_many(
            run_start, (pos_s, rank.expand_as(pos_s).contiguous()))
        q = rank - head_rank
        a1, a2, a3 = (scan.ffill(q % d == 0, pos_s) for d in (16, 256, 4096))
        anc = torch.where(q % 16 != 0, a1, torch.where(
            q % 256 != 0, a2, torch.where(q % 4096 != 0, a3, first_pos)))
        oldest = torch.where(valid & (anc < pos_s), pos_s - anc, 0)
    else:
        first_pos = scan.ffill(run_start, pos_s)
    first = torch.where(valid & (first_pos < pos_s), pos_s - first_pos, 0)
    if flatten == "full":
        return first
    if flatten != "lift":
        oldest = first
    c0 = offs[0]
    m1 = functools.reduce(torch.maximum, [
        torch.where((o > 0) & (o < _C1), o, 0) for o in offs])
    m2 = functools.reduce(torch.maximum, offs)
    o1 = (oldest > 0) & (oldest < _C1)
    return torch.where(c0 < _C1, torch.where(o1, oldest, m1),
                       torch.where(oldest > 0, oldest, m2))


def _dedup_slots(offs: list, slots: int, interval=None) -> list:
    """Compact the ascending probes into `slots` slots, dropping the
    consecutive ladder rooted at offset 1 that byte runs make
    (encode.py:310-323) and, past the nearest probe, the members of an
    (lo, hi) `interval` (lo == 0: none)."""
    out = [torch.zeros_like(offs[0]) for _ in range(slots)]
    cnt = torch.zeros_like(offs[0])
    ladder = offs[0] == 1
    for j, o in enumerate(offs):
        kp = o > 0
        if j:
            step = o == offs[j - 1] + 1
            kp = kp & ~(ladder & step)
            ladder = ladder & step
            if interval is not None:
                lo, hi = interval
                kp = kp & ~((o >= lo) & (o <= hi) & (lo > 0))
        for s in range(slots):
            out[s] = torch.where(kp & (cnt == s), o, out[s])
        cnt = cnt + kp.to(torch.int32)
    return out


def _interval_slots(offs: list, k: int) -> list:
    """Interval-set table (encode.py:267-309): the longest run of 3 or more
    consecutive probes not rooted at 1 becomes one (lo, hi) interval; the
    point slots take the root-ladder dedup minus the interval's members.
    Returns K-3 point slots, then lo, hi."""
    run_len = (offs[0] > 0).to(torch.int32)
    best_len = torch.zeros_like(offs[0])
    best_hi = torch.zeros_like(offs[0])
    for j in range(1, len(offs)):
        step = (offs[j] == offs[j - 1] + 1) & (offs[j - 1] > 0)
        run_len = torch.where(step, run_len + 1,
                              (offs[j] > 0).to(torch.int32))
        lo_j = offs[j] - run_len + 1
        take = (run_len >= 3) & (run_len > best_len) & (lo_j != 1)
        best_len = torch.where(take, run_len, best_len)
        best_hi = torch.where(take, offs[j], best_hi)
    ilo = torch.where(best_len > 0, best_hi - best_len + 1, 0)
    ihi = torch.where(best_len > 0, best_hi, 0)
    return _dedup_slots(offs, k - 3, (ilo, ihi)) + [ilo, ihi]


def _flat_gate(flat: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Take the flattening offset only where it proves an 8-byte extension
    and the nearest does not win (encode.py:402)."""
    agree = (torch.roll(flat, -4, dims=-1) == flat) & (flat > 0)
    agree_near = (torch.roll(c0, -4, dims=-1) == c0) & (c0 > 0)
    return torch.where(agree & ((c0 > 68) | ~agree_near), flat, c0)


def _sig_bit(x: torch.Tensor) -> torch.Tensor:
    """One-bit u32 signature of an offset: bit ((x * 0x9E3779B1) mod 2^32)
    >> 27 (encode.py:427), in int64 (no u32 shifts on the CPU)."""
    h = ((x.to(torch.int64) * _SIG_MUL) & 0xFFFFFFFF) >> 27
    return torch.ones_like(h) << h


def _sticky_offsets(cands: torch.Tensor,
                    sticky: str = "exact") -> torch.Tensor:
    """Chain-stable offset per position (encode.py:520-618): windowed
    composition of "keep the offset from i-4 if it is one of my
    candidates, else my default" over 2**STICKY_LEVELS stride-4 steps.
    Membership at "exact" compares with every keep ((B, N, K, K)
    compares, in K passes of (B, N, K)); at "sig" it is one AND with a
    32-bucket bit mask of the keeps, and the final choice is re-verified
    exactly against the position's own table, falling back to column 0,
    so a bucket collision only changes a tie-break."""
    keep = cands
    dflt = cands[..., 0]
    iota = _iota(cands.device)
    for lvl in range(STICKY_LEVELS):
        shift = 4 << lvl
        a_keep = torch.roll(keep, shift, dims=1)
        a_dflt = torch.roll(dflt, shift, dims=1)
        if sticky == "sig":
            sig = torch.where(keep > 0, _sig_bit(keep), 0)
            mask = functools.reduce(torch.bitwise_or, sig.unbind(-1))
            in_keep = (mask[..., None] & _sig_bit(a_keep)) != 0
            in_dflt = (mask & _sig_bit(a_dflt)) != 0
        else:
            in_keep = functools.reduce(torch.bitwise_or, (
                a_keep == keep[..., m, None] for m in range(keep.shape[-1])))
            in_dflt = (a_dflt[..., None] == keep).any(dim=-1)
        new_keep = torch.where(in_keep & (a_keep > 0), a_keep, 0)
        new_dflt = torch.where(in_dflt & (a_dflt > 0), a_dflt, dflt)
        # Window start: no left context rolls in from the array end.
        edge = iota < shift
        keep = torch.where(edge[:, None], keep, new_keep)
        dflt = torch.where(edge, dflt, new_dflt)
    if sticky == "sig":
        verified = ((dflt[..., None] == cands) & (dflt[..., None] > 0)
                    ).any(-1)
        dflt = torch.where(verified, dflt, cands[..., 0])
    return dflt


def _sticky_offsets_intervals(cands: torch.Tensor,
                              sticky: str = "exact") -> torch.Tensor:
    """Sticky composition over an interval table (encode.py:436): columns
    [:-2] are point slots (column 0 the default), -2/-1 a verified offset
    interval (lo == 0: none). Intervals compose by intersection; the
    final choice is verified against the position's own points or
    interval."""
    pts, lo, hi = cands[..., :-2], cands[..., -2], cands[..., -1]
    dflt = cands[..., 0]
    iota = _iota(cands.device)

    def in_ivl(x, lo, hi):
        return (x > 0) & (x >= lo) & (x <= hi) & (lo > 0)

    for lvl in range(STICKY_LEVELS):
        shift = 4 << lvl
        a_pts, a_lo, a_hi, a_d = (torch.roll(t, shift, dims=1)
                                  for t in (pts, lo, hi, dflt))
        if sticky == "sig":
            sig = torch.where(pts > 0, _sig_bit(pts), 0)
            mask = functools.reduce(torch.bitwise_or, sig.unbind(-1))
            in_pts = ((mask[..., None] & _sig_bit(a_pts)) != 0) & (a_pts > 0)
            in_d = ((mask & _sig_bit(a_d)) != 0) & (a_d > 0)
        else:
            in_pts = ((a_pts[..., None] == pts[..., None, :])
                      & (a_pts[..., None] > 0)).any(-1)
            in_d = ((a_d[..., None] == pts) & (a_d[..., None] > 0)).any(-1)
        in_pts = in_pts | in_ivl(a_pts, lo[..., None], hi[..., None])
        in_d = in_d | in_ivl(a_d, lo, hi)
        keep = torch.where(in_pts, a_pts, 0)
        nlo = torch.maximum(a_lo, lo)
        nhi = torch.minimum(a_hi, hi)
        valid = (a_lo > 0) & (lo > 0) & (nlo <= nhi)
        nlo = torch.where(valid, nlo, 0)
        nhi = torch.where(valid, nhi, 0)
        d = torch.where(in_d, a_d, dflt)
        edge = iota < shift
        pts = torch.where(edge[:, None], pts, keep)
        lo = torch.where(edge, lo, nlo)
        hi = torch.where(edge, hi, nhi)
        dflt = torch.where(edge, dflt, d)
    p0, lo0, hi0 = cands[..., :-2], cands[..., -2], cands[..., -1]
    verified = (((dflt[..., None] == p0) & (dflt[..., None] > 0)).any(-1)
                | in_ivl(dflt, lo0, hi0))
    return torch.where(verified, dflt, cands[..., 0])


def _match_lengths(off: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Exact match length (capped at 68) per position (encode.py:621)."""
    iota = _iota(off.device)
    m4 = off > 0
    link = (m4 & torch.roll(m4, -4, dims=-1)
            & (torch.roll(off, -4, dims=-1) == off))
    r = link.to(torch.int32)
    step = 1
    for _ in range(4):
        r = torch.where(r == step, step + torch.roll(r, -4 * step, dims=-1),
                        r)
        step *= 2
    mlq = torch.where(m4, 4 + 4 * torch.clamp(r, max=16), 0)
    ml = mlq
    for p in (1, 2, 3):
        agree = ((torch.roll(off, -p, dims=-1) == off)
                 & torch.roll(m4, -p, dims=-1))
        ml = torch.maximum(ml, torch.where(
            agree, p + torch.roll(mlq, -p, dims=-1), 0))
    ml = torch.where(m4, ml, 0)
    return torch.minimum(ml, n.to(torch.int32)[:, None] - iota)


def _propagate(ml: torch.Tensor, off: torch.Tensor):
    """Suffix-match propagation ml'[i] = max_{j<=i} ml[j] - (i-j), over a
    128-wide window (encode.py:647)."""
    iota = _iota(ml.device)
    pvs = ml + iota
    offp = off
    for lvl in range(7):
        shift = 1 << lvl
        av = torch.roll(pvs, shift, dims=-1)
        av[..., :shift] = -1
        ao = torch.roll(offp, shift, dims=-1)
        take_a = av > pvs
        pvs = torch.where(take_a, av, pvs)
        offp = torch.where(take_a, ao, offp)
    return torch.clamp(pvs - iota, max=68), offp


def _jump(mlp: torch.Tensor) -> torch.Tensor:
    """Greedy advance: literals move 1, matches by emitted copy length
    (long matches split 64/60 so the last element stays >= 4)."""
    return torch.where(mlp < 4, 1, torch.where(
        mlp <= 64, mlp, torch.where(mlp < 68, 60, 64))).to(torch.int32)


def _matcher_xla(cands: torch.Tensor, n: torch.Tensor,
                 lazy: int = DEFAULT_CONFIG.lazy, sticky: str = "exact",
                 table: str = "points"):
    """Candidate table (B, N, K) -> (jump, offset) (encode.py:680): the
    plain body of the matcher kernels, and the route of table
    "intervals"."""
    iota = _iota(cands.device)
    if table == "intervals":
        off_s = _sticky_offsets_intervals(cands, sticky)
    else:
        off_s = _sticky_offsets(cands, sticky)
    ml = _match_lengths(off_s, n)
    # Profitability filter: drop len-4 far copies, and len-5 far copies
    # with no other match start in the 16 bytes before.
    has = (ml > 0).to(torch.int32)
    m4cnt = torch.cumsum(has, dim=-1, dtype=torch.int32)
    before16 = m4cnt - torch.where(iota >= 17,
                                   torch.roll(m4cnt, 17, dims=-1), 0)
    isolated = (before16 - has) == 0
    near = off_s < _C1
    keep = ((ml >= 5) | near) & ((ml >= 6) | near | ~isolated)
    ml = torch.where(keep, ml, 0)
    mlp, off = _propagate(ml, off_s)
    # Lazy deferral: a match becomes a literal when the next position's
    # match is at least `lazy` bytes longer (never inside the 64/68 split).
    nxt = torch.roll(mlp, -1, dims=-1)
    nxt[..., -1] = 0
    if lazy:
        defer = (mlp >= 4) & (mlp < 64) & (nxt >= mlp + lazy)
        mlp = torch.where(defer, 0, mlp)
    return _jump(mlp), off


def _match(blocks: torch.Tensor, n: torch.Tensor, cfg: CodecConfig):
    """Window keys, candidate table and matcher on the route of cfg's
    table (module docstring). Returns (jump, off), each (B, N) int32."""
    if cfg.stride == 1:
        key = _window_keys(blocks, n)
    else:
        key = _window_keys_strided(blocks, n, cfg.stride)
    packed = cfg.table == "points" and cfg.flatten != "off"
    with profiling.span("encode.candidates"):
        cands = _candidate_offsets(key, n, cfg, packed=packed)
    if cfg.table == "intervals":
        return _matcher_xla(cands, n, cfg.lazy, cfg.sticky, cfg.table)
    if not packed:
        return _matcher.matcher_block(cands, n, cfg.lazy, cfg.sticky)
    pref, words = cands
    return _matcher.matcher_block_packed(pref, words, n, cfg.candidates,
                                         cfg.lazy, cfg.sticky)


def _emit_lanes(cj: torch.Tensor, off: torch.Tensor, blocks: torch.Tensor,
                n: torch.Tensor):
    """XLA emission lanes (encode.py:836-904) of the committed parse cj
    (committed ? jump : -1): every output byte becomes one (dest << 8 |
    byte) pack. Lane A carries tag bytes (the 2nd/3rd header byte rides
    position i+1/i+2), lane B the literal payload; dest = SENT where a
    lane is idle. Returns (pack_a, pack_b (B, N) int32, total (B,) int32),
    the plain form of the two-lane emission kernel."""
    iota = _iota(cj.device)
    nn = n.to(torch.int32)[:, None]
    is_copy = cj >= 4
    is_lit = (cj >= 0) & (cj < 4)
    lit_start = is_lit & ~_rollz(is_lit, 1)
    elem = is_copy | lit_start

    run_end = torch.minimum(scan.next_element_start(elem, N), nn)
    lit_len = torch.clamp(run_end - iota, min=1)  # valid at lit_start only
    copy_small = (cj <= fmt.COPY1_MAX_LEN) & (off < _C1)
    copy_sz = torch.where(copy_small, 2, 3)
    lit_hdr = torch.where(lit_len <= 60, 1, torch.where(lit_len <= 256, 2, 3))
    esz = torch.where(is_copy, copy_sz, lit_hdr + lit_len)
    esz = torch.where(elem, esz, 0).to(torch.int32)
    out_off = scan.exclusive_cumsum(esz)
    total = esz.sum(dim=-1, dtype=torch.int32)

    n1 = lit_len - 1
    lt0 = torch.where(lit_len <= 60, n1 << 2,
                      torch.where(lit_len <= 256, 60 << 2, 61 << 2))
    ct0 = torch.where(copy_small, 1 | ((cj - 4) << 2) | ((off >> 8) << 5),
                      2 | ((cj - 1) << 2))
    t0 = torch.where(is_copy, ct0, lt0)
    t12 = torch.where(is_copy, off, n1)
    t1 = t12 & 0xFF
    t2 = (t12 >> 8) & 0xFF
    hdr = torch.where(is_copy, copy_sz, lit_hdr)

    a_t1 = _rollz(elem, 1) & (_rollz(hdr, 1) >= 2)
    a_t2 = _rollz(elem, 2) & (_rollz(hdr, 2) >= 3)
    lane_a_val = torch.where(elem, t0, torch.where(
        a_t1, _rollz(t1, 1), _rollz(t2, 2)))
    lane_a_dst = torch.where(elem, out_off, torch.where(
        a_t1, _rollz(out_off, 1) + 1, _rollz(out_off, 2) + 2))
    lane_a_on = elem | a_t1 | a_t2
    # Lane B: literal payload, dest = out_off[s] + hdr[s] + (i - s).
    basef = scan.ffill(lit_start, (out_off + lit_hdr - iota).to(torch.int32))
    pack_a = (torch.where(lane_a_on, lane_a_dst, SENT) << 8) | (
        lane_a_val & 0xFF)
    pack_b = (torch.where(is_lit, basef + iota, SENT) << 8) | blocks.to(
        torch.int32)
    return pack_a.to(torch.int32), pack_b.to(torch.int32), total


def _sort_lanes(pack: torch.Tensor, total: torch.Tensor, cap: int):
    """Placement sort: rank j of the sorted packs is output byte j; the tail
    past each row's total is zeroed (sentinel low bytes)."""
    out = (torch.sort(pack, dim=-1).values[..., :cap] & 0xFF).to(torch.uint8)
    keep = torch.arange(cap, device=pack.device) < total[:, None]
    return torch.where(keep, out, 0), total


def _overflow_entries(pa, pb, head) -> torch.Tensor:
    """The 2048 overflow entries of a row (encode.py:797-805): `pa` max-
    compacted to 256 slots, `pb` to 1024, `head`, then 640 sentinels.
    Nonzero overflow packs sit > 64 (pa: > 256) positions apart, so one
    per slot survives the max; empty slots become sentinel packs."""
    b = pa.shape[0]
    sentp = SENT << 8
    ovf_a = pa.reshape(b, 256, N // 256).amax(dim=-1)
    ovf_b = pb.reshape(b, 1024, N // 1024).amax(dim=-1)
    return torch.cat([torch.where(ovf_a == 0, sentp, ovf_a),
                      torch.where(ovf_b == 0, sentp, ovf_b), head,
                      torch.full((b, 640), sentp, dtype=torch.int32,
                                 device=pa.device)], dim=-1)


def _emit_winplace(blocks, n, cj, off, cap: int):
    """Single-lane emission, windowed placement and the overflow scatter
    (encode.py:793-821): each output byte rides one position of the main
    lane, placed by the windowed kernel; literal headers' 2nd and 3rd
    bytes and a block-opening tag ride 2048 overflow entries, compacted by
    reshape-max and placed by the full-height scatter. The two placements
    write disjoint cells, so their sum is the stream."""
    pm, pa, pb, head, total = _emit.emit_block_single(cj, off, blocks, n)
    ovf = _overflow_entries(pa, pb, head)
    main, _ = _place.place_block(pm >> 8, pm & 0xFF, cap // 128)
    extra = _scatter.scatter_block(ovf >> 8, ovf & 0xFF, 1, cap)
    out = (main + extra).to(torch.uint8)
    keep = torch.arange(cap, device=blocks.device) < total[:, None]
    return torch.where(keep, out, 0), total


def _emit_single_sort(blocks, n, cj, off, cap: int):
    """Single-lane emission and the N + 2048 placement sort
    (encode.py:817-819)."""
    pm, pa, pb, head, total = _emit.emit_block_single(cj, off, blocks, n)
    pad = torch.full((pm.shape[0], max(cap - N - 2048, 0)), SENT << 8,
                     dtype=torch.int32, device=pm.device)
    pack = torch.cat([pm, _overflow_entries(pa, pb, head), pad], dim=-1)
    return _sort_lanes(pack, total, cap)


def encode_blocks(blocks: torch.Tensor, lengths: torch.Tensor,
                  cfg: CodecConfig = DEFAULT_CONFIG,
                  placement: str = "auto"):
    """Batched block encode at `cfg`. blocks (B, 65536) uint8 zero-padded
    past each length; lengths (B,) int32 (at most cfg.block_size each).
    placement: one of PLACEMENTS (module docstring); all give the same
    bytes. Returns (out (B, cfg.block_capacity) uint8 raw Snappy elements,
    zero past out_lens; out_lens (B,) int32). ("kernel" returns the
    placement's cap // 128 * 128 cells, as the JAX package does.)"""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r}: one of {PLACEMENTS}")
    n = lengths.to(torch.int32)
    with profiling.span("encode.match"):
        jump, off = _match(blocks, n, cfg)
    with profiling.span("encode.commit"):
        committed = scan.commit_bounded(jump) & (_iota(blocks.device)
                                                 < n[:, None])
    with profiling.span("encode.emit"):
        return _emit_placed(blocks, n, torch.where(committed, jump, -1), off,
                            cfg.block_capacity, placement)


def _emit_placed(blocks, n, cj, off, cap: int, placement: str):
    """Emission and placement of the committed parse cj on `placement`'s
    route (module docstring)."""
    if placement in ("auto", "winplace"):
        return _emit_winplace(blocks, n, cj, off, cap)
    if placement == "single":
        return _emit_single_sort(blocks, n, cj, off, cap)
    if placement == "emit":
        pack_a, pack_b, total = _emit.emit_block(cj, off, blocks, n)
    else:
        pack_a, pack_b, total = _emit_lanes(cj, off, blocks, n)
    pack = torch.cat([pack_a, pack_b], dim=-1)
    if placement == "kernel":
        placed, _ = _place.place_block(pack >> 8, pack & 0xFF, cap // 128)
        return placed.to(torch.uint8), total
    return _sort_lanes(pack, total, cap)


def encode_block(block, n, cfg: CodecConfig = DEFAULT_CONFIG,
                 placement: str = "auto", *, device="cuda"):
    """Encode one 64 KB block (encode.py:721): block (65536,) uint8,
    zero-padded past n (at most cfg.block_size), as an array or tensor,
    moved to `device` (a CUDA device unless the caller asks for the CPU).
    placement: one of PLACEMENTS. Returns (out (cfg.block_capacity,) uint8
    raw Snappy elements with no stream preamble, zero past out_len;
    out_len, an int32 0-d tensor): row 0 of encode_blocks on the block
    alone."""
    blocks = torch.as_tensor(block, device=device).reshape(1, N)
    lengths = torch.as_tensor(n, dtype=torch.int32, device=device).reshape(1)
    out, out_lens = encode_blocks(blocks, lengths, cfg, placement)
    return out[0], out_lens[0]


#: Rows that compact_blocks masks at once: the mask's index tensor takes
#: 8 bytes per kept byte, so a corpus-wide mask would take about 8x the
#: stream on the device; 128 rows keep it under 70 MB.
_COMPACT_ROWS = 128


def compact_blocks(out: torch.Tensor, out_lens: torch.Tensor):
    """Join each row's first out_lens bytes into one dense stream. Returns
    (dense (B*cap,) uint8 with the stream first and zeros after, total)."""
    nb, cap = out.shape
    dense = torch.zeros(nb * cap, dtype=torch.uint8, device=out.device)
    cols = torch.arange(cap, device=out.device)
    total = 0
    for s in range(0, nb, _COMPACT_ROWS):
        rows = slice(s, s + _COMPACT_ROWS)
        keep = (cols < out_lens[rows, None]).reshape(-1)
        stream = out[rows].reshape(-1)[keep]  # the rows' payloads in order
        dense[total:total + stream.numel()] = stream
        total += stream.numel()
    return dense, total


def encode_corpus(blocks: torch.Tensor, lengths: torch.Tensor,
                  cfg: CodecConfig = DEFAULT_CONFIG, placement: str = "auto",
                  wave: int = 8):
    """encode_blocks over a corpus in waves of `wave` blocks
    (encode.py:971): blocks (NB, 65536) uint8 and lengths (NB,) int32, NB a
    multiple of `wave` (ValueError otherwise; pad with zero-length rows).
    Each wave's result is written into one (NB, cap) tensor. Returns (out,
    out_lens (NB,) int32), the rows encode_blocks gives."""
    nb = blocks.shape[0]
    if wave < 1 or not nb or nb % wave:
        raise ValueError(f"encode_corpus: {nb} blocks are not a multiple of "
                         f"the wave {wave}; pad with zero-length rows")
    out = lens = None
    for s in range(0, nb, wave):
        with profiling.span("encode.wave"):
            rows, row_lens = encode_blocks(blocks[s:s + wave],
                                           lengths[s:s + wave], cfg,
                                           placement)
            if out is None:  # the placement decides the row width
                out = rows.new_empty((nb, rows.shape[1]))
                lens = row_lens.new_empty(nb)
            out[s:s + wave], lens[s:s + wave] = rows, row_lens
    return out, lens


def encode_corpus_compact(blocks: torch.Tensor, lengths: torch.Tensor,
                          cfg: CodecConfig = DEFAULT_CONFIG,
                          placement: str = "auto", wave: int = 8):
    """encode_corpus, then compact_blocks (encode.py:959): returns (dense
    (NB * cap,) uint8 with the stream first, out_lens (NB,) int32, total),
    so that the host fetches dense[:total] once."""
    with profiling.span("encode.corpus"):
        out, lens = encode_corpus(blocks, lengths, cfg, placement, wave)
        with profiling.span("encode.compact"):
            dense, total = compact_blocks(out, lens)
    return dense, lens, total
