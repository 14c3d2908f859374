"""Batched Snappy block encoder in PyTorch (port of tpu_snappy/ops/encode.py).

This is the JAX encoder at DEFAULT_CONFIG (K=14 point candidates, probes
== K, flatten "class", lazy 2, sticky "exact", stride 1) on its TPU
default route (encode.py:750-821): the packed candidate form feeds the
fused matcher kernel, then the commit scan, single-lane emission,
windowed placement and the overflow scatter. Every kernel runs through
ops/kernels/ (hand-written CUDA on the card, the plain version on the
CPU); the rest is plain tensor code. Every per-position array is
(B, 65536).

Stages: window keys, pair sort of (key, position), rank-space candidate
table, restore to position space (packed words), matcher, commit scan,
emission, placement. `placement="sort"` keeps the XLA emission lanes and
the 2N placement sort (the JAX package's CPU route; same bytes).
"""

from __future__ import annotations

import functools

import torch

from .. import format as fmt
from ..config import DEFAULT_CONFIG
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

#: The DEFAULT_CONFIG knobs this slice implements (presets are later
#: slices): K point candidates (probes == K), lazy threshold, capacity.
K = DEFAULT_CONFIG.candidates
LAZY = DEFAULT_CONFIG.lazy
CAPACITY = DEFAULT_CONFIG.block_capacity

_C1 = fmt.COPY1_MAX_OFFSET


def _iota(device) -> torch.Tensor:
    return torch.arange(N, dtype=torch.int32, device=device)


def _rollz(x: torch.Tensor, s: int) -> torch.Tensor:
    """Roll toward higher indices with zero fill (no wrap)."""
    y = torch.roll(x, s, dims=-1)
    y[..., :s] = 0
    return y


def _window_keys(blocks: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Pair-sort keys: the window at every i <= n-4, 0xFFFFFFFF past it."""
    return _windows.window_keys(blocks, n)


def _candidate_offsets(key: torch.Tensor, n: torch.Tensor):
    """Rank-space candidate table (encode.py:134) at even K, probes == K,
    flatten "class", in the packed form the matcher kernel takes
    (encode.py:359-376, packed=True). Returns (pref (B, N) int32, the gated
    flattening default; words (B, K/2, N) int32, the restore payload: word
    j holds offsets 2j and 2j+1 of the K-1 nearest earlier positions with
    the same 4-byte window (0 = none) as two 16-bit halves, low first, and
    the last word carries the flattening offset in its high half)."""
    dev = key.device
    iota = _iota(dev)
    nn = n.to(torch.int32)[:, None]
    # (key, position) pairs sort as one int64: keys are < 2^32 and
    # positions unique, so this is lax.sort(num_keys=2)'s order.
    packed, _ = torch.sort((key << 16) | iota.to(torch.int64), dim=-1)
    w_s = packed >> 16
    pos_s = (packed & 0xFFFF).to(torch.int32)

    offs = []
    for shift in range(1, K + 1):
        prev_w = torch.roll(w_s, shift, dims=-1)
        prev_pos = torch.roll(pos_s, shift, dims=-1)
        same = ((w_s == prev_w) & (iota >= shift) & (prev_pos <= nn - 4)
                & (pos_s <= nn - 4))
        offs.append(torch.where(same, pos_s - prev_pos, 0))

    # Chain-flattening candidate "class" (encode.py:188-258).
    run_start = (w_s != torch.roll(w_s, 1, dims=-1)) | (iota == 0)
    first_pos = scan.ffill(run_start, pos_s)
    first = torch.where((w_s != _windows.INVALID) & (first_pos < pos_s),
                        pos_s - first_pos, 0)
    c0 = offs[0]
    m1 = functools.reduce(torch.maximum, [
        torch.where((o > 0) & (o < _C1), o, 0) for o in offs])
    m2 = functools.reduce(torch.maximum, offs)
    f1 = (first > 0) & (first < _C1)
    flat = torch.where(c0 < _C1, torch.where(f1, first, m1),
                       torch.where(first > 0, first, m2))
    slots = offs[:K - 1] + [flat]
    # Two 16-bit offsets per int32 word (the u32 bit pattern; unpack with
    # >> 16 then & 0xFFFF).
    ranked = torch.stack([slots[2 * j] | (slots[2 * j + 1] << 16)
                          for j in range(K // 2)], dim=1)  # (B, K/2, N)

    # Back to position space: positions are a permutation, so the JAX
    # restore sort is an inverse-permutation scatter.
    words = torch.empty_like(ranked)
    words.scatter_(2, pos_s.to(torch.int64)[:, None].expand_as(ranked),
                   ranked)
    pref = _flat_gate((words[:, K // 2 - 1] >> 16) & 0xFFFF,
                      words[:, 0] & 0xFFFF)
    return pref, words


def _flat_gate(flat: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Take the flattening offset only where it proves an 8-byte extension
    and the nearest does not win (encode.py:402)."""
    agree = (torch.roll(flat, -4, dims=-1) == flat) & (flat > 0)
    agree_near = (torch.roll(c0, -4, dims=-1) == c0) & (c0 > 0)
    return torch.where(agree & ((c0 > 68) | ~agree_near), flat, c0)


def _sticky_offsets(cands: torch.Tensor) -> torch.Tensor:
    """Chain-stable offset per position (encode.py:568): windowed
    composition of "keep the offset from i-4 if it is one of my
    candidates, else my default" over 2**STICKY_LEVELS stride-4 steps."""
    keep = cands
    dflt = cands[..., 0]
    iota = _iota(cands.device)
    for lvl in range(STICKY_LEVELS):
        shift = 4 << lvl
        a_keep = torch.roll(keep, shift, dims=1)
        a_dflt = torch.roll(dflt, shift, dims=1)
        # Membership in this position's keep-set: (B, N, K, K) compares.
        in_keep = ((a_keep[..., None] == keep[..., None, :])
                   & (a_keep[..., None] > 0)).any(dim=-1)
        in_dflt = ((a_dflt[..., None] == keep) & (a_dflt[..., None] > 0)
                   ).any(dim=-1)
        new_keep = torch.where(in_keep, a_keep, 0)
        new_dflt = torch.where(in_dflt, a_dflt, dflt)
        # Window start: no left context rolls in from the array end.
        edge = iota < shift
        keep = torch.where(edge[:, None], keep, new_keep)
        dflt = torch.where(edge, dflt, new_dflt)
    return dflt


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


def _matcher_xla(cands: torch.Tensor, n: torch.Tensor, lazy: int = LAZY):
    """Candidate table (B, N, K) -> (jump, offset) (encode.py:680, sticky
    "exact"): the plain body of the matcher kernel."""
    iota = _iota(cands.device)
    off_s = _sticky_offsets(cands)
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


def _emit_sort(blocks, n, jump, off, committed):
    """XLA emission lanes + the 2N placement sort (encode.py:836-918):
    every output byte becomes one (dest << 8 | byte) entry, and rank j of
    the sorted entries is output byte j."""
    iota = _iota(blocks.device)
    nn = n.to(torch.int32)[:, None]
    is_copy = committed & (jump >= 4)
    is_lit = committed & ~is_copy
    lit_start = is_lit & ~_rollz(is_lit, 1)
    elem = is_copy | lit_start

    run_end = torch.minimum(scan.next_element_start(elem, N), nn)
    lit_len = torch.clamp(run_end - iota, min=1)  # valid at lit_start only
    cpy_len = jump
    copy_small = (cpy_len <= fmt.COPY1_MAX_LEN) & (off < _C1)
    copy_sz = torch.where(copy_small, 2, 3)
    lit_hdr = torch.where(lit_len <= 60, 1, torch.where(lit_len <= 256, 2, 3))
    esz = torch.where(is_copy, copy_sz, lit_hdr + lit_len)
    esz = torch.where(elem, esz, 0).to(torch.int32)
    out_off = scan.exclusive_cumsum(esz)
    total = esz.sum(dim=-1, dtype=torch.int32)

    n1 = lit_len - 1
    lt0 = torch.where(lit_len <= 60, n1 << 2,
                      torch.where(lit_len <= 256, 60 << 2, 61 << 2))
    ct0 = torch.where(copy_small,
                      1 | ((cpy_len - 4) << 2) | ((off >> 8) << 5),
                      2 | ((cpy_len - 1) << 2))
    t0 = torch.where(is_copy, ct0, lt0)
    t12 = torch.where(is_copy, off, n1)
    t1 = t12 & 0xFF
    t2 = (t12 >> 8) & 0xFF
    hdr = torch.where(is_copy, copy_sz, lit_hdr)

    # Lane A: tag bytes; the 2nd/3rd header byte rides position i+1/i+2.
    a_t1 = _rollz(elem, 1) & (_rollz(hdr, 1) >= 2)
    a_t2 = _rollz(elem, 2) & (_rollz(hdr, 2) >= 3)
    lane_a_val = torch.where(elem, t0, torch.where(
        a_t1, _rollz(t1, 1), _rollz(t2, 2)))
    lane_a_dst = torch.where(elem, out_off, torch.where(
        a_t1, _rollz(out_off, 1) + 1, _rollz(out_off, 2) + 2))
    lane_a_on = elem | a_t1 | a_t2
    # Lane B: literal payload, dest = out_off[s] + hdr[s] + (i - s).
    basef = scan.ffill(lit_start, (out_off + lit_hdr - iota).to(torch.int32))
    lane_b_dst = basef + iota

    dest = torch.cat([torch.where(lane_a_on, lane_a_dst, SENT),
                      torch.where(is_lit, lane_b_dst, SENT)], dim=-1)
    vals = torch.cat([lane_a_val & 0xFF, blocks.to(torch.int32)], dim=-1)
    pack = (dest.to(torch.int64) << 8) | vals.to(torch.int64)
    out = (torch.sort(pack, dim=-1).values[..., :CAPACITY] & 0xFF
           ).to(torch.uint8)
    # Zero the tail (sentinel low bytes), as the JAX path does.
    keep = torch.arange(CAPACITY, device=blocks.device) < total[:, None]
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


def _emit_winplace(blocks, n, jump, off, committed):
    """Single-lane emission, windowed placement and the overflow scatter
    (encode.py:793-821): each output byte rides one position of the main
    lane, placed by the windowed kernel; literal headers' 2nd and 3rd
    bytes and a block-opening tag ride 2048 overflow entries, compacted by
    reshape-max and placed by the full-height scatter. The two placements
    write disjoint cells, so their sum is the stream."""
    cj = torch.where(committed, jump, -1)
    pm, pa, pb, head, total = _emit.emit_block_single(cj, off, blocks, n)
    ovf = _overflow_entries(pa, pb, head)
    main, _ = _place.place_block(pm >> 8, pm & 0xFF, CAPACITY // 128)
    extra = _scatter.scatter_block(ovf >> 8, ovf & 0xFF, 1, CAPACITY)
    out = (main + extra).to(torch.uint8)
    keep = torch.arange(CAPACITY, device=blocks.device) < total[:, None]
    return torch.where(keep, out, 0), total


def encode_blocks(blocks: torch.Tensor, lengths: torch.Tensor,
                  placement: str = "auto"):
    """Batched block encode at DEFAULT_CONFIG. blocks (B, 65536) uint8
    zero-padded past each length; lengths (B,) int32. placement: "auto"
    (single-lane emission + windowed placement + overflow scatter, the
    TPU default) or "sort" (XLA emission lanes + the 2N placement sort);
    both give the same bytes. Returns (out (B, CAPACITY) uint8 raw Snappy
    elements, zero past out_lens; out_lens (B,) int32)."""
    if placement not in ("auto", "sort"):
        raise ValueError(f"placement {placement!r}: 'auto' or 'sort'")
    n = lengths.to(torch.int32)
    key = _window_keys(blocks, n)
    pref, words = _candidate_offsets(key, n)
    jump, off = _matcher.matcher_block_packed(pref, words, n, K, LAZY,
                                              DEFAULT_CONFIG.sticky)
    committed = scan.commit_bounded(jump) & (_iota(blocks.device)
                                             < n[:, None])
    if placement == "sort":
        return _emit_sort(blocks, n, jump, off, committed)
    return _emit_winplace(blocks, n, jump, off, committed)


def compact_blocks(out: torch.Tensor, out_lens: torch.Tensor):
    """Join each row's first out_lens bytes into one dense stream. Returns
    (dense (B*cap,) uint8 with the stream first and zeros after, total)."""
    nb, cap = out.shape
    keep = torch.arange(cap, device=out.device) < out_lens[:, None]
    stream = out[keep]  # row-major: the rows' payloads in order
    dense = torch.zeros(nb * cap, dtype=torch.uint8, device=out.device)
    dense[:stream.numel()] = stream
    return dense, int(stream.numel())
