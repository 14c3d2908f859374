"""Parallel scans shared by encode and decode (port of tpu_snappy/ops/scan.py).

Both pipelines chase `next[i] = i + jump[i]` from 0 (the encoder's greedy
parse, the decoder's tag chain). The two-level scheme is the JAX one:
exit maps per 64-position segment by pointer doubling, entry states per
segment by composing maps, then a 64-step recurrence for the committed
flags. The entry states have the JAX package's forms: the log-depth
composition and the walk over segments, the grouped walk (G segments a
table), and the halving trees of bounded maps and of concatenated pair
tables, which shorten the walk to NSEG / 2**levels steps. Every form gives
the same flags. These stages are XLA (not Pallas) in the JAX package, so
they are plain PyTorch here; every gather is an integer `torch.gather`
(the JAX one-hot f32 einsum is a TPU workaround). Arrays carry a leading
batch dimension: (B, N).
"""

from __future__ import annotations

import torch

from .kernels import ffill as _ffill_kernel

S = 64  # segment width == MAX_COPY_LEN; the encode invariant jump <= S


def ffill(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Forward-fill `vals` from the latest position where mask holds;
    positions before the first set mask keep their own entry."""
    return _ffill_kernel.ffill(mask, (vals,))[0]


def ffill_many(mask: torch.Tensor, vals: tuple) -> tuple:
    """Forward-fill any number of payloads from one mask (one scan of the
    mask; on the card, one gather launch for each four payloads)."""
    return _ffill_kernel.ffill(mask, vals)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=x.dtype) - x


def next_element_start(flags: torch.Tensor, default: int) -> torch.Tensor:
    """For each i, the smallest j > i with flags[j], else `default`."""
    n = flags.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=flags.device)
    eidx = torch.where(flags, iota, default)
    rc = torch.flip(torch.cummin(torch.flip(eidx, [-1]), dim=-1).values, [-1])
    out = torch.roll(rc, -1, dims=-1)
    out[..., -1] = default
    return out


def gather_s(maps: torch.Tensor, idx: torch.Tensor,
             small: bool = False) -> torch.Tensor:
    """Within-segment gather (scan.py:34): y[..., g, t] = maps[..., g,
    idx[..., g, t]], 0 where the index lies outside the segment (the JAX
    one-hot finds no column there). maps (..., G, S), idx (..., G, T).
    `small` is the TPU's hint that every value is below 256 (JAX then
    feeds bf16 to its one-hot product); an integer gather needs no such
    hint, and it changes no value in that domain. Returns maps' dtype."""
    inside = (idx >= 0) & (idx < maps.shape[-1])
    got = torch.gather(maps, -1, torch.where(inside, idx, 0).to(torch.int64))
    return torch.where(inside, got, torch.zeros_like(got))


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[..., idx] along the last axis, each index clamped into the
    table (the gather_s / _gather_d of scan.py)."""
    return torch.gather(table, -1, torch.clamp(
        idx, 0, table.shape[-1] - 1).to(torch.int64))


def segment_exit_maps(jump: torch.Tensor,
                      bounded: bool = False) -> torch.Tensor:
    """Within-segment chase tables. jump: (B, N) int32, every entry >= 1.
    Returns (B, N//S, S): entry state d -> exit state (distance past the
    segment end; >= S where one jump overshoots the next segment).
    bounded: the JAX package's argument (scan.py:91), the caller's
    promise that every jump is at most S. There it lets the TPU run the
    map rounds in bf16; the values are the same either way, so here it
    changes nothing."""
    b, n = jump.shape
    t = torch.arange(S, dtype=torch.int32, device=jump.device) \
        + jump.reshape(b, n // S, S)
    # Each round at least doubles the covered hops; S hops need 6 rounds.
    for _ in range(6):
        t = torch.where(t >= S, t, _lookup(t, t))
    return t - S


def entry_states_bounded(exit_maps: torch.Tensor) -> torch.Tensor:
    """Entry state per segment by a log-depth prefix composition of the
    exit maps (bounded jumps only: every map value lies in [0, S)).
    exit_maps: (B, NSEG, S). Returns (B, NSEG)."""
    prefix = exit_maps
    nseg = exit_maps.shape[-2]
    shift = 1
    while shift < nseg:
        # prefix[i] <- prefix[i] after prefix[i - shift] (earlier first).
        later = _lookup(prefix[:, shift:], prefix[:, :-shift])
        prefix = torch.cat([prefix[:, :shift], later], dim=1)
        shift *= 2
    e = prefix[..., 0]  # state after segments 0..s, entered at 0
    entry = torch.roll(e, 1, dims=-1)
    entry[..., 0] = 0
    return entry


def _entry_walk(maps: torch.Tensor, width: int) -> torch.Tensor:
    """Entry state per table by a walk over the tables (B, T, width) in
    order: a state d < width enters through the table, d >= width skips
    it (d - width). Returns (B, T)."""
    b, count, _ = maps.shape
    steps = maps.permute(1, 0, 2)  # (T, B, width)
    entries = torch.empty((count, b), dtype=maps.dtype, device=maps.device)
    d = torch.zeros(b, dtype=maps.dtype, device=maps.device)
    for k in range(count):
        entries[k] = d
        d = torch.where(d >= width, d - width,
                        _lookup(steps[k], d[:, None])[:, 0])
    return entries.t()


def _at(table: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """One entry of each table: (B, T, W) at (B, T) -> (B, T)."""
    return _lookup(table, state[..., None])[..., 0]


def _halves(maps: torch.Tensor, levels: int, name: str) -> None:
    if maps.shape[-2] % (1 << levels):
        raise ValueError(f"{name}: {maps.shape[-2]} segments do not halve "
                         f"{levels} times")


def entry_states_sequential(exit_maps: torch.Tensor) -> torch.Tensor:
    """Entry state per segment by a walk over segments (any jump >= 1:
    exit states >= S skip whole segments). Returns (B, NSEG)."""
    return _entry_walk(exit_maps, S)


#: Segments per group of entry_states_grouped, and the width D = G * S of
#: its group tables: an entry state at or above D skips the whole group.
G = 4
D = G * S


def entry_states_grouped(exit_maps: torch.Tensor) -> torch.Tensor:
    """Entry state per segment, two-level (scan.py:181): each group of G
    segments composes into one D-wide table, a walk over the NSEG / G
    groups gives the group entries, and each segment's entry is a stored
    prefix table evaluated at its group's entry. Any jump >= 1; NSEG a
    multiple of G."""
    b, nseg, _ = exit_maps.shape
    if nseg % G:
        raise ValueError(f"entry_states_grouped: {nseg} segments are not a "
                         f"multiple of {G}")
    local = torch.arange(D, dtype=exit_maps.dtype, device=exit_maps.device)
    # Domain D: entering a segment at d >= S skips it (exit d - S).
    wide = torch.nn.functional.pad(exit_maps, (0, D - S))
    seg = torch.where(local < S, wide, local - S).reshape(b, nseg // G, G, D)
    prefixes = [seg[:, :, 0]]
    for j in range(1, G):
        h = prefixes[-1]
        thru = _lookup(seg[:, :, j], h)
        prefixes.append(torch.where(h < S, thru, h - S))
    ge = _entry_walk(prefixes[-1], D)  # (B, NSEG / G)
    cols = [ge] + [torch.where(ge >= D, ge - (j + 1) * S,
                               _at(prefixes[j], ge)) for j in range(G - 1)]
    return torch.stack(cols, dim=-1).reshape(b, nseg)


def entry_states_tree(exit_maps: torch.Tensor,
                      levels: int = 3) -> torch.Tensor:
    """Entry states by a halving tree of bounded exit maps (scan.py:253;
    bounded jumps only, so every table stays S wide): `levels` pairwise
    compositions, a walk over the NSEG / 2**levels coarse tables, then a
    descent in which an odd segment's entry is its even sibling's exit map
    at the sibling's entry."""
    _halves(exit_maps, levels, "entry_states_tree")
    maps, stack = exit_maps, []
    for _ in range(levels):
        f, g = maps[:, 0::2], maps[:, 1::2]
        stack.append(f)
        maps = _lookup(g, f)
    e = _entry_walk(maps, S)
    for f in reversed(stack):
        e = torch.stack([e, _at(f, e)], dim=-1).reshape(e.shape[0], -1)
    return e


def entry_states_tree_general(exit_maps: torch.Tensor,
                              levels: int = 2) -> torch.Tensor:
    """Entry states for any jump >= 1 by a halving tree of concatenated
    pair tables (scan.py:304): a pair (f earlier, g later, each w wide) is
    answered by [h | g], 2w wide, with h[d] = g[f[d]] where f[d] < w, else
    f[d] - w; an entry >= 2w skips the pair. The walk runs over NSEG /
    2**levels tables, and the descent keeps each level's (f, w): an odd
    entry is f at the even entry, or e - w where e >= w."""
    _halves(exit_maps, levels, "entry_states_tree_general")
    maps, w, stack = exit_maps, S, []
    for _ in range(levels):
        f, g = maps[:, 0::2], maps[:, 1::2]
        stack.append((f, w))
        h = torch.where(f < w, _lookup(g, f), f - w)
        maps = torch.cat([h, g], dim=-1)
        w *= 2
    e = _entry_walk(maps, w)
    for f, fw in reversed(stack):
        odd = torch.where(e < fw, _at(f, e), e - fw)
        e = torch.stack([e, odd], dim=-1).reshape(e.shape[0], -1)
    return e


def committed_from_entries(jump: torch.Tensor,
                           entry: torch.Tensor) -> torch.Tensor:
    """Per-position committed flags from per-segment entry states: the
    greedy recurrence d' = (d == 0 ? jump : d) - 1 over the S positions of
    every segment at once."""
    b, n = jump.shape
    seg = jump.reshape(b, n // S, S)
    flags = torch.empty((b, n // S, S), dtype=torch.bool, device=jump.device)
    d = entry
    for i in range(S):
        com = d == 0
        flags[..., i] = com
        d = torch.where(com, seg[..., i], d) - 1
    return flags.reshape(b, n)


def commit_bounded(jump: torch.Tensor, sequential: bool = False,
                   tree_levels: int = 0) -> torch.Tensor:
    """Committed flags for bounded jumps (1 <= jump <= S): the encode
    parse (scan.py:283). The entry states come from the log-depth
    composition by default, from the walk over segments with
    `sequential`, or from a halving tree of `tree_levels` levels (NSEG
    must halve that often: ValueError otherwise). Every form gives the
    same flags."""
    maps = segment_exit_maps(jump)
    if tree_levels > 0:
        entry = entry_states_tree(maps, tree_levels)
    elif sequential:
        entry = entry_states_sequential(maps)
    else:
        entry = entry_states_bounded(maps)
    return committed_from_entries(jump, entry)


def commit_general(jump: torch.Tensor, grouped: bool = False,
                   tree_levels: int = 0) -> torch.Tensor:
    """Committed flags for arbitrary jumps >= 1: the decode tag parse
    (scan.py:359). The entry states come from the walk over segments by
    default, from the concatenated halving tree where `tree_levels` > 0
    and NSEG halves that often, else from the grouped walk where
    `grouped` and NSEG is a multiple of G. Every form gives the same
    flags."""
    maps = segment_exit_maps(jump)
    nseg = maps.shape[-2]
    if tree_levels > 0 and nseg % (1 << tree_levels) == 0:
        entry = entry_states_tree_general(maps, tree_levels)
    elif grouped and nseg % G == 0:
        entry = entry_states_grouped(maps)
    else:
        entry = entry_states_sequential(maps)
    return committed_from_entries(jump, entry)
