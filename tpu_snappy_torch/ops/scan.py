"""Parallel scans shared by encode and decode (port of tpu_snappy/ops/scan.py).

Both pipelines chase `next[i] = i + jump[i]` from 0 (the encoder's greedy
parse, the decoder's tag chain). The two-level scheme is the JAX one:
exit maps per 64-position segment by pointer doubling, entry states per
segment by composing maps, then a 64-step recurrence for the committed
flags. These stages are XLA (not Pallas) in the JAX package, so they are
plain PyTorch here; every gather is an integer `torch.gather` (the JAX
one-hot f32 einsum is a TPU workaround). Arrays carry a leading batch
dimension: (B, N).
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
    """Forward-fill up to four payloads from one mask in one pass."""
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


def segment_exit_maps(jump: torch.Tensor) -> torch.Tensor:
    """Within-segment chase tables. jump: (B, N) int32, every entry >= 1.
    Returns (B, N//S, S): entry state d -> exit state (distance past the
    segment end; >= S where one jump overshoots the next segment)."""
    b, n = jump.shape
    t = torch.arange(S, dtype=torch.int32, device=jump.device) \
        + jump.reshape(b, n // S, S)
    # Each round at least doubles the covered hops; S hops need 6 rounds.
    for _ in range(6):
        g = torch.gather(t, -1, torch.clamp(t, 0, S - 1).to(torch.int64))
        t = torch.where(t >= S, t, g)
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
        earlier = torch.clamp(prefix[:, :-shift], 0, S - 1).to(torch.int64)
        later = torch.gather(prefix[:, shift:], -1, earlier)
        prefix = torch.cat([prefix[:, :shift], later], dim=1)
        shift *= 2
    e = prefix[..., 0]  # state after segments 0..s, entered at 0
    entry = torch.roll(e, 1, dims=-1)
    entry[..., 0] = 0
    return entry


def entry_states_sequential(exit_maps: torch.Tensor) -> torch.Tensor:
    """Entry state per segment by a walk over segments (any jump >= 1:
    exit states >= S skip whole segments). Returns (B, NSEG)."""
    b, nseg, _ = exit_maps.shape
    maps = exit_maps.permute(1, 0, 2)  # (NSEG, B, S)
    entries = torch.empty((nseg, b), dtype=exit_maps.dtype,
                          device=exit_maps.device)
    d = torch.zeros(b, dtype=exit_maps.dtype, device=exit_maps.device)
    for k in range(nseg):
        entries[k] = d
        idx = torch.clamp(d, 0, S - 1).to(torch.int64)[:, None]
        thru = torch.gather(maps[k], -1, idx)[:, 0]
        d = torch.where(d >= S, d - S, thru)
    return entries.t()


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


def commit_bounded(jump: torch.Tensor) -> torch.Tensor:
    """Committed flags for bounded jumps (1 <= jump <= S): the encode
    parse, by the log-depth composition (scan.py:283)."""
    maps = segment_exit_maps(jump)
    return committed_from_entries(jump, entry_states_bounded(maps))


def commit_general(jump: torch.Tensor) -> torch.Tensor:
    """Committed flags for arbitrary jumps >= 1: the decode tag parse, by
    the sequential entry walk (scan.py:359 at its default)."""
    maps = segment_exit_maps(jump)
    return committed_from_entries(jump, entry_states_sequential(maps))
