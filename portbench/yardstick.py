"""The benchmark's frozen yardstick for the port's kernels: the chip's
peaks and the least time each kernel call could take.

Copied from chip_smoke.py (`HBM_BYTES_PER_S`, `INT_OPS_PER_S`, `_OPS`,
`_bound`, `_doubling_rounds`) and tests/torch_edges.py (`matcher_ops`,
with the encoder's signature hash, `STICKY_LEVELS` and the packed table's
layout), so that a later change to the program cannot move the bounds
it is measured against. It reads only a call's arguments and outputs.

A call's bound is the larger of the bytes the function must move (each
distinct input tensor read once, each output written once; of
gather_block's table, the entries its indices name; of ffill's payloads,
the entries the fill reads) over the memory rate, and the integer
operations it needs over the integer rate. A kernel wrapper that has no
operation rule here is bounded by its bytes alone.
"""

from __future__ import annotations

import functools

import torch

#: Device memory rate and integer rate of one H100 SXM at its full power
#: limit: 3.35 TB/s (NVIDIA's data sheet) and 64 INT32 lanes per SM x 132
#: SMs x 1.98 GHz boost clock (the Hopper architecture white paper).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9

#: Integer operations an element (position, source or target) of each
#: kernel needs, beside the matchers and resolve_block, which count their
#: own.
OPS = {"window_keys": 8, "ffill": 3, "scatter_windowed": 12,
       "resolve_tiled": 2, "emit_block_single": 60, "place_block": 6,
       "scatter_block": 8, "gather_block": 3, "resolve_tiled_depth": 2,
       "emit_block": 60, "resolve_tiled_flag": 3, "local_round": 3,
       "doubling_round": 3, "gather_window_block": 5,
       "gather_window_anchored": 6, "elem_fields_block": 40,
       "resolve_tiled_dual": 2, "cumsum_block": 1, "next_start_block": 2}

#: The matcher's windowed sticky depth and the operations of its stages
#: after the sticky walk: match-length compares, 3 phases, the 16-wide
#: filter, 7 propagation levels, lazy and the jump.
STICKY_LEVELS = 4
LATER_STAGE_OPS = 72
_SIG_MUL = 0x9E3779B1


def tensors(x) -> list:
    """The tensors in a call's arguments or results, flattened."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return tensors(tuple(x.values()))
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in tensors(item)]
    return []


def distinct(ts: list) -> list:
    """The tensors with each storage once (the decoder passes one tensor
    as two arguments)."""
    seen = {}
    for t in ts:
        seen.setdefault((t.data_ptr(), t.numel() * t.element_size()), t)
    return list(seen.values())


def sig_bit(x: torch.Tensor) -> torch.Tensor:
    """One-bit signature of an offset: bit ((x * 0x9E3779B1) mod 2^32)
    >> 27."""
    h = ((x.to(torch.int64) * _SIG_MUL) & 0xFFFFFFFF) >> 27
    return torch.ones_like(h) << h


def unpack_table(pref: torch.Tensor, words: torch.Tensor,
                 k: int) -> torch.Tensor:
    """The (B, N, k) candidate table of the packed form: column 0 `pref`,
    then the 16-bit halves of words 0, 1, ... (low half first)."""
    cols = [pref]
    for j in range(k // 2):
        w = words[:, j]
        cols.append(w & 0xFFFF)
        if len(cols) < k:
            cols.append((w >> 16) & 0xFFFF)
    return torch.stack(cols, dim=-1)


def matcher_ops(cands: torch.Tensor, sticky: str) -> int:
    """Integer operations the matcher function needs on this (B, N, K)
    table: per position the K bucket bits of its mask, 3 a sticky level
    and LATER_STAGE_OPS; at "exact", for each level's default that passes
    the bucket test, the compares its window needs (at each of its 2^l
    positions in turn the keeps up to the one equal to it, all K where
    none is, and then no further position); at "sig" the verification's
    compares likewise at the position itself, where the default is not
    keep 0."""
    b, n, k = cands.shape
    iota = torch.arange(n, device=cands.device)
    bits = torch.where(cands != 0, sig_bit(cands), 0)
    mask = functools.reduce(torch.bitwise_or, bits.unbind(-1))
    del bits
    d = cands[..., 0]
    total = b * n * (k + 3 * STICKY_LEVELS + LATER_STAGE_OPS)

    def scan(at, x):
        eq = at == x[..., None]
        hit = eq.any(-1)
        return torch.where(hit, eq.to(torch.int8).argmax(-1) + 1, k), hit

    for lvl in range(STICKY_LEVELS):
        s = 4 << lvl
        edge = iota < s
        x = torch.roll(d, s, dims=1)
        take = (x != 0) & ((mask & sig_bit(x)) != 0) & ~edge
        if sticky == "exact":
            for i in range(1 << lvl):
                length, hit = scan(torch.roll(cands, 4 * i, dims=1), x)
                total += int(torch.where(take, length, 0).sum())
                take &= hit
        d = torch.where(take, x, d)
        mask = torch.where(edge, mask, torch.roll(mask, s, dims=1) & mask)
    if sticky == "sig":
        length, hit = scan(cands, d)
        need = (d != 0) & (d != cands[..., 0])
        total += int(torch.where(need, length, 0).sum())
    return total


def doubling_rounds(src: torch.Tensor) -> int:
    """Synchronous doubling rounds that take the batch to its fixed point,
    the one that sees it included (at most 16)."""
    s = src
    for r in range(1, 17):
        s2 = torch.gather(s, -1, s.long())
        if torch.equal(s2, s):
            return r
        s = s2
    return 16


def _matcher_table(name: str, args):
    """A matcher call's (B, N, K) candidate table, or None for another
    kernel."""
    if name == "matcher_block":
        return args[0]
    if name == "matcher_block_packed":
        return unpack_table(args[0], args[1], args[3])
    return None


def bound(name: str, args, outs) -> tuple[float, str]:
    """Least seconds one call of kernel wrapper `name` could take on the
    card, and what bounds it ("bytes" or "operations"). `args` are the
    call's positional then keyword arguments, `outs` its results."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in distinct(tensors(args) + tensors(outs)))
    if name == "ffill":
        mask, payloads = args[0], distinct(list(args[1]))
        first = torch.where(mask.any(-1), mask.to(torch.int8).argmax(-1),
                            mask.shape[-1])
        used = int(mask.sum()) + int(first.sum())
        nbytes += (used - mask.numel()) * 4 * len(payloads)
    if name == "gather_block" and args[0].data_ptr() != args[1].data_ptr():
        x, idx = args[0], args[1]
        inside = (idx >= 0) & (idx < x.shape[1])
        rows = torch.arange(x.shape[0], device=idx.device)[:, None]
        used = torch.unique((rows * x.shape[1] + idx)[inside]).numel()
        nbytes += (used - x.numel()) * x.element_size()
    ts = tensors(args)
    first = ts[1 if name == "gather_block" else 0] if ts else None
    sticky = ("sig" if any(isinstance(a, str) and a == "sig" for a in args)
              else "exact")
    table = _matcher_table(name, args)
    if table is not None:
        ops = matcher_ops(table, sticky)
    elif name == "resolve_block":
        ops = first.numel() * (3 * doubling_rounds(args[1]) + 1)
    elif name in OPS and first is not None:
        ops = first.numel() * OPS[name]
    else:
        ops = 0
    byte_s = nbytes / HBM_BYTES_PER_S
    op_s = ops / INT_OPS_PER_S
    return (byte_s, "bytes") if byte_s >= op_s else (op_s, "operations")
