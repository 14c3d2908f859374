"""A torch model of the order in which resolve_tiled_flag's CUDA kernel
(tpu_snappy_torch/ops/kernels/csrc/tiledres.cu) computes the TPU's bytes,
against the Pallas kernel in interpret mode
(tpu_snappy/ops/pallas/tiledres.py:709) and the port's plain walk.

The kernel does not walk the tiles, and it takes one of two routes a row.
A row with an over-approximate flag (set on a lane whose pointer is not
at a root) takes the flag route, `_flag_route`: `_flag_rounds` runs
every tile's rounds at once (before each round each tile votes, on its
current state, whether some lane points in-tile with flag 0, the TPU's
loop test; the round moves pointers and flags from one snapshot; a
tile's loop ends at that vote, after bit_length(tile) rounds, or at a
round that moves no pointer, where the TPU's loop may go on: its
pointers' rounds do not read the flags, so its bytes are the same), then
the absorbs, as merges of blocks of tiles at the caller's tile (`_merges`
of tests/test_torch_tiledres.py, the lanes of a level in a seeded random
order). Any other row takes resolve_tiled's route (`_schedule` there:
rounds in 1024-tiles until nothing moves, merges to the roots): with no
over-approximate flag every tile reaches its local fixed point, so the
TPU's bytes are lit[fix(src)]. Held with exact equality under every
FLAG_KINDS kind of tests/torch_edges.py on five of its tiled-resolve
rows: the schedule and the flag route alone on every row, against the
Pallas kernel at tiles 128, 1024, 4096 and 65536, and against the plain
walk at every tile the kernel takes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops.pallas import tiledres as PT

from tpu_snappy_torch.ops.kernels import tiledres as KT

from test_torch_tiledres import _merges, _schedule
from test_torch_tile_variants import TILES
from torch_edges import FLAG_KINDS, root_flags, tiled_resolve_rows
from torch_threads import share_cores

share_cores()

N = 1 << 16
#: The rows of tiled_resolve_rows the model is held on: each 4096-tile's
#: lanes pointing just left of it, the period-1 chain, short random hops,
#: sparse 7-hops and random hops around a 10000-deep chain.
ROWS = (3, 5, 8, 9, 11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flag_rounds(s, f, tile):
    """Every tile's flag rounds at once, as the kernel runs them. s: (B,
    65536) int64 pointers, f: (B, 65536) bool flags. Returns (s, the
    rounds that moved a pointer, the tiles whose loop a round that moved
    nothing ended while their vote was open, the lanes whose flag changed
    while their pointer stayed)."""
    rows, tiles = s.shape[0], N // tile
    pos = torch.arange(N)
    base = pos - pos % tile
    live = torch.ones(rows, tiles, dtype=torch.bool)
    ran = early = flag_only = 0
    for _ in range(tile.bit_length()):
        vote = ((s >= base) & ~f).view(rows, tiles, tile).any(-1)
        inside = (s >= base) & (s < base + tile)
        idx = torch.where(inside, s, 0)
        s2 = torch.where(inside, torch.gather(s, 1, idx), s)
        f2 = torch.where(inside, torch.gather(f, 1, idx), f)
        moved = (s2 != s).view(rows, tiles, tile).any(-1)
        early += int((live & vote & ~moved).sum())
        live &= vote & moved
        if not bool(live.any()):
            break
        lanes = live.repeat_interleave(tile, dim=1)
        flag_only += int((lanes & (f2 != f) & (s2 == s)).sum())
        s = torch.where(lanes, s2, s)
        f = torch.where(lanes, f2, f)
        ran += 1
    return s, ran, early, flag_only


def _flag_route(lit, src, flags, tile, seed=0):
    """The flag route, in torch: (out (B, 65536) int32, then the counts of
    _flag_rounds)."""
    s, *counts = _flag_rounds(src.to(torch.int64), flags != 0, tile)
    shift = tile.bit_length() - 1
    s = _merges(s, shift, False, torch.Generator().manual_seed(seed))
    pos = torch.arange(N)
    term = s >= (pos >> shift << shift)
    idx = torch.where(term, s, torch.gather(s, 1, s))
    return torch.gather(lit.to(torch.int64), 1, idx).to(torch.int32), *counts


def _over(src, flags):
    """(B,) bool: the rows with an over-approximate flag, which take the
    flag route."""
    s = src.to(torch.int64)
    return ((flags != 0) & (torch.gather(s, 1, s) != s)).any(-1)


def _flag_schedule(lit, src, flags, tile, seed=0):
    """The kernel's schedule, in torch: (out (B, 65536) int32, the rows
    that took the flag route)."""
    over = _over(src, flags)
    out = _schedule(lit, src, KT.TILE, seed=seed)[0]
    if bool(over.any()):
        out[over] = _flag_route(lit[over], src[over], flags[over], tile,
                                seed)[0]
    return out, over


@pytest.fixture(scope="module")
def rows():
    lit, src = tiled_resolve_rows(12)
    lit, src = lit[list(ROWS)], src[list(ROWS)]
    return lit, src, {k: root_flags(k, src) for k in FLAG_KINDS}


@pytest.fixture(scope="module", params=TILES)
def pallas(request, rows):
    """(tile, the Pallas resolve_tiled_flag on ROWS under each kind's flags,
    one vmapped call over all kinds' rows)."""
    tile = request.param
    lit, src, flags = rows
    k = len(FLAG_KINDS)
    out = jax.vmap(lambda l, s, f: PT.resolve_tiled_flag(l, s, f, tile=tile))(
        jnp.asarray(np.concatenate([lit] * k)),
        jnp.asarray(np.concatenate([src] * k)),
        jnp.asarray(np.concatenate([flags[x] for x in FLAG_KINDS])))
    return tile, dict(zip(FLAG_KINDS, np.split(np.asarray(out), k)))


@pytest.mark.parametrize("kind", FLAG_KINDS)
def test_flag_schedule_matches_pallas(rows, pallas, kind):
    """The schedule gives the Pallas kernel's bytes, the over-approximate
    flags' wrong ones included, and only those rows take the flag route.
    The flag route alone gives them on every row, in at most
    bit_length(tile) rounds; with all-zero and under-approximate flags a
    round that moves nothing ends some tile's loop while the TPU's would
    go on, and under-approximate flags change while their pointers
    stay."""
    tile, want = pallas
    lit, src, flags = rows
    got, over = _flag_schedule(_t(lit), _t(src), _t(flags[kind]), tile,
                               seed=tile + len(kind))
    assert (got.numpy() == want[kind]).all(), (tile, kind)
    assert bool(over.all()) if kind == "over" else not bool(over.any())
    got, ran, early, flag_only = _flag_route(
        _t(lit), _t(src), _t(flags[kind]), tile, seed=tile + len(kind))
    assert (got.numpy() == want[kind]).all(), (tile, kind)
    assert ran <= tile.bit_length()
    if kind in ("zero", "under"):
        assert early > 0, (tile, kind)
    if kind == "under":
        assert flag_only > 0, tile


@pytest.mark.parametrize("tile", KT.TILES)
def test_flag_schedule_matches_the_walk(rows, tile):
    """At every tile the kernel takes, under every kind of flags: the
    schedule's bytes and the flag route's are the plain walk's."""
    lit, src, flags = rows
    for kind in FLAG_KINDS:
        f = _t(flags[kind])
        want = KT.resolve_tiled_flag_plain(_t(lit), _t(src), f, tile)
        for route in (_flag_schedule, _flag_route):
            got = route(_t(lit), _t(src), f, tile, seed=tile)[0]
            assert torch.equal(got, want), (tile, kind, route.__name__)
