"""The port's resolve kernels (tpu_snappy_torch/ops/kernels/tiledres.py)
against the Pallas kernels they replace: resolve_tiled with its `resolved`
flag, resolve_tiled_depth, and resolve_tiled_flag.

On the CPU each wrapper runs its plain PyTorch version, a round-for-round
simulation of the TPU's tile walk; it is held, with exact equality, against
tpu_snappy/ops/pallas/tiledres.py in interpret mode. That includes the
cases where the walk does not reach the fixed point: `resolved=True` given
for a map that is not at it, under-declared depths (a stale or corrupt
framed 0x81 hint) and over-approximate root flags, which must give exactly
the TPU's wrong bytes. The `gpu` tests hold the CUDA kernels against the
plain versions on the card.

`_schedule` is a torch model of how the CUDA kernels of resolve_tiled and
resolve_tiled_depth compute the walk's bytes without walking the tiles
(csrc/tiledres.cu): every 1024-tile's rounds at once (the declared count
for resolve_tiled_depth; until nothing moves for a resolve_tiled row not
flagged `resolved`), then the absorbs as merges of tile blocks, one
level at a time, the lanes of a level in a seeded random order. It is
held, with exact equality, against the plain walk on the JAX tests' maps
and on tests/torch_edges.py's tiled-resolve rows, under every `resolved`
and depth kind there, in the rounds the kernel's note states.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops import decode as D
from tpu_snappy.ops.pallas import tiledres as PT

from tpu_snappy_torch.ops.kernels import tiledres as KT

from torch_edges import (DEPTH_KINDS, RESOLVED_KINDS, depth_variant,
                         resolved_flags, tiled_resolve_rows)
from torch_threads import share_cores

share_cores()

N = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _maps():
    """(lit, src) rows from a seed: short random hops, hops that straddle
    tiles, the period-1 chain, a depth-hint-tile straddle, a map already at
    its fixed point, and sparse 7-hops."""
    rng = np.random.default_rng(51)
    ident = np.arange(N, dtype=np.int32)
    src = np.stack([
        np.maximum(ident - rng.integers(1, 300, N), 0),
        np.maximum(ident - ident % PT.TILE - 1, 0),
        np.maximum(ident - 1, 0),
        np.maximum(ident - ident % D.HINT_TILE - 3, 0),
        np.where(rng.random(N) < 0.3, ident, ident // 7 * 7),
        np.where(rng.random(N) < 0.5, ident, np.maximum(ident - 7, 0)),
    ]).astype(np.int32)
    lit = rng.integers(0, 256, src.shape).astype(np.int32)
    return lit, src


def _fixed_point(src):
    s = src.copy()
    for _ in range(17):
        s = s[s]
    return s


@pytest.fixture(scope="module")
def maps():
    return _maps()


@pytest.mark.parametrize("resolved", [False, True])
def test_resolve_tiled_plain_matches_pallas(maps, resolved):
    lit, src = maps
    flag = torch.full((len(src),), resolved)
    got = KT.resolve_tiled(_t(lit), _t(src), resolved=flag).numpy()
    for row in range(len(src)):
        want = PT.resolve_tiled(jnp.asarray(lit[row]), jnp.asarray(src[row]),
                                resolved=jnp.bool_(resolved))
        assert (got[row] == np.asarray(want)).all(), row
        exact = (got[row] == lit[row][_fixed_point(src[row])]).all()
        # `resolved` skips the doubling: exact only where the map is
        # already at its fixed point (row 4) or the absorbs alone finish
        # it; the chain (row 2) is not.
        assert exact or (resolved and row != 4), row
    if resolved:
        assert not (got[2] == lit[2][_fixed_point(src[2])]).all()
    # No flag is the same as all-False.
    assert (KT.resolve_tiled(_t(lit), _t(src)).numpy()
            == KT.resolve_tiled(_t(lit), _t(src),
                                torch.zeros(len(src), dtype=torch.bool))
            .numpy()).all()


@pytest.mark.parametrize("kind", ["exact", "over", "under", "zero"])
def test_resolve_tiled_depth_plain_matches_pallas(maps, kind):
    lit, src = maps
    rng = np.random.default_rng(52)
    deps = KT.tile_depths_plain(_t(src)).numpy()
    if kind == "over":
        deps = deps + rng.integers(1, 6, deps.shape)
    elif kind == "under":
        deps = np.maximum(deps - rng.integers(1, 4, deps.shape), 0)
    elif kind == "zero":
        deps = np.zeros_like(deps)
    deps = deps.astype(np.int32)
    got = KT.resolve_tiled_depth(_t(lit), _t(src), _t(deps),
                                 tile=KT.DEPTH_TILE).numpy()
    for row in range(len(src)):
        want = PT.resolve_tiled_depth(
            jnp.asarray(lit[row]), jnp.asarray(src[row]),
            jnp.asarray(deps[row]), tile=D.HINT_TILE)
        assert (got[row] == np.asarray(want)).all(), (kind, row)
    exact = [(got[r] == lit[r][_fixed_point(src[r])]).all()
             for r in range(len(src))]
    if kind in ("exact", "over"):
        assert all(exact)
    else:
        assert not all(exact)  # the wrong bytes a frame's CRC rejects


def _flags(src, kind):
    """Root flags for resolve_tiled_flag: "exact" (flags[p] = 1 iff src[p]
    is a fixed point, what "flagtail" computes), "over" (also 1 on about
    half the unresolved lanes) or "zero"."""
    exact = (np.take_along_axis(src, src, axis=-1) == src).astype(np.int32)
    if kind == "exact":
        return exact
    if kind == "over":
        rng = np.random.default_rng(53)
        return (exact | (rng.random(src.shape) < 0.5)).astype(np.int32)
    return np.zeros_like(exact)


FLAG_KINDS = ("exact", "over", "zero")


@pytest.fixture(scope="module")
def flagged(maps):
    """The Pallas resolve_tiled_flag on every map with each kind of flags,
    one vmapped call over all kinds' rows."""
    lit, src = maps
    flags = np.concatenate([_flags(src, k) for k in FLAG_KINDS])
    k = len(FLAG_KINDS)
    out = jax.vmap(PT.resolve_tiled_flag)(
        jnp.asarray(np.concatenate([lit] * k)),
        jnp.asarray(np.concatenate([src] * k)), jnp.asarray(flags))
    return np.asarray(out).reshape(k, *src.shape)


@pytest.mark.parametrize("kind", FLAG_KINDS)
def test_resolve_tiled_flag_plain_matches_pallas(maps, flagged, kind):
    lit, src = maps
    flags = _flags(src, kind)
    got = KT.resolve_tiled_flag(_t(lit), _t(src), _t(flags)).numpy()
    assert (got == flagged[FLAG_KINDS.index(kind)]).all(), kind
    exact = [(got[r] == lit[r][_fixed_point(src[r])]).all()
             for r in range(len(src))]
    if kind == "over":
        assert not all(exact)  # stopped early: the TPU's wrong bytes
    else:
        assert all(exact)


def test_resolve_tiled_flag_runs_the_tpu_loop():
    """Every flag is 1: no tile runs a round, so the result is the absorbs
    alone (resolve_tiled with `resolved`); all-zero flags on the period-1
    chain run the full 13 rounds a tile and are exact."""
    lit, src = _maps()
    ones = torch.ones(src.shape, dtype=torch.int32)
    assert torch.equal(
        KT.resolve_tiled_flag(_t(lit), _t(src), ones),
        KT.resolve_tiled(_t(lit), _t(src),
                         torch.ones(len(src), dtype=torch.bool)))
    chain = _t(src[2:3])
    got = KT.resolve_tiled_flag(_t(lit[2:3]), chain, torch.zeros_like(chain))
    assert (got.numpy() == lit[2, 0]).all()


def _rounds(s, counts):
    """Synchronous doubling rounds in 1024-tiles, every tile at once: tile t
    of each row runs counts[:, t] of them, a round that moves nothing
    ending its loop. Returns (s, the most rounds a tile ran, the one that
    found nothing to move included)."""
    tile = KT.DEPTH_TILE
    pos = torch.arange(N)
    base = pos - pos % tile
    cap = counts.repeat_interleave(tile, dim=1)
    active = cap > 0
    ran = 0
    while bool(active.any()):
        inside = (s >= base) & (s < base + tile)
        s2 = torch.where(active & inside, torch.gather(s, 1, s), s)
        moved = (s2 != s).view(s.shape[0], -1, tile).any(-1)
        s = s2
        ran += 1
        active &= (cap > ran) & moved.repeat_interleave(tile, dim=1)
    return s, ran


def _merges(s, shift, roots, gen):
    """The absorbs as merges of blocks of 2^shift-lane tiles, levels k =
    shift .. 15: a lane of a right 2^k-lane block whose pointer v lies in
    the left sibling takes s[v] (with `roots` always, else unless v is
    terminal: s[v] at or right of v's tile base). Within a level the lanes
    go in a random order, each reading the state the earlier ones left:
    writers and the lanes they read are disjoint, so the order is moot."""
    pos = torch.arange(N)
    for k in range(shift, 16):
        lo = pos & ~((2 << k) - 1)
        mid = pos & ~((1 << k) - 1)
        for part in torch.randperm(N, generator=gen).chunk(16):
            v = s[:, part]
            inside = (v >= lo[part]) & (v < mid[part])
            w = torch.gather(s, 1, torch.where(inside, v, 0))
            take = inside & (roots | (w < (v >> shift << shift)))
            s[:, part] = torch.where(take, w, v)
    return s


def _schedule(lit, src, tile, resolved=None, depths=None, seed=0):
    """The CUDA kernels' schedule, in torch: returns (out (B, 65536) int32,
    the most local rounds a tile ran). tile 4096:
    resolve_tiled; a `resolved` row merges 4096-tiles of src; any other
    row runs 1024-tile rounds until nothing moves, then merges 1024-tiles
    to its roots. tile 1024: resolve_tiled_depth, exactly
    min(max(depths[:, t], 0), 11) rounds in 1024-tile t, then merges of
    1024-tiles to terminal lanes."""
    gen = torch.Generator().manual_seed(seed)
    s = src.to(torch.int64).clone()
    rows = s.shape[0]
    cap = KT.DEPTH_TILE.bit_length()
    out = torch.empty_like(s)
    local = 0
    if depths is None:
        flagged = (torch.zeros(rows, dtype=torch.bool) if resolved is None
                   else resolved)
        groups = ((flagged, False, KT.TILE), (~flagged, True, KT.DEPTH_TILE))
    else:
        groups = ((torch.ones(rows, dtype=torch.bool), False, KT.DEPTH_TILE),)
    for pick, roots, t in groups:
        if not bool(pick.any()):
            continue
        g = s[pick]
        if depths is not None:
            g, ran = _rounds(g, torch.clamp(depths.to(torch.int64), 0, cap))
        elif roots:
            g, ran = _rounds(g, torch.full((len(g), N // KT.DEPTH_TILE),
                                           cap))
        else:
            ran = 0
        local = max(local, ran)
        shift = t.bit_length() - 1
        g = _merges(g, shift, roots, gen)
        pos = torch.arange(N)
        term = roots | (g >= (pos >> shift << shift))
        idx = torch.where(term, g, torch.gather(g, 1, g))
        out[pick] = torch.gather(lit[pick].to(torch.int64), 1, idx)
    return out.to(torch.int32), local


@pytest.fixture(scope="module")
def schedule_maps(maps):
    """The JAX tests' maps, then tests/torch_edges.py's tiled-resolve rows
    (every lane at 0, chains of tiles - 1 hops, ...), with lit bytes."""
    lit, src = maps
    lit2, src2 = tiled_resolve_rows(12)
    return (_t(np.concatenate([lit, lit2])),
            _t(np.concatenate([src, src2])))


SCHEDULE_CASES = ([("tiled", k) for k in RESOLVED_KINDS]
                  + [("depth", k) for k in DEPTH_KINDS])


@pytest.mark.parametrize("kernel,kind", SCHEDULE_CASES)
def test_schedule_model_matches_the_walk(schedule_maps, kernel, kind):
    """The kernels' schedule gives the walk's bytes, also where the walk
    does not reach the fixed point (`resolved` on maps that are not at it,
    under-declared depths), in at most the 11 rounds a 1024-tile that the
    kernel's note states (10 that move and one that finds none)."""
    lit, src = schedule_maps
    rows = len(src)
    if kernel == "tiled":
        flags = resolved_flags(kind, rows)
        res = None if flags is None else _t(flags)
        want = KT.resolve_tiled_plain(lit, src, res)
        got, local = _schedule(lit, src, KT.TILE, resolved=res,
                               seed=len(kind))
    else:
        exact = KT.tile_depths_plain(src).numpy()
        deps = _t(depth_variant(kind, exact))
        want = KT.resolve_tiled_depth_plain(lit, src, deps, KT.DEPTH_TILE)
        got, local = _schedule(lit, src, KT.DEPTH_TILE, depths=deps,
                               seed=len(kind))
    assert torch.equal(got, want), (kernel, kind)
    assert local <= KT.DEPTH_TILE.bit_length()
    if kind in ("all", "under", "zero", "negative"):
        fixed = torch.stack([_t(r) for r in
                             (lit.numpy()[i][_fixed_point(src.numpy()[i])]
                              for i in range(rows))])
        assert not torch.equal(got, fixed)  # the walk's own wrong bytes


@pytest.mark.gpu
def test_resolve_kernels_match_plain(schedule_maps, cuda):
    """Both kernels against their plain versions on the schedule model's
    maps, every `resolved` and depth kind, at 1, 2, 8 and 133 rows (more
    rows than SMs)."""
    lit, src = schedule_maps
    exact = KT.tile_depths_plain(src).numpy()
    for batch in (1, 2, 8, 133):
        pick = np.arange(batch) % len(src)
        lt, st = lit[pick].to(cuda), src[pick].to(cuda)
        for kind in RESOLVED_KINDS:
            flags = resolved_flags(kind, batch)
            res = None if flags is None else _t(flags).to(cuda)
            assert torch.equal(KT.resolve_tiled(lt, st, res),
                               KT.resolve_tiled_plain(lt, st, res)), (
                                   batch, kind)
        for kind in DEPTH_KINDS:
            dt = _t(depth_variant(kind, exact[pick])).to(cuda)
            assert torch.equal(
                KT.resolve_tiled_depth(lt, st, dt, KT.DEPTH_TILE),
                KT.resolve_tiled_depth_plain(lt, st, dt, KT.DEPTH_TILE)), (
                    batch, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", FLAG_KINDS)
def test_resolve_tiled_flag_kernel_matches_plain(maps, kind, cuda):
    lit, src = maps
    args = [_t(a).to(cuda) for a in (lit, src, _flags(src, kind))]
    assert torch.equal(KT.resolve_tiled_flag(*args),
                       KT.resolve_tiled_flag_plain(*args))
