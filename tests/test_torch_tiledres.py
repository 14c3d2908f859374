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
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops import decode as D
from tpu_snappy.ops.pallas import tiledres as PT

from tpu_snappy_torch.ops.kernels import tiledres as KT

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
    got = KT.resolve_tiled_depth(_t(lit), _t(src), _t(deps)).numpy()
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


@pytest.mark.gpu
def test_resolve_kernels_match_plain(maps, cuda):
    lit, src = maps
    lt, st = _t(lit).to(cuda), _t(src).to(cuda)
    flag = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.bool, device=cuda)
    assert torch.equal(KT.resolve_tiled(lt, st, flag),
                       KT.resolve_tiled_plain(lt, st, flag))
    deps = KT.tile_depths_plain(_t(src)).numpy()
    for d in (deps, np.maximum(deps - 2, 0), deps + 3):
        dt = _t(d.astype(np.int32)).to(cuda)
        assert torch.equal(KT.resolve_tiled_depth(lt, st, dt),
                           KT.resolve_tiled_depth_plain(lt, st, dt))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", FLAG_KINDS)
def test_resolve_tiled_flag_kernel_matches_plain(maps, kind, cuda):
    lit, src = maps
    args = [_t(a).to(cuda) for a in (lit, src, _flags(src, kind))]
    assert torch.equal(KT.resolve_tiled_flag(*args),
                       KT.resolve_tiled_flag_plain(*args))
