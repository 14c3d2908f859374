"""The port's doubling kernels against the Pallas kernels they replace:
local_round (tpu_snappy_torch/ops/kernels/localround.py), doubling_round
(doubling.py) and resolve_block (resolve.py).

On the CPU each wrapper runs its plain PyTorch version, held with exact
equality against tpu_snappy/ops/pallas/{localround,doubling,resolve}.py in
interpret mode on test_torch_tiledres.py's maps (random back hops, tile
straddles, the period-1 chain, a depth-hint straddle, a map at its fixed
point, sparse 7-hops) and on tests/test_pallas.py's resolve maps
(identity, and random back hops around a depth-10000 chain), and
doubling_round on a map with pointers outside [0, 65536) (each reads 0);
resolve_block also on tests/torch_edges.py's tiled-resolve rows at 1, 8,
128 and 133 rows (every lane at 0, chains one hop a tile, the period-1
chain, the identity, random maps, ...), which phase 3 of chip_smoke.py
runs on the card.
With the launch stubbed, doubling_round's CUDA path must refuse a
misaligned map or flags. The `gpu` tests hold the CUDA kernels against
the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops.pallas import doubling as PD
from tpu_snappy.ops.pallas import localround as PL
from tpu_snappy.ops.pallas import resolve as PR

from tpu_snappy_torch.ops.kernels import doubling as KD
from tpu_snappy_torch.ops.kernels import localround as KL
from tpu_snappy_torch.ops.kernels import resolve as KR

from test_torch_tiledres import _fixed_point, _maps, _t
from torch_edges import tiled_resolve_rows

from torch_threads import share_cores

share_cores()

N = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _resolve_maps():
    """tests/test_pallas.py:162-184's maps: random back hops (1-63) of
    20000 lanes around a depth-10000 chain, and the identity."""
    rng = np.random.default_rng(21)
    src = np.arange(N, dtype=np.int32)
    copies = rng.choice(np.arange(1, N), 20000, replace=False)
    src[copies] = np.maximum(copies - rng.integers(1, 64, 20000), 0)
    src[40000:50000] = np.arange(40000, 50000) - 1
    lit = rng.integers(0, 256, (2, N)).astype(np.int32)
    return lit, np.stack([src, np.arange(N, dtype=np.int32)])


@pytest.fixture(scope="module")
def maps():
    lit, src = _maps()
    lit2, src2 = _resolve_maps()
    return np.concatenate([lit, lit2]), np.concatenate([src, src2])


def test_local_round_plain_matches_pallas(maps):
    _, src = maps
    s = src
    for _ in range(2):  # a round, then a round of its result
        got = KL.local_round(_t(s)).numpy()
        want = np.asarray(jax.vmap(PL.local_round)(jnp.asarray(s)))
        assert (got == want).all()
        assert not (got == s).all()
        s = got
    for tile in (2000, 64, 131072):  # legal: 128 << k dividing 65536
        with pytest.raises(ValueError, match="tile"):
            KL.local_round(_t(src), tile=tile)


def test_local_rounds_reach_the_tile_fixed_point(maps):
    """Fourteen rounds (paratail's cap) leave every lane at an in-tile root
    or pointing left of its tile, and a further round moves nothing."""
    _, src = maps
    s = _t(src)
    for _ in range(14):
        s = KL.local_round(s)
    assert torch.equal(KL.local_round(s), s)
    tile = torch.arange(N) // KL.TILE * KL.TILE
    hop = torch.gather(s, -1, s.long())
    assert ((s < tile) | (hop == s)).all()


@pytest.mark.parametrize("kind", ["zero", "random", "ones"])
def test_doubling_round_plain_matches_pallas(maps, kind):
    _, src = maps
    rng = np.random.default_rng(54)
    shape = (len(src), KD.TILES)
    stable = {"zero": np.zeros(shape), "random": rng.random(shape) < 0.4,
              "ones": np.ones(shape)}[kind].astype(np.int32)
    got, got_st = (x.numpy() for x in KD.doubling_round(_t(src), _t(stable)))
    for r in range(len(src)):  # one row a call: cheaper interpreted
        want, want_st = PD.doubling_round(jnp.asarray(src[r]),
                                          jnp.asarray(stable[r]))
        assert (got[r] == np.asarray(want)).all(), (kind, r)
        assert (got_st[r] == np.asarray(want_st)).all(), (kind, r)
    if kind == "ones":
        assert (got == src).all() and (got_st == 1).all()
    else:
        assert 0 < got_st.sum() < got_st.size


def _outside_map():
    """A map with pointers below 0 and at or past 65536 (each reads 0, as
    the TPU's one-hot finds no row there), table entries outside the map
    among the targets, and a tile whose every pointer lies outside."""
    rng = np.random.default_rng(56)
    s = np.maximum(np.arange(N) - rng.integers(1, 300, N), 0)
    picks = rng.choice(N, 4000, replace=False)
    s[picks] = rng.choice([-1, -5, -(1 << 31), N, N + 1, 70000,
                           (1 << 31) - 1], 4000)
    s[KD.TILE_SIZE:2 * KD.TILE_SIZE] = rng.integers(N, 1 << 20,
                                                    KD.TILE_SIZE)
    return s.astype(np.int32)


def test_doubling_round_reads_zero_outside_the_map():
    s = _outside_map()
    stable = np.zeros(KD.TILES, np.int32)
    stable[5] = 1
    got, got_st = KD.doubling_round(_t(s[None]), _t(stable[None]))
    want, want_st = PD.doubling_round(jnp.asarray(s), jnp.asarray(stable))
    assert (got[0].numpy() == np.asarray(want)).all()
    assert (got_st[0].numpy() == np.asarray(want_st)).all()
    outside = (s < 0) | (s >= N)
    tile5 = np.arange(N) // KD.TILE_SIZE == 5
    assert (got[0].numpy()[outside & ~tile5] == 0).all()
    assert int(got_st[0, 1]) == 0 and int(got_st[0, 5]) == 1


def test_doubling_round_refuses_misaligned_maps(monkeypatch):
    """The kernel loads and stores 16 bytes a thread: a map or flags that
    do not start on a 16-byte boundary are refused before any launch (the
    CUDA path's checks, run on CPU tensors with the launch stubbed)."""
    def no_launch():
        raise AssertionError("launched")

    def shifted(x):
        y = torch.zeros(x.numel() + 4, dtype=x.dtype)[1:1 + x.numel()]
        return y.view(x.shape)

    monkeypatch.setattr(KD._build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(KD._build, "lib", no_launch)
    s = torch.zeros((2, N), dtype=torch.int32)
    st = torch.zeros((2, KD.TILES), dtype=torch.int32)
    with pytest.raises(AssertionError, match="launched"):
        KD.doubling_round(s, st)
    for args in ((shifted(s), st), (s, shifted(st))):
        assert args[0].data_ptr() % 16 or args[1].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            KD.doubling_round(*args)


def test_doubling_rounds_converge(maps):
    """resolve="stable"'s loop: rounds until every tile is stable, at most
    16, give the fixed point on every map (the period-1 chain needs all
    16 and one more to see it stable)."""
    _, src = maps
    s = _t(src)
    st = torch.zeros((len(src), KD.TILES), dtype=torch.int32)
    rounds = 0
    while rounds < 16 and not bool((st == 1).all()):
        s, st = KD.doubling_round(s, st)
        rounds += 1
    assert rounds == 16
    for r in range(len(src)):
        assert (s[r].numpy() == _fixed_point(src[r])).all(), r


def test_resolve_block_plain_matches_pallas():
    """On test_torch_tiledres.py's maps, the period-1 chain (16 rounds)
    among them; one row a call (a vmapped call runs every row for the
    slowest row's rounds, interpreted)."""
    lit, src = _maps()
    got = KR.resolve_block(_t(lit), _t(src)).numpy()
    for r in range(len(src)):
        want = PR.resolve_block(jnp.asarray(lit[r]), jnp.asarray(src[r]))
        assert (got[r] == np.asarray(want)).all(), r
        assert (got[r] == lit[r][_fixed_point(src[r])]).all(), r


#: Batch sizes of the tiled-resolve rows (chip_smoke.TILED_BATCHES).
TILED_BATCHES = (1, 8, 128, 133)


@pytest.fixture(scope="module")
def tiled_rows_pallas():
    """The Pallas resolve_block on the first 12 tiled-resolve rows, one of
    each map kind; every batch's rows start with them (the rows are drawn
    from one seed in order)."""
    lit, src = tiled_resolve_rows(12)
    return [np.asarray(PR.resolve_block(jnp.asarray(lit[r]),
                                        jnp.asarray(src[r])))
            for r in range(len(src))]


@pytest.mark.parametrize("rows", TILED_BATCHES)
def test_resolve_block_plain_matches_pallas_on_tiled_rows(rows,
                                                          tiled_rows_pallas):
    lit, src = tiled_resolve_rows(rows)
    got = KR.resolve_block(_t(lit), _t(src)).numpy()
    for r in range(rows):
        assert (got[r] == lit[r][_fixed_point(src[r])]).all(), r
        if r < len(tiled_rows_pallas):
            assert (got[r] == tiled_rows_pallas[r]).all(), r


@pytest.mark.gpu
@pytest.mark.parametrize("rows", TILED_BATCHES)
def test_resolve_block_matches_plain_on_tiled_rows_on_the_card(rows, cuda):
    lit, src = (_t(a).to(cuda) for a in tiled_resolve_rows(rows))
    assert torch.equal(KR.resolve_block(lit, src),
                       KR.resolve_block_plain(lit, src))


@pytest.mark.gpu
def test_doubling_kernels_match_plain(maps, cuda):
    lit, src = maps
    rng = np.random.default_rng(55)
    lt, st = _t(lit).to(cuda), _t(src).to(cuda)
    s = st
    for _ in range(3):
        nxt = KL.local_round(s)
        assert torch.equal(nxt, KL.local_round_plain(s))
        s = nxt
    flags = _t((rng.random((len(src), KD.TILES)) < 0.4).astype(np.int32))
    out = _t(np.tile(_outside_map(), (len(src), 1))).to(cuda)
    for stable in (torch.zeros_like(flags), flags, torch.ones_like(flags)):
        got = KD.doubling_round(out, stable.to(cuda))
        want = KD.doubling_round_plain(out, stable.to(cuda))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        s, stab = st, stable.to(cuda)
        for _ in range(17):
            got = KD.doubling_round(s, stab)
            want = KD.doubling_round_plain(s, stab)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            s, stab = got
    assert torch.equal(KR.resolve_block(lt, st),
                       KR.resolve_block_plain(lt, st))
