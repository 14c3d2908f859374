"""The TPU kernels' other arguments in the port, against the Pallas kernels
in interpret mode: resolve_tiled_depth and resolve_tiled_flag at every
tile (tpu_snappy/ops/pallas/tiledres.py:736, :709), local_round at every
tile (localround.py:74) and ffill with `max_gap` (ffill.py:70).

On the CPU each wrapper runs its plain version. Held with exact equality
at tiles 128, 1024, 4096 and 65536 (resolve_tiled_depth at 512 in place
of 128: the Pallas kernel keeps its depths in one 128-lane row, so it
cannot run below 512) on tests/torch_edges.py's
tiled-resolve rows, with exact, over- and under-declared and zero depths
(an under-declared depth gives the TPU's own wrong bytes, which depend on
the tile), exact, over-approximate, zero and under-approximate root
flags, and fill masks whose gaps lie below, at and above the window
`max_gap` gives. The `gpu` twins hold the CUDA kernels against the plain
versions at every tile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops.pallas import ffill as PF
from tpu_snappy.ops.pallas import localround as PL
from tpu_snappy.ops.pallas import tiledres as PT

from tpu_snappy_torch.ops.kernels import ffill as KF
from tpu_snappy_torch.ops.kernels import localround as KL
from tpu_snappy_torch.ops.kernels import tiledres as KT

from test_torch_tile_variants import TILES, fixed_bytes, rows  # noqa: F401
from torch_edges import (DEPTH_KINDS, FLAG_KINDS, depth_variant, root_flags,
                         tiled_resolve_rows)
from torch_threads import share_cores

share_cores()

N = 1 << 16
#: The depth kinds held to the Pallas kernel (tests/torch_edges.py).
DEPTHS = ("exact", "over", "under", "zero")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


#: resolve_tiled_depth's tiles held to the Pallas kernel: it keeps the
#: depths in one 128-lane row, so it runs from the 512-tile up.
DEPTH_TILES = (512, 1024, 4096, N)


@pytest.mark.parametrize("tile", DEPTH_TILES)
def test_resolve_tiled_depth_matches_pallas(rows, tile):
    lit, src = rows
    exact = KT.tile_depths_plain(_t(src), tile).numpy()
    assert exact.shape == (len(src), N // tile)
    deps = np.concatenate([depth_variant(k, exact) for k in DEPTHS])
    lits = np.concatenate([lit] * len(DEPTHS))
    srcs = np.concatenate([src] * len(DEPTHS))
    got = KT.resolve_tiled_depth(_t(lits), _t(srcs), _t(deps), tile).numpy()
    want = np.asarray(jax.vmap(lambda l, s, d: PT.resolve_tiled_depth(
        l, s, d, tile=tile))(jnp.asarray(lits), jnp.asarray(srcs),
                             jnp.asarray(deps)))
    assert (got == want).all(), tile
    fixed = fixed_bytes(lit, src)
    ok = [(g == fixed).all(axis=-1) for g in np.split(got, len(DEPTHS))]
    assert ok[0].all() and ok[1].all()  # exact and over-declared
    assert not ok[2].all()  # under-declared: the wrong bytes a CRC rejects


@pytest.mark.parametrize("tile", [128, 256])
def test_resolve_tiled_depth_below_the_pallas_limit(rows, tile):
    """At the 128- and 256-tiles (the C++ golden's hints are defined
    there) the Pallas kernel cannot hold the depths; the port's walk
    gives the fixed point's bytes with exact depths and other bytes with
    under-declared ones."""
    lit, src = rows
    exact = KT.tile_depths_plain(_t(src), tile).numpy()
    with pytest.raises(ValueError):
        PT.resolve_tiled_depth(jnp.asarray(lit[0]), jnp.asarray(src[0]),
                               jnp.asarray(exact[0]), tile=tile)
    fixed = fixed_bytes(lit, src)
    for kind, want in (("exact", True), ("over", True), ("under", False)):
        got = KT.resolve_tiled_depth(_t(lit), _t(src),
                                     _t(depth_variant(kind, exact)), tile)
        assert (got.numpy() == fixed).all() == want, (tile, kind)


def test_resolve_tiled_depth_takes_the_jax_default_tile(rows):
    """JAX's default form: (B, 16) depths at tile 4096."""
    lit, src = rows
    deps = KT.tile_depths_plain(_t(src), KT.TILE)
    assert deps.shape == (len(src), 16)
    got = KT.resolve_tiled_depth(_t(lit), _t(src), deps)
    assert (got.numpy() == fixed_bytes(lit, src)).all()
    with pytest.raises(ValueError, match="tile"):
        KT.resolve_tiled_depth(_t(lit), _t(src), deps, 3 * 128)


@pytest.mark.parametrize("tile", TILES)
def test_resolve_tiled_flag_matches_pallas(rows, tile):
    lit, src = rows
    flags = np.concatenate([root_flags(k, src) for k in FLAG_KINDS])
    lits = np.concatenate([lit] * len(FLAG_KINDS))
    srcs = np.concatenate([src] * len(FLAG_KINDS))
    got = KT.resolve_tiled_flag(_t(lits), _t(srcs), _t(flags), tile).numpy()
    want = np.asarray(jax.vmap(lambda l, s, f: PT.resolve_tiled_flag(
        l, s, f, tile=tile))(jnp.asarray(lits), jnp.asarray(srcs),
                             jnp.asarray(flags)))
    assert (got == want).all(), tile
    fixed = np.concatenate([fixed_bytes(lit, src)] * len(FLAG_KINDS))
    exact = dict(zip(FLAG_KINDS,
                     np.split((got == fixed).all(axis=-1), len(FLAG_KINDS))))
    for kind in ("exact", "zero", "under"):  # these reach the fixed point
        assert exact[kind].all(), kind
    if tile < N:  # one tile reaches its fixed point within its rounds
        assert not exact["over"].all()  # stopped early


@pytest.mark.parametrize("tile", TILES)
def test_local_round_matches_pallas(rows, tile):
    _, src = rows
    s = src
    for _ in range(2):  # a round, then a round of its result
        got = KL.local_round(_t(s), tile).numpy()
        want = np.asarray(jax.vmap(lambda x: PL.local_round(x, tile))(
            jnp.asarray(s)))
        assert (got == want).all(), tile
        s = got


#: max_gap values: windows of 2, 128, 1024 and 2048 (1024 fills 1023
#: positions behind a set mask, 1025 one more), and none.
GAPS = (1, 100, 1024, 1025, None)


def _gap_masks(m: int) -> np.ndarray:
    """Fill masks whose gaps cross every window of GAPS: set every 1024
    positions, every 1023, every 1025, sparse random, set only at 0."""
    rng = np.random.default_rng(61)
    rows = np.zeros((5, m), bool)
    rows[0, ::1024] = True
    rows[1, ::1023] = True
    rows[2, 7::1025] = True
    rows[3] = rng.random(m) < 0.002
    rows[4, 0] = True
    return rows


@pytest.mark.parametrize("gap", GAPS)
def test_ffill_max_gap_matches_pallas(gap):
    m = 8192
    mask = _gap_masks(m)
    rng = np.random.default_rng(62)
    vals = [rng.integers(-(1 << 30), 1 << 30, mask.shape).astype(np.int32)
            for _ in range(2)]
    got = KF.ffill(_t(mask), tuple(_t(v) for v in vals), max_gap=gap)
    want = jax.vmap(lambda mk, a, b: PF.ffill_block(mk, a, b, max_gap=gap))(
        jnp.asarray(mask), *(jnp.asarray(v) for v in vals))
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all(), gap
    unlimited = KF.ffill(_t(mask), tuple(_t(v) for v in vals))
    if gap is None or gap > m:
        assert all(torch.equal(a, b) for a, b in zip(got, unlimited))
    else:
        assert not torch.equal(got[0], unlimited[0])  # the bound bit


@pytest.mark.gpu
def test_tile_kernels_at_every_tile(cuda):
    """resolve_tiled_depth (every DEPTH_KINDS depth), resolve_tiled_flag
    (every FLAG_KINDS flag) and local_round against their plain versions
    at every tile, on the tiled-resolve rows at 1 and 133 rows."""
    for batch in (1, 133):
        lit_np, src_np = tiled_resolve_rows(batch)
        lit, src = _t(lit_np).to(cuda), _t(src_np).to(cuda)
        for tile in KT.TILES:
            exact = KT.tile_depths_plain(src, tile).cpu().numpy()
            for kind in DEPTH_KINDS:
                d = _t(depth_variant(kind, exact)).to(cuda)
                assert torch.equal(
                    KT.resolve_tiled_depth(lit, src, d, tile),
                    KT.resolve_tiled_depth_plain(lit, src, d, tile)), (
                        batch, tile, kind)
            for kind in FLAG_KINDS:
                f = _t(root_flags(kind, src_np)).to(cuda)
                assert torch.equal(
                    KT.resolve_tiled_flag(lit, src, f, tile),
                    KT.resolve_tiled_flag_plain(lit, src, f, tile)), (
                        batch, tile, kind)
            assert torch.equal(KL.local_round(src, tile),
                               KL.local_round_plain(src, tile)), tile


@pytest.mark.gpu
@pytest.mark.parametrize("gap", GAPS)
def test_ffill_max_gap_kernel_matches_plain(gap, cuda):
    for m in (57344, N):
        mask = torch.from_numpy(np.resize(_gap_masks(m), (128, m))).to(cuda)
        vals = tuple(torch.randint(-(1 << 30), 1 << 30, (128, m),
                                   dtype=torch.int32, device=cuda)
                     for _ in range(4))
        want = KF.ffill_plain(mask, vals, gap)
        for chunk in (None, *KF.CHUNKS):
            got = KF.ffill(mask, vals, chunk=chunk, max_gap=gap)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                m, chunk)
