"""resolve_tiled at every tile, check and variant, against the Pallas
kernel in interpret mode (tpu_snappy/ops/pallas/tiledres.py:764).

On the CPU the port's wrapper runs its plain version, the TPU's tile walk
simulated round for round. Held here, with exact equality, at tiles 128,
1024, 4096 and 65536, check 1 and 3, under the "fori", "pair" and "grid"
variants ("tri" is in tests/test_torch_tile_tri.py: its statically
unrolled walk takes most of a file's time to compile), on rows of
tests/torch_edges.py's tiled-resolve maps that include `resolved` rows
off their fixed point, whose bytes depend on the tile. The `gpu` twin
holds the CUDA kernel against the plain version at every tile the kernel
takes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops.pallas import tiledres as PT

from tpu_snappy_torch.ops.kernels import tiledres as KT

from torch_edges import tiled_resolve_rows
from torch_threads import share_cores

share_cores()

N = 1 << 16
#: The tiles the CPU tests hold to the Pallas kernels: the smallest, the
#: hints', the default and the whole row.
TILES = (128, 1024, 4096, N)
CHECKS = (1, 3)
#: Rows of tiled_resolve_rows: the period-1 chain and each 4096-tile's
#: lanes pointing just left of it (both flagged `resolved` though neither
#: map is at its fixed point), random hops around a 10000-deep chain and
#: short random hops (not flagged).
ROWS = (5, 3, 11, 8)
RESOLVED = np.array([True, True, False, False])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def rows():
    lit, src = tiled_resolve_rows(12)
    return lit[list(ROWS)], src[list(ROWS)]


def pallas_resolve(lit, src, resolved, tile, check, variant):
    """The Pallas resolve_tiled, vmapped over rows, as numpy."""
    fn = jax.vmap(lambda l, s, r: PT.resolve_tiled(
        l, s, r, tile=tile, check=check, variant=variant))
    return np.asarray(fn(jnp.asarray(lit), jnp.asarray(src),
                         jnp.asarray(resolved)))


def fixed_bytes(lit, src):
    """lit at each lane's fixed point of src: a full resolve's bytes."""
    s = src.copy()
    for _ in range(17):
        s = np.take_along_axis(s, s, axis=-1)
    return np.take_along_axis(lit, s, axis=-1)


@pytest.mark.parametrize("variant", ["fori", "pair", "grid"])
@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("tile", TILES)
def test_resolve_tiled_matches_pallas(rows, tile, check, variant):
    lit, src = rows
    if variant == "pair" and tile == N:
        with pytest.raises(ValueError, match="pair"):
            KT.resolve_tiled(_t(lit), _t(src), _t(RESOLVED), tile, check,
                             variant)
        return
    got = KT.resolve_tiled(_t(lit), _t(src), _t(RESOLVED), tile, check,
                           variant).numpy()
    want = pallas_resolve(lit, src, RESOLVED, tile, check, variant)
    assert (got == want).all(), (tile, check, variant)
    fixed = fixed_bytes(lit, src)
    assert (got[2:] == fixed[2:]).all()  # unflagged rows: any tile
    assert not (got[0] == fixed[0]).all()  # the walk's own wrong bytes


def test_flagged_bytes_depend_on_the_tile(rows):
    """A `resolved` row off its fixed point gets other bytes at each tile
    (so the tile must reach the kernel); an unflagged row the same."""
    lit, src = rows
    outs = [KT.resolve_tiled(_t(lit), _t(src), _t(RESOLVED), tile).numpy()
            for tile in KT.TILES]
    for a, b in zip(outs, outs[1:]):
        assert not (a[0] == b[0]).all()
        assert (a[2:] == b[2:]).all()


@pytest.mark.parametrize("kw", [{"tile": 2048 + 128}, {"tile": 64},
                                {"tile": 2 * N}, {"check": 0},
                                {"variant": "dual"}, {"variant": "flag"}])
def test_resolve_tiled_refuses_what_the_tpu_does_not_take(rows, kw):
    lit, src = rows
    with pytest.raises(ValueError, match="resolve_tiled"):
        KT.resolve_tiled(_t(lit), _t(src), **kw)


@pytest.mark.gpu
def test_resolve_tiled_kernel_at_every_tile(cuda):
    """The kernel against its plain version at every tile, check and
    variant, on the tiled-resolve rows at 1 and 133 rows, with `resolved`
    none, all and alternate."""
    for batch in (1, 133):
        lit, src = (_t(a).to(cuda) for a in tiled_resolve_rows(batch))
        for flags in (None, np.ones(batch, bool), np.arange(batch) % 2 == 0):
            res = None if flags is None else _t(flags).to(cuda)
            for tile in KT.TILES:
                for check in CHECKS:
                    want = KT.resolve_tiled_plain(lit, src, res, tile, check)
                    for variant in KT.VARIANTS:
                        if variant == "pair" and tile == N:
                            continue
                        got = KT.resolve_tiled(lit, src, res, tile, check,
                                               variant)
                        assert torch.equal(got, want), (batch, tile, variant)
