"""resolve_tiled's "tri" variant and resolve_tiled_dual at every tile,
against the Pallas kernels in interpret mode (tpu_snappy/ops/pallas/
tiledres.py:593 and :678).

"tri" unrolls the tile walk at trace time and reads only the byte plane's
rows left of each tile's end; it must give "fori"'s bytes, on `resolved`
rows off their fixed point too. It is held at tiles 1024 (check 1 and
3), 4096 and 65536 (the 1024-tile compiles for about 12 s in interpret
mode; at the 128-tile, 512 unrolled steps take about 110 s, so that tile
is held for "fori", "pair" and "grid" only,
tests/test_torch_tile_variants.py).
resolve_tiled_dual takes the tile and check of resolve_tiled and gives
each row its bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy.ops.pallas import tiledres as PT

from tpu_snappy_torch.ops.kernels import tiledres as KT

from test_torch_tile_variants import (CHECKS, RESOLVED, TILES,  # noqa: F401
                                      pallas_resolve, rows)
from torch_edges import tiled_resolve_rows
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


@pytest.mark.parametrize("tile,check", [(1024, 1), (1024, 3), (4096, 1),
                                        (N, 1)])
def test_tri_matches_pallas(rows, tile, check):
    lit, src = rows
    got = KT.resolve_tiled(_t(lit), _t(src), _t(RESOLVED), tile, check,
                           "tri").numpy()
    want = pallas_resolve(lit, src, RESOLVED, tile, check, "tri")
    assert (got == want).all(), (tile, check)
    assert (got == KT.resolve_tiled(_t(lit), _t(src), _t(RESOLVED),
                                    tile).numpy()).all()


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("tile", TILES)
def test_resolve_tiled_dual_matches_pallas(rows, tile, check):
    """The first two rows (both flagged, off their fixed point) and the
    last two (neither flagged) as two dual calls; asymmetric flags on the
    middle pair."""
    lit, src = rows
    for pick, flags in (((0, 1), (True, True)), ((2, 3), (False, False)),
                        ((1, 2), (True, False))):
        l2, s2 = lit[list(pick)], src[list(pick)]
        f2 = np.array(flags)
        got = KT.resolve_tiled_dual(_t(l2), _t(s2), _t(f2), tile,
                                    check).numpy()
        want = np.asarray(PT.resolve_tiled_dual(
            jnp.asarray(l2), jnp.asarray(s2), jnp.asarray(f2), tile=tile,
            check=check))
        assert (got == want).all(), (tile, check, pick)


@pytest.mark.gpu
def test_resolve_tiled_dual_kernel_at_every_tile(cuda):
    lit, src = (_t(a).to(cuda) for a in tiled_resolve_rows(12))
    for row in (0, 4, 10):
        l2, s2 = lit[row:row + 2].contiguous(), src[row:row + 2].contiguous()
        for flags in (None, [True, False], [True, True]):
            res = None if flags is None else torch.tensor(flags, device=cuda)
            for tile in KT.TILES:
                for check in CHECKS:
                    assert torch.equal(
                        KT.resolve_tiled_dual(l2, s2, res, tile, check),
                        KT.resolve_tiled_dual_plain(l2, s2, res, tile,
                                                    check)), (row, tile)
