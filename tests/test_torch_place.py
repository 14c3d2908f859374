"""The port's encoder placements (ops/kernels/place.py, scatter.py's
scatter_block) against the Pallas kernels in interpret mode.

place_block's plain version (the CPU path) must equal the Pallas
place_block on emission-shaped destinations, on the encoder's own main
lane, and on a tile that breaks the window contract (counted once and
dropped), as tests/test_pallas.py:97-126 runs it, and on every row of
torch_edges.place_edge_rows (chip_smoke.py's phase 3 cases). On the card
place_block runs the windowed scatter at one limb: the identity
place_block_plain(d, v, r) == scatter_windowed_plain(d, v, 32, limbs=1,
out_cells=128 r) is held on the encoder's lanes and on those rows, and
with the launch stubbed, place_block's CUDA path must call the windowed
scatter's entry point at one limb and refuse misaligned tensors first.
scatter_block's plain
version must equal the Pallas scatter_block on permutations with dropped
writes, at limbs 1-3, on a sparse scatter, on summed duplicates, and on
the encoder's 2048 overflow entries, on every source onto one cell at
out_cells 128, and at the top limb's 2^(8 limbs). All comparisons are
exact. scatter_block's tile rule is checked on the CPU. The `gpu` tests
hold the CUDA kernels against their plain versions on the card:
scatter_block at limbs 1-3, out_cells 128, 65536 and 67584, M 1024, 2048
and 65536, colliding atomics, drops at out_cells and below 0, the top limb
at 2^(8 limbs), with the rule's tile and others.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy.ops.pallas import place as PP
from tpu_snappy.ops.pallas import scatter as PS

from tpu_snappy_torch.config import DEFAULT_CONFIG
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import emit as KE
from tpu_snappy_torch.ops.kernels import place as KP
from tpu_snappy_torch.ops.kernels import scatter as KS

from test_torch_emit import parse  # noqa: F401 (fixture)
from torch_edges import PLACE_KINDS, place_edge_rows

from torch_threads import share_cores

share_cores()

N = 1 << 16
CAPACITY = DEFAULT_CONFIG.block_capacity
OUT_ROWS = CAPACITY // 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_place_constants():
    assert KP.W == PP.W and KP.TILE == PP.TR * PP.TC and KP.LO == PP.LO
    assert KS.LO == PS.LO and KS.TILE == PS.TR * PS.TC
    assert OUT_ROWS == 528


def _place_cases():
    """Emission-shaped rows (monotone, +1/+2 steps, 20% inactive) and one
    tile whose destinations span far more than the window."""
    rng = np.random.default_rng(11)
    m = 8 * 1024
    dest = np.cumsum(rng.integers(1, 3, m)).astype(np.int32) - 1
    active = rng.random(m) < 0.8
    mono = np.where(active, dest, PP.SENT).astype(np.int32)
    broken = np.full(m, PP.SENT, np.int32)
    broken[0], broken[1023] = 0, 10000
    vals = rng.integers(0, 256, (2, m)).astype(np.int32)
    return np.stack([mono, broken]), vals


def test_place_plain_matches_pallas():
    dest, vals = _place_cases()
    out, ovf = KP.place_block(_t(dest), _t(vals), 136)
    for row in range(2):
        want, wovf = PP.place_block(jnp.asarray(dest[row]),
                                    jnp.asarray(vals[row]), 136)
        assert (out[row].numpy() == np.asarray(want)).all(), row
        assert int(ovf[row]) == int(wovf), row
    assert ovf.tolist() == [0, 1]
    assert int(out[1, 0]) == vals[1, 0] and int(out[1, 10000]) == 0


def _encoder_lanes(parse):
    """The main lane and the 2048 overflow entries of the parsed rows."""
    pm, pa, pb, head, _ = KE.emit_block_single(*parse)
    return pm, TE._overflow_entries(pa, pb, head)


def test_place_plain_matches_pallas_on_encoder_lane(parse):  # noqa: F811
    pm, _ = _encoder_lanes(parse)
    row = 3  # far copies and long literals
    dest, vals = (pm[row:row + 1] >> 8), (pm[row:row + 1] & 0xFF)
    out, ovf = KP.place_block(dest, vals, OUT_ROWS)
    want, wovf = PP.place_block(jnp.asarray(dest[0].numpy()),
                                jnp.asarray(vals[0].numpy()), OUT_ROWS)
    assert (out[0].numpy() == np.asarray(want)).all()
    assert int(ovf[0]) == int(wovf) == 0


def _same_as_windowed(dest, vals, out_rows):
    """place_block's CPU result, checked against the windowed scatter's
    plain version at one limb (the kernels place_block runs on the
    card)."""
    out, ovf = KP.place_block(dest, vals, out_rows)
    wout, wovf = KS.scatter_windowed_plain(dest, vals, KP.W, limbs=1,
                                           out_cells=out_rows * KP.LO)
    assert torch.equal(out, wout) and torch.equal(ovf, wovf)
    return out, ovf


def test_place_is_the_windowed_scatter_on_encoder_lanes(parse):  # noqa: F811
    """The identity on every row of the encoder's main lanes, and on two
    lanes side by side (placement "kernel")."""
    pm, _ = _encoder_lanes(parse)
    out, ovf = _same_as_windowed(pm >> 8, pm & 0xFF, OUT_ROWS)
    assert not ovf.any() and out.any()
    pair = torch.cat([pm, pm.flip(0)], dim=-1)
    _, ovf = _same_as_windowed(pair >> 8, pair & 0xFF, OUT_ROWS)
    assert not ovf.any()


@pytest.mark.parametrize("kind", PLACE_KINDS)
def test_place_edge_rows_match_windowed_and_pallas(kind):
    """Each kind of phase 3's adversarial rows: the identity at 528 rows
    (the encoder's) and 40, and the Pallas place_block on the row (its
    contract takes a negative destination as active: it gets the port's
    drop rule explicitly, as SENT)."""
    row = PLACE_KINDS.index(kind)
    dest, vals = place_edge_rows(len(PLACE_KINDS), 16 * 1024)
    d, v = _t(dest[row:row + 1]), _t(vals[row:row + 1])
    out, ovf = _same_as_windowed(d, v, OUT_ROWS)
    small = np.minimum(dest[row:row + 1], 40 * 128 + 5)
    _same_as_windowed(_t(small), v, 40)
    pd = np.where(dest[row] < 0, PP.SENT, dest[row])
    want, wovf = PP.place_block(jnp.asarray(pd), jnp.asarray(vals[row]),
                                OUT_ROWS)
    assert (out[0].numpy() == np.asarray(want)).all()
    assert int(ovf[0]) == int(wovf)
    assert (int(ovf[0]) > 0) == (kind == "random")
    assert bool(out.any()) == (kind != "empty")


def _launch_stubbed(monkeypatch):
    """place_block's CUDA path on CPU tensors with the library stubbed:
    returns the list of (entry point, arguments) it calls."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(KP._build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(KP._build, "lib", Lib)
    monkeypatch.setattr(KP._build, "stream", lambda: 0)
    return calls


def test_place_launches_the_windowed_scatter(monkeypatch):
    """place_block's one launch is snk_scatter_windowed at one limb,
    wrows 32 and out_rows * 128 cells; place_block counts it, and
    scatter_windowed (whose count the decode paths read) does not."""
    calls = _launch_stubbed(monkeypatch)
    d = torch.zeros((2, 4096), dtype=torch.int32)
    before = (KP.place_block.launches, KS.scatter_windowed.launches)
    out, ovf = KP.place_block(d, d, 136)
    assert out.shape == (2, 136 * 128) and ovf.shape == (2,)
    assert [name for name, _ in calls] == ["snk_scatter_windowed"]
    m, cells, wrows, tile, limbs, batch = calls[0][1][5:11]
    assert (m, cells, wrows, limbs, batch) == (4096, 136 * 128, 32, 1, 2)
    assert tile == KS.windowed_tile(2, 136 * 128)
    assert (KP.place_block.launches, KS.scatter_windowed.launches) == (
        before[0] + 1, before[1])
    assert not hasattr(KP._build, "snk_place")
    assert "snk_place" not in KP._build.SIGNATURES
    assert KP.SOURCE == KS.SOURCE


def test_place_refuses_misaligned_lanes(monkeypatch):
    """The windowed kernels load 16 bytes a thread: a lane that does not
    start on a 16-byte boundary is refused before any launch."""
    calls = _launch_stubbed(monkeypatch)
    d = torch.zeros((2, 4096), dtype=torch.int32)
    y = torch.zeros(d.numel() + 4, dtype=torch.int32)[1:1 + d.numel()]
    y = y.view(d.shape)
    assert y.is_contiguous() and y.data_ptr() % 16
    for args in ((y, d), (d, y)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            KP.place_block(*args, 136)
    assert not calls


def _scatter_cases():
    """(dest, values, limbs, out_cells): a permutation with dropped writes
    (test_pallas.py:40), full permutations at limbs 1-3, a sparse scatter,
    duplicates that sum and negative destinations."""
    rng = np.random.default_rng(2)
    m = 68 * 1024
    perm = np.concatenate([rng.permutation(N).astype(np.int32),
                           np.full(m - N, N, np.int32)])
    rng.shuffle(perm)
    cases = [(perm, rng.integers(0, 1 << 16, m).astype(np.int32), 2, N)]
    for limbs, bits in ((1, 8), (2, 16), (3, 19)):
        cases.append((rng.permutation(N).astype(np.int32),
                      rng.integers(0, 1 << bits, N).astype(np.int32),
                      limbs, N))
    sparse = np.full(N, N, np.int32)
    picks = rng.choice(N, 1000, replace=False)
    sparse[picks] = rng.choice(N, 1000, replace=False)
    cases.append((sparse, rng.integers(0, 1 << 16, N).astype(np.int32), 2,
                  N))
    dup = rng.integers(-8, 64, 2048).astype(np.int32)
    cases.append((dup, rng.integers(0, 256, 2048).astype(np.int32), 1,
                  CAPACITY))
    return cases


def _one_cell_case(limbs: int, cells: int, m: int):
    """Every source onto cell cells - 1 (the atomics collide), values at
    the top limb's 2^(8 limbs) and below."""
    rng = np.random.default_rng(limbs * cells + m)
    vals = rng.integers(0, 1 << (8 * limbs), m).astype(np.int32)
    vals[:16] = 1 << (8 * limbs)
    return np.full(m, cells - 1, np.int32), vals


@pytest.mark.parametrize("limbs", [1, 2, 3])
def test_scatter_block_plain_matches_pallas_one_cell(limbs):
    dest, vals = _one_cell_case(limbs, 128, 1024)
    got = KS.scatter_block(_t(dest[None]), _t(vals[None]), limbs, 128)
    want = PS.scatter_block(jnp.asarray(dest), jnp.asarray(vals), limbs, 128)
    assert (got[0].numpy() == np.asarray(want)).all()
    assert int(got[0, -1]) != 0 and not got[0, :-1].any()


@pytest.mark.parametrize("cells,m,limbs,batch,want", [
    (CAPACITY, 2048, 1, 128, 7552),   # the encoder: 9 tiles of 30 KB
    (CAPACITY, 2048, 1, 8, 4224),     # few rows: 16 tiles, re-reads cap
    (N, 2048, 3, 128, 7296),          # 9 tiles a row, 86 KB each
    (N, N, 1, 1, 58112),              # many sources: shared memory rules
    (N, N, 3, 1, 19328),              # 227 KB of three limbs
    (128, 1024, 2, 1, 128),           # one tile
])
def test_scatter_block_tile(cells, m, limbs, batch, want):
    """The tile rule: aim at 8 blocks an SM, re-read the sources (8 bytes
    each a tile) no more than the row writes, fit in 227 KB."""
    tile = KS.block_tile(cells, m, limbs, batch)
    assert tile == want
    assert tile % 128 == 0 and tile * limbs * 4 <= 227 * 1024


def test_scatter_block_refuses_bad_tiles():
    d = torch.zeros((1, 1024), dtype=torch.int32)
    for tile in (100, 0, 19456):  # not of 128, empty, above 227 KB at 3
        with pytest.raises(ValueError, match="tile"):
            KS.scatter_block(d, d, 3, N, tile=tile)
    with pytest.raises(ValueError, match="out_cells"):
        KS.scatter_block(d, d, 1, 1 << 30)
    assert not KS.scatter_block(d, d, 1, 256, tile=128).any()


@pytest.mark.parametrize("case", range(6))
def test_scatter_block_plain_matches_pallas(case):
    dest, vals, limbs, cells = _scatter_cases()[case]
    got = KS.scatter_block(_t(dest[None]), _t(vals[None]), limbs, cells)
    # The Pallas kernel's contract is dest in [0, cells]: give it the
    # port's drop rule (negative destinations drop) explicitly.
    d = np.where(dest < 0, cells, dest)
    want = PS.scatter_block(jnp.asarray(d), jnp.asarray(vals), limbs, cells)
    assert (got[0].numpy() == np.asarray(want)).all()


def test_scatter_block_plain_matches_pallas_on_overflow(parse):  # noqa: F811
    _, ovf = _encoder_lanes(parse)
    got = KS.scatter_block(ovf >> 8, ovf & 0xFF, 1, CAPACITY)
    for row in (1, 3):
        o = jnp.asarray(ovf[row].numpy())
        want = PS.scatter_block(o >> 8, o & 0xFF, 1, CAPACITY)
        assert (got[row].numpy() == np.asarray(want)).all(), row
    assert (got > 0).sum() > 0


def test_scatter_block_refuses_bad_shapes():
    x = torch.zeros((1, 1000), dtype=torch.int32)
    with pytest.raises(ValueError):
        KS.scatter_block(x, x, 1, N)
    y = torch.zeros((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        KS.scatter_block(y, y, 4, N)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_place_kernel_matches_plain(parse, cuda):  # noqa: F811
    dest, vals = (_t(x).to(cuda) for x in _place_cases())
    got, govf = KP.place_block(dest, vals, 136)
    want, wovf = KP.place_block_plain(dest, vals, 136)
    assert torch.equal(got, want) and torch.equal(govf, wovf)
    pm = _encoder_lanes(parse)[0].to(cuda)
    got, govf = KP.place_block(pm >> 8, pm & 0xFF, OUT_ROWS)
    want, wovf = KP.place_block_plain(pm >> 8, pm & 0xFF, OUT_ROWS)
    assert torch.equal(got, want) and torch.equal(govf, wovf)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m", [(1, 65536), (8, 65536), (128, 65536),
                                    (8, 131072), (7, 16384)])
def test_place_edge_rows_kernel_matches_plain(rows, m, cuda):
    """Every kind of place_edge_rows (cycled over the rows) at the
    encoder's 528 output rows and at 40, on the card."""
    dest, vals = place_edge_rows(rows, m)
    for out_rows in (OUT_ROWS, 40):
        d = _t(np.minimum(dest, out_rows * 128 + 5)).to(cuda)
        v = _t(vals).to(cuda)
        got = KP.place_block(d, v, out_rows)
        want = KP.place_block_plain(d, v, out_rows)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), out_rows


@pytest.mark.gpu
def test_scatter_block_kernel_matches_plain(cuda):
    for dest, vals, limbs, cells in _scatter_cases():
        d, v = _t(dest[None]).to(cuda), _t(vals[None]).to(cuda)
        assert torch.equal(KS.scatter_block(d, v, limbs, cells),
                           KS.scatter_block_plain(d, v, limbs, cells))


#: (limbs, out_cells, M, B) for the `gpu` scatter_block tests.
SCATTER_CASES = [(1, CAPACITY, 2048, 128), (2, N, 2048, 3), (3, N, 1024, 3),
                 (1, 128, 2048, 1), (2, 128, 65536, 1), (3, N, N, 1),
                 (1, N, N, 3), (3, CAPACITY, 2048, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("limbs,cells,m,batch", SCATTER_CASES)
def test_scatter_block_cases_match_plain(limbs, cells, m, batch, cuda):
    """Drops at out_cells and below 0, duplicates, the top limb at
    2^(8 limbs), and every source on one cell, with the rule's tile, one
    tile a row where it fits, and tiles of 128 cells."""
    rng = np.random.default_rng(limbs + cells + m + batch)
    d = rng.integers(-50, cells + 50, (batch, m)).astype(np.int32)
    d[:, :64] = cells
    d[:, 64:128] = -1
    d[:, 128:512] = rng.integers(0, 16, (batch, 384))
    v = rng.integers(0, 1 << (8 * limbs), (batch, m)).astype(np.int32)
    v[:, :256] = 1 << (8 * limbs)
    one = np.full_like(d, cells - 1)
    for dest in (d, one):
        dt, vt = _t(dest).to(cuda), _t(v).to(cuda)
        want = KS.scatter_block_plain(dt, vt, limbs, cells)
        for tile in (None, cells, 128):
            if tile and tile * limbs * 4 > 227 * 1024:
                continue
            assert torch.equal(KS.scatter_block(dt, vt, limbs, cells, tile),
                               want), tile
