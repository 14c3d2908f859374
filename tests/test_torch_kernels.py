"""The port's kernel modules (tpu_snappy_torch/ops/kernels) against the JAX
package.

On the CPU each wrapper runs its plain PyTorch version; it is held, with
exact equality (everything is integer), against the Pallas kernel it
replaces in interpret mode, as tests/test_pallas.py runs it, and against
the XLA expression the JAX encoder uses off the TPU. The tests marked
`gpu` hold each CUDA kernel against its plain version on the card; they
skip where no CUDA device is visible.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy.config import DEFAULT_CONFIG
from tpu_snappy.ops import decode as D
from tpu_snappy.ops import encode as E
from tpu_snappy.ops import scan as JS
from tpu_snappy.ops.pallas import ffill as PF
from tpu_snappy.ops.pallas import place as PP
from tpu_snappy.ops.pallas import scatter as PS
from tpu_snappy.ops.pallas import tiledres as PT
from tpu_snappy.ops.pallas import windows as PW

from tpu_snappy_torch import config as TC
from tpu_snappy_torch import sidecar as SC
from tpu_snappy_torch.ops import decode as TD
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import ffill as KF
from tpu_snappy_torch.ops.kernels import scatter as KS
from tpu_snappy_torch.ops.kernels import tiledres as KT
from tpu_snappy_torch.ops.kernels import windows as KW

from torch_edges import LIMB_WROWS, OUT_CELLS, limb_rows
from torch_threads import share_cores

share_cores()

N = 1 << 16
N_EDGES = (N, N - 1, 5000, 4, 3, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_shared_constants():
    """The constants the port's kernels and pipelines bake in equal the
    JAX modules' own, and DEFAULT_CONFIG still has the knobs the port
    implements."""
    assert dataclasses.asdict(TC.DEFAULT_CONFIG) == dataclasses.asdict(
        DEFAULT_CONFIG)
    assert (DEFAULT_CONFIG.flatten, DEFAULT_CONFIG.sticky,
            DEFAULT_CONFIG.stride, DEFAULT_CONFIG.table) == (
        "class", "exact", 1, "points")
    assert TE.STICKY_LEVELS == E.STICKY_LEVELS
    assert TE.SENT == PP.SENT
    assert KS.WROWS == PS.WROWS
    assert KS.TILE == PS.TR * PS.TC
    assert KT.TILE == PT.TILE
    assert TD.FRAG_CAP == D.FRAG_CAP
    assert TD.OUT == D.OUT
    assert KW.N == PW.N == KS.N == KT.N == N


# --- window_keys -----------------------------------------------------------

def _window_cases():
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 256, (len(N_EDGES), N), dtype=np.uint8)
    blocks[1, :] = 0x61  # a run: every window equal
    return blocks, np.asarray(N_EDGES, np.int32)


def test_window_keys_plain_matches_pallas_and_xla():
    blocks, ns = _window_cases()
    got = KW.window_keys(_t(blocks), _t(ns)).numpy()
    iota = jnp.arange(N, dtype=jnp.int32)
    for row, n in enumerate(ns):
        b = jnp.asarray(blocks[row])
        kern = np.asarray(PW.window_keys_block(b, jnp.int32(n)))
        xla = np.asarray(jnp.where(iota <= n - 4, E._windows_u32(b),
                                   jnp.uint32(0xFFFFFFFF)))
        assert (got[row] == kern.astype(np.int64)).all(), n
        assert (got[row] == xla.astype(np.int64)).all(), n


@pytest.mark.gpu
def test_window_keys_kernel_matches_plain(cuda):
    blocks, ns = _window_cases()
    b, n = _t(blocks).to(cuda), _t(ns).to(cuda)
    assert torch.equal(KW.window_keys(b, n), KW.window_keys_plain(b, n))


# --- ffill -----------------------------------------------------------------

def _chunk_edge_masks(m: int) -> np.ndarray:
    """Masks set only at the last position of each chunk, one row per
    chunk size the kernel takes, then only at each chunk's first position,
    only at 0 and only at m - 1."""
    rows = []
    for chunk in KF.CHUNKS:
        row = np.zeros(m, bool)
        row[chunk - 1::chunk] = True
        rows.append(row)
    row = np.zeros(m, bool)
    row[::KF.SEGMENT] = True
    rows.append(row)
    rows += [np.zeros(m, bool), np.zeros(m, bool)]
    rows[-2][0] = rows[-1][m - 1] = True
    return np.stack(rows)


def _ffill_cases():
    """(mask, payloads) at the encode width and two decode widths: sparse
    masks, leading unmasked positions, an empty mask; then the chunk-edge
    masks at 8192 and 69632 (17 chunks of 4096, each chunk's last position
    set in its own row)."""
    rng = np.random.default_rng(7)
    out = []
    for m, k in ((N, 1), (8192, 4), (68 * 1024, 2)):
        mask = rng.random((3, m)) < 0.03
        mask[0, 0] = True
        mask[1, :500] = False
        mask[2] = False
        vals = tuple(rng.integers(-(1 << 19), 1 << 19, (3, m)).astype(np.int32)
                     for _ in range(k))
        out.append((mask, vals))
    for m, k in ((8192, 1), (68 * 1024, 3)):
        mask = _chunk_edge_masks(m)
        vals = tuple(rng.integers(-(1 << 31), (1 << 31) - 1, mask.shape)
                     .astype(np.int32) for _ in range(k))
        out.append((mask, vals))
    return out


@pytest.mark.parametrize("case", range(5))
def test_ffill_plain_matches_pallas_and_scan(case):
    mask, vals = _ffill_cases()[case]
    got = KF.ffill(_t(mask), tuple(_t(v) for v in vals))
    for row in range(mask.shape[0]):
        m = jnp.asarray(mask[row])
        vs = tuple(jnp.asarray(v[row]) for v in vals)
        kern = PF.ffill_block(m, *vs)
        xla = JS.ffill_many(m, vs)
        # scan.ffill_many (the XLA associative scan) gives a row's FIRST
        # entry before its first set mask, where ffill_block and the port
        # keep each position's own entry; they agree from the first mask on.
        filled = np.maximum.accumulate(mask[row])
        for g, a, b in zip(got, kern, xla):
            g = g[row].numpy()
            assert (g == np.asarray(a)).all(), (case, row)
            assert (g[filled] == np.asarray(b)[filled]).all(), (case, row)


@pytest.mark.gpu
def test_ffill_kernel_matches_plain(cuda):
    for mask, vals in _ffill_cases():
        m = _t(mask).to(cuda)
        vs = tuple(_t(v).to(cuda) for v in vals)
        for g, w in zip(KF.ffill(m, vs), KF.ffill_plain(m, vs)):
            assert torch.equal(g, w)


def test_fill_chunk_rule():
    """The chunk fills the card at the main path's batches (the largest
    chunk whose grid reaches FILL_BLOCKS), and falls to one segment for
    few rows."""
    assert KF.fill_chunk(128, N) == KF.fill_chunk(126, 57344) == 4096
    assert KF.fill_chunk(2, N) == KF.fill_chunk(1, 8192) == KF.SEGMENT
    for batch in (1, 2, 3, 8, 16, 33, 64, 126, 128, 512):
        for m in (1024, 8192, 57344, N, 68 * 1024):
            chunk = KF.fill_chunk(batch, m)
            assert chunk in KF.CHUNKS
            blocks = batch * -(-m // chunk)
            assert blocks >= KF.FILL_BLOCKS or chunk == KF.SEGMENT
            larger = [c for c in KF.CHUNKS if c > chunk]
            assert all(batch * -(-m // c) < KF.FILL_BLOCKS for c in larger)


def test_ffill_refuses_what_the_kernel_does_not_take():
    mask = torch.zeros((2, 1000), dtype=torch.bool)
    val = torch.zeros((2, 1000), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        KF.ffill(mask, (val,))
    mask, val = mask[:, :896], val[:, :896].contiguous()
    with pytest.raises(ValueError, match="chunk"):
        KF.ffill(mask, (val,), chunk=3072)
    with pytest.raises(ValueError, match="payload"):
        KF.ffill(mask, ())
    assert torch.equal(KF.ffill(mask, (val,), chunk=2048)[0], val)


def _ffill_card_masks(batch: int, m: int) -> np.ndarray:
    """Main-path-sized masks for the card: the chunk-edge rows, an empty
    and a full row, then random rows from sparse to dense."""
    rng = np.random.default_rng(batch + m)
    rows = list(_chunk_edge_masks(m)) + [np.zeros(m, bool), np.ones(m, bool)]
    rows += [rng.random(m) < p for p in (0.001, 0.03, 0.3, 0.9)]
    return np.stack([rows[i % len(rows)] for i in range(batch)])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [2, 126, 128])
def test_ffill_kernel_matches_plain_at_main_path_shapes(cuda, batch):
    """B 2, 126 and 128 at widths 57344 and 65536 (and 57344 + 128: a
    ragged last chunk and segment), 1 to 4 payloads, at the rule's chunk
    and at every chunk size."""
    rng = np.random.default_rng(batch)
    for m in (57344, N, 57344 + 128):
        mask = _t(_ffill_card_masks(batch, m)).to(cuda)
        for k in range(1, KF.LAUNCH_PAYLOADS + 1):
            vals = tuple(_t(rng.integers(-(1 << 31), (1 << 31) - 1,
                                         (batch, m)).astype(np.int32))
                         .to(cuda) for _ in range(k))
            want = KF.ffill_plain(mask, vals)
            for chunk in (None, *KF.CHUNKS):
                got = KF.ffill(mask, vals, chunk=chunk)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    m, k, chunk)


# --- scatter_windowed ------------------------------------------------------

def _scatter_cases():
    """Transport-shaped rows (test_pallas.py:586): nondecreasing dests with
    dropped writes and tag/payload pairs sharing a cell; random dests that
    overflow their windows; and one overflow of count 1."""
    rng = np.random.default_rng(31)
    m = 32 * 1024
    dest = np.minimum(np.cumsum(rng.integers(1, 3, m)), N).astype(np.int32)
    drop = rng.random(m) < 0.3
    d = np.where(drop, N, dest).astype(np.int32)
    vals = np.where(rng.random(m) < 0.5, rng.integers(0, 1 << 16, m) << 8,
                    rng.integers(0, 256, m)).astype(np.int32)
    dup = (~drop) & (rng.random(m) < 0.1) & (vals >= 256)
    d2 = np.where(dup, d, N).astype(np.int32)
    v2 = np.where(dup, rng.integers(0, 256, m), 0).astype(np.int32)
    transport = (np.concatenate([d, d2]), np.concatenate([vals, v2]))
    rand = (rng.integers(0, N + 1, 2 * m).astype(np.int32),
            rng.integers(0, 1 << 24, 2 * m).astype(np.int32))
    ovf_d = np.full(2 * m, N, np.int32)
    ovf_d[0], ovf_d[1023] = 0, 40000
    ovf = (ovf_d, np.full(2 * m, 5, np.int32))
    return [transport, rand, ovf]


def test_scatter_windowed_plain_matches_pallas():
    cases = _scatter_cases()
    dest = np.stack([c[0] for c in cases])
    vals = np.stack([c[1] for c in cases])
    out, ovf = KS.scatter_windowed(_t(dest), _t(vals))
    for row in range(len(cases)):
        want, wovf = PS.scatter_windowed(jnp.asarray(dest[row]),
                                         jnp.asarray(vals[row]), 3, N)
        assert (out[row].numpy() == np.asarray(want)).all(), row
        assert int(ovf[row]) == int(wovf), row
    assert int(ovf[0]) == 0 and int(ovf[1]) > 0 and int(ovf[2]) == 1
    assert int(out[2, 0]) == 5 and int(out[2, 40000]) == 0


@pytest.mark.gpu
def test_scatter_windowed_kernel_matches_plain(cuda):
    cases = _scatter_cases()
    dest = _t(np.stack([c[0] for c in cases])).to(cuda)
    vals = _t(np.stack([c[1] for c in cases])).to(cuda)
    got, govf = KS.scatter_windowed(dest, vals)
    want, wovf = KS.scatter_windowed_plain(dest, vals)
    assert torch.equal(got, want) and torch.equal(govf, wovf)


def _sidecar_rows(wrows: int, m: int = 8192):
    """Sidecar-shaped piece starts at `wrows` (ascending with gaps that fit
    the window, padded with 65536 from half the row on), a row with no
    active dest (all at or past 65536: the TPU kernel takes a negative
    dest as active, the port drops it, and no caller passes one), a tile
    whose kept dests straddle three 4096-cell output tiles (at the larger
    windows), a tile that overflows its window, and values whose top limb
    is negative."""
    rng = np.random.default_rng(100 + wrows)
    step = max(1, (wrows - 9) * 128 // 1024)
    fit = np.minimum(np.cumsum(rng.integers(1, step + 1, m)), N)
    pad = fit.copy()
    pad[m // 2:] = N
    none = np.where(np.arange(m) % 3 == 0, N, N + 5)
    straddle = fit.copy()
    straddle[:1024] = 100 + np.arange(1024) * (min(wrows - 9, 80) * 128
                                               // 1024)
    straddle[1024:] = np.maximum(straddle[1024:], straddle[1023])
    wide = fit.copy()
    wide[:1024] = np.minimum(np.arange(1024) * (wrows * 128 // 1024 + 16),
                             N - 1)
    wide[1024:] = np.maximum(wide[1024:], wide[1023])
    dest = np.stack([pad, none, np.minimum(straddle, N),
                     np.minimum(wide, N)]).astype(np.int32)
    vals = rng.integers(0, 1 << 24, dest.shape).astype(np.int32)
    vals[:, ::7] = -1
    return dest, vals


@pytest.mark.parametrize("wrows", SC.PARENT_WROWS)
def test_scatter_windowed_plain_matches_pallas_wrows(wrows):
    dest, vals = _sidecar_rows(wrows)
    out, ovf = KS.scatter_windowed(_t(dest), _t(vals), wrows)
    for row in range(len(dest)):
        want, wovf = PS.scatter_windowed(jnp.asarray(dest[row]),
                                         jnp.asarray(vals[row]), 3, N,
                                         wrows=wrows)
        assert (out[row].numpy() == np.asarray(want)).all(), (wrows, row)
        assert int(ovf[row]) == int(wovf), (wrows, row)
    assert not out[1].any() and int(ovf[1]) == 0
    assert (int(ovf[3]) > 0) == (wrows < N // KS.LO)


def test_windowed_tile_rule():
    """WINDOWED_TILE while the grid reaches WINDOWED_BLOCKS, halved for few
    rows down to MIN_WINDOWED_TILE; every tile a power of two that fits
    shared memory with the source-tile list."""
    assert KS.windowed_tile(128) == KS.windowed_tile(126) == 4096
    assert KS.windowed_tile(2) == KS.MIN_WINDOWED_TILE == 512
    for batch in (1, 2, 3, 8, 16, 33, 64, 126, 128, 1024):
        tile = KS.windowed_tile(batch)
        assert KS.MIN_WINDOWED_TILE <= tile <= KS.WINDOWED_TILE
        assert tile & (tile - 1) == 0 and tile % KS.LO == 0
        assert (batch * (N // tile) >= KS.WINDOWED_BLOCKS
                or tile == KS.MIN_WINDOWED_TILE)
        assert (tile == KS.WINDOWED_TILE
                or batch * (N // (2 * tile)) < KS.WINDOWED_BLOCKS)


def test_scatter_windowed_refuses_bad_tiles():
    d = torch.full((1, 1024), N, dtype=torch.int32)
    for tile in (100, 0, 2 * N, 20480):
        with pytest.raises(ValueError, match="tile"):
            KS.scatter_windowed(d, d, tile=tile)
    out, ovf = KS.scatter_windowed(d, d, tile=16384)
    assert not out.any() and int(ovf[0]) == 0


@pytest.mark.parametrize("cells", OUT_CELLS)
@pytest.mark.parametrize("limbs", [1, 2, 3])
def test_scatter_windowed_limbs_out_cells_match_pallas(limbs, cells):
    """scatter_windowed's `limbs` and `out_cells` (scatter.py:176-178):
    the plain version equals the Pallas kernel, drop counts included."""
    wrows = LIMB_WROWS[limbs]
    dest, vals = limb_rows(limbs, cells)
    out, ovf = KS.scatter_windowed(_t(dest), _t(vals), wrows, limbs=limbs,
                                   out_cells=cells)
    assert out.shape == (3, cells)
    for row in range(len(dest)):
        want, wovf = PS.scatter_windowed(jnp.asarray(dest[row]),
                                         jnp.asarray(vals[row]), limbs,
                                         cells, wrows=wrows)
        assert (out[row].numpy() == np.asarray(want)).all(), row
        assert int(ovf[row]) == int(wovf), row
    assert int(ovf[0]) == 0 and int(ovf[1]) > 0 and int(ovf[2]) == 1
    assert int(out[2, 0]) == vals[2, 0] and out[2, -128 * wrows:].any()


def test_scatter_windowed_refuses_bad_limbs_and_cells():
    """out_cells not a multiple of 128, below 128 * wrows or at 2^30, and
    limbs outside 1-3, refused by the wrapper and the plain version; the
    least output (128 * wrows cells) is taken."""
    d = torch.full((1, 1024), 5, dtype=torch.int32)
    for fn in (KS.scatter_windowed, KS.scatter_windowed_plain):
        for cells in (65600, 128 * 191, 1 << 30, 0):
            with pytest.raises(ValueError, match="out_cells"):
                fn(d, d, KS.WROWS, out_cells=cells)
        for limbs in (0, 4):
            with pytest.raises(ValueError, match="limbs"):
                fn(d, d, 32, limbs=limbs, out_cells=4096)
        out, ovf = fn(d, d, 32, limbs=1, out_cells=4096)
        assert out.shape == (1, 4096) and int(out[0, 5]) == 5 * 1024
    with pytest.raises(ValueError, match="tile"):
        KS.scatter_windowed(d, d, 32, 8192, limbs=1, out_cells=4096)


@pytest.mark.parametrize("batch,cells,want", [
    (128, N, 4096), (128, 32768, 4096), (128, 67584, 4096),
    (8, 67584, 1024), (1, 67584, 512), (64, 4096, 512), (2, 128 * 32, 512),
    (128, 256, 256)])
def test_windowed_tile_counts_out_cells(batch, cells, want):
    """The tile rule at other out_cells: the grid counts a partial last
    tile (67584 cells are 16.5 tiles of 4096), and the tile is at most
    out_cells; every limb count's planes fit shared memory beside the
    list."""
    tile = KS.windowed_tile(batch, cells)
    assert tile == want and tile <= cells
    assert 3 * tile * 4 + KS._WINDOWED_LIST_BYTES <= 227 * 1024


def test_signatures_match_the_sources():
    """Every C entry point _build declares is exported by one csrc file
    with that many parameters, and every export is declared."""
    import re
    from tpu_snappy_torch.ops.kernels import _build
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r"SNK_EXPORT int (\w+)\(([^)]*)\)",
                                       src.read_text()):
            found[name] = len(params.split(","))
    assert found == {k: len(v) for k, v in _build.SIGNATURES.items()}
    assert "snk_place" not in found and found["snk_scatter_windowed"] == 12


@pytest.mark.gpu
@pytest.mark.parametrize("cells", OUT_CELLS)
@pytest.mark.parametrize("limbs", [1, 2, 3])
def test_scatter_windowed_limbs_kernel_matches_plain(cuda, limbs, cells):
    """The limb-count rows at B 3 and tiled to B 128, at the rule's tile
    and at tiles of 512 to 16384 cells."""
    wrows = LIMB_WROWS[limbs]
    dest, vals = limb_rows(limbs, cells)
    for d, v in ((dest, vals), (np.tile(dest, (43, 1))[:128],
                                np.tile(vals, (43, 1))[:128])):
        dt, vt = _t(d).to(cuda), _t(v).to(cuda)
        want = KS.scatter_windowed_plain(dt, vt, wrows, limbs=limbs,
                                         out_cells=cells)
        for tile in (None, 512, 2048, 4096, 8192, 16384):
            got = KS.scatter_windowed(dt, vt, wrows, tile, limbs=limbs,
                                      out_cells=cells)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                d.shape, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("wrows", [*SC.PARENT_WROWS, KS.WROWS])
def test_scatter_windowed_kernel_matches_plain_wrows(cuda, wrows):
    """The sidecar rows at B 4 and tiled to B 128 at M 8192 and 32768, at
    the rule's tile and at tiles of 512 to 8192 cells; random dests at
    wrows 512 meet every output tile."""
    dest, vals = _sidecar_rows(wrows)
    cases = [(dest, vals), (np.tile(dest, (32, 4)), np.tile(vals, (32, 4)))]
    if wrows == 512:
        rng = np.random.default_rng(5)
        cases.append((rng.integers(-5, N + 5, (128, 32768)).astype(np.int32),
                      rng.integers(0, 1 << 24, (128, 32768))
                      .astype(np.int32)))
    for d, v in cases:
        dt, vt = _t(d).to(cuda), _t(v).to(cuda)
        want = KS.scatter_windowed_plain(dt, vt, wrows)
        for tile in (None, 512, 1024, 2048, 4096, 8192):
            got = KS.scatter_windowed(dt, vt, wrows, tile)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                d.shape, tile)


# --- resolve_tiled ---------------------------------------------------------

def _resolve_cases():
    """Random decreasing maps, the identity, the period-1 chain of depth
    65535, and hops that straddle tile boundaries (test_pallas.py:187)."""
    rng = np.random.default_rng(33)
    ident = np.arange(N, dtype=np.int32)
    srcs = np.stack([
        np.minimum(ident, rng.integers(0, N, N)),
        ident,
        np.maximum(ident - 1, 0),
        np.maximum(ident - ident % PT.TILE - 1, 0),
    ]).astype(np.int32)
    lit = rng.integers(0, 256, srcs.shape).astype(np.int32)
    return lit, srcs


def _fixed_point(src):
    s = src.copy()
    for _ in range(17):
        s = s[s]
    return s


def test_resolve_tiled_plain_matches_pallas():
    lit, srcs = _resolve_cases()
    got = KT.resolve_tiled(_t(lit), _t(srcs)).numpy()
    for row in range(len(srcs)):
        assert (got[row] == lit[row][_fixed_point(srcs[row])]).all(), row
    # The Pallas kernel itself, interpreted, on the mixed and the
    # straddling maps (the identity and chain cases are covered above).
    for row in (0, 3):
        want = PT.resolve_tiled(jnp.asarray(lit[row]), jnp.asarray(srcs[row]))
        assert (got[row] == np.asarray(want)).all(), row


@pytest.mark.gpu
def test_resolve_tiled_kernel_matches_plain(cuda):
    lit, srcs = _resolve_cases()
    lt, st = _t(lit).to(cuda), _t(srcs).to(cuda)
    assert torch.equal(KT.resolve_tiled(lt, st),
                       KT.resolve_tiled_plain(lt, st))


def test_wrappers_refuse_mixed_devices():
    """A wrapper never falls back: tensors on no single CPU/CUDA device
    raise instead of running somewhere."""
    x = torch.zeros((1, N), dtype=torch.int32)
    with pytest.raises(ValueError):
        KT.resolve_tiled(x, x.to("meta"))
