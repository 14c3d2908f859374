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
from tpu_snappy_torch.ops import decode as TD
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import ffill as KF
from tpu_snappy_torch.ops.kernels import scatter as KS
from tpu_snappy_torch.ops.kernels import tiledres as KT
from tpu_snappy_torch.ops.kernels import windows as KW

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

def _ffill_cases():
    """(mask, payloads) at the encode width and two decode widths: sparse
    masks, leading unmasked positions, an empty mask."""
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
    return out


@pytest.mark.parametrize("case", range(3))
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
