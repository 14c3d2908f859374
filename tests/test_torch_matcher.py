"""The port's packed candidate form and matcher kernel module against JAX.

The packed (pref, words) of tpu_snappy_torch.ops.encode._candidate_offsets
must equal the JAX `_candidate_offsets(..., packed=True)` per block, and
matcher_block_packed's plain version (the CPU path) must equal the JAX
XLA-form matcher on the rows of test_torch_encode.py and the Pallas
`matcher_block_packed` in interpret mode on one block; so at odd K and at
sticky "sig", where a row planted with signature collisions
(test_torch_presets.sig_collision_row) needs the final exact
verification. The unpacked matcher_block's plain version must equal the
XLA-form matcher and the Pallas `matcher_block` in interpret mode. All
comparisons are exact (everything is integer). The `gpu` tests hold the
CUDA kernels against their plain versions on the card.
"""

import dataclasses
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.config import DEFAULT_CONFIG
from tpu_snappy.ops import encode as E
from tpu_snappy.ops.pallas import matcher as PM

from tpu_snappy_torch import config as TC
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import matcher as KM

from test_torch_encode import _inputs
from test_torch_presets import sig_collision_row

from torch_threads import share_cores

from torch_edges import matcher_edge_rows

share_cores()

N = 1 << 16
K = DEFAULT_CONFIG.candidates
ROWS = range(len(_inputs()[1]))


@pytest.fixture(scope="module")
def port():
    blocks, lens = _inputs()
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    pref, words = TE._candidate_offsets(TE._window_keys(b, n), n)
    return pref, words, n


@pytest.fixture(scope="module")
def jax_packed():
    """JAX's packed form per block: (pref (B, N), words (B, N, K/2) u32)."""
    blocks, lens = _inputs()
    iota = jnp.arange(N, dtype=jnp.int32)

    def one(block, length):
        key = E._window_keys(block, length, iota)
        return E._candidate_offsets(key, length, iota, K, "class",
                                    DEFAULT_CONFIG.probes, packed=True)

    pref, words = jax.jit(jax.vmap(one))(jnp.asarray(blocks),
                                         jnp.asarray(lens))
    return np.asarray(pref), np.asarray(words)


def test_kernel_constants():
    assert KM.MIN_K <= K <= KM.FIXED_K and K % 2 == 0
    assert DEFAULT_CONFIG.sticky == "exact"


@pytest.mark.parametrize("row", ROWS)
def test_packed_candidates_match_jax(port, jax_packed, row):
    pref, words, _ = port
    jp, jw = jax_packed
    assert words.shape == (len(ROWS), K // 2, N)
    assert (pref[row].numpy() == jp[row]).all()
    # JAX keeps (N, K/2) u32 words; the port (K/2, N) int32 bit patterns.
    assert (words[row].numpy() == jw[row].T.view(np.int32)).all()


def test_unpacked_table_matches_jax(port):
    pref, words, n = port
    blocks, lens = _inputs()
    iota = jnp.arange(N, dtype=jnp.int32)

    def one(block, length):
        key = E._window_keys(block, length, iota)
        return E._candidate_offsets(key, length, iota, K, "class",
                                    DEFAULT_CONFIG.probes)

    want = jax.jit(jax.vmap(one))(jnp.asarray(blocks), jnp.asarray(lens))
    assert (KM.unpack_table(pref, words, K).numpy() == np.asarray(want)).all()


@pytest.mark.parametrize("lazy", [DEFAULT_CONFIG.lazy, 0])
def test_matcher_plain_matches_xla(port, lazy):
    pref, words, n = port
    jump, off = KM.matcher_block_packed(pref, words, n, K, lazy)
    cands = jnp.asarray(KM.unpack_table(pref, words, K).numpy())
    iota = jnp.arange(N, dtype=jnp.int32)
    wj, wo = jax.jit(jax.vmap(lambda c, m: E._matcher_xla(c, m, iota, lazy)))(
        cands, jnp.asarray(n.numpy()))
    assert (jump.numpy() == np.asarray(wj)).all()
    assert (off.numpy() == np.asarray(wo)).all()


def test_matcher_plain_matches_pallas_interpret(port):
    """One block (the far-copy / long-literal mix), K=14, lazy 2, "exact":
    the Pallas kernel interpreted on the CPU costs about 12 s a block."""
    pref, words, n = port
    row = 3
    got_j, got_o = KM.matcher_block_packed_plain(
        pref[row:row + 1], words[row:row + 1], n[row:row + 1], K,
        DEFAULT_CONFIG.lazy)
    jw = jnp.asarray(words[row].numpy().T.view(np.uint32))
    want_j, want_o = PM.matcher_block_packed(
        jnp.asarray(pref[row].numpy()), jw, jnp.int32(int(n[row])), K,
        DEFAULT_CONFIG.lazy, "exact")
    assert (got_j[0].numpy() == np.asarray(want_j)).all()
    assert (got_o[0].numpy() == np.asarray(want_o)).all()


def test_matcher_refuses_unported_forms(port):
    pref, words, n = port
    with pytest.raises(ValueError, match="K from 2"):
        KM.matcher_block_packed(pref, words[:, :0], n, KM.MIN_K - 1, 2)
    with pytest.raises(ValueError, match="K from 2"):
        KM.matcher_block(torch.zeros((1, N, 1), dtype=torch.int32), n[:1])
    with pytest.raises(ValueError, match="sticky"):
        KM.matcher_block_packed(pref, words, n, K, 2, "hash")


def _tables(k: int, flatten: str = "class"):
    """The port's packed (pref, words) and unpacked table at K=k (probes
    == k) on _inputs() plus the signature-collision row, with lengths."""
    blocks, lens = _inputs()
    row, _ = sig_collision_row()
    blocks = np.concatenate([blocks, row[None]])
    lens = np.concatenate([lens, [N]]).astype(np.int32)
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    cfg = dataclasses.replace(TC.DEFAULT_CONFIG, candidates=k, probes=k,
                              flatten=flatten)
    key = TE._window_keys(b, n)
    if flatten == "off":
        return None, None, TE._candidate_offsets(key, n, cfg, False), n
    pref, words = TE._candidate_offsets(key, n, cfg)
    return pref, words, KM.unpack_table(pref, words, k), n


def _xla(cands, n, lazy, sticky):
    iota = jnp.arange(N, dtype=jnp.int32)
    return (np.asarray(x) for x in jax.jit(jax.vmap(
        lambda c, m: E._matcher_xla(c, m, iota, lazy, sticky)))(
            jnp.asarray(cands.numpy()), jnp.asarray(n.numpy())))


@pytest.mark.parametrize("sticky", ["exact", "sig"])
@pytest.mark.parametrize("k", [3, 8, 15, 18])
def test_matcher_plain_matches_xla_at_k(k, sticky):
    """Odd and even K, both sticky modes, lazy 2."""
    pref, words, cands, n = _tables(k)
    jump, off = KM.matcher_block_packed(pref, words, n, k, 2, sticky)
    wj, wo = _xla(cands, n, 2, sticky)
    assert (jump.numpy() == wj).all()
    assert (off.numpy() == wo).all()


def test_sig_collision_falls_back_to_column_0():
    """At each planted p the signature composition carries p-4's default a
    into p, where a is no candidate; the verification must give b."""
    _, plants = sig_collision_row()
    pref, words, cands, n = _tables(3)
    jump, off = KM.matcher_block_packed(pref, words, n, 3, 2, "sig")
    sig = TE._sig_bit(torch.tensor([[a, b] for _, a, b in plants]))
    assert (sig[:, 0] == sig[:, 1]).all()
    for p, a, b in plants:
        assert a not in cands[-1, p].tolist()
        assert int(cands[-1, p - 4, 0]) == a
        assert int(off[-1, p]) == b and int(jump[-1, p]) == 4


def test_matcher_sig_k3_plain_matches_pallas_interpret():
    """TURBO's point (K=3, sticky "sig", lazy 2) on the collision row."""
    pref, words, _, n = _tables(3)
    got_j, got_o = KM.matcher_block_packed_plain(
        pref[-1:], words[-1:], n[-1:], 3, 2, "sig")
    jw = jnp.asarray(words[-1].numpy().T.view(np.uint32))
    want_j, want_o = PM.matcher_block_packed(
        jnp.asarray(pref[-1].numpy()), jw, jnp.int32(N), 3, 2, "sig")
    assert (got_j[0].numpy() == np.asarray(want_j)).all()
    assert (got_o[0].numpy() == np.asarray(want_o)).all()


def test_matcher_block_plain_matches_pallas_interpret():
    """The unpacked kernel on TURBO's table of the collision row."""
    _, _, cands, n = _tables(3)
    got_j, got_o = KM.matcher_block(cands[-1:], n[-1:], 2, "sig")
    want_j, want_o = PM.matcher_block(jnp.asarray(cands[-1].numpy()),
                                      jnp.int32(N), 2, "sig")
    assert (got_j[0].numpy() == np.asarray(want_j)).all()
    assert (got_o[0].numpy() == np.asarray(want_o)).all()


@pytest.mark.parametrize("sticky", ["exact", "sig"])
def test_matcher_block_plain_matches_xla_without_flattening(sticky):
    """flatten "off": the nearest-first (B, N, 14) table."""
    _, _, cands, n = _tables(K, "off")
    assert cands.shape == (len(n), N, K)
    jump, off = KM.matcher_block(cands, n, 2, sticky)
    wj, wo = _xla(cands, n, 2, sticky)
    assert (jump.numpy() == wj).all()
    assert (off.numpy() == wo).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_matcher_kernel_matches_plain(port, cuda):
    pref, words, n = (x.to(cuda) for x in port)
    for lazy in (DEFAULT_CONFIG.lazy, 0):
        got = KM.matcher_block_packed(pref, words, n, K, lazy)
        want = KM.matcher_block_packed_plain(pref, words, n, K, lazy)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_matcher_kernels_sig_and_odd_k_match_plain(cuda):
    for k in (3, 8, 14, 15, 17, 18, 24):
        pref, words, cands, n = (None if x is None else x.to(cuda)
                                 for x in _tables(k))
        for sticky in ("exact", "sig"):
            for lazy in (2, 0):
                got = KM.matcher_block_packed(pref, words, n, k, lazy, sticky)
                want = KM.matcher_block_packed_plain(pref, words, n, k, lazy,
                                                     sticky)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    k, sticky, lazy)
                got = KM.matcher_block(cands, n, lazy, sticky)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    k, sticky, lazy)


# --- The kernel's restated stages (csrc/matcher.cu), in torch ---------------
#
# The CUDA kernel tiles a row into KM.TILES tiles of KM.TILE outputs, each
# computed from a region of THREADS x PER positions around it (LEFT before,
# RIGHT after, wrapping mod N like the TPU's rolls), and restates the stages
# after sticky: link runs as trailing ones of stride-4 equality ballots, the
# filter as a 20-bit window of per-thread match nibbles, and the 7
# Hillis-Steele propagation levels as a sliding max over [i - 127, i] of the
# key (value + 1) << 11 | region index (largest key = rightmost argmax),
# from per-128-position prefix and suffix maxima (van Herk / Gil-Werman).
# The forms below are that design, written out, and must give the plain
# version's bits on the edge rows.

LEN = KM.THREADS * KM.PER
IDX_BITS = 11


def _bits(x: torch.Tensor, count: int) -> torch.Tensor:
    """The low `count` bits of an int64 tensor, in a new last dimension."""
    return (x[..., None] >> torch.arange(count)) & 1


def _sliding_max_keys(key: torch.Tensor) -> torch.Tensor:
    """max(key[p - 127 .. p]) over the region (clipped at 0): prefix maxima
    within 128-blocks with the previous block's suffix maxima."""
    b, m = key.shape
    blocks = key.view(b, m // 128, 128)
    g = blocks.cummax(-1).values.view(b, m)
    h = blocks.flip(-1).cummax(-1).values.flip(-1).view(b, m)
    prev = torch.full_like(h, -1)
    prev[:, 127:] = h[:, :m - 127]
    return torch.maximum(g, prev)


def _ballot_runs(o: torch.Tensor) -> torch.Tensor:
    """Consecutive links o[p + 4j] == o[p], j = 1.., capped at 16, from the
    stride-4 equality ballots: per warp (128 positions) and chain (p mod
    4) a 32-bit word, with the next warp's word above it."""
    b, m = o.shape
    eq = torch.zeros_like(o, dtype=torch.bool)
    eq[:, :-4] = o[:, 4:] == o[:, :-4]
    lanes = eq.view(b, m // 128, 32, 4).to(torch.int64)
    bal = (lanes << torch.arange(32)[:, None]).sum(2)  # (b, warps, 4)
    nxt = torch.zeros_like(bal)
    nxt[:, :-1] = bal[:, 1:]
    pair = bal | nxt << 32
    ahead = (pair[:, :, None, :] >> torch.arange(32)[:, None]) & 0xFFFFFFFF
    ones = _bits(ahead, 16).cumprod(-1).sum(-1)  # trailing ones, capped
    return ones.reshape(b, m)


def _nibble_before(has: torch.Tensor) -> torch.Tensor:
    """Match starts in [p - 16, p - 1] from a 20-bit window of the thread's
    and the four previous threads' 4-bit match nibbles."""
    b, m = has.shape
    nib = (has.view(b, m // 4, 4).to(torch.int64)
           << torch.arange(4)).sum(-1)
    padded = torch.cat([torch.zeros((b, 4), dtype=torch.int64), nib], 1)
    win = sum(padded[:, s:s + m // 4] << (4 * s) for s in range(5))
    shifted = (win[..., None] >> torch.arange(4)) & 0xFFFF  # (b, m/4, 4)
    return _bits(shifted, 16).sum(-1).reshape(b, m)


def _region_sticky(tab, gm, sticky):
    """The plain sticky levels on a region (identity where the global index
    or the region index is below the shift)."""
    p = torch.arange(tab.shape[1])
    keep, dflt = tab, tab[..., 0]
    for lvl in range(TE.STICKY_LEVELS):
        s = 4 << lvl
        a_keep = torch.roll(keep, s, dims=1)
        a_dflt = torch.roll(dflt, s, dims=1)
        if sticky == "sig":
            sig = torch.where(keep > 0, TE._sig_bit(keep), 0)
            mask = sig[..., 0]
            for j in range(1, sig.shape[-1]):
                mask = mask | sig[..., j]
            in_keep = (mask[..., None] & TE._sig_bit(a_keep)) != 0
            in_dflt = (mask & TE._sig_bit(a_dflt)) != 0
        else:
            in_keep = (a_keep[..., None] == keep[..., None, :]).any(-1)
            in_dflt = (a_dflt[..., None] == keep).any(-1)
        new_keep = torch.where(in_keep & (a_keep > 0), a_keep, 0)
        new_dflt = torch.where(in_dflt & (a_dflt > 0), a_dflt, dflt)
        ident = (gm < s) | (p < s)
        keep = torch.where(ident[:, None], keep, new_keep)
        dflt = torch.where(ident, dflt, new_dflt)
    if sticky == "sig":
        ver = ((dflt[..., None] == tab) & (dflt[..., None] > 0)).any(-1)
        dflt = torch.where(ver, dflt, tab[..., 0])
    return dflt


def _tiled_matcher(cands: torch.Tensor, n: torch.Tensor, lazy: int,
                   sticky: str):
    """The kernel's tiling and restated stages: (jump, off) of (B, N, K)
    cands, tile by tile from each tile's region alone."""
    b = cands.shape[0]
    cands = cands.to(torch.int64)
    n = n.to(torch.int64)[:, None]
    p = torch.arange(LEN)
    jump = torch.empty((b, N), dtype=torch.int32)
    off = torch.empty((b, N), dtype=torch.int32)
    for t in range(KM.TILES):
        t0 = t * KM.TILE
        gm = (t0 - KM.LEFT + p) % N
        o = _region_sticky(cands[:, gm], gm, sticky)
        run = _ballot_runs(o)
        mlq = torch.where(o != 0, 4 + 4 * run, 0)
        ml = mlq.clone()
        for e in (1, 2, 3):
            o_e = torch.zeros_like(o)
            mlq_e = torch.zeros_like(mlq)
            o_e[:, :-e], mlq_e[:, :-e] = o[:, e:], mlq[:, e:]
            ml = torch.where(o_e == o, torch.maximum(ml, e + mlq_e), ml)
        ml = torch.minimum(torch.where(o != 0, ml, 0), n - gm)
        neg = (t0 == 0) & (p < KM.LEFT)
        isolated = _nibble_before((ml > 0) & ~neg) == 0
        near = o < 2048
        keep = ((ml >= 5) | near) & ((ml >= 6) | near | ~isolated)
        pva = torch.where(keep, ml, 0) + gm
        key = torch.where(neg, p, (pva + 1) << IDX_BITS | p)
        wk = _sliding_max_keys(key)
        q = torch.arange(KM.LEFT, KM.LEFT + KM.TILE)
        q = q[t0 + q - KM.LEFT < N]
        g = gm[q]
        mlp = torch.clamp((wk[:, q] >> IDX_BITS) - 1 - g, max=68)
        if lazy:
            nx = torch.clamp((wk[:, q + 1] >> IDX_BITS) - 1 - (g + 1), max=68)
            nx = torch.where(g == N - 1, 0, nx)
            mlp = torch.where((mlp >= 4) & (mlp < 64) & (nx >= mlp + lazy), 0,
                              mlp)
        jump[:, g] = TE._jump(mlp)
        off[:, g] = torch.gather(o, 1, wk[:, q] & (LEN - 1)).to(torch.int32)
    return jump, off


_edge_rows = functools.lru_cache(maxsize=None)(matcher_edge_rows)


@functools.lru_cache(maxsize=None)
def _edge_tables(k: int):
    """The port's packed table of torch_edges.matcher_edge_rows at K=k, its
    unpacked form and the lengths (built once a K; the tests only read
    them)."""
    blocks, lens = _edge_rows()
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    cfg = dataclasses.replace(TC.DEFAULT_CONFIG, candidates=k, probes=k)
    pref, words = TE._candidate_offsets(TE._window_keys(b, n), n, cfg)
    return pref, words, KM.unpack_table(pref, words, k), n


def test_matcher_tiling():
    """The wrapper's tiling is the kernel's (csrc/matcher.cu), the region is
    a whole number of PER-position threads, the halos cover the stages'
    reach, and the tiles cover the row."""
    src = (pathlib.Path(KM.__file__).parent / "csrc" /
           "matcher.cu").read_text()
    cu = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                              src).group(1))
          for name in ("kThreads", "kPer", "kLeft", "kRight")}
    assert (KM.THREADS, KM.PER, KM.LEFT, KM.RIGHT) == tuple(cu.values())
    assert LEN == 1 << IDX_BITS and LEN % 128 == 0
    assert KM.LEFT >= 60 + 16 + 127 and KM.RIGHT >= 64 + 3 + 1
    assert KM.LEFT % KM.PER == 0 and KM.TILE % KM.PER == 0
    assert KM.TILES * KM.TILE >= N > (KM.TILES - 1) * KM.TILE


@pytest.mark.parametrize("packed", [True, False])
def test_matcher_refuses_misaligned_tables(monkeypatch, packed):
    """The kernel loads the tables 16 bytes a thread: a view that does not
    start on a 16-byte boundary is refused before any launch (the CUDA
    path's checks, run here on CPU tensors with the launch stubbed)."""
    def no_launch():
        raise AssertionError("launched")

    def shifted(x):
        y = torch.zeros(x.numel() + 4, dtype=x.dtype)[1:1 + x.numel()]
        return y.view(x.shape)

    monkeypatch.setattr(KM._build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(KM._build, "lib", no_launch)
    n = torch.full((2,), N, dtype=torch.int32)
    if packed:
        tables = [torch.zeros((2, N), dtype=torch.int32),
                  torch.zeros((2, 7, N), dtype=torch.int32)]
    else:
        tables = [torch.zeros((2, N, 14), dtype=torch.int32)]

    def call(ts):
        if packed:
            return KM.matcher_block_packed(*ts, n, 14, 2)
        return KM.matcher_block(*ts, n, 2)

    with pytest.raises(AssertionError, match="launched"):
        call(tables)
    for i in range(len(tables)):
        case = list(tables)
        case[i] = shifted(case[i])
        assert case[i].is_contiguous() and case[i].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(case)


@pytest.mark.parametrize("k", [3, 14])
def test_propagation_as_sliding_max_of_keys(k):
    """The 7 strict-> levels equal the sliding max of (value + 1) << 11 |
    index with the rightmost argmax, on rows with ties (equal values at
    different positions and offsets inside one window)."""
    _, _, cands, n = _edge_tables(k)
    off_s = TE._sticky_offsets(cands)
    ml = TE._match_lengths(off_s, n)
    has = (ml > 0).to(torch.int32)
    m4cnt = torch.cumsum(has, dim=-1, dtype=torch.int32)
    iota = torch.arange(N, dtype=torch.int32)
    before = m4cnt - torch.where(iota >= 17, torch.roll(m4cnt, 17, -1), 0)
    near = off_s < 2048
    keep = ((ml >= 5) | near) & ((ml >= 6) | near | (before - has != 0))
    ml = torch.where(keep, ml, 0)
    want_v, want_o = TE._propagate(ml, off_s)
    pva = (ml + iota).to(torch.int64)
    # Row-wide indices need 16 bits here (the kernel's region needs 11).
    key = (pva + 1) << 16 | iota
    wk = _sliding_max_keys(key)
    assert torch.equal(torch.clamp((wk >> 16) - 1 - iota, max=68), want_v)
    assert torch.equal(torch.gather(off_s, 1, wk & 0xFFFF), want_o)
    # The tie row has windows whose maximum sits at several positions with
    # different offsets (so the rightmost rule decides).
    v = ml[0] + iota
    ties = 0
    for i in range(200, N, 997):
        w = v[i - 127:i + 1]
        at = (w == w.max()).nonzero().flatten() + i - 127
        ties += len(set(off_s[0, at].tolist())) > 1
    assert ties > 0


def test_filter_and_links_restated():
    """The nibble window gives the plain filter's count of match starts in
    [i - 16, i - 1], and the ballot runs its link count (row-wide, the
    region rules aside)."""
    _, _, cands, n = _edge_tables(14)
    off_s = TE._sticky_offsets(cands)
    ml = TE._match_lengths(off_s, n)
    has = (ml > 0).to(torch.int32)
    m4cnt = torch.cumsum(has, dim=-1, dtype=torch.int32)
    iota = torch.arange(N, dtype=torch.int32)
    before = m4cnt - torch.where(iota >= 17, torch.roll(m4cnt, 17, -1), 0)
    assert torch.equal(_nibble_before(ml > 0), (before - has).to(torch.int64))
    o = off_s.to(torch.int64)
    run = _ballot_runs(o)
    want = torch.zeros_like(o)
    alive = torch.ones_like(o, dtype=torch.bool)
    for j in range(1, 17):
        nxt = torch.zeros_like(o)
        nxt[:, :-4 * j] = o[:, 4 * j:]
        alive &= nxt == o
        want += alive
    inside = iota < N - 64  # the row end wraps in the plain form
    assert torch.equal(run[:, inside], want[:, inside])


@pytest.mark.parametrize("k,sticky,lazy", [(2, "exact", 0), (3, "sig", 2),
                                           (8, "exact", 1), (14, "exact", 2),
                                           (14, "sig", 1), (15, "sig", 0),
                                           (16, "exact", 2), (16, "sig", 1)])
def test_tiled_matcher_matches_plain(k, sticky, lazy):
    """The kernel's tiling and restated stages give the plain version's
    (jump, off) on the edge rows: ties, copies at every halo and tile
    edge, n at a tile boundary and one past it, runs over boundaries, the
    wrap."""
    pref, words, cands, n = _edge_tables(k)
    want = KM.matcher_block_packed_plain(pref, words, n, k, lazy, sticky)
    got = _tiled_matcher(cands, n, lazy, sticky)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_tiled_matcher_matches_pallas_interpret():
    """TURBO's point (K=3, "sig", lazy 2) on the row with copies at every
    halo edge, against the Pallas kernel interpreted on the CPU."""
    pref, words, cands, n = _edge_tables(3)
    got_j, got_o = _tiled_matcher(cands[1:2], n[1:2], 2, "sig")
    jw = jnp.asarray(words[1].numpy().T.view(np.uint32))
    want_j, want_o = PM.matcher_block_packed(
        jnp.asarray(pref[1].numpy()), jw, jnp.int32(int(n[1])), 3, 2, "sig")
    assert (got_j[0].numpy() == np.asarray(want_j)).all()
    assert (got_o[0].numpy() == np.asarray(want_o)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3, 8, 14, 15, 16])
def test_matcher_kernels_match_plain_on_edge_rows(k, cuda):
    """Both kernels at every sticky mode and lazy 0-2 on the edge rows."""
    pref, words, cands, n = (x.to(cuda) for x in _edge_tables(k))
    cands = cands.contiguous()
    for sticky in ("exact", "sig"):
        for lazy in (0, 1, 2):
            want = KM.matcher_block_packed_plain(pref, words, n, k, lazy,
                                                 sticky)
            got = KM.matcher_block_packed(pref, words, n, k, lazy, sticky)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                k, sticky, lazy)
            got = KM.matcher_block(cands, n, lazy, sticky)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                k, sticky, lazy)
