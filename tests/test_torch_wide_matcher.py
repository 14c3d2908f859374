"""The wide matcher kernel's design, restated on the CPU.

ops/kernels/csrc/matcher.cu's wide form (the matcher at K above the fixed
instances' FIXED_K, and at any K through the private `matcher._wide`)
walks the sticky stage as torch_edges.wide_sticky restates it: each level
moves the default where the position's composed bucket mask admits it
and, at "exact", where it lies in the table at every window position,
answered by the near bits of the mask pass where the default is keep 0 of
a position at most 12 back, else at keep 0, else by a scan of the rest.
The walk must give the plain composition's
offsets (encode._sticky_offsets, the body of the plain matcher
encode._matcher_xla) at K 2, 3, 14, 25-33, 40, 64 and 96 on encoder,
signature-collision and random small-offset tables; the composed "exact"
bucket mask must never reject a member of the window's intersection; the
unpacked mask pass's index map (torch_edges.wide_lane_map) must read every
(position, column) of a tile's region exactly once, the wrap of tile 0 and
K % 4 != 0 included; and the window tests' compares must stay far below
the table's bytes on the card. `_wide` on CPU tensors is the plain matcher.
The `gpu` tests hold the kernel against the plain version on the card:
through `_wide` at K 2-24, and through the public wrappers and `_wide` at
K 25-33, 48, 64 and 96, in both table forms.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tpu_snappy_torch import config as TC
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import matcher as KM

from torch_edges import make_data, wide_lane_map, wide_mask, wide_sticky
from test_torch_presets import sig_collision_row

from torch_threads import share_cores

share_cores()

N = 1 << 16
WALK_KS = (2, 3, 14, *range(25, 34), 40, 64, 96)
#: The K whose walk also runs on the signature-collision row and on a
#: table of three offsets (every keep a member: the most scans).
EXTRA_TABLE_KS = (3, 14, 26, 33)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _encoder_table(row: np.ndarray, n: int, k: int):
    """The port's packed (pref, words) of one row at K = probes = k."""
    b = torch.from_numpy(row[None].copy())
    m = torch.tensor([n], dtype=torch.int32)
    cfg = dataclasses.replace(TC.DEFAULT_CONFIG, candidates=k, probes=k)
    return TE._candidate_offsets(TE._window_keys(b, m), m, cfg)


@functools.lru_cache(maxsize=None)
def _text_row() -> np.ndarray:
    return np.frombuffer(make_data(2 * N, 19)[:N], np.uint8)


def _random_packed(k: int, hi: int, rows: int = 1, seed: int = 0):
    """A packed table of random offsets below `hi`."""
    rng = np.random.default_rng(seed + 1000 * k + hi)
    pref = rng.integers(0, hi, (rows, N)).astype(np.int32)
    lo, up = (rng.integers(0, hi, (rows, k // 2, N)) for _ in range(2))
    return (torch.from_numpy(pref),
            torch.from_numpy((lo | up << 16).astype(np.int32)))


def _walk_tables(k: int) -> list:
    """(name, (1, N, k) table): the text row's encoder table and a random
    table of offsets below 40 at every K; at EXTRA_TABLE_KS also the
    signature-collision row's encoder table and offsets below 3."""
    tables = [("text", KM.unpack_table(*_encoder_table(_text_row(), N, k),
                                       k)),
              ("below 40", KM.unpack_table(*_random_packed(k, 40), k))]
    if k in EXTRA_TABLE_KS:
        row, _ = sig_collision_row()
        tables += [("collision", KM.unpack_table(
                        *_encoder_table(row, N, k), k)),
                   ("below 3", KM.unpack_table(*_random_packed(k, 3), k))]
    return tables


@pytest.mark.parametrize("sticky", ["exact", "sig"])
@pytest.mark.parametrize("k", WALK_KS)
def test_wide_walk_is_the_sticky_composition(k, sticky):
    for name, cands in _walk_tables(k):
        got, counts = wide_sticky(cands, sticky)
        assert torch.equal(got, TE._sticky_offsets(cands, sticky)), (
            k, sticky, name)
        if sticky == "sig":
            assert counts["tests"] == counts["near"] == 0
        else:
            assert counts["scans"] <= counts["tests"]
            assert counts["near"] + counts["tests"] <= 15 * N


def _window_members(table: torch.Tensor, lvl: int):
    """The keeps of each position that lie in the table at every position
    of its level-`lvl` window (i, i - 4, ..., i - 4 (2^l - 1)), and where
    that window lies inside the row."""
    n = table.shape[1]
    member = torch.ones(table.shape, dtype=torch.bool)
    for j in range(1, 1 << lvl):
        at = torch.roll(table, 4 * j, dims=1)
        member &= (table[..., :, None] == at[..., None, :]).any(-1)
    inside = torch.arange(n) >= 4 * ((1 << lvl) - 1)
    return member, inside


@settings(max_examples=30, deadline=None)
@given(k=st.integers(2, 96), hi=st.sampled_from([2, 5, 40, 65536]),
       seed=st.integers(0, 2**32 - 1))
def test_exact_prefilter_never_rejects_a_member(k, hi, seed):
    """The AND of the "exact" bucket masks over a window holds the bucket
    of every keep that lies in all of the window's tables, at every level
    (zero keeps included)."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.integers(0, hi, (1, 512, k))
                             .astype(np.int32))
    composed = wide_mask(table, "exact")
    for lvl in range(TE.STICKY_LEVELS):
        member, inside = _window_members(table, lvl)
        for c in range(k):
            got = (composed & TE._sig_bit(table[..., c])) != 0
            assert not (member[..., c] & inside & ~got).any(), (lvl, c)
        composed = composed & torch.roll(composed, 4 << lvl, dims=1)


def test_wide_masks_are_the_kernels():
    """Bit (x * 0x9E3779B1 mod 2^32) >> 27 of each keep: at "exact" a zero
    keep sets bit 0 (the bucket of 0), at "sig" it sets none."""
    table = torch.tensor([[[1, 0]]], dtype=torch.int32)
    one = 1 << (0x9E3779B1 >> 27)
    assert int(wide_mask(table, "exact")[0, 0]) == one | 1
    assert int(wide_mask(table, "sig")[0, 0]) == one


@pytest.mark.parametrize("t0", [0, 5 * KM.TILE, (KM.TILES - 1) * KM.TILE])
@pytest.mark.parametrize("k", [2, 3, 4, 14, 25, 32, 33, 64, 96])
def test_wide_lane_map_reads_the_region_once(k, t0):
    """Every (position, column) of the tile's 2048-position region, the
    positions wrapping at the row's end, exactly once."""
    flat = wide_lane_map(k, t0)
    flat = np.sort(flat[flat >= 0])
    length = KM.THREADS * KM.PER
    pos = (t0 - KM.LEFT + np.arange(length)) % N
    want = np.sort((pos[:, None] * k + np.arange(k)[None]).ravel())
    assert np.array_equal(flat, want)


#: Integer operations a second and bytes a second of the card, as
#: chip_smoke.py bounds a kernel (INT_OPS_PER_S, HBM_BYTES_PER_S).
INT_OPS_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


@pytest.mark.parametrize("k", [32, 64])
def test_window_compares_stay_under_the_bytes(k):
    """On the encoder's tables of the seeded mix, the window tests' work
    (a near bit or a keep-0 compare a test, K - 1 compares a scan at most)
    takes far less time at the card's integer rate than the packed table's
    bytes at its memory rate."""
    data = np.frombuffer(make_data(4 * N, 23)[:2 * N], np.uint8)
    for row in data.reshape(2, N):
        cands = KM.unpack_table(*_encoder_table(row, N, k), k)
        _, counts = wide_sticky(cands, "exact")
        compares = (counts["near"] + counts["tests"]
                    + counts["scans"] * (k - 1))
        nbytes = N * (4 + 2 * (k // 2) + 8)
        assert compares / INT_OPS_PER_S < 0.1 * nbytes / HBM_BYTES_PER_S


@pytest.mark.parametrize("k", [3, 14, 26])
def test_wide_entry_on_the_cpu_is_plain(k):
    pref, words = _random_packed(k, 40, rows=2, seed=1)
    n = torch.tensor([N, N - 7], dtype=torch.int32)
    cands = KM.unpack_table(pref, words, k).contiguous()
    want = KM.matcher_block_packed_plain(pref, words, n, k, 2, "sig")
    for table in ((pref, words), (cands,)):
        got = KM._wide(table, n, k, 2, "sig")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="K from 2"):
        KM._wide((cands[..., :1].contiguous(),), n, 1)


# --- on the card -------------------------------------------------------------

def _card_tables(k: int, dev):
    """The text row's and a random (offsets below 40) packed table at K = k
    on two rows, their unpacked form and lengths, on `dev`."""
    tp, tw = _encoder_table(_text_row(), N, k)
    rp, rw = _random_packed(k, 40)
    pref, words = torch.cat([tp, rp]), torch.cat([tw, rw])
    n = torch.tensor([N, N - 5], dtype=torch.int32)
    cands = KM.unpack_table(pref, words, k).contiguous()
    return tuple(x.to(dev) for x in (pref, words, cands, n))


def _hold(k: int, dev, public: bool) -> None:
    pref, words, cands, n = _card_tables(k, dev)
    for sticky in ("exact", "sig"):
        for lazy in (0, 2):
            want = KM.matcher_block_packed_plain(pref, words, n, k, lazy,
                                                 sticky)
            runs = [KM._wide((pref, words), n, k, lazy, sticky),
                    KM._wide((cands,), n, k, lazy, sticky)]
            if public:
                runs += [KM.matcher_block_packed(pref, words, n, k, lazy,
                                                 sticky),
                         KM.matcher_block(cands, n, lazy, sticky)]
            for got in runs:
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    k, sticky, lazy)


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(KM.MIN_K, KM.FIXED_K + 1))
def test_wide_kernel_at_the_instances_k_matches_plain(k, cuda):
    before = KM._wide.launches
    _hold(k, cuda, public=False)
    assert KM._wide.launches - before == 8


@pytest.mark.gpu
@pytest.mark.parametrize("k", [*range(25, 34), 48, 64, 96])
def test_wide_kernel_matches_plain(k, cuda):
    _hold(k, cuda, public=True)
