"""The port at every K and every payload count the JAX package takes.

The matchers above K 24 (ops/kernels/matcher.py: the fixed kernel
instances end at FIXED_K, the wide kernel takes larger K at run time)
and the forward fill with five payloads or more (ops/kernels/ffill.py:
one fill launch for each four). On the CPU the wrappers run their plain
versions: the packed and unpacked plain matchers at K 25, 26, 32, 48 and
64 must equal the JAX package's XLA-form matcher on the same table (one
case at K 26 also the Pallas kernel in interpret mode), api.compress
must give the JAX package's streams above K 24 (packed "exact" and
"sig", flatten "off", stride 2; K 32 against a live JAX compress), and encode_blocks must reach the packed
wrapper there. The wide kernel's sticky stage, restated in torch
(torch_edges.matcher_ops), must equal the plain composition. The
fill with 5
to 9 payloads must equal the Pallas `ffill_block` in interpret mode and
one single-payload fill for each payload. The `gpu` tests hold the CUDA
kernels against their plain versions on the card.
"""

import dataclasses
import functools
import hashlib
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy import api as jax_api
from tpu_snappy import config as JC
from tpu_snappy.ops import encode as E
from tpu_snappy.ops.pallas import ffill as PF
from tpu_snappy.ops.pallas import matcher as PM

from tpu_snappy_torch import api
from tpu_snappy_torch import config as TC
from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops import scan as TS
from tpu_snappy_torch.ops.kernels import ffill as KF
from tpu_snappy_torch.ops.kernels import matcher as KM

from test_torch_presets import sig_collision_row
from torch_edges import LATER_STAGE_OPS, matcher_ops

from torch_threads import share_cores

share_cores()

N = 1 << 16
WIDE = (25, 26, 32, 48, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fox() -> bytes:
    return b"".join(b"the quick brown fox jumps over the lazy dog %d " % i
                    for i in range(3000))[:70000]


def _cfg(**knobs):
    return dataclasses.replace(TC.DEFAULT_CONFIG, **knobs)


@functools.lru_cache(maxsize=None)
def _tables(k: int):
    """Packed (pref, words), the unpacked table and lengths at K=k on two
    rows: the port's table of _fox()'s first block (probes == k), and a
    random table of offsets below 40 (memberships hit often, and 40
    offsets share 32 signature buckets)."""
    data = np.frombuffer(_fox()[:N], np.uint8)
    b = torch.from_numpy(data[None].copy())
    n = torch.tensor([N], dtype=torch.int32)
    pref, words = TE._candidate_offsets(TE._window_keys(b, n), n,
                                        _cfg(candidates=k, probes=k))
    rng = np.random.default_rng(k)
    rp = torch.from_numpy(rng.integers(0, 40, (1, N)).astype(np.int32))
    lo, hi = (rng.integers(0, 40, (1, k // 2, N)) for _ in range(2))
    rw = torch.from_numpy((lo | hi << 16).astype(np.int32))
    pref, words = torch.cat([pref, rp]), torch.cat([words, rw])
    n = torch.tensor([N, N - 5], dtype=torch.int32)
    return pref, words, KM.unpack_table(pref, words, k).contiguous(), n


def _xla(cands, n, sticky: str, lazies: tuple) -> list:
    """JAX's XLA-form matcher at each lazy: [(jump, off), ...] as numpy.
    "exact" compiles fast, so it runs jitted over the rows; "sig" unrolls
    K per level, whose compile grows with K, so it runs op by op on one
    row."""
    iota = jnp.arange(N, dtype=jnp.int32)
    c, m = jnp.asarray(cands.numpy()), jnp.asarray(n.numpy())
    if sticky == "exact":
        out = jax.jit(jax.vmap(lambda c, m: [
            E._matcher_xla(c, m, iota, lazy, sticky) for lazy in lazies]))(
                c, m)
        return [tuple(np.asarray(x) for x in pair) for pair in out]
    assert len(n) == 1
    return [tuple(np.asarray(x)[None] for x in E._matcher_xla(
        c[0], m[0], iota, lazy, sticky)) for lazy in lazies]


@pytest.mark.parametrize("sticky", ["exact", "sig"])
@pytest.mark.parametrize("k", WIDE)
def test_wide_plain_matchers_match_xla(k, sticky):
    """Packed and unpacked plain matchers on both rows at "exact", lazy 0
    and 2; at "sig" on the random row (where the bucket collisions are),
    lazy 0 at K 25, 32 and 64 and lazy 2 at K 26 and 48 (the stages after
    sticky, where lazy acts, are the same at both sticky modes)."""
    pref, words, cands, n = _tables(k)
    lazies = (0, 2)
    if sticky == "sig":
        pref, words, cands, n = pref[1:], words[1:], cands[1:], n[1:]
        lazies = (2,) if k in (26, 48) else (0,)
    for lazy, (wj, wo) in zip(lazies, _xla(cands, n, sticky, lazies)):
        for jump, off in (KM.matcher_block_packed(pref, words, n, k, lazy,
                                                  sticky),
                          KM.matcher_block(cands, n, lazy, sticky)):
            assert (jump.numpy() == wj).all(), (k, sticky, lazy)
            assert (off.numpy() == wo).all(), (k, sticky, lazy)


def test_wide_plain_matches_pallas_interpret():
    """K 26, "sig", lazy 2 on the random row, against the Pallas kernel
    interpreted on the CPU (about 12 s)."""
    pref, words, _, n = _tables(26)
    got_j, got_o = KM.matcher_block_packed_plain(pref[1:], words[1:], n[1:],
                                                 26, 2, "sig")
    jw = jnp.asarray(words[1].numpy().T.view(np.uint32))
    want_j, want_o = PM.matcher_block_packed(
        jnp.asarray(pref[1].numpy()), jw, jnp.int32(int(n[1])), 26, 2, "sig")
    assert (got_j[0].numpy() == np.asarray(want_j)).all()
    assert (got_o[0].numpy() == np.asarray(want_o)).all()


@pytest.mark.parametrize("sticky", ["exact", "sig"])
@pytest.mark.parametrize("k", [2, 3, 14, 26, 33])
def test_window_intersection_is_the_sticky_composition(k, sticky):
    """The wide kernel's sticky stage, restated in torch by
    torch_edges.matcher_ops (the keep sets as intersections over a
    window of the original table, the bucket masks as ANDs), equals the
    plain composition (the function raises where it does not) on random
    tables of few, more and many distinct offsets (K 2-33), on the text
    row and on the signature-collision row; its count of operations lies
    between the data-independent part and the window tests' worst case."""
    rng = np.random.default_rng(100 + k)
    tables = [torch.from_numpy(rng.integers(0, hi, (1, N, k))
                               .astype(np.int32)) for hi in (3, 40, 2000)]
    tables.append(_tables(k)[2][:1] if k >= 3 else tables[0])
    row, _ = sig_collision_row()
    b = torch.from_numpy(row[None].copy())
    n = torch.tensor([N], dtype=torch.int32)
    if k >= 3:
        pref, words = TE._candidate_offsets(
            TE._window_keys(b, n), n, _cfg(candidates=k, probes=k))
        tables.append(KM.unpack_table(pref, words, k))
    for cands in tables:
        least = N * (k + 3 * TE.STICKY_LEVELS + LATER_STAGE_OPS)
        ops = matcher_ops(cands, sticky)
        assert least <= ops <= least + N * 15 * k, (k, sticky)


#: api.compress(_fox()) above K 24: the JAX package's stream at each
#: config, by size and the first 16 hex digits of its sha256, as
#: `hashlib.sha256(tpu_snappy.api.compress(_fox(), dataclasses.replace(
#: tpu_snappy.config.DEFAULT_CONFIG, **knobs), small_fastpath=False))`
#: gives them under JAX_PLATFORMS=cpu (6-11 s a config, so only K 32 runs
#: live here: test_k32_compress_equals_the_live_jax_stream).
JAX_STREAMS = {
    "k32": (dict(candidates=32, probes=32), 7846, "93af979840f9f4ae"),
    "k64": (dict(candidates=64, probes=64), 7845, "69ab6b5312ef7d63"),
    "k26_sig": (dict(candidates=26, probes=26, sticky="sig"), 9537,
                "7352cda1733503b9"),
    "k26_off": (dict(candidates=26, probes=26, flatten="off"), 7854,
                "c7074c46e9163cdd"),
    "k26_stride2": (dict(candidates=26, probes=26, stride=2), 9789,
                    "25a946438302d07e")}


@pytest.mark.parametrize("name", JAX_STREAMS)
def test_wide_k_compress_gives_the_jax_stream(name):
    knobs, size, digest = JAX_STREAMS[name]
    comp = api.compress(_fox(), _cfg(**knobs), device="cpu",
                        small_fastpath=False)
    assert len(comp) == size
    assert hashlib.sha256(comp).hexdigest()[:16] == digest
    assert api.decompress(comp, device="cpu") == _fox()


def test_k32_compress_equals_the_live_jax_stream():
    """K 32 "exact" against tpu_snappy.api.compress on the same input, run
    here (about 7 s of JAX compiles)."""
    knobs = JAX_STREAMS["k32"][0]
    jcfg = dataclasses.replace(JC.DEFAULT_CONFIG, **knobs)
    want = jax_api.compress(_fox(), jcfg, small_fastpath=False)
    assert api.compress(_fox(), _cfg(**knobs), device="cpu",
                        small_fastpath=False) == want


@pytest.mark.parametrize("knobs,name", [
    (dict(candidates=26, probes=26), "matcher_block_packed"),
    (dict(candidates=26, probes=26, stride=2), "matcher_block_packed"),
    (dict(candidates=26, probes=26, flatten="off"), "matcher_block")])
def test_wide_k_reaches_the_matcher_wrappers(monkeypatch, knobs, name):
    """Above K 24 encode_blocks calls the matcher wrapper of its table's
    form, as the JAX package does on the TPU, and the XLA-form matcher
    runs only inside it (its plain version, on the CPU)."""
    seen = []
    for fn, mod in (("matcher_block", KM), ("matcher_block_packed", KM),
                    ("_matcher_xla", TE)):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _n=fn, _r=real, **k: (
            seen.append(_n), _r(*a, **k))[1])
    data = np.frombuffer(_fox()[:N], np.uint8)
    b = torch.from_numpy(data[None].copy())
    TE.encode_blocks(b, torch.tensor([N], dtype=torch.int32), _cfg(**knobs))
    assert seen == [name, "_matcher_xla"]


def _cu_constant(source: str, name: str) -> int:
    src = (pathlib.Path(KM.__file__).parent / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_the_wrappers_constants_are_the_kernels():
    """The K where the wide kernel starts, and the payloads a fill launch
    takes, as the sources define them."""
    assert KM.FIXED_K == _cu_constant("matcher.cu", "kFixedK") == 24
    assert KF.LAUNCH_PAYLOADS == _cu_constant("ffill.cu",
                                              "kLaunchPayloads") == 4


def test_matcher_takes_every_k_from_min_k():
    pref, words, cands, n = _tables(26)
    assert KM.MIN_K == 2
    with pytest.raises(ValueError, match="K from 2"):
        KM.matcher_block(cands[..., :1].contiguous(), n)
    with pytest.raises(ValueError, match="K from 2"):
        KM.matcher_block_packed(pref, words[:, :0], n, 1)


# --- ffill with more than four payloads -----------------------------------

def _fill_case(k: int, m: int = 2048):
    """Masks at width m (sparse with leading unmasked positions, empty,
    set only at 0 and only at each segment's start) and k payloads (each
    count's payloads begin with the smaller counts')."""
    rng = np.random.default_rng(m)
    mask = rng.random((4, m)) < 0.03
    mask[0, :700] = False
    mask[1] = False
    mask[2] = False
    mask[2, 0] = True
    mask[3] = False
    mask[3, ::KF.SEGMENT] = True
    vals = tuple(rng.integers(-(1 << 31), (1 << 31) - 1, (4, m))
                 .astype(np.int32) for _ in range(k))
    return mask, vals


@functools.lru_cache(maxsize=None)
def _pallas_fill(k: int, max_gap=None) -> list:
    """The Pallas ffill_block in interpret mode on _fill_case(k), a row at
    a time: [row][payload] as numpy."""
    mask, vals = _fill_case(k)
    return [[np.asarray(x) for x in PF.ffill_block(
        jnp.asarray(mask[row]), *(jnp.asarray(v[row]) for v in vals),
        max_gap=max_gap)] for row in range(mask.shape[0])]


@pytest.mark.parametrize("k", [5, 6, 7, 8, 9])
def test_ffill_many_payloads_match_pallas_and_one_at_a_time(k):
    """The wrapper and scan.ffill_many at 5-9 payloads against the Pallas
    kernel (its nine-payload call: a payload's fill depends on the mask
    and that payload alone) and against one single-payload fill each."""
    mask, vals = _fill_case(k)
    tm = torch.from_numpy(mask)
    tv = tuple(torch.from_numpy(v) for v in vals)
    got = KF.ffill(tm, tv)
    assert len(got) == k
    assert all(torch.equal(g, h) for g, h in zip(got, TS.ffill_many(tm, tv)))
    for g, v in zip(got, tv):
        assert torch.equal(g, KF.ffill(tm, (v,))[0])
    for row, want in enumerate(_pallas_fill(9)):
        for g, a in zip(got, want):
            assert (g[row].numpy() == a).all(), (k, row)


def test_ffill_many_payloads_with_max_gap():
    mask, vals = _fill_case(6)
    tm = torch.from_numpy(mask)
    tv = tuple(torch.from_numpy(v) for v in vals)
    for gap in (1, 1025):
        got = KF.ffill(tm, tv, max_gap=gap)
        for row, want in enumerate(_pallas_fill(6, gap)):
            for g, a in zip(got, want):
                assert (g[row].numpy() == a).all(), (gap, row)


def test_ffill_takes_at_least_one_payload():
    with pytest.raises(ValueError, match="at least one payload"):
        KF.ffill(torch.zeros((2, 128), dtype=torch.bool), ())


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("k", [25, 26, 32, 33, 48, 64])
def test_wide_matcher_kernels_match_plain(k, cuda):
    pref, words, cands, n = (x.to(cuda) for x in _tables(k))
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


@pytest.mark.gpu
@pytest.mark.parametrize("name", JAX_STREAMS)
def test_wide_k_compress_on_the_card(name, cuda):
    knobs, size, digest = JAX_STREAMS[name]
    comp = api.compress(_fox(), _cfg(**knobs), device=cuda,
                        small_fastpath=False)
    assert len(comp) == size
    assert hashlib.sha256(comp).hexdigest()[:16] == digest


@pytest.mark.gpu
@pytest.mark.parametrize("k", [5, 8, 9])
def test_ffill_many_payloads_on_the_card(k, cuda):
    mask, vals = _fill_case(k, N)
    tm = torch.from_numpy(mask).to(cuda)
    tv = tuple(torch.from_numpy(v).to(cuda) for v in vals)
    for gap in (None, 100):
        want = KF.ffill_plain(tm, tv, gap)
        for chunk in (None, *KF.CHUNKS):
            got = KF.ffill(tm, tv, chunk=chunk, max_gap=gap)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                k, gap, chunk)
