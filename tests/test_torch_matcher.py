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
    assert KM.MAX_K >= K and K % 2 == 0
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
    with pytest.raises(ValueError, match="K from 2 to 16"):
        KM.matcher_block_packed(pref, words, n, 17, 2)
    with pytest.raises(ValueError, match="K from 2 to 16"):
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
@pytest.mark.parametrize("k", [3, 8, 15])
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
    for k in (3, 8, 14, 15):
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
