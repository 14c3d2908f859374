"""The port's packed candidate form and matcher kernel module against JAX.

The packed (pref, words) of tpu_snappy_torch.ops.encode._candidate_offsets
must equal the JAX `_candidate_offsets(..., packed=True)` per block, and
matcher_block_packed's plain version (the CPU path) must equal the JAX
XLA-form matcher on the rows of test_torch_encode.py and the Pallas
`matcher_block_packed` in interpret mode on one block. All comparisons are
exact (everything is integer). The `gpu` test holds the CUDA kernel
against its plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.config import DEFAULT_CONFIG
from tpu_snappy.ops import encode as E
from tpu_snappy.ops.pallas import matcher as PM

from tpu_snappy_torch.ops import encode as TE
from tpu_snappy_torch.ops.kernels import matcher as KM

from test_torch_encode import _inputs

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
    with pytest.raises(ValueError):
        KM.matcher_block_packed(pref, words, n, K, 2, "sig")
    with pytest.raises(ValueError):
        KM.matcher_block_packed(pref, words, n, K - 1, 2)


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
