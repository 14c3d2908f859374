"""The port's scans (tpu_snappy_torch/ops/scan.py) against tpu_snappy.ops.scan.

Committed flags of the encode (bounded) and decode (general) parse scans
must equal the JAX scans' on the jump patterns of tests/test_scan.py, and
the helpers the pipelines share must agree exactly (all integer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy.ops import scan as JS
from tpu_snappy_torch.ops import scan as TS

from torch_threads import share_cores

share_cores()


def _golden_committed(jump: np.ndarray) -> np.ndarray:
    out = np.zeros(len(jump), bool)
    i = 0
    while i < len(jump):
        out[i] = True
        i += max(1, int(jump[i]))
    return out


def _cases(rng, n):
    """The jump patterns of tests/test_scan.py: all literals, max copies,
    a bounded mix, small jumps with giant literal jumps, one huge jump."""
    yield np.ones(n, np.int32)
    yield np.full(n, 64, np.int32)
    yield rng.integers(1, 65, n).astype(np.int32)
    j = rng.integers(1, 6, n).astype(np.int32)
    j[rng.choice(n, 20, replace=False)] = rng.integers(1000, n, 20)
    yield j
    j = np.ones(n, np.int32)
    j[0] = n - 1
    yield j


@pytest.mark.parametrize("n", [JS.S * JS.G * 17, 68 * 1024])
def test_commit_general_matches_jax(n):
    rng = np.random.default_rng(n)
    jumps = np.stack(list(_cases(rng, n)))
    got = TS.commit_general(torch.from_numpy(jumps)).numpy()
    want = np.asarray(JS.commit_general(jnp.asarray(jumps)))
    assert (got == want).all()
    for row, jump in enumerate(jumps):
        assert (got[row] == _golden_committed(jump)).all(), row


def test_commit_bounded_matches_jax():
    rng = np.random.default_rng(3)
    n = 1 << 16
    jumps = np.stack([np.ones(n, np.int32), np.full(n, 64, np.int32),
                      rng.integers(1, 65, n).astype(np.int32),
                      rng.integers(1, 5, n).astype(np.int32)])
    got = TS.commit_bounded(torch.from_numpy(jumps)).numpy()
    want = np.asarray(JS.commit_bounded(jnp.asarray(jumps)))
    assert (got == want).all()
    for row, jump in enumerate(jumps):
        assert (got[row] == _golden_committed(jump)).all(), row


def test_entry_states_match_jax():
    rng = np.random.default_rng(7)
    n = JS.S * JS.G * 23
    jumps = np.stack(list(_cases(rng, n)))
    maps_t = TS.segment_exit_maps(torch.from_numpy(jumps))
    maps_j = JS.segment_exit_maps(jnp.asarray(jumps))
    assert (maps_t.numpy() == np.asarray(maps_j)).all()
    assert (TS.entry_states_sequential(maps_t).numpy()
            == np.asarray(JS.entry_states_sequential(maps_j))).all()
    bounded = rng.integers(1, 65, (3, n)).astype(np.int32)
    mb_t = TS.segment_exit_maps(torch.from_numpy(bounded))
    mb_j = JS.segment_exit_maps(jnp.asarray(bounded), bounded=True)
    assert (TS.entry_states_bounded(mb_t).numpy()
            == np.asarray(JS.entry_states_bounded(mb_j))).all()


def test_cumsum_and_next_element_start_match_jax():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 300, (3, 1 << 16)).astype(np.int32)
    flags = rng.random((3, 1 << 16)) < 0.05
    flags[1] = False
    assert (TS.exclusive_cumsum(torch.from_numpy(x)).numpy()
            == np.asarray(JS.exclusive_cumsum(jnp.asarray(x)))).all()
    got = TS.next_element_start(torch.from_numpy(flags), 1 << 16).numpy()
    want = np.asarray(JS.next_element_start(jnp.asarray(flags), 1 << 16))
    assert (got == want).all()
