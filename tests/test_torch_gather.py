"""The port's gather_block (tpu_snappy_torch/ops/kernels/gather.py) against
the Pallas kernel it replaces.

On the CPU the wrapper runs its plain PyTorch version; it is held, with
exact equality (integer data), against tpu_snappy/ops/pallas/gather.py
gather_block in interpret mode, as tests/test_pallas.py runs it, at limbs 1
and 2 and table widths 8192 and 65536, indices 0 and S-1 included, and at
limbs 3 and sparse targets with indices outside [0, S). The `gpu` tests
hold the CUDA kernel against the plain version on the card: limbs 1-3, S
8192 to 131072, T 4096 to 65536, B 1, 3 and 128, out-of-range and
negative indices, values at 2^(8 limbs) - 1, and x and idx one tensor
(the dense round).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy.ops.pallas import gather as PG

from tpu_snappy_torch.ops.kernels import gather as KG

from torch_threads import share_cores

share_cores()

N = 1 << 16
CASES = [(s, limbs) for s in (8192, N) for limbs in (1, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(s: int, limbs: int, rows: int = 2):
    """(x (rows, s), idx (rows, 65536)) from a seed: values filling the
    limb width, random indices with 0 and s - 1 at both ends."""
    rng = np.random.default_rng(s + limbs)
    x = rng.integers(0, 1 << (8 * limbs), (rows, s)).astype(np.int32)
    idx = rng.integers(0, s, (rows, N)).astype(np.int32)
    idx[:, :2] = (0, s - 1)
    idx[:, -2:] = (s - 1, 0)
    return x, idx


@pytest.mark.parametrize("s,limbs", CASES)
def test_gather_plain_matches_pallas(s, limbs):
    x, idx = _case(s, limbs)
    got = KG.gather_block(_t(x), _t(idx), limbs).numpy()
    for row in range(x.shape[0]):
        want = PG.gather_block(jnp.asarray(x[row]), jnp.asarray(idx[row]),
                               limbs)
        assert (got[row] == np.asarray(want)).all(), row
        assert (got[row] == x[row][idx[row]]).all(), row


def test_gather_contract():
    """Values wider than the limbs raise in the plain version; an index
    outside [0, S) reads 0, as the TPU's one-hot does; limbs is 1 to 3."""
    x = torch.full((1, 8192), 300, dtype=torch.int32)
    idx = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="bits"):
        KG.gather_block(x, idx, limbs=1)
    assert (KG.gather_block(x, idx, limbs=2) == 300).all()
    idx[0, :3] = torch.tensor([-1, 8192, 1 << 20])
    assert KG.gather_block(x, idx, limbs=2)[0, :4].tolist() == [0, 0, 0, 300]
    with pytest.raises(ValueError, match="limbs"):
        KG.gather_block(x, idx, limbs=4)


def _wide_case(limbs: int, s: int, t: int, rows: int, seed: int = 0):
    """(x (rows, s), idx (rows, t)): values up to 2^(8 limbs) - 1 (the
    first three at it), indices from -100 to s + 99 with 0, s - 1, -1 and
    s first."""
    rng = np.random.default_rng(seed + 7 * s + t + limbs)
    top = (1 << (8 * limbs)) - 1
    x = rng.integers(0, top + 1, (rows, s)).astype(np.int32)
    x[:, :3] = top
    idx = rng.integers(-100, s + 100, (rows, t)).astype(np.int32)
    idx[:, :4] = (0, s - 1, -1, s)
    return x, idx


@pytest.mark.parametrize("s,limbs,t", [(16384, 3, 12288), (N, 2, 4096),
                                        (16384, 1, 4096)])
def test_gather_plain_matches_pallas_sparse(s, limbs, t):
    """Fewer targets than table entries (the chase's form), limbs 1-3,
    values up to 2^(8 limbs) - 1. An index outside [0, S) reads 0 in the
    port; the Pallas kernel agrees at limbs 1 only (its multi-limb int8
    path returns the limb bias, 0x80 a limb, there), so at limbs 2-3 the
    two are compared where the index lies inside."""
    x, idx = _wide_case(limbs, s, t, rows=1)
    got = KG.gather_block(_t(x), _t(idx), limbs).numpy()[0]
    want = np.asarray(PG.gather_block(jnp.asarray(x[0]),
                                      jnp.asarray(idx[0]), limbs))
    inside = (idx[0] >= 0) & (idx[0] < s)
    assert (got[inside] == want[inside]).all()
    assert (got[~inside] == 0).all() and (~inside).sum() > 4
    if limbs == 1:
        assert (got == want).all()


@pytest.mark.gpu
@pytest.mark.parametrize("s,limbs", CASES)
def test_gather_kernel_matches_plain(s, limbs, cuda):
    x, idx = _case(s, limbs, rows=8)
    xt, it = _t(x).to(cuda), _t(idx).to(cuda)
    assert torch.equal(KG.gather_block(xt, it, limbs),
                       KG.gather_block_plain(xt, it, limbs))


#: (limbs, S, T, B) for the `gpu` tests: every limb count at S 8192,
#: 16384 and 65536, T 4096, 12288, 57344 and 65536, B 1, 3 and 128, odd
#: widths (the kernel's one-by-one loop, at few and many rows), and a
#: table of 131072.
WIDE_CASES = [(1, 8192, 4096, 1), (2, 8192, 12288, 3), (3, 8192, N, 3),
              (1, 16384, 57344, 3), (2, 16384, 4096, 128),
              (3, 16384, 12288, 1), (1, N, N, 128), (2, N, 12288, 128),
              (3, N, 57344, 3), (2, N, N, 1), (3, 8192, 4093, 3),
              (2, 8190, 12288, 1), (2, 8190, 12285, 64),
              (2, 131072, 12288, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("limbs,s,t,batch", WIDE_CASES)
def test_gather_wide_cases_match_plain(limbs, s, t, batch, cuda):
    """Values up to 2^(8 limbs) - 1, indices out of range and negative."""
    x, idx = (_t(a).to(cuda) for a in _wide_case(limbs, s, t, batch))
    assert torch.equal(KG.gather_block(x, idx, limbs),
                       KG.gather_block_plain(x, idx, limbs))


@pytest.mark.gpu
@pytest.mark.parametrize("limbs,s,batch", [(2, N, 128), (3, N, 3),
                                           (1, 256, 1), (2, N, 1)])
def test_gather_aliased_matches_plain(limbs, s, batch, cuda):
    """x and idx one tensor, a map of back pointers (the dense round)."""
    rng = np.random.default_rng(s + batch)
    ptr = np.minimum(np.arange(s), rng.integers(0, s, (batch, s)))
    src = _t(ptr.astype(np.int32)).to(cuda)
    assert torch.equal(KG.gather_block(src, src, limbs),
                       KG.gather_block_plain(src, src, limbs))
