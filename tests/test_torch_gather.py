"""The port's gather_block (tpu_snappy_torch/ops/kernels/gather.py) against
the Pallas kernel it replaces.

On the CPU the wrapper runs its plain PyTorch version; it is held, with
exact equality (integer data), against tpu_snappy/ops/pallas/gather.py
gather_block in interpret mode, as tests/test_pallas.py runs it, at limbs 1
and 2 and table widths 8192 and 65536, indices 0 and S-1 included. The
`gpu` test holds the CUDA kernel against the plain version on the card.
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


@pytest.mark.gpu
@pytest.mark.parametrize("s,limbs", CASES)
def test_gather_kernel_matches_plain(s, limbs, cuda):
    x, idx = _case(s, limbs, rows=8)
    xt, it = _t(x).to(cuda), _t(idx).to(cuda)
    assert torch.equal(KG.gather_block(xt, it, limbs),
                       KG.gather_block_plain(xt, it, limbs))
