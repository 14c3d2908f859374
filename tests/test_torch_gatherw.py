"""The kernels of the decoder's last resolve modes and fields="kernel"
against the Pallas kernels they replace: gather_window_block
(resolve="windowed"), gather_window_anchored ("hybrid" with
WINDOWED_OPENING), elem_fields_block (fields="kernel") and
resolve_tiled_dual.

On the CPU each wrapper runs its plain PyTorch version; it is held, with
exact equality (integer data), against the Pallas kernel in interpret
mode, on tests/test_pallas.py's inputs for the two windowed gathers, on
random, all-zero and all-255 rows at widths 8192 and 57344 for the fields
(the all-255 row is all 4-byte copies, whose look-ahead wraps at the
row's end), and with asymmetric `resolved2` flags for the dual resolve.
The `gpu` tests hold the CUDA kernels against the plain versions on the
card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops.pallas import fields as PF
from tpu_snappy.ops.pallas import gatherw as PW
from tpu_snappy.ops.pallas import gatherwin as PA
from tpu_snappy.ops.pallas import tiledres as PT

from tpu_snappy_torch.ops.kernels import fields as KF
from tpu_snappy_torch.ops.kernels import gatherw as KW
from tpu_snappy_torch.ops.kernels import gatherwin as KA
from tpu_snappy_torch.ops.kernels import tiledres as KT

from torch_threads import share_cores

share_cores()

N = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _window_case():
    """(x, idx), each (2, N) int32: tests/test_pallas.py:426's row (16-bit
    values, backward hops up to 50000) and a row of short hops."""
    rng = np.random.default_rng(7)
    pos = np.arange(N)
    x = rng.integers(0, 1 << 16, (2, N), dtype=np.int32)
    far = np.maximum(pos - rng.integers(0, 50000, N), 0)
    near = np.maximum(pos - rng.integers(0, 3000, N), 0)
    return x, np.stack([far, near]).astype(np.int32)


@pytest.mark.parametrize("k", [8, 16])
def test_gather_window_block_plain_matches_pallas(k):
    x, idx = _window_case()
    got = KW.gather_window_block(_t(x), _t(idx), k).numpy()
    want = np.asarray(jax.vmap(
        lambda a, b: PW.gather_window_block(a, b, k=k))(
            jnp.asarray(x), jnp.asarray(idx)))
    assert (got == want).all()
    # Both sides of the window occur in each row.
    lo = ((np.arange(N) >> 11) - (k - 1)) << 11
    assert (idx < lo).any() and (idx >= lo).any()


def test_gather_window_block_checks_its_contract():
    x, idx = _window_case()
    with pytest.raises(ValueError, match="16 bits"):
        KW.gather_window_block(_t(x) + (1 << 16), _t(idx), 8)
    with pytest.raises(ValueError, match="limbs"):
        KW.gather_window_block(_t(x), _t(idx), 8, limbs=4)
    # From itself, as the decoder calls it: a map that is its own table.
    got = KW.gather_window_block(_t(idx), _t(idx), 16, limbs=2).numpy()
    want = np.asarray(jax.vmap(
        lambda a: PW.gather_window_block(a, a, k=16))(jnp.asarray(idx)))
    assert (got == want).all()


def _anchored_case():
    """tests/test_pallas.py:626's row (local hops, 5% far indices anywhere)
    and a row of hops up to 9000 back."""
    rng = np.random.default_rng(11)
    pos = np.arange(N, dtype=np.int32)
    x = rng.integers(0, N, (2, N), dtype=np.int32)
    idx = np.maximum(pos - rng.integers(1, 2400, N, dtype=np.int32), 0)
    far = rng.random(N) < 0.05
    idx[far] = rng.integers(0, N, far.sum(), dtype=np.int32)
    long_hops = np.maximum(pos - rng.integers(1, 9000, N, dtype=np.int32), 0)
    return x, np.stack([idx, long_hops]).astype(np.int32)


def test_gather_window_anchored_plain_matches_pallas():
    x, idx = _anchored_case()
    y, inwin = KA.gather_window_anchored(_t(x), _t(idx))
    wy, wwin = jax.vmap(PA.gather_window_anchored)(jnp.asarray(x),
                                                   jnp.asarray(idx))
    assert (y.numpy() == np.asarray(wy)).all()
    assert (inwin.numpy() == np.asarray(wwin)).all()
    assert set(np.unique(inwin.numpy())) == {0, 1}
    with pytest.raises(ValueError, match="16 bits"):
        KA.gather_window_anchored(_t(x) + N, _t(idx))


def _fields_rows(w: int) -> np.ndarray:
    rng = np.random.default_rng(w)
    return np.stack([rng.integers(0, 256, w, dtype=np.uint8),
                     np.zeros(w, np.uint8), np.full(w, 255, np.uint8)])


@pytest.mark.parametrize("w", [8192, 57344])
def test_elem_fields_plain_matches_pallas(w):
    c = _fields_rows(w)
    got = KF.elem_fields_block(_t(c))
    want = jax.vmap(PF.elem_fields_block)(jnp.asarray(c))
    for g, v in zip(got, want):
        assert g.dtype == torch.int32
        assert (g.numpy() == np.asarray(v)).all()
    # The all-255 row's offsets wrap at the row's own width: negative
    # 4-byte values everywhere.
    assert (got[4][2].numpy() == -1).all()
    with pytest.raises(ValueError, match="multiple of 2048"):
        KF.elem_fields_block(_t(c[:, :w - 1024]))


def _dual_case():
    """tests/test_pallas.py:267's dual inputs: a fragment at its fixed point
    (the identity) flagged resolved, and one of tile-straddling hops that
    is not."""
    rng = np.random.default_rng(3)
    ident = np.arange(N, dtype=np.int32)
    lit = rng.integers(0, 256, N).astype(np.int32)
    cross = np.maximum(ident - ident % KT.TILE - 1, 0)
    cross = np.where(rng.random(N) < 0.5, cross, np.maximum(ident - 5, 0))
    lit2 = np.stack([lit, np.roll(lit, 7)])
    src2 = np.stack([ident, cross]).astype(np.int32)
    return lit2, src2


def test_resolve_tiled_dual_plain_matches_pallas():
    lit2, src2 = _dual_case()
    flags = np.array([True, False])
    got = KT.resolve_tiled_dual(_t(lit2), _t(src2), _t(flags)).numpy()
    want = np.asarray(PT.resolve_tiled_dual(
        jnp.asarray(lit2), jnp.asarray(src2), resolved2=jnp.asarray(flags)))
    assert (got == want).all()
    assert (got[0] == lit2[0]).all()
    # Each half is resolve_tiled on its fragment.
    assert (got == KT.resolve_tiled(_t(lit2), _t(src2),
                                    _t(flags)).numpy()).all()
    for kw in ({"tile": 2000}, {"check": 0}):  # an illegal tile, check
        with pytest.raises(ValueError, match="resolve_tiled_dual"):
            KT.resolve_tiled_dual(_t(lit2), _t(src2), **kw)
    with pytest.raises(ValueError, match="two"):
        KT.resolve_tiled_dual(_t(lit2[:1]), _t(src2[:1]))


@pytest.mark.gpu
def test_window_gathers_match_plain(cuda):
    x, idx = (_t(a).to(cuda) for a in _window_case())
    for k in (8, 16):
        assert torch.equal(KW.gather_window_block(x, idx, k),
                           KW.gather_window_block_plain(x, idx, k))
        assert torch.equal(KW.gather_window_block(idx, idx, k),
                           KW.gather_window_block_plain(idx, idx, k))
    x, idx = (_t(a).to(cuda) for a in _anchored_case())
    for got, want in zip(KA.gather_window_anchored(x, idx),
                         KA.gather_window_anchored_plain(x, idx)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [8192, 57344, 69632])
def test_elem_fields_kernel_matches_plain(w, cuda):
    c = _t(_fields_rows(w)).to(cuda)
    for got, want in zip(KF.elem_fields_block(c),
                         KF.elem_fields_block_plain(c)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_resolve_tiled_dual_kernel_matches_plain(cuda):
    lit2, src2 = (_t(a).to(cuda) for a in _dual_case())
    for flags in (None, [True, False], [False, True]):
        res = None if flags is None else torch.tensor(flags, device=cuda)
        assert torch.equal(KT.resolve_tiled_dual(lit2, src2, res),
                           KT.resolve_tiled_dual_plain(lit2, src2, res))
