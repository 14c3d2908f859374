"""The two prefix-scan kernels (cumsum_block, next_start_block) against the
Pallas kernels they replace and numpy.

On the CPU each wrapper runs its plain PyTorch version; it is held, with
exact equality (integer data), against tpu_snappy.ops.pallas.scans in
interpret mode (row by row, as tests/test_pallas.py runs them) and against
a numpy oracle: widths 384 (a multiple of 128 but not of the kernels' 4096
tile), 65536 and 69632, 1-D and three rows, int32-wrapping sums, and
next_start_block at default m, 0, 100 and m // 2 on random, all-zero,
first-only, last-only and all-set flags, and on tests/torch_edges.py's
next_start_edge_rows (a single flag around each of the kernel's span and
read-ahead edges, only at m - 1, none) at widths 384, 57344, 65536 and
69632, batched and 1-D. At default < m - 1 on all-set
rows the TPU kernel, and so the port, differs from scan.next_element_start:
the tests hold that difference too. The `gpu` tests hold the CUDA kernels
against the plain versions on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy.ops import scan as JS
from tpu_snappy.ops.pallas import scans as PS

from tpu_snappy_torch.ops import scan as TS
from tpu_snappy_torch.ops.kernels import scans as KS

from torch_edges import next_start_edge_rows
from torch_threads import share_cores

share_cores()

WIDTHS = [384, 65536, 69632]
#: The widths phase 3 of chip_smoke.py runs the kernels at.
EDGE_WIDTHS = [384, 57344, 65536, 69632]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _values(rng, m: int) -> np.ndarray:
    """Three rows of int32: small counts, full-range values whose sums
    wrap, and a row of 2^30 entries (two of them sum to -2^31)."""
    return np.stack([rng.integers(0, 70, m),
                     rng.integers(-(1 << 31), 1 << 31, m),
                     np.full(m, 1 << 30)]).astype(np.int32)


def _flags(rng, m: int) -> np.ndarray:
    """Five rows of flags: random, all-zero, first-only, last-only,
    all-set."""
    f = np.zeros((5, m), bool)
    f[0] = rng.random(m) < 0.02
    f[2, 0] = True
    f[3, -1] = True
    f[4] = True
    return f


def _next_start_oracle(flags: np.ndarray, default: int) -> np.ndarray:
    """min(default, smallest j > i with flags[j]) per row, in numpy."""
    m = flags.shape[-1]
    at = np.where(flags, np.arange(m), np.iinfo(np.int32).max)
    suffix = np.minimum.accumulate(at[..., ::-1], axis=-1)[..., ::-1]
    after = np.concatenate([suffix[..., 1:],
                            np.full(flags.shape[:-1] + (1,),
                                    np.iinfo(np.int32).max)], axis=-1)
    return np.minimum(after, default).astype(np.int32)


@pytest.mark.parametrize("m", WIDTHS)
def test_cumsum_block_plain_matches_pallas(m):
    x = _values(np.random.default_rng(m), m)
    got = KS.cumsum_block(torch.from_numpy(x)).numpy()
    wrapped = np.cumsum(x.astype(np.int64), axis=-1).astype(np.int32)
    assert (got == wrapped).all()
    assert got[2, 1] == -(1 << 31)
    for row in range(3):
        want = np.asarray(PS.cumsum_block(jnp.asarray(x[row])))
        assert (got[row] == want).all(), row
        one = KS.cumsum_block(torch.from_numpy(x[row])).numpy()
        assert one.shape == (m,) and (one == want).all(), row


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("pick", ["m", "0", "100", "m//2"])
def test_next_start_block_plain_matches_pallas(m, pick):
    default = {"m": m, "0": 0, "100": 100, "m//2": m // 2}[pick]
    flags = _flags(np.random.default_rng(m + 1), m)
    got = KS.next_start_block(torch.from_numpy(flags), default).numpy()
    assert (got == _next_start_oracle(flags, default)).all()
    for row in range(len(flags)):
        want = np.asarray(PS.next_start_block(jnp.asarray(flags[row]),
                                              default))
        assert (got[row] == want).all(), row
    one = KS.next_start_block(torch.from_numpy(flags[0]), default).numpy()
    assert one.shape == (m,) and (one == got[0]).all()
    # The TPU kernel's function, not scan.next_element_start's: they
    # differ exactly where every later position is set and i + 1 > default.
    xla = TS.next_element_start(torch.from_numpy(flags), default).numpy()
    assert (xla == np.asarray(JS.next_element_start(jnp.asarray(flags),
                                                    default))).all()
    pos = np.arange(m)
    later_all_set = np.concatenate(
        [np.logical_and.accumulate(flags[:, ::-1], axis=-1)[:, ::-1][:, 1:],
         np.zeros((len(flags), 1), bool)], axis=-1)
    assert ((got != xla) == (later_all_set & (pos + 1 > default))).all()
    assert (got[4] != xla[4]).sum() == max(0, m - 1 - default)


@pytest.mark.parametrize("m", EDGE_WIDTHS)
def test_next_start_block_plain_matches_pallas_on_edge_rows(m):
    """Single flags around every span end and read-ahead end of the CUDA
    kernel, only at m - 1, none; batched and 1-D, at every default the
    tests use."""
    flags = next_start_edge_rows(m)
    for default in (m, 0, 100, m // 2):
        got = KS.next_start_block(torch.from_numpy(flags), default).numpy()
        assert (got == _next_start_oracle(flags, default)).all(), default
        for row in range(len(flags)):
            want = np.asarray(PS.next_start_block(jnp.asarray(flags[row]),
                                                  default))
            assert (got[row] == want).all(), (default, row)
            one = KS.next_start_block(torch.from_numpy(flags[row]), default)
            assert (one.numpy() == want).all(), (default, row)


def test_next_start_edges_follow_the_kernel():
    """SPAN and AHEAD, which place the edge rows, are the CUDA kernel's
    span and read-ahead."""
    src = (pathlib.Path(KS.__file__).parent / "csrc" / "scans.cu").read_text()
    threads = int(re.search(r"kSpanThreads = (\d+);", src).group(1))
    assert 16 * threads == KS.SPAN
    assert int(re.search(r"kAhead = (\d+);", src).group(1)) == KS.AHEAD


def test_next_start_block_takes_any_flag_dtype():
    flags = _flags(np.random.default_rng(3), 384)
    want = KS.next_start_block(torch.from_numpy(flags), 100)
    for dtype in (torch.uint8, torch.int32):
        got = KS.next_start_block(torch.from_numpy(flags).to(dtype) * 3, 100)
        assert torch.equal(got, want), dtype


@pytest.mark.parametrize("shape", [(100,), (3, 200), (2, 3, 128)])
def test_scans_reject_widths_the_tpu_kernels_cannot_take(shape):
    with pytest.raises(ValueError, match="multiple of 128"):
        KS.cumsum_block(torch.zeros(shape, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 128"):
        KS.next_start_block(torch.zeros(shape, dtype=torch.bool), 0)
    with pytest.raises(ValueError, match="int32"):
        KS.next_start_block(torch.zeros(128, dtype=torch.bool), 1 << 31)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [384, 57344, 65536, 69632])
def test_scan_kernels_match_plain_on_the_card(m, cuda):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(np.concatenate([_values(rng, m)] * 3)).to(cuda)
    before = KS.cumsum_block.launches
    assert torch.equal(KS.cumsum_block(x), KS.cumsum_block_plain(x))
    assert torch.equal(KS.cumsum_block(x[0]), KS.cumsum_block_plain(x[0]))
    assert KS.cumsum_block.launches == before + 2
    flags = torch.from_numpy(_flags(rng, m)).to(cuda)
    for default in (m, 0, 100, m // 2):
        before = KS.next_start_block.launches
        got = KS.next_start_block(flags, default)
        assert torch.equal(got, KS.next_start_block_plain(flags, default))
        assert torch.equal(KS.next_start_block(flags.to(torch.int32) * 3,
                                               default), got)
        assert KS.next_start_block.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_WIDTHS)
def test_next_start_block_matches_plain_on_edge_rows_on_the_card(m, cuda):
    flags = torch.from_numpy(next_start_edge_rows(m)).to(cuda)
    for default in (m, 0, 100, m // 2):
        assert torch.equal(KS.next_start_block(flags, default),
                           KS.next_start_block_plain(flags, default))
        for row in flags:
            assert torch.equal(KS.next_start_block(row, default),
                               KS.next_start_block_plain(row, default))
