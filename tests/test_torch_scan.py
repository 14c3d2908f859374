"""The port's scans (tpu_snappy_torch/ops/scan.py) against tpu_snappy.ops.scan.

Committed flags of the encode (bounded) and decode (general) parse scans
must equal the JAX scans' on the jump patterns of tests/test_scan.py, in
every form (log-depth, sequential, grouped, the halving trees), and so
must the entry states of each form; the helpers the pipelines share must
agree exactly (all integer). The JAX scans run under jax.jit (one program
a form, the same values as op by op).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_snappy.ops import decode as JD
from tpu_snappy.ops import scan as JS
from tpu_snappy_torch.ops import decode as TD
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


def _jax(fn, *arrays, **static) -> np.ndarray:
    """fn(*arrays, **static) of the JAX package, jitted, as numpy."""
    jitted = jax.jit(functools.partial(fn, **static))
    return np.asarray(jitted(*map(jnp.asarray, arrays)))


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
    want = _jax(JS.commit_general, jumps)
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
    want = _jax(JS.commit_bounded, jumps)
    assert (got == want).all()
    for row, jump in enumerate(jumps):
        assert (got[row] == _golden_committed(jump)).all(), row


def test_entry_states_match_jax():
    rng = np.random.default_rng(7)
    n = JS.S * JS.G * 23
    jumps = np.stack(list(_cases(rng, n)))
    maps_t = TS.segment_exit_maps(torch.from_numpy(jumps))
    maps_j = _jax(JS.segment_exit_maps, jumps)
    assert (maps_t.numpy() == maps_j).all()
    assert (TS.entry_states_sequential(maps_t).numpy()
            == _jax(JS.entry_states_sequential, maps_j)).all()
    bounded = rng.integers(1, 65, (3, n)).astype(np.int32)
    mb_t = TS.segment_exit_maps(torch.from_numpy(bounded))
    mb_j = _jax(JS.segment_exit_maps, bounded, bounded=True)
    assert (TS.entry_states_bounded(mb_t).numpy()
            == _jax(JS.entry_states_bounded, mb_j)).all()


#: The decode forms of commit_general other than its default.
GENERAL_FORMS = {"grouped": {"grouped": True},
                 **{f"tree{k}": {"tree_levels": k} for k in (1, 2, 3, 4)}}
#: The encode forms of commit_bounded other than its default.
BOUNDED_FORMS = {"sequential": {"sequential": True},
                 **{f"tree{k}": {"tree_levels": k} for k in (1, 2, 3, 4)}}


@pytest.mark.parametrize("form", GENERAL_FORMS)
@pytest.mark.parametrize("n", [JS.S * JS.G * 17, 68 * 1024])
def test_commit_general_forms_match_jax(n, form):
    """At n = S*G*17 (68 segments) three and four tree levels do not
    divide: both packages fall back to the walk over segments."""
    rng = np.random.default_rng(n)
    jumps = np.stack(list(_cases(rng, n)))
    got = TS.commit_general(torch.from_numpy(jumps),
                            **GENERAL_FORMS[form]).numpy()
    assert (got == _jax(JS.commit_general, jumps,
                        **GENERAL_FORMS[form])).all()
    for row, jump in enumerate(jumps):
        assert (got[row] == _golden_committed(jump)).all(), row


@pytest.mark.parametrize("form", BOUNDED_FORMS)
def test_commit_bounded_forms_match_jax(form):
    rng = np.random.default_rng(5)
    n = 1 << 16
    jumps = np.stack([np.ones(n, np.int32), np.full(n, 64, np.int32),
                      rng.integers(1, 65, n).astype(np.int32),
                      rng.integers(1, 5, n).astype(np.int32)])
    got = TS.commit_bounded(torch.from_numpy(jumps),
                            **BOUNDED_FORMS[form]).numpy()
    assert (got == _jax(JS.commit_bounded, jumps,
                        **BOUNDED_FORMS[form])).all()
    for row, jump in enumerate(jumps):
        assert (got[row] == _golden_committed(jump)).all(), row


@pytest.mark.parametrize("form", ["grouped", "general1", "general2",
                                  "general4", "tree3"])
def test_entry_state_forms_match_jax(form):
    """Entry states of the grouped walk and of both halving trees (the
    bounded tree on bounded jumps) equal the JAX forms' and the walk's."""
    rng = np.random.default_rng(11)
    n = JS.S * JS.G * 17 * 4  # 272 segments: G and 2**4 divide
    if form.startswith("tree"):
        jumps = rng.integers(1, 65, (3, n)).astype(np.int32)
        fns, kw = (TS.entry_states_tree, JS.entry_states_tree), {
            "levels": int(form[-1])}
    else:
        jumps = np.stack(list(_cases(rng, n)))
        if form == "grouped":
            fns, kw = (TS.entry_states_grouped, JS.entry_states_grouped), {}
        else:
            fns, kw = (TS.entry_states_tree_general,
                       JS.entry_states_tree_general), {
                           "levels": int(form[-1])}
    maps = TS.segment_exit_maps(torch.from_numpy(jumps))
    got = fns[0](maps, **kw).numpy()
    assert (got == _jax(fns[1], maps.numpy(), **kw)).all()
    assert (got == TS.entry_states_sequential(maps).numpy()).all()


def test_scan_forms_raise_where_the_segments_do_not_divide():
    """JAX's bounded tree fails at trace time on a segment count the
    levels do not halve; the port raises ValueError (and the grouped walk
    does on a count G does not divide)."""
    jump = torch.ones((2, JS.S * 68), dtype=torch.int32)  # 68 segments
    with pytest.raises(ValueError, match="do not halve"):
        TS.commit_bounded(jump, tree_levels=3)
    maps = TS.segment_exit_maps(torch.ones((2, JS.S * 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        TS.entry_states_grouped(maps)
    with pytest.raises(ValueError, match="do not halve"):
        TS.entry_states_tree_general(maps, 2)


def test_constants_and_parse_tree_levels(monkeypatch):
    """G, D and PARSE_TREE_LEVELS are the JAX package's; the decoder reads
    PARSE_TREE_LEVELS at call time and, as JAX off the TPU, passes 0 for
    tensors on the CPU."""
    assert (TS.S, TS.G, TS.D) == (JS.S, JS.G, JS.D)
    assert TD.PARSE_TREE_LEVELS == JD.PARSE_TREE_LEVELS == 0
    seen = []
    commit_general = TS.commit_general

    def spy(jump, **kwargs):
        seen.append(kwargs)
        return commit_general(jump, **kwargs)

    monkeypatch.setattr(TS, "commit_general", spy)
    monkeypatch.setattr(TD, "PARSE_TREE_LEVELS", 2)
    c = torch.zeros((2, 8192), dtype=torch.uint8)
    zero = torch.zeros(2, dtype=torch.int32)
    TD.transport_cells(c, zero, zero)
    assert seen == [{"tree_levels": 0}]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_scan_forms_on_the_card_match_cpu(cuda):
    rng = np.random.default_rng(13)
    n = 68 * 1024
    general = torch.from_numpy(np.stack(list(_cases(rng, n))))
    want = TS.commit_general(general)
    for form in GENERAL_FORMS.values():
        assert torch.equal(TS.commit_general(general.to(cuda), **form).cpu(),
                           want), form
    bounded = torch.from_numpy(rng.integers(1, 65, (3, 1 << 16)).astype(
        np.int32))
    want = TS.commit_bounded(bounded)
    for form in [{}, *BOUNDED_FORMS.values()]:
        assert torch.equal(TS.commit_bounded(bounded.to(cuda), **form).cpu(),
                           want), form


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
