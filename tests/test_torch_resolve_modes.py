"""The port decoder's resolve modes and decode_corpus against the JAX ones.

One seeded batch (the port's streams of text, b"ab" * 8000 and random
bytes, reference_codec's b"x" * 30000, and a stream of alternating-offset
copies that needs seven dense rounds) goes once through JAX
decode_fragments_jit per resolve mode, and through the port's
decode_fragments and decode_corpus under each mode of ORACLE
(tests/test_torch_windowed.py holds "auto", "hybrid" and "windowed").
Bytes and ok flags must be equal, with and without the periodic-run
collapse. On the CPU, JAX's "stable" is its "plain" loop (decode.py:468
takes the doubling_round kernel only on a TPU) and "xla" is the same
branch, so both are held against JAX's "plain"; collapse_runs=False is
held against JAX decode_corpus at "plain" (every JAX mode gives the same
bytes, and its "kernel" mode takes 16 s interpreted on this batch without
the collapse).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy import format as fmt
from tpu_snappy import reference_codec
from tpu_snappy.ops import decode as D

from tpu_snappy_torch import api
from tpu_snappy_torch.ops import decode as TD

from torch_threads import share_cores

share_cores()

WAVE = 3  # the batch holds 6 fragments: two waves
#: JAX mode each port mode is held against on the CPU (see above).
ORACLE = {"tiledtail": "plain", "tiled": "plain", "flagtail": "flagtail",
          "paratail": "paratail", "kernel": "kernel", "stable": "plain",
          "plain": "plain", "xla": "plain"}


def _streams():
    rng = np.random.default_rng(5)
    text = b"The quick brown fox jumps over the lazy dog. " * 1600
    out = {}
    for name, data in (("port-text", text), ("port-rle", b"ab" * 8000),
                       ("port-random", bytes(rng.integers(0, 256, 5000,
                                                          "u1")))):
        out[name] = api.compress(data, device="cpu", small_fastpath=False)
    out["ref-x"] = reference_codec.compress(b"x" * 30000)
    head = bytes(rng.integers(0, 256, 128, "u1"))
    out["deep-chains"] = fmt.varint_encode(fmt.BLOCK_SIZE) + b"".join(
        [fmt.literal_header(128), head,
         *[fmt.copy_element(64 << (i & 1), 64) for i in range(1022)]])
    return out


@pytest.fixture(scope="module")
def batch():
    """The fragments at one width, as numpy and as CPU tensors, with each
    stream's bytes."""
    frags, clens, ulens, datas = [], [], [], []
    for comp in _streams().values():
        total, start = fmt.varint_decode(comp)
        f, c, u = TD.fragment_table(comp, start, total)
        frags.append(f)
        clens += c.tolist()
        ulens += u.tolist()
        datas.append(reference_codec.decompress(comp))
    clens = np.asarray(clens, np.int32)
    ulens = np.asarray(ulens, np.int32)
    frags = np.concatenate(frags)[:, :TD.frag_width(clens)]
    assert len(clens) == 2 * WAVE
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a))
                    for a in (frags, clens, ulens))
    return dict(np=(frags, clens, ulens), t=tensors, data=b"".join(datas))


@pytest.fixture(scope="module")
def oracle(batch):
    """JAX's (out, ok) per mode, and at "plain" without the collapse."""
    args = tuple(jnp.asarray(a) for a in batch["np"])
    res = {}
    for mode in sorted(set(ORACLE.values())):
        out, ok = D.decode_fragments_jit(*args, resolve=mode)
        res[mode, True] = (np.asarray(out), np.asarray(ok))
    out, ok = D.decode_corpus(*args, resolve="plain", collapse_runs=False,
                              wave=WAVE)
    res["plain", False] = (np.asarray(out), np.asarray(ok))
    return res


def _joined(out, ulens) -> bytes:
    return b"".join(out[i, :n].tobytes() for i, n in enumerate(ulens))


def test_jax_modes_agree(batch, oracle):
    """The oracle itself: every JAX mode gives the streams' bytes, all
    fragments ok."""
    ulens = batch["np"][2]
    for (mode, collapse), (out, ok) in oracle.items():
        assert ok.all(), (mode, collapse)
        assert _joined(out, ulens) == batch["data"], (mode, collapse)


@pytest.mark.parametrize("collapse", [True, False])
@pytest.mark.parametrize("mode", ORACLE)
def test_decode_fragments_matches_jax(batch, oracle, mode, collapse):
    # "xla" also takes fields="xla" (the same arithmetic as "auto").
    fields = "xla" if mode == "xla" else "auto"
    out, ok, rounds = TD.decode_fragments(*batch["t"], resolve=mode,
                                          fields=fields,
                                          collapse_runs=collapse)
    want_out, want_ok = oracle[ORACLE[mode] if collapse else "plain",
                               collapse]
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()
    if mode in ("tiled", "kernel"):
        assert rounds == 0
    elif mode == "paratail":  # one dense round, then 1-14 local rounds
        assert 1 < rounds <= 1 + TD.MAX_LOCAL_ROUNDS
    elif mode in ("stable", "plain", "xla") and not collapse:
        # ref-x without the collapse is a 29999-deep chain: 15 rounds to
        # its fixed point, one more to see it.
        assert rounds == 16


# decode_corpus runs decode_fragments a wave at a time, which the test
# above holds in every mode: each mode with a kernel of its own once here,
# and both collapse settings.
@pytest.mark.parametrize("mode, collapse", [
    ("tiledtail", True), ("flagtail", True), ("paratail", True),
    ("kernel", False), ("stable", False), ("plain", True)])
def test_decode_corpus_matches_jax(batch, oracle, mode, collapse):
    want_out, want_ok = oracle[ORACLE[mode] if collapse else "plain",
                               collapse]
    out, ok = TD.decode_corpus(*batch["t"], resolve=mode,
                               collapse_runs=collapse, wave=WAVE)
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()


def test_paratail_runs_one_dense_round(batch):
    """PARA_CAP = 65536 reads as "no dense rounds", but the count starts at
    65537 (decode.py:448-449), so every fragment runs exactly one."""
    _lit, src, _ok = TD.parse_transport(*batch["t"])
    s, cnt, rounds = TD.dense_rounds(src, TD.PARA_CAP)
    assert rounds == 1 and (cnt <= TD.PARA_CAP).all() and (cnt > 0).any()


def test_modes_the_port_does_not_run_raise(batch):
    """Every JAX mode runs (tests/test_torch_windowed.py holds the newer
    ones); an unknown resolve or fields mode, or a batch that is not a
    whole number of waves, raises."""
    assert set(ORACLE) | {"auto", "hybrid", "windowed"} == set(TD.RESOLVES)
    assert TD.FIELDS == ("auto", "xla", "kernel")
    with pytest.raises(ValueError, match="resolve 'depthtail'"):
        TD.decode_fragments(*batch["t"], resolve="depthtail")
    with pytest.raises(ValueError, match="fields 'pallas'"):
        TD.decode_fragments(*batch["t"], fields="pallas")
    with pytest.raises(ValueError, match="multiple"):
        TD.decode_corpus(*batch["t"], wave=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ORACLE)
def test_modes_on_the_card_match_cpu(batch, mode, cuda):
    args = tuple(t.to(cuda) for t in batch["t"])
    for collapse in (True, False):
        want = TD.decode_fragments(*batch["t"], resolve=mode,
                                   collapse_runs=collapse)
        got = TD.decode_fragments(*args, resolve=mode,
                                  collapse_runs=collapse)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert got[2] == want[2]
