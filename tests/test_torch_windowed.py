"""The port decoder's last resolve modes ("auto", "hybrid", "windowed"),
fields="kernel" and the depth-hinted decodes against the JAX ones.

One seeded batch of six fragments (two waves of three) goes once through
JAX decode_fragments_jit / decode_corpus and through the port's
decode_fragments / decode_corpus; bytes and ok flags must be equal, with
and without the periodic-run collapse. Its fragments: seeded Zipf-word
text, which enters "hybrid"'s sparse chase; reference_codec's
b"x" * 30000 and b"x" * 65536 (a chain 65535 deep without the collapse:
its dense loop stops at 16 rounds with more than SPARSE_CAP lanes still
moving); random bytes; b"ab" * 8000; and a stream of alternating-offset
copies that needs seven dense rounds. On the CPU JAX's "auto" is its
"hybrid" (decode.py:315, before anything is traced), so one JAX run holds
both port modes, and the port's "auto" is "tiledtail"; JAX runs the
Pallas kernels of "windowed" and fields="kernel" in interpret mode, and
its "windowed" runs take fields="kernel" too (the JAX suite holds its
kernel fields equal to its XLA fields), so each JAX run is compiled once.
The depth-hinted decodes get the hints of the pipeline with the collapse,
so without it some are under-declared and both give the same wrong bytes.
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
from tpu_snappy_torch.ops.kernels import tiledres as KT

from torch_threads import share_cores

share_cores()

WAVE = 3
MODES = ("auto", "hybrid", "windowed")


def zipf_text(seed: int, size: int) -> bytes:
    """Words drawn from a seeded 2000-word vocabulary by a Zipf law."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    vocab = [bytes(letters[rng.integers(0, 26, rng.integers(2, 11))])
             for _ in range(2000)]
    words = [vocab[i % len(vocab)] for i in rng.zipf(1.3, size // 3)]
    return b" ".join(words)[:size]


def _streams():
    rng = np.random.default_rng(5)
    port = {"zipf": zipf_text(7, 1 << 16),
            "random": bytes(rng.integers(0, 256, 5000, "u1")),
            "ab": b"ab" * 8000}
    out = {k: api.compress(v, device="cpu", small_fastpath=False)
           for k, v in port.items()}
    out["x30000"] = reference_codec.compress(b"x" * 30000)
    out["x65536"] = reference_codec.compress(b"x" * 65536)
    head = bytes(rng.integers(0, 256, 128, "u1"))
    out["deep-chains"] = fmt.varint_encode(fmt.BLOCK_SIZE) + b"".join(
        [fmt.literal_header(128), head,
         *[fmt.copy_element(64 << (i & 1), 64) for i in range(1022)]])
    return out


#: The batch's fragments, in order (one each).
NAMES = ("zipf", "random", "ab", "x30000", "x65536", "deep-chains")


@pytest.fixture(scope="module")
def batch():
    """The fragments at one width as numpy and CPU tensors, each stream's
    bytes, and the depth hints of the pipeline with the collapse."""
    frags, clens, ulens, datas = [], [], [], []
    streams = _streams()
    assert tuple(streams) == NAMES
    for comp in streams.values():
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
    t = tuple(torch.from_numpy(np.ascontiguousarray(a))
              for a in (frags, clens, ulens))
    src = TD.dense_rounds(TD.parse_transport(*t)[1])[0]
    depths = KT.tile_depths_plain(src)
    return dict(np=(frags, clens, ulens), t=t, data=datas, depths=depths)


@pytest.fixture(scope="module")
def oracle(batch):
    """JAX's (out, ok) by (resolve, collapse_runs): "auto" (its "hybrid")
    and "windowed" with fields="kernel" through decode_fragments_jit with
    the collapse, "hybrid" and "windowed" with fields="kernel" through
    decode_corpus without it."""
    args = tuple(jnp.asarray(a) for a in batch["np"])
    res = {("auto", True): D.decode_fragments_jit(*args, resolve="auto"),
           ("windowed", True): D.decode_fragments_jit(
               *args, resolve="windowed", fields="kernel")}
    for mode in ("hybrid", "windowed"):
        res[mode, False] = D.decode_corpus(
            *args, resolve=mode, fields="kernel" if mode == "windowed"
            else "auto", collapse_runs=False, wave=WAVE)
    return {k: (np.asarray(o), np.asarray(ok)) for k, (o, ok) in res.items()}


def _want(oracle, mode, collapse):
    """The JAX result a port mode is held against: every JAX mode gives
    the same bytes, and ok includes only the parse and the chase."""
    if mode == "windowed":
        return oracle["windowed", collapse]
    return oracle["auto" if collapse else "hybrid", collapse]


def _joined(out, ulens) -> bytes:
    return b"".join(out[i, :n].tobytes() for i, n in enumerate(ulens))


def test_jax_modes_agree(batch, oracle):
    """The oracle itself: every JAX run gives the streams' bytes, all
    fragments ok."""
    for key, (out, ok) in oracle.items():
        assert ok.all(), key
        assert _joined(out, batch["np"][2]) == b"".join(batch["data"]), key


def test_port_constants_are_jax_constants():
    for name in ("SPARSE_CAP", "WINDOWED_OPENING", "TAIL_CAP", "PARA_CAP",
                 "TAIL_TILE", "HINT_TILE", "PARA_TILE", "FRAG_CAP", "OUT",
                 "PARSE_TREE_LEVELS"):
        assert getattr(TD, name) == getattr(D, name), name


@pytest.mark.parametrize("collapse", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_decode_fragments_matches_jax(batch, oracle, mode, collapse):
    out, ok, rounds = TD.decode_fragments(*batch["t"], resolve=mode,
                                          collapse_runs=collapse)
    want_out, want_ok = _want(oracle, mode, collapse)
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()
    if mode == "windowed":  # four windowed rounds, then dense ones
        assert len(TD.WINDOW_KS) < rounds <= len(TD.WINDOW_KS) + 16
    elif mode == "hybrid":  # the zipf fragment's dense loop: 10 rounds
        assert rounds == (10 if collapse else 16)


@pytest.mark.parametrize("collapse", [True, False])
def test_fields_kernel_matches_jax(batch, oracle, collapse, monkeypatch):
    """fields="kernel" at a width that is a multiple of 2048 takes
    elem_fields_block; at one that is not, the plain arithmetic, as JAX
    (decode.py:194) does, and raises nothing."""
    want_out, want_ok = oracle["windowed", collapse]
    frags, clens, ulens = batch["t"]
    out, ok, _ = TD.decode_fragments(frags, clens, ulens, resolve="tiledtail",
                                     fields="kernel", collapse_runs=collapse)
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()

    def no_kernel(c):
        raise AssertionError(f"elem_fields_block at width {c.shape[-1]}")

    monkeypatch.setattr(TD._fields, "elem_fields_block", no_kernel)
    odd = torch.nn.functional.pad(frags, (0, 1024))
    assert odd.shape[-1] % 2048 == 1024
    out, ok, _ = TD.decode_fragments(odd, clens, ulens, resolve="tiledtail",
                                     fields="kernel", collapse_runs=collapse)
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()


@pytest.mark.parametrize("mode, collapse", [
    ("auto", True), ("hybrid", False), ("windowed", True)])
def test_decode_corpus_matches_jax(batch, oracle, mode, collapse):
    want_out, want_ok = _want(oracle, mode, collapse)
    out, ok = TD.decode_corpus(*batch["t"], resolve=mode,
                               collapse_runs=collapse, wave=WAVE)
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()


def test_hybrid_enters_the_sparse_chase(batch):
    """The zipf fragment leaves the dense loop after 10 rounds with lanes
    still moving, under SPARSE_CAP, and its chase converges; the others
    leave with none moving. Without the collapse, b"x" * 65536 leaves at
    16 rounds with more than SPARSE_CAP moving: only the first SPARSE_CAP
    are chased, and the map is right all the same."""
    zipf, x65536 = NAMES.index("zipf"), NAMES.index("x65536")
    frags, clens, ulens = batch["t"]
    for collapse in (True, False):
        _lit, src, _ok = TD.parse_transport(frags, clens, ulens,
                                            collapse_runs=collapse)
        s, mask, cnt, rounds = TD.hybrid_rounds(src)
        assert int(mask[zipf].sum()) == int(cnt[zipf])
        s2, chase_ok, steps = TD.sparse_chase(s, mask, cnt)
        assert chase_ok.all()
        assert ((steps > 0) == (cnt > 0)).all()
        assert 0 < int(cnt[zipf]) <= TD.SPARSE_CAP and int(steps[zipf]) > 0
        fixed = src.clone()
        for _ in range(17):
            fixed = torch.gather(fixed, -1, fixed.long())
        assert torch.equal(s2, fixed)
        if collapse:
            assert rounds == 10 and int((cnt > 0).sum()) == 1
        else:
            assert rounds == 16 and int(cnt[x65536]) > TD.SPARSE_CAP


@pytest.mark.parametrize("collapse", [True, False])
def test_hybrid_windowed_opening_gives_jax_bytes(batch, oracle, collapse,
                                                 monkeypatch):
    """With WINDOWED_OPENING set, two gather_window_anchored rounds open
    "hybrid" (JAX runs them only on a TPU); the bytes are JAX "hybrid"'s,
    and every chase converges on this batch, so ok is too."""
    calls = []
    anchored = TD._gatherwin.gather_window_anchored

    def counted(x, idx):
        calls.append(x.shape)
        return anchored(x, idx)

    monkeypatch.setattr(TD, "WINDOWED_OPENING", True)
    monkeypatch.setattr(TD._gatherwin, "gather_window_anchored", counted)
    out, ok, rounds = TD.decode_fragments(*batch["t"], resolve="hybrid",
                                          collapse_runs=collapse)
    want_out, want_ok = _want(oracle, "hybrid", collapse)
    assert len(calls) == 2 and rounds <= 14
    assert (out.numpy() == want_out).all()
    assert (ok.numpy() == want_ok).all()


@pytest.mark.parametrize("fields, collapse", [("auto", True),
                                              ("kernel", False)])
def test_depth_decodes_match_jax(batch, fields, collapse):
    """decode_fragments_depth and decode_corpus_depth against JAX's, with
    the hints of the pipeline with the collapse: without it they are
    under-declared for the deep chains, and both give the same wrong
    bytes."""
    args = tuple(jnp.asarray(a) for a in batch["np"])
    depths = batch["depths"]
    jd = jnp.asarray(depths.numpy())
    want_out, want_ok = (np.asarray(a) for a in D.decode_corpus_depth(
        *args, jd, fields=fields, collapse_runs=collapse, wave=WAVE))
    out, ok, _ = TD.decode_fragments_depth(*batch["t"], depths, fields,
                                           collapse)
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()
    out, ok = TD.decode_corpus_depth(*batch["t"], depths, fields, collapse,
                                     wave=WAVE)
    assert (ok.numpy() == want_ok).all()
    assert (out.numpy() == want_out).all()
    right = _joined(want_out, batch["np"][2]) == b"".join(batch["data"])
    assert right == collapse
    with pytest.raises(ValueError, match="multiple"):
        TD.decode_corpus_depth(*batch["t"], depths, wave=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert got[2] == want[2]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_new_modes_on_the_card_match_cpu(batch, mode, cuda):
    args = tuple(t.to(cuda) for t in batch["t"])
    for collapse in (True, False):
        for fields in ("auto", "kernel"):
            _same(TD.decode_fragments(*args, resolve=mode, fields=fields,
                                      collapse_runs=collapse),
                  TD.decode_fragments(*batch["t"], resolve=mode,
                                      fields=fields, collapse_runs=collapse))


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [2, 4])
def test_parse_tree_on_the_card_matches_cpu(batch, levels, cuda,
                                            monkeypatch):
    args = tuple(t.to(cuda) for t in batch["t"])
    want = TD.decode_fragments(*batch["t"])
    monkeypatch.setattr(TD, "PARSE_TREE_LEVELS", levels)
    _same(TD.decode_fragments(*args), want)


@pytest.mark.gpu
def test_opening_and_depth_on_the_card_match_cpu(batch, cuda, monkeypatch):
    args = tuple(t.to(cuda) for t in batch["t"])
    depths = batch["depths"]
    for collapse in (True, False):
        _same(TD.decode_fragments_depth(*args, depths.to(cuda), "kernel",
                                        collapse),
              TD.decode_fragments_depth(*batch["t"], depths, "kernel",
                                        collapse))
    monkeypatch.setattr(TD, "WINDOWED_OPENING", True)
    launches = TD._gatherwin.gather_window_anchored.launches
    for collapse in (True, False):
        _same(TD.decode_fragments(*args, resolve="hybrid",
                                  collapse_runs=collapse),
              TD.decode_fragments(*batch["t"], resolve="hybrid",
                                  collapse_runs=collapse))
    assert TD._gatherwin.gather_window_anchored.launches == launches + 4
