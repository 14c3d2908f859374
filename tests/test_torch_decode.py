"""The port's decoder (tpu_snappy_torch/ops/decode.py) against the JAX one.

Fragments of the port's own streams, reference_codec streams, and the
copy4 / exotic / corrupt streams of tests/test_exotic_streams.py decode in
one batch through the port and through JAX decode_fragments_jit, at
resolve="tiled" and at the TPU default resolve="tiledtail" (dense rounds,
then the resolve kernel with each fragment's `resolved` flag), and through
the depth-hinted decode_fragments_depth against decode_fragments_depth_jit
with the C++ golden's hints. Bytes and ok flags must be equal. A stream of
alternating-offset copies needs seven dense rounds while the others stop
after one, so the per-fragment loop (a fragment whose moved count fell to
TAIL_CAP is frozen) is exercised. The JAX CPU path scatters without the
TPU window and so cannot count a window overflow; where the port counts
one, it must report ok=False and the API must still give the reference
bytes (or raise the same error).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_snappy import format as fmt
from tpu_snappy import reference_codec
from tpu_snappy.ops import decode as D
from tpu_snappy.utils import corpus

from tpu_snappy_torch import api
from tpu_snappy_torch.ops import decode as TD
from tpu_snappy_torch.ops.kernels import scatter as KS

from torch_threads import share_cores

share_cores()


def _build(total, elements):
    return fmt.varint_encode(total) + b"".join(elements)


def _periodic(period, runlen):
    head = bytes(range(max(4, period)))[:max(4, period)]
    nfull, rest = divmod(runlen, 64)
    els = [fmt.literal_header(len(head)), head]
    els += [fmt.copy_element(period, 64)] * nfull
    if rest >= 4:
        els.append(fmt.copy_element(period, rest))
    else:
        runlen -= rest
    return _build(len(head) + runlen, els)


@functools.cache
def _streams():
    """name -> Snappy stream (built once per process)."""
    rng = np.random.default_rng(5)
    text = b"The quick brown fox jumps over the lazy dog. " * 1600
    out = {}
    for name, data in (("port-text", text),
                       ("port-random", bytes(rng.integers(0, 256, 20000,
                                                          "u1"))),
                       ("port-rle", b"ab" * 8000)):
        out[name] = api.compress(data, device="cpu", small_fastpath=False)
    for name, data in (("ref-abcd", b"abcd" * 5000), ("ref-x", b"x" * 30000),
                       ("ref-random", bytes(rng.integers(0, 256, 3000,
                                                         "u1"))),
                       ("ref-ascii", corpus.synth("random", 20000))):
        out[name] = reference_codec.compress(data)
    a = rng.integers(0, 256, fmt.BLOCK_SIZE, dtype=np.uint8).tobytes()
    out["cross-fragment-copy"] = _build(
        fmt.BLOCK_SIZE + 64 + 10,
        [fmt.literal_header(fmt.BLOCK_SIZE), a, fmt.copy_element(1000, 64),
         fmt.literal_header(10), b"0123456789"])
    x = b"x" * 70000
    out["copy4"] = _build(70000 + 64, [
        fmt.literal_header(65536), x[:65536],
        fmt.literal_header(70000 - 65536), x[65536:],
        bytes([(63 << 2) | 3, 0x10, 0x27, 0, 0])])
    out["corrupt-offset"] = _build(100, [fmt.literal_header(4), b"abcd",
                                         fmt.copy_element(5000, 64)])
    out["tiny-copy"] = _build(7, [fmt.literal_header(4), b"abcd",
                                  bytes([(2 << 2) | 2, 3, 0])])
    for period, runlen in ((1, 5000), (3, 4997), (64, 6400), (61, 6100)):
        out[f"periodic-{period}"] = _periodic(period, runlen)
    out["same-offset-split"] = _build(8 + 16 + 4 + 16, [
        fmt.literal_header(8), b"abcdefgh", fmt.copy_element(4, 16),
        fmt.literal_header(4), b"WXYZ", fmt.copy_element(4, 16)])
    out["offset-change"] = _build(16 + 9 + 21 + 8 + 64, [
        fmt.literal_header(16), b"0123456789abcdef",
        fmt.copy_element(3, 9), fmt.copy_element(7, 21),
        fmt.copy_element(2, 8), fmt.copy_element(2, 64)])
    out["chain-into-run"] = _build(5 + 60 + 4 + 24, [
        fmt.literal_header(5), b"hello", fmt.copy_element(5, 60),
        fmt.literal_header(4), b"####", fmt.copy_element(40, 24)])
    head = bytes(rng.integers(0, 256, 128, "u1"))
    out["deep-chains"] = _build(fmt.BLOCK_SIZE, [
        fmt.literal_header(128), head,
        *[fmt.copy_element(64 << (i & 1), 64) for i in range(1022)]])
    return out


@pytest.fixture(scope="module")
def batch():
    """All fragments of all streams, at one width, decoded by both."""
    frags, clens, ulens, names = [], [], [], []
    for name, comp in _streams().items():
        total, start = fmt.varint_decode(comp)
        try:
            f, c, u = TD.fragment_table(comp, start, total)
        except ValueError:  # malformed before any fragment decodes
            with pytest.raises(ValueError):
                D.fragment_table(comp, start, total)
            continue
        jf, jc, ju = D.fragment_table(comp, start, total)
        assert (f == np.asarray(jf)).all() and (c == jc).all() \
            and (u == ju).all(), name
        frags.append(f)
        clens += c.tolist()
        ulens += u.tolist()
        names += [f"{name}#{i}" for i in range(len(u))]
    # Two fragments of random garbage: parse and ok must agree there too.
    rng = np.random.default_rng(99)
    garbage = np.zeros((2, TD.FRAG_CAP), np.uint8)
    garbage[:, :3000] = rng.integers(0, 256, (2, 3000))
    frags.append(garbage)
    clens += [3000, 3000]
    ulens += [5000, 65536]
    names += ["garbage#0", "garbage#1"]

    clens = np.asarray(clens, np.int32)
    ulens = np.asarray(ulens, np.int32)
    width = TD.frag_width(clens)
    assert width == D.frag_width(clens)
    frags = np.concatenate(frags)[:, :width]
    j_out, j_ok = D.decode_fragments_jit(
        jnp.asarray(frags), jnp.asarray(clens), jnp.asarray(ulens),
        resolve="tiled")
    ft, ct, ut = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (frags, clens, ulens))
    t_out, t_ok, _ = TD.decode_fragments(ft, ct, ut, resolve="tiled")
    mdst, mval, _ = TD.transport_cells(ft, ct, ut)
    _, ovf = KS.scatter_windowed(mdst, mval)
    return dict(names=names, ulens=ulens, j_out=np.asarray(j_out),
                j_ok=np.asarray(j_ok), t_out=t_out.numpy(),
                t_ok=t_ok.numpy(), ovf=ovf.numpy(), inputs=(ft, ct, ut),
                np_inputs=(frags, clens, ulens))


def test_ok_flags_match_jax(batch):
    for i, name in enumerate(batch["names"]):
        if batch["ovf"][i]:
            assert not batch["t_ok"][i], name
        else:
            assert batch["t_ok"][i] == batch["j_ok"][i], name
    # Fragment-local streams all decode on the device; copies reaching
    # into an earlier fragment (cross-fragment-copy, the copy4 case) and
    # garbage do not.
    local = [n not in ("cross-fragment-copy#1", "copy4#1")
             and not n.startswith("garbage") for n in batch["names"]]
    assert batch["t_ok"][local].all()
    assert not batch["t_ok"][[not v for v in local]].any()


def test_bytes_match_jax(batch):
    both = batch["t_ok"] & batch["j_ok"]
    assert (batch["t_out"][both] == batch["j_out"][both]).all()
    # Zero past each fragment's length, as in JAX.
    for i, n in enumerate(batch["ulens"]):
        assert not batch["t_out"][i, n:].any(), batch["names"][i]


def _hints(frags, clens, ulens):
    """The C++ golden's depth hints per fragment (zeros where its element
    stream is not self-contained), or None where the golden does not
    build."""
    golden = TD.native_golden()
    if golden is None:
        return None
    deps = np.zeros((len(clens), TD.OUT // TD.HINT_TILE), np.int32)
    for i, (c, u) in enumerate(zip(clens, ulens)):
        try:
            deps[i] = golden.depth_hints(frags[i, :c].tobytes(), int(u),
                                         TD.TAIL_CAP, TD.HINT_TILE)
        except RuntimeError:
            pass
    return deps


@pytest.fixture(scope="module")
def tail(batch):
    """The same batch at resolve="tiledtail" and depth-hinted, both
    packages."""
    frags, clens, ulens = batch["np_inputs"]
    ft, ct, ut = batch["inputs"]
    j_out, _ = D.decode_fragments_jit(
        jnp.asarray(frags), jnp.asarray(clens), jnp.asarray(ulens),
        resolve="tiledtail")
    t_out, t_ok, rounds = TD.decode_fragments(ft, ct, ut)
    res = dict(j_out=np.asarray(j_out), t_out=t_out.numpy(),
               t_ok=t_ok.numpy(), rounds=rounds,
               src=TD.dense_rounds(TD.parse_transport(ft, ct, ut)[1]))
    deps = _hints(frags, clens, ulens)
    if deps is not None:
        jd_out, jd_ok = D.decode_fragments_depth_jit(
            jnp.asarray(frags), jnp.asarray(clens), jnp.asarray(ulens),
            jnp.asarray(deps))
        td_out, td_ok, _ = TD.decode_fragments_depth(
            ft, ct, ut, torch.from_numpy(deps))
        res.update(jd_out=np.asarray(jd_out), jd_ok=np.asarray(jd_ok),
                   td_out=td_out.numpy(), td_ok=td_ok.numpy())
    return res


def test_tiledtail_matches_jax(batch, tail):
    assert (tail["t_ok"] == batch["t_ok"]).all()
    ok = tail["t_ok"] & batch["j_ok"]
    assert (tail["t_out"][ok] == tail["j_out"][ok]).all()
    assert (tail["t_out"][ok] == batch["t_out"][ok]).all()
    for i, n in enumerate(batch["ulens"]):
        assert not tail["t_out"][i, n:].any(), batch["names"][i]


def test_dense_rounds_run_per_fragment(batch, tail):
    """decode.py:349-359 per fragment: the deep-chain fragment runs seven
    rounds, the others freeze once at most TAIL_CAP lanes moved, and a
    fragment's `resolved` flag is its own count reaching 0."""
    src, cnt, rounds = tail["src"]
    assert rounds == tail["rounds"] == 7
    names = batch["names"]
    deep = names.index("deep-chains#0")
    assert int(cnt[deep]) <= TD.TAIL_CAP
    assert (cnt <= TD.TAIL_CAP).all()
    # Replay in numpy, one fragment at a time, as the vmapped while_loop.
    _, src0, _ = TD.parse_transport(*batch["inputs"])
    for i in (deep, names.index("port-text#0"), names.index("ref-x#0")):
        s, c, it = src0[i].numpy(), TD.OUT + 1, 0
        while c > TD.TAIL_CAP and it < 16:
            s2 = s[s]
            c, s, it = int((s2 != s).sum()), s2, it + 1
        assert (src[i].numpy() == s).all() and int(cnt[i]) == c, names[i]


def test_depth_hinted_decode_matches_jax(batch, tail):
    if "jd_out" not in tail:
        pytest.skip("cmake / Ninja missing: the golden cannot build here")
    assert (tail["td_ok"] == tail["jd_ok"]).all()
    assert (tail["td_ok"] == tail["t_ok"]).all()
    ok = tail["td_ok"]
    assert (tail["td_out"][ok] == tail["jd_out"][ok]).all()
    # The golden's hints are exact for this pipeline: the hinted bytes are
    # the normal decode's, the deep-chain fragment included.
    assert (tail["td_out"][ok] == tail["t_out"][ok]).all()


@pytest.mark.parametrize("name", sorted(_streams()))
def test_api_decompress_matches_reference(name):
    comp = _streams()[name]
    try:
        want = reference_codec.decompress(comp)
    except ValueError:
        with pytest.raises(ValueError):
            api.decompress(comp, device="cpu", small_fastpath=False)
        return
    got, stats = api.decompress_with_stats(comp, device="cpu",
                                           small_fastpath=False)
    assert got == want
    if name == "cross-fragment-copy":
        assert stats.spliced == 1  # re-decoded on the host with context


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_decode_on_the_card_matches_cpu(batch, cuda):
    """The same fragments on the card: bytes and ok equal the CPU port's
    (which the tests above hold against JAX), overflow counts included."""
    ft, ct, ut = (t.to(cuda) for t in batch["inputs"])
    out, ok, _ = TD.decode_fragments(ft, ct, ut, resolve="tiled")
    assert (ok.cpu().numpy() == batch["t_ok"]).all()
    assert (out.cpu().numpy() == batch["t_out"]).all()


@pytest.mark.gpu
def test_tiledtail_and_depth_on_the_card_match_cpu(batch, tail, cuda):
    ft, ct, ut = (t.to(cuda) for t in batch["inputs"])
    out, ok, rounds = TD.decode_fragments(ft, ct, ut)
    assert rounds == tail["rounds"]
    assert (ok.cpu().numpy() == tail["t_ok"]).all()
    assert (out.cpu().numpy() == tail["t_out"]).all()
    if "td_out" in tail:
        deps = _hints(*batch["np_inputs"])
        out, ok, _ = TD.decode_fragments_depth(
            ft, ct, ut, torch.from_numpy(deps).to(cuda))
        assert (ok.cpu().numpy() == tail["td_ok"]).all()
        assert (out.cpu().numpy() == tail["td_out"]).all()
