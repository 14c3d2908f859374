"""The port called in the JAX package's positional forms, on the CPU.

A caller written against tpu_snappy passes `cfg`, `mesh` and the wave
sizes by position (tpu_snappy/__main__.py:109, tpu_snappy/compat.py:102).
The port's framed entry points, ops.decode.decode_fragments,
parallel.shard.decode_dp and ops.scan.segment_exit_maps take the same
positions and must give the JAX package's bytes there. A value of the
wrong kind in `cfg`'s or `mesh`'s place (a policy string or a flag from
an older order) raises TypeError naming the argument instead of binding
silently. A guard compares the positional parameters of every public
function the two packages share, by inspect.signature; the C++ golden's
`mode` is among them.
"""

import importlib
import inspect
import io
import pkgutil

import numpy as np
import pytest
import torch

from tpu_snappy import framing as JF
from tpu_snappy.config import DEFAULT_CONFIG as J_DEFAULT
from tpu_snappy.config import FAST_CONFIG as J_FAST
from tpu_snappy.native import golden as J_GOLDEN
from tpu_snappy.ops import decode as JD
from tpu_snappy.ops import scan as JS

import tpu_snappy_torch
from tpu_snappy_torch import api, framing as TF, reference_codec
from tpu_snappy_torch import format as fmt
from tpu_snappy_torch.config import DEFAULT_CONFIG, FAST_CONFIG
from tpu_snappy_torch.native import golden
from tpu_snappy_torch.ops import decode as TD
from tpu_snappy_torch.ops import scan as TS
from tpu_snappy_torch.parallel import mesh as meshlib, shard
from torch_threads import share_cores

share_cores()

#: The input of the fault record (ROADMAP.md, Queue 3): 98890 bytes.
FOX = b"".join(b"the quick brown fox %d " % i for i in range(4000))

#: Positional parameters the JAX package has and the port does not, each
#: with its reason. All are sharding names of JAX's device mesh.
JAX_ONLY = {
    ("parallel.mesh", "make_mesh"): {
        "axis": "the name of JAX's mesh axis; the port's Mesh is a tuple "
                "of devices and has no axis names"},
    ("parallel.multihost", "global_mesh"): {
        "axis": "the same mesh axis name, for the global mesh"},
    ("parallel.shard", "assemble_compact"): {
        "cap": "the row stride of JAX's one global dense array; the port "
               "keeps one dense payload a shard, cut at its own total",
        "fetch_bucket": "JAX's bucketed slice sizes, which bound its count "
                        "of compiled fetch programs; the port fetches each "
                        "payload once and compiles nothing"},
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn) -> list:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in _POSITIONAL]


def _shared_modules() -> dict:
    """Every module of the port (its CUDA kernels' package aside) whose
    name the JAX package also has, as (port module, JAX module)."""
    out = {}
    for info in pkgutil.walk_packages(tpu_snappy_torch.__path__,
                                      "tpu_snappy_torch."):
        rel = info.name.split(".", 1)[1]
        if rel.startswith("ops.kernels") or "._build" in rel:
            continue
        try:
            jax_mod = importlib.import_module(f"tpu_snappy.{rel}")
        except ModuleNotFoundError:
            continue
        out[rel] = (importlib.import_module(info.name), jax_mod)
    return out


def _shared_functions() -> list:
    """(module, qualified name, port function, JAX function) for every
    public function, class constructor and public method the two packages
    share, each defined in the JAX module itself."""
    found = []
    for rel, (mine, theirs) in sorted(_shared_modules().items()):
        for name, jf in sorted(vars(theirs).items()):
            tf = getattr(mine, name, None)
            if (name.startswith("_") or tf is None or not callable(jf)
                    or getattr(jf, "__module__", None) != theirs.__name__):
                continue
            if not inspect.isclass(jf):
                found.append((rel, name, tf, jf))
                continue
            for meth in ["__init__"] + sorted(vars(jf)):
                if meth in vars(jf) and (meth == "__init__"
                                         or not meth.startswith("_")):
                    jm, tm = getattr(jf, meth), getattr(tf, meth, None)
                    if callable(jm) and callable(tm):
                        found.append((rel, f"{name}.{meth}", tm, jm))
    return found


def test_every_shared_function_starts_with_the_jax_positions():
    checked, bad = [], []
    for rel, name, mine, theirs in _shared_functions():
        try:
            want, got = _positional(theirs), _positional(mine)
        except (TypeError, ValueError):  # a builtin with no signature
            continue
        allowed = JAX_ONLY.get((rel, name), {})
        want = [p for p in want if p not in allowed]
        checked.append(f"{rel}.{name}")
        if got[:len(want)] != want:
            bad.append(f"{rel}.{name}: JAX {want}, port {got}")
    assert not bad, "\n".join(bad)
    for must in ("framing.compress", "framing.compress_stream",
                 "framing.decompress", "framing.decompress_stream",
                 "ops.decode.decode_fragments", "parallel.shard.decode_dp",
                 "ops.scan.segment_exit_maps", "native.golden.compress",
                 "serving.CodecServer.__init__", "api.compress"):
        assert must in checked, must
    for (rel, name), names in JAX_ONLY.items():
        theirs = getattr(importlib.import_module(f"tpu_snappy.{rel}"), name)
        assert set(names) <= set(_positional(theirs)), (rel, name)


def test_framed_compress_in_the_jax_form():
    assert len(FOX) == 98890
    got = TF.compress(FOX, FAST_CONFIG, device="cpu")
    want = JF.compress(FOX, J_FAST)
    assert len(want) == 20514 and got == want
    assert TF.compress(FOX, FAST_CONFIG, None, "off", device="cpu") == want


def test_framed_compress_stream_in_the_jax_form():
    dst = io.BytesIO()
    n = TF.compress_stream(io.BytesIO(FOX), dst, len(FOX), None,
                           device="cpu")
    jdst = io.BytesIO()
    JF.compress_stream(io.BytesIO(FOX), jdst, len(FOX), None)
    assert n == 21029 and dst.getvalue() == jdst.getvalue()
    dst = io.BytesIO()
    TF.compress_stream(io.BytesIO(FOX), dst, len(FOX), None, 1,
                       DEFAULT_CONFIG, "off", device="cpu")
    assert dst.getvalue() == jdst.getvalue()


@pytest.fixture(scope="module")
def sidecar_stream():
    """FOX framed with a 0x80 root map before every compressed chunk."""
    fr = TF.compress(FOX, sidecar="always", device="cpu")
    assert fr == JF.compress(FOX, sidecar="always")
    return fr


def _spy(monkeypatch) -> list:
    """Record (use_sidecar, FramedStats) of every _decode_data_chunks call,
    the decode paths' dispatch."""
    calls, real = [], TF._decode_data_chunks

    def spy(bodies, mesh, use_sidecar, stats):
        calls.append((use_sidecar, stats))
        return real(bodies, mesh, use_sidecar, stats)

    monkeypatch.setattr(TF, "_decode_data_chunks", spy)
    return calls


def test_framed_decodes_in_the_jax_form_take_the_sidecars(sidecar_stream,
                                                          monkeypatch):
    calls = _spy(monkeypatch)
    assert TF.decompress(sidecar_stream, DEFAULT_CONFIG,
                         device="cpu") == FOX
    got, stats = TF.decompress_with_stats(sidecar_stream, DEFAULT_CONFIG,
                                          None, device="cpu")
    assert got == FOX and stats.root_map == 2 and stats.normal == 0
    dst = io.BytesIO()
    n = TF.decompress_stream(io.BytesIO(sidecar_stream), dst, None,
                             device="cpu")
    assert dst.getvalue() == FOX and n == len(FOX)
    assert calls and all(use is True for use, _ in calls)
    assert all(st.root_map for _, st in calls)
    del calls[:]
    dst = io.BytesIO()
    TF.decompress_stream(io.BytesIO(sidecar_stream), dst, None, 64,
                         DEFAULT_CONFIG, False, device="cpu")
    assert dst.getvalue() == FOX
    assert all(use is False and not st.root_map for use, st in calls)


def test_old_call_forms_raise_type_error(sidecar_stream):
    with pytest.raises(TypeError, match="cfg"):
        TF.compress(FOX, "auto", device="cpu")
    with pytest.raises(TypeError, match="cfg"):
        TF.compress(FOX, "auto")
    with pytest.raises(TypeError, match="cfg"):
        TF.decompress(sidecar_stream, False, device="cpu")
    with pytest.raises(TypeError, match="cfg"):
        TF.decompress_with_stats(sidecar_stream, True, device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        TF.compress_stream(io.BytesIO(FOX), io.BytesIO(), len(FOX), "auto",
                           device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        TF.decompress_stream(io.BytesIO(sidecar_stream), io.BytesIO(), False,
                             device="cpu")
    with pytest.raises(TypeError, match="use_sidecar"):
        TF.decompress(sidecar_stream, DEFAULT_CONFIG, None, DEFAULT_CONFIG,
                      device="cpu")
    with pytest.raises(TypeError, match="blocks_per_wave"):
        TF.compress_stream(io.BytesIO(FOX), io.BytesIO(), len(FOX), None,
                           True, device="cpu")
    frags, clens, ulens = _fragments(api.compress(FOX[:4096],
                                                  device="cpu"))
    with pytest.raises(TypeError, match="cfg"):
        TD.decode_fragments(frags, clens, ulens, "tiled")
    with pytest.raises(TypeError, match="cfg"):
        shard.decode_dp(b"\x00", meshlib.make_mesh(1, device="cpu"),
                        "tiledtail")


def _fragments(comp: bytes):
    """The port's fragment table of a raw stream, cut to its width, as
    tensors."""
    total, start = fmt.varint_decode(comp)
    frags, clens, ulens = TD.fragment_table(comp, start, total)
    frags = frags[:, :TD.frag_width(clens)]
    return (torch.from_numpy(np.ascontiguousarray(frags)),
            torch.from_numpy(clens.astype(np.int32)),
            torch.from_numpy(ulens.astype(np.int32)))


def test_decode_fragments_and_decode_dp_in_the_jax_form():
    comp = api.compress(FOX, device="cpu")
    frags, clens, ulens = _fragments(comp)
    out, ok, _ = TD.decode_fragments(frags, clens, ulens, DEFAULT_CONFIG)
    keyed, kok, _ = TD.decode_fragments(frags, clens, ulens,
                                        resolve="tiledtail")
    assert torch.equal(out, keyed) and torch.equal(ok, kok)
    jout, jok = JD.decode_fragments(frags.numpy(), clens.numpy(),
                                    ulens.numpy(), J_DEFAULT)[:2]
    assert (out.numpy() == np.asarray(jout)).all()
    assert (ok.numpy() == np.asarray(jok)).all()
    lens = ulens.tolist()
    assert b"".join(out[i, :n].numpy().tobytes()
                    for i, n in enumerate(lens)) == FOX
    mesh = meshlib.make_mesh(2, device="cpu")
    assert shard.decode_dp(comp, mesh, DEFAULT_CONFIG) == FOX


def test_segment_exit_maps_bounded_gives_the_same_values():
    rng = np.random.default_rng(5)
    jump = rng.integers(1, JS.S + 1, (2, JS.S * 8)).astype(np.int32)
    plain = TS.segment_exit_maps(torch.from_numpy(jump))
    bounded = TS.segment_exit_maps(torch.from_numpy(jump), True)
    assert torch.equal(plain, bounded)
    want = np.asarray(JS.segment_exit_maps(jump, True))
    assert (bounded.numpy() == want).all()


def test_golden_modes_in_the_jax_form():
    """The C++ golden's `mode` argument, positional as in the JAX binding:
    the baseline is the default, the dense mode's stream is no longer on
    text, and every stream decodes. (The JAX binding itself is not called:
    it would build the JAX package's native/build.)"""
    assert (golden.MODE_BASELINE, golden.MODE_DENSE) == (
        J_GOLDEN.MODE_BASELINE, J_GOLDEN.MODE_DENSE)
    if not golden.available():
        pytest.skip("cmake / Ninja missing: the golden cannot build here")
    base = golden.compress(FOX, golden.MODE_BASELINE)
    dense = golden.compress(FOX, golden.MODE_DENSE)
    assert base == golden.compress(FOX) and len(dense) <= len(base)
    for comp in (base, dense):
        assert reference_codec.decompress(comp) == FOX
    framed = golden.compress_framed(FOX, golden.MODE_DENSE)
    assert golden.uncompress_framed(framed, max_out=len(FOX) + 16) == FOX
    assert TF.decompress(framed, DEFAULT_CONFIG, device="cpu") == FOX
