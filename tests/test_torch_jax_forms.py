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
`mode` is among them. A second guard pairs each kernel wrapper of
ops/kernels/ with the Pallas function its REPLACES names and requires the
wrapper to take every parameter of it, and a third requires every public
function, class and UPPER_CASE constant of a JAX module to have a
counterpart in the port's module (ops.pallas.X in ops.kernels.X), or an
entry in JAX_ONLY_NAMES with its reason.
"""

import ast
import importlib
import inspect
import io
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

import tpu_snappy
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

#: Public names of JAX modules the port has no counterpart for, each with
#: its reason: jit objects (the port runs eagerly), the JAX mesh's
#: sharding objects, a TPU-only switch, and the Pallas kernels' VMEM
#: layout constants.
JIT = "a jax.jit of a function the port has; PyTorch runs eagerly"
SHARDING = ("a JAX sharding object of the device mesh; the port's Mesh is "
            "a tuple of devices and moves whole rows")
LAYOUT = ("the Pallas kernel's VMEM layout (its (8, 128) tiling: rows, "
          "lanes and blocks a grid step), which a CUDA kernel does not have")
PALLAS_LAYOUT = {"LANES", "ROWS", "HI", "LO", "LO_BITS", "TR", "TC", "TILES",
                 "WR", "NBLK"}
JAX_ONLY_NAMES = {
    ("ops.decode", "decode_fragments_jit"): JIT,
    ("ops.decode", "decode_fragments_depth_jit"): JIT,
    ("sidecar", "decode_chunks_jit"): JIT,
    ("ops.pallas.gather", "gather_blocks"): JIT + " (gather_block is "
                                                  "batched already)",
    ("parallel.mesh", "P"): "jax.sharding.PartitionSpec, imported; "
                            + SHARDING,
    ("parallel.mesh", "block_sharding"): SHARDING,
    ("parallel.mesh", "scalar_sharding"): SHARDING,
    ("parallel.mesh", "replicated"): SHARDING,
    ("ops.encode", "FORCE_XLA_MATCHER"): (
        "a switch that keeps the TPU off its Pallas matcher; the port's "
        "matcher route follows the CodecConfig alone (ops/encode.py:_match)"),
    ("ops.pallas.gather", "N"): ("the table width the Pallas kernel fixes; "
                                 "the port's gather_block takes any width"),
    ("ops.pallas.fields", "FRAG_CAP"): (
        "the Pallas kernel's input width; ops.decode.FRAG_CAP holds it, and "
        "the port's elem_fields_block takes any multiple of WIDTH_STEP"),
    ("utils.profiling", "Timer"): (
        "wall-clock sections that wait for the card at each end; nothing "
        "read them, and the port's spans (utils.profiling.span under "
        "tracing()) time the same stages without the wait"),
    ("ops.pallas.place", "SENT"): (
        "the Pallas kernel's inactive-destination sentinel; the port's "
        "place_block drops a destination outside [0, out_cells) and needs "
        "none (ops.encode.SENT is the emission's)"),
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
                 "serving.CodecServer.__init__", "api.compress",
                 "ops.decode.decode_fragment", "ops.encode.encode_block",
                 "ops.scan.gather_s", "parallel.shard.pad_count",
                 "utils.profiling.sync1", "native.golden.swcompression_path",
                 "native.golden.depth_hints_sim"):
        assert must in checked, must
    for (rel, name), names in JAX_ONLY.items():
        theirs = getattr(importlib.import_module(f"tpu_snappy.{rel}"), name)
        assert set(names) <= set(_positional(theirs)), (rel, name)


def _kernel_modules() -> dict:
    """Every kernel module of the port, by name (ops.kernels.X)."""
    import tpu_snappy_torch.ops.kernels as K
    return {info.name: importlib.import_module(f"{K.__name__}.{info.name}")
            for info in pkgutil.iter_modules(K.__path__)
            if not info.name.startswith("_")}


def _replaced() -> list:
    """(wrapper, Pallas function) for every entry of every kernel module's
    REPLACES ("file:line" of the Pallas function's def)."""
    root = pathlib.Path(tpu_snappy.__file__).resolve().parent.parent
    pairs = []
    for mod in _kernel_modules().values():
        rep = getattr(mod, "REPLACES", None)
        if rep is None:
            continue
        if isinstance(rep, dict):
            items = rep.items()
        else:  # the module's one wrapper: its one launch counter
            counted = [n for n, f in vars(mod).items()
                       if callable(f) and hasattr(f, "launches")]
            assert len(counted) == 1, (mod.__name__, counted)
            items = [(counted[0], rep)]
        for name, where in items:
            path, line = where.split(":")
            tree = ast.parse((root / path).read_text())
            defs = [n.name for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef) and n.lineno == int(line)]
            assert len(defs) == 1, f"{mod.__name__}: no def at {where}"
            jax_mod = importlib.import_module(
                path[:-3].replace("/", "."))
            pairs.append((mod, getattr(mod, name),
                          getattr(jax_mod, defs[0])))
    return pairs


def test_every_kernel_wrapper_takes_the_pallas_parameters():
    """Each wrapper named in a REPLACES takes every parameter of its Pallas
    function (`*vals` aside; an option by its name, a tensor input by its
    name or its position): the kernels' arguments that change bytes
    (tiles, variants, check counts, max_gap) cannot go missing."""
    pairs, bad = _replaced(), []
    for mod, wrapper, pallas in pairs:
        theirs = inspect.signature(inspect.unwrap(pallas)).parameters
        mine = inspect.signature(wrapper).parameters
        slots = [q for q in mine.values() if q.kind in _POSITIONAL]
        for i, p in enumerate(theirs.values()):
            if p.kind is inspect.Parameter.VAR_POSITIONAL:
                continue
            # A tensor input (no default) may take a batched name
            # (window_keys_block's `block`, the wrapper's `blocks`) in its
            # place; an option must keep its name.
            tensor = (p.default is inspect.Parameter.empty and i < len(slots)
                      and slots[i].default is inspect.Parameter.empty)
            if p.name not in mine and not tensor:
                bad.append(f"{mod.__name__}.{wrapper.__name__} lacks "
                           f"{pallas.__name__}'s {p.name}")
    assert not bad, "\n".join(bad)
    assert len(pairs) == 22  # every function reaching pl.pallas_call
    names = {w.__name__ for _, w, _ in pairs}
    assert {"ffill", "local_round", "resolve_tiled", "resolve_tiled_flag",
            "resolve_tiled_depth", "resolve_tiled_dual"} <= names


def _port_module_name(rel: str) -> str:
    return ("tpu_snappy_torch." + rel.replace("ops.pallas", "ops.kernels", 1))


def test_every_jax_name_has_a_port_counterpart():
    replaced = {p.__name__ for _, _, p in _replaced()}
    missing, seen = [], set()
    for info in pkgutil.walk_packages(tpu_snappy.__path__, "tpu_snappy."):
        rel = info.name.split(".", 1)[1]
        theirs = importlib.import_module(info.name)
        mine = importlib.import_module(_port_module_name(rel))
        for name, obj in vars(theirs).items():
            if name.startswith("_"):
                continue
            public = name.isupper() or (
                callable(obj) and getattr(obj, "__module__", None)
                == theirs.__name__)
            if not public or hasattr(mine, name):
                continue
            seen.add((rel, name))
            if (rel, name) in JAX_ONLY_NAMES:
                continue
            if rel.startswith("ops.pallas.") and (
                    name in PALLAS_LAYOUT or name in replaced):
                continue
            missing.append(f"{rel}.{name}")
    assert not missing, missing
    stale = set(JAX_ONLY_NAMES) - seen
    assert not stale, f"allowlisted names the port now has: {stale}"


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
