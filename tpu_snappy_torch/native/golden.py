"""ctypes binding of the repository's clean-room C++ Snappy codec (native/).

The port's own binding: `compress` (in MODE_BASELINE or MODE_DENSE),
`uncompress`, `scan_index` (the decoder's host fragment split),
`available`, and for the framed container `crc32c`, `root_map` and
`depth_hints` (the 0x80 and 0x81 sidecars' payloads), `depth_hints_sim`
(the hints' brute-force oracle), `compress_framed` and
`uncompress_framed` (an independent framed codec); `swcompression_path`
builds the codec's command-line harness. It builds the
shared sources in native/ at the repository root with CMake and Ninja, as
tpu_snappy/native/golden.py does, but into a directory of its own
(`_build/` beside this file, git-ignored), under a file lock, so
concurrent test processes never build over each other or over the JAX
package's native/build/.
"""

from __future__ import annotations

import ctypes
import fcntl
import pathlib
import subprocess
import threading

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_NATIVE = _ROOT / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

#: sr_compress's modes (native/snappy_ref.h): software Snappy's sparse
#: parse, and the dense one that inserts every position.
MODE_BASELINE = 0
MODE_DENSE = 1

_ERRORS = {
    1: "truncated stream",
    2: "bad copy offset",
    3: "length mismatch",
    4: "output capacity too small",
    5: "bad varint",
    6: "chunk CRC mismatch",
    7: "bad chunk",
}

_lock = threading.Lock()
_lib = None


def _build(target: str = "snappy_ref",
           name: str = "libsnappy_ref.so") -> pathlib.Path:
    """Build one CMake target of native/ into BUILD_DIR (configured once),
    under the directory's file lock, unless its file `name` is there.
    Returns the file's path."""
    path = BUILD_DIR / name
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            if not (BUILD_DIR / "build.ninja").exists():
                subprocess.run(["cmake", "-S", str(_NATIVE), "-B",
                                str(BUILD_DIR), "-G", "Ninja"], check=True,
                               capture_output=True)
            subprocess.run(["cmake", "--build", str(BUILD_DIR), "--target",
                            target], check=True, capture_output=True)
    return path


def swcompression_path() -> pathlib.Path:
    """Path to the C++ golden's command-line harness (native/
    swcompression.cc: roundtrip, compress, uncompress and bench of a
    file, in the baseline or the dense mode), built on demand into
    BUILD_DIR."""
    return _build("swcompression", "swcompression")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.sr_max_compressed_length.restype = ctypes.c_size_t
            lib.sr_max_compressed_length.argtypes = [ctypes.c_size_t]
            lib.sr_compress.restype = ctypes.c_size_t
            lib.sr_compress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
            ]
            lib.sr_uncompressed_length.restype = ctypes.c_int
            lib.sr_uncompressed_length.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)
            ]
            lib.sr_uncompress.restype = ctypes.c_int
            lib.sr_uncompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.sr_scan_index.restype = ctypes.c_int
            lib.sr_scan_index.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.sr_root_map.restype = ctypes.c_int
            lib.sr_root_map.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.sr_depth_hints.restype = ctypes.c_int
            lib.sr_depth_hints.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
                ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.sr_depth_hints_sim.restype = ctypes.c_int
            lib.sr_depth_hints_sim.argtypes = lib.sr_depth_hints.argtypes
            lib.sr_crc32c.restype = ctypes.c_uint32
            lib.sr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.sr_max_framed_length.restype = ctypes.c_size_t
            lib.sr_max_framed_length.argtypes = [ctypes.c_size_t]
            lib.sr_compress_framed.restype = ctypes.c_size_t
            lib.sr_compress_framed.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
            ]
            lib.sr_uncompress_framed.restype = ctypes.c_int
            lib.sr_uncompress_framed.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64),
            ]
            _lib = lib
    return _lib


def available() -> bool:
    """True when the library builds (cmake and Ninja present) and loads."""
    try:
        _load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def compress(data: bytes, mode: int = MODE_BASELINE) -> bytes:
    """Raw Snappy stream of `data` in `mode` (MODE_BASELINE or
    MODE_DENSE)."""
    lib = _load()
    cap = lib.sr_max_compressed_length(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.sr_compress(data, len(data), out, mode)
    return out.raw[:n]


def uncompress(data: bytes) -> bytes:
    """Decode a raw Snappy stream; ValueError on an invalid one."""
    lib = _load()
    ulen = ctypes.c_uint64()
    rc = lib.sr_uncompressed_length(data, len(data), ctypes.byref(ulen))
    if rc:
        raise ValueError(f"golden uncompress: {_ERRORS.get(rc, rc)}")
    out = ctypes.create_string_buffer(max(1, ulen.value))
    got = ctypes.c_uint64()
    rc = lib.sr_uncompress(data, len(data), out, ulen.value, ctypes.byref(got))
    if rc:
        raise ValueError(f"golden uncompress: {_ERRORS.get(rc, rc)}")
    return out.raw[: got.value]


def scan_index(comp: bytes, start: int, total: int, max_frags: int):
    """Fragment table of a Snappy stream by the native element walk.
    Returns (comp_offsets (F,) int64, out_lens (F,) int64, F). Raises
    RuntimeError on malformed or non-fragmentable streams (callers fall
    back to the Python walk)."""
    lib = _load()
    offs = (ctypes.c_uint32 * max_frags)()
    lens = (ctypes.c_uint32 * max_frags)()
    nfrag = ctypes.c_uint32()
    rc = lib.sr_scan_index(comp, len(comp), start, total, offs, lens,
                           max_frags, ctypes.byref(nfrag))
    if rc:
        raise RuntimeError(f"scan_index: {_ERRORS.get(rc, rc)}")
    f = nfrag.value
    return (np.frombuffer(offs, dtype=np.uint32)[:f].astype(np.int64),
            np.frombuffer(lens, dtype=np.uint32)[:f].astype(np.int64), f)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, unmasked) of one buffer, slice-by-8 in C."""
    return _load().sr_crc32c(data, len(data))


def root_map(elems: bytes, ulen: int):
    """Affine pieces of an element stream's literal-root map (the framed
    0x80 sidecar's payload; sr_root_map in native/snappy_ref.h). Returns
    (starts u16[P], roots u16[P], slopes u8[P] in {0, 1}). Raises
    RuntimeError on a malformed stream or past capacity (elems >= 64 KB)."""
    lib = _load()
    cap = max(1, ulen)
    starts = (ctypes.c_uint16 * cap)()
    roots = (ctypes.c_uint16 * cap)()
    slopes = (ctypes.c_uint8 * cap)()
    npieces = ctypes.c_uint32()
    rc = lib.sr_root_map(elems, len(elems), ulen, starts, roots, slopes,
                         cap, ctypes.byref(npieces))
    if rc:
        raise RuntimeError(f"root_map: {_ERRORS.get(rc, rc)}")
    p = npieces.value
    return (np.frombuffer(starts, dtype=np.uint16)[:p].copy(),
            np.frombuffer(roots, dtype=np.uint16)[:p].copy(),
            np.frombuffer(slopes, dtype=np.uint8)[:p].copy())


def depth_hints(elems: bytes, ulen: int, tail_cap: int, tile: int):
    """Per-tile resolve round counts of one element stream for the decode
    pipeline at (tail_cap, tile) (the framed 0x81 sidecar; sr_depth_hints).
    Returns a (65536 // tile,) uint8 array. Raises RuntimeError on a
    malformed stream or past capacity."""
    lib = _load()
    out = (ctypes.c_uint8 * (65536 // tile))()
    rc = lib.sr_depth_hints(elems, len(elems), ulen, tail_cap, tile, out)
    if rc:
        raise RuntimeError(f"depth_hints: {_ERRORS.get(rc, rc)}")
    return np.frombuffer(out, dtype=np.uint8).copy()


def depth_hints_sim(elems: bytes, ulen: int, tail_cap: int, tile: int):
    """depth_hints by brute force (sr_depth_hints_sim): the decode
    pipeline simulated on the stream, each tile's rounds counted; the
    oracle the analytic depth_hints is held to. Returns a (65536 // tile,)
    uint8 array. Raises RuntimeError on a malformed stream or past
    capacity."""
    lib = _load()
    out = (ctypes.c_uint8 * (65536 // tile))()
    rc = lib.sr_depth_hints_sim(elems, len(elems), ulen, tail_cap, tile, out)
    if rc:
        raise RuntimeError(f"depth_hints_sim: {_ERRORS.get(rc, rc)}")
    return np.frombuffer(out, dtype=np.uint8).copy()


def compress_framed(data: bytes, mode: int = MODE_BASELINE) -> bytes:
    """A Snappy framed stream (framing_format.txt) of `data`, each chunk
    compressed in `mode` as compress does."""
    lib = _load()
    out = ctypes.create_string_buffer(lib.sr_max_framed_length(len(data)))
    n = lib.sr_compress_framed(data, len(data), out, mode)
    return out.raw[:n]


def uncompress_framed(data: bytes, max_out: int | None = None) -> bytes:
    """Decode and validate (structure and every CRC) a framed stream;
    ValueError on an invalid one. Framed streams carry no total length:
    the buffer is `max_out` bytes, by default the worst-case expansion."""
    lib = _load()
    cap = max_out if max_out is not None else max(1, len(data) * 256)
    out = ctypes.create_string_buffer(cap)
    got = ctypes.c_uint64()
    rc = lib.sr_uncompress_framed(data, len(data), out, cap,
                                  ctypes.byref(got))
    if rc:
        raise ValueError(f"golden uncompress_framed: {_ERRORS.get(rc, rc)}")
    return out.raw[: got.value]
