"""ctypes binding of the repository's clean-room C++ Snappy codec (native/).

The port's own binding, with only what it calls: `compress`,
`uncompress`, `scan_index` (the decoder's host fragment split) and
`available`. It builds the shared sources in native/ at the repository
root with CMake and Ninja, as tpu_snappy/native/golden.py does, but into
a directory of its own (`_build/` beside this file, git-ignored), under a
file lock, so concurrent test processes never build over each other or
over the JAX package's native/build/.
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

_ERRORS = {
    1: "truncated stream",
    2: "bad copy offset",
    3: "length mismatch",
    4: "output capacity too small",
    5: "bad varint",
}

_lock = threading.Lock()
_lib = None


def _build() -> pathlib.Path:
    lib = BUILD_DIR / "libsnappy_ref.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            subprocess.run(["cmake", "-S", str(_NATIVE), "-B", str(BUILD_DIR),
                            "-G", "Ninja"], check=True, capture_output=True)
            subprocess.run(["cmake", "--build", str(BUILD_DIR), "--target",
                            "snappy_ref"], check=True, capture_output=True)
    return lib


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
            _lib = lib
    return _lib


def available() -> bool:
    """True when the library builds (cmake and Ninja present) and loads."""
    try:
        _load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def compress(data: bytes) -> bytes:
    """Raw Snappy stream of `data` (baseline mode)."""
    lib = _load()
    cap = lib.sr_max_compressed_length(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.sr_compress(data, len(data), out, 0)
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
