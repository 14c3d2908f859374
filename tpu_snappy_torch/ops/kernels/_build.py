"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). The library lands in `_build/`, keyed by a hash of the sources
and flags, so a fresh checkout builds at first use and an edited source
rebuilds. Nothing here runs at import time.

Each C entry point returns `cudaGetLastError()` after its launches;
`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int

#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "snk_window_keys": [P, P, P, I, P],
    "snk_ffill": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "snk_scatter_windowed": [P, P, P, P, P, I, I, I, I, I, I, P],
    "snk_resolve_tiled": [P, P, P, P, I, I, P],
    "snk_resolve_tiled_depth": [P, P, P, P, I, I, P],
    "snk_gather": [P, P, P, I, I, I, I, P],
    "snk_matcher_packed": [P, P, P, P, P, I, I, I, I, P],
    "snk_matcher": [P, P, P, P, I, I, I, I, P],
    "snk_matcher_wide": [P, P, I, P, P, P, I, I, I, I, P],
    "snk_emit_single": [P, P, P, P, P, P, P, P, P, P, I, P],
    "snk_emit_two_lane": [P, P, P, P, P, P, P, P, I, P],
    "snk_scatter_block": [P, P, P, I, I, I, I, I, P],
    "snk_resolve_tiled_flag": [P, P, P, P, I, I, P],
    "snk_local_round": [P, P, I, I, P],
    "snk_doubling_round": [P, P, P, P, I, P],
    "snk_resolve_block": [P, P, P, I, P],
    "snk_elem_fields": [P, P, I, I, P],
    "snk_gather_window": [P, P, P, I, I, I, P],
    "snk_gather_window_anchored": [P, P, P, P, I, P],
    "snk_cumsum": [P, P, I, I, P],
    "snk_next_start": [P, P, I, I, I, P],
    "snk_crc32c_rows": [P, P, P, P, I, P],
}

#: The H100's streaming multiprocessors, and the shared memory one block
#: may take (227 KB, as dynamic shared memory after opting in).
SMS = 132
SMEM_BYTES = 227 * 1024

_lock = threading.Lock()
_lib = None

#: What the last build or load did: library path, whether nvcc ran, its
#: wall time, and the `-Xptxas -v` lines (registers, shared memory, spills).
build_info: dict = {}


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run(cmds: list) -> list:
    """Run the commands side by side; raise if any fails. Returns their
    (stdout, stderr) pairs."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}\n{err}")
    return outs


def build(force: bool = False) -> pathlib.Path:
    """Compile csrc/*.cu (one nvcc process per file, in parallel) and link
    one shared library (skipped when a library for the same sources
    exists, unless force). Returns its path."""
    so = BUILD_DIR / f"libsnappy_kernels_{_digest()}.so"
    if so.exists() and not force:
        build_info.update(path=str(so), compiled=False, seconds=0.0,
                          ptxas=[])
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{_digest()}.{os.getpid()}"
    nvcc = _nvcc()
    objs, cmds = [], []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    outs = _run(cmds)
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    ptxas = [ln.strip() for out, err in outs
             for ln in (out + err).splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    build_info.update(path=str(so), compiled=True, seconds=seconds,
                      ptxas=ptxas)
    return so


def lib(force_build: bool = False):
    """The loaded kernel library (built on first use; once loaded, no lock
    is taken)."""
    global _lib
    if _lib is not None and not force_build:
        return _lib
    with _lock:
        if _lib is None or force_build:
            so = build(force=force_build)
            handle = ctypes.CDLL(str(so))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.snk_error_string.argtypes = [ctypes.c_int]
            handle.snk_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().snk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream() -> int:
    """PyTorch's current CUDA stream, as the integer the C side takes
    (under CUDA graph capture, the capture stream)."""
    import torch
    return torch.cuda.current_stream().cuda_stream


def on_cpu(*tensors) -> bool:
    """Dispatch rule of every kernel wrapper: True when all tensors lie on
    the CPU (use the plain version), False when all lie on one CUDA device
    (launch the kernel). Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def require(t, dtype, shape: tuple, name: str) -> None:
    """Raise unless t has the dtype and shape a kernel takes and is
    contiguous (the kernels index raw row-major memory)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_aligned(name: str, *tensors) -> None:
    """Raise unless every tensor starts 16-byte aligned (the kernels that
    load and store 16 bytes a thread; a fresh PyTorch allocation is)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start 16-byte aligned")
