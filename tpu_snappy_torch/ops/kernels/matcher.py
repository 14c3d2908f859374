"""Fused matcher: candidate table -> (jump, off).

Port of tpu_snappy/ops/pallas/matcher.py: `matcher_block_packed` (the
packed form: the gated default plus 16-bit halves in int32 words) and
`matcher_block` (the unpacked (B, N, K) table, column 0 the default), at
sticky "exact" and "sig" and any K from 2 up, as the Pallas kernels take.
The CUDA kernels are in csrc/matcher.cu, each one template for both forms
that differ only in the load stage. A block of THREADS threads owns one
row's tile of TILE outputs plus its halos (LEFT and RIGHT positions), PER
consecutive positions a thread (16-byte loads of the table and stores of
the outputs, so the tables must start 16-byte aligned), and restates the
stages after sticky as ballots, a nibble window and a sliding max over
128-position warp blocks (see its note). Up to FIXED_K a kernel instance
for each K holds the K sticky planes in shared memory; on this card their
compares bound it (integer operations). Above FIXED_K one wide kernel
takes K at run time: the keep sets compose by intersection over a window
of the original table, and a default is always keep 0 of a position at
most 60 back, so it holds each position's default with that origin, its
bucket mask and near bits (one streamed pass over the table answers the
first two levels' tests), and tests the rest at keep 0 in shared memory
or by warp-wide scans of the table in device memory. `_wide` runs it at
any K, the instances' included, for chip_smoke.py and the tests; no
config reaches it. The plain versions run the XLA-form matcher,
encode._matcher_xla, on the (unpacked) table; the JAX suite proves it
bit-identical to both Pallas kernels (tests/test_pallas.py:513-583).
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/matcher.cu"
REPLACES = {"matcher_block_packed": "tpu_snappy/ops/pallas/matcher.py:224",
            "matcher_block": "tpu_snappy/ops/pallas/matcher.py:202"}

#: The kernel's tiling (csrc/matcher.cu): threads a block, consecutive
#: positions a thread, the left halo (sticky 60 + filter 16 + propagation
#: 127, rounded up to PER) and the right one (links 64 + phases 3 + lazy 1).
THREADS, PER, LEFT, RIGHT = 512, 4, 204, 68
TILE = THREADS * PER - LEFT - RIGHT
TILES = -(-N // TILE)

#: The least candidate count (at K 1 the JAX matcher fails too), and the
#: largest with a kernel instance of its own (csrc/matcher.cu's kFixedK:
#: one block's sticky planes fit its shared memory at either sticky mode);
#: larger K run the wide kernel.
MIN_K, FIXED_K = 2, 24
STICKY = ("exact", "sig")


def unpack_table(pref: torch.Tensor, words: torch.Tensor,
                 k: int) -> torch.Tensor:
    """The (B, N, k) candidate table of the packed form: column 0 the gated
    default `pref`, then the 16-bit halves of words 0, 1, ... in order (low
    half first), k - 1 of them. words: (B, k//2, N) int32 bit patterns."""
    cols = [pref]
    for j in range(k // 2):
        w = words[:, j]
        cols.append(w & 0xFFFF)
        if len(cols) < k:
            cols.append((w >> 16) & 0xFFFF)
    return torch.stack(cols, dim=-1)


def _check_args(k: int, sticky: str) -> None:
    if k < MIN_K:
        raise ValueError(f"matcher: K={k}; the kernels take K from {MIN_K}")
    if sticky not in STICKY:
        raise ValueError(f"matcher: sticky={sticky!r}; one of {STICKY}")


def matcher_block_packed_plain(pref: torch.Tensor, words: torch.Tensor,
                               n: torch.Tensor, k: int, lazy: int = 0,
                               sticky: str = "exact"):
    """Plain PyTorch form: (jump (B, N) int32, off (B, N) int32)."""
    _check_args(k, sticky)
    from .. import encode  # the XLA-form matcher is the plain body
    return encode._matcher_xla(unpack_table(pref, words, k), n, lazy,
                               sticky)


def matcher_block_plain(cands: torch.Tensor, n: torch.Tensor, lazy: int = 0,
                        sticky: str = "exact"):
    """Plain PyTorch form of matcher_block: (jump, off), each (B, N)."""
    _check_args(cands.shape[-1], sticky)
    from .. import encode
    return encode._matcher_xla(cands, n, lazy, sticky)


def _launch(entry: str, name: str, lead: list, n: torch.Tensor, k: int,
            lazy: int, sticky: str):
    """Run one C entry point on (B, N) outputs; `lead` are its arguments
    before the lengths (the tables' pointers)."""
    jump = torch.empty((n.shape[0], N), dtype=torch.int32, device=n.device)
    off = torch.empty_like(jump)
    if n.shape[0]:
        rc = getattr(_build.lib(), entry)(
            *lead, n.data_ptr(), jump.data_ptr(), off.data_ptr(), k, lazy,
            int(sticky == "sig"), n.shape[0], _build.stream())
        _build.check(rc, name)
    return jump, off


def matcher_block_packed(pref: torch.Tensor, words: torch.Tensor,
                         n: torch.Tensor, k: int, lazy: int = 0,
                         sticky: str = "exact"):
    """Sticky offsets, match lengths, profitability filter, suffix
    propagation, lazy deferral and the greedy jump for (B, N) int32 `pref`,
    (B, k//2, N) int32 `words` (two 16-bit offsets each) and (B,) int32
    lengths `n`. Returns (jump, off), each (B, N) int32. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check_args(k, sticky)
    if _build.on_cpu(pref, words, n):
        return matcher_block_packed_plain(pref, words, n, k, lazy, sticky)
    batch = pref.shape[0]
    _build.require(pref, torch.int32, (batch, N), "pref")
    _build.require(words, torch.int32, (batch, k // 2, N), "words")
    _build.require(n, torch.int32, (batch,), "n")
    _build.require_aligned("matcher_block_packed", pref, words)
    out = _launch("snk_matcher_packed", "matcher_block_packed",
                  [pref.data_ptr(), words.data_ptr()], n, k, lazy, sticky)
    if batch:
        matcher_block_packed.launches += 1
    return out


def matcher_block(cands: torch.Tensor, n: torch.Tensor, lazy: int = 0,
                  sticky: str = "exact"):
    """The matcher on the unpacked (B, N, K) int32 table (column 0 the
    sticky default, every entry an offset below 65536) and (B,) int32
    lengths. Returns (jump, off), each (B, N) int32. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    k = cands.shape[-1]
    _check_args(k, sticky)
    if _build.on_cpu(cands, n):
        return matcher_block_plain(cands, n, lazy, sticky)
    batch = cands.shape[0]
    _build.require(cands, torch.int32, (batch, N, k), "cands")
    _build.require(n, torch.int32, (batch,), "n")
    _build.require_aligned("matcher_block", cands)
    out = _launch("snk_matcher", "matcher_block", [cands.data_ptr()], n, k,
                  lazy, sticky)
    if batch:
        matcher_block.launches += 1
    return out


def _wide(table: tuple, n: torch.Tensor, k: int, lazy: int = 0,
          sticky: str = "exact"):
    """The wide kernel at any K from MIN_K, the instances' K included, so
    that chip_smoke.py and the `gpu` tests can hold and time it where the
    instances run; no config and no public function reaches it. `table` is
    (pref, words), the packed form, or (cands,), the unpacked one. Returns
    (jump, off) as the public wrappers; CPU tensors take the plain
    version."""
    _check_args(k, sticky)
    packed = len(table) == 2
    if _build.on_cpu(*table, n):
        if packed:
            return matcher_block_packed_plain(*table, n, k, lazy, sticky)
        return matcher_block_plain(table[0], n, lazy, sticky)
    batch = n.shape[0]
    _build.require(n, torch.int32, (batch,), "n")
    if packed:
        pref, words = table
        _build.require(pref, torch.int32, (batch, N), "pref")
        _build.require(words, torch.int32, (batch, k // 2, N), "words")
        _build.require_aligned("_wide", pref, words)
        lead = [pref.data_ptr(), words.data_ptr(), 1]
    else:
        cands, = table
        _build.require(cands, torch.int32, (batch, N, k), "cands")
        _build.require_aligned("_wide", cands)
        lead = [None, cands.data_ptr(), 0]
    out = _launch("snk_matcher_wide", "_wide", lead, n, k, lazy, sticky)
    if batch:
        _wide.launches += 1
    return out


matcher_block_packed.launches = 0
matcher_block.launches = 0
_wide.launches = 0
