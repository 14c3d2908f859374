"""Fused matcher on the packed candidate form: (pref, words) -> (jump, off).

Port of tpu_snappy/ops/pallas/matcher.py:matcher_block_packed at sticky
"exact" and any even K <= 16 (sticky "sig" and odd K belong to the
presets). The CUDA kernel is csrc/matcher.cu (one block per row and
1024-position tile, halos in shared memory, see its note). The plain
version unpacks the words into the (B, N, K) candidate table and runs the
XLA-form matcher, encode._matcher_xla, which the JAX suite proves
bit-identical to the Pallas kernel.
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/matcher.cu"
REPLACES = "tpu_snappy/ops/pallas/matcher.py:224"

#: Largest candidate count the kernel takes.
MAX_K = 16


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
    if k % 2 or not 2 <= k <= MAX_K:
        raise ValueError(f"matcher_block_packed: K={k}; even K up to "
                         f"{MAX_K} is ported (odd K belongs to the presets)")
    if sticky != "exact":
        raise ValueError(f"matcher_block_packed: sticky={sticky!r}; only "
                         "'exact' is ported")


def matcher_block_packed_plain(pref: torch.Tensor, words: torch.Tensor,
                               n: torch.Tensor, k: int, lazy: int = 0,
                               sticky: str = "exact"):
    """Plain PyTorch form: (jump (B, N) int32, off (B, N) int32)."""
    _check_args(k, sticky)
    from .. import encode  # the XLA-form matcher is the plain body
    return encode._matcher_xla(unpack_table(pref, words, k), n, lazy)


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
    jump = torch.empty((batch, N), dtype=torch.int32, device=pref.device)
    off = torch.empty_like(jump)
    if batch:
        rc = _build.lib().snk_matcher_packed(
            pref.data_ptr(), words.data_ptr(), n.data_ptr(), jump.data_ptr(),
            off.data_ptr(), k, lazy, batch, _build.stream())
        _build.check(rc, "matcher_block_packed")
        matcher_block_packed.launches += 1
    return jump, off


matcher_block_packed.launches = 0
