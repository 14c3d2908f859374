"""Windowed doubling step: y[p] = x[idx[p]] where idx[p] lies in the
k x 2048-position window that ends with p's 2048-position tile, else
y[p] = idx[p] (the lane does not advance).

Port of tpu_snappy/ops/pallas/gatherw.py:gather_window_block, the four
opening rounds of the decoder's resolve="windowed". The CUDA kernel is
csrc/gatherw.cu: one thread per target, a window test and one indexed
load (no overlapping chunk views; see its note). Precondition, as on the
TPU: 0 <= idx[p] <= p, which decode's maps keep. Beyond it the TPU
kernel's result is not defined; the port gives 0 for an index past p's
tile and reads x[idx[p]] inside it. `limbs` keeps the TPU kernel's value
width: values of x must fit 8 * limbs bits, which the plain version
checks.
"""

from __future__ import annotations

import torch

from . import _build
from .gather import MAX_LIMBS

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/gatherw.cu"
REPLACES = "tpu_snappy/ops/pallas/gatherw.py:88"

#: Positions per window chunk and target tile (gatherw.py:38).
CHUNK = 2048


def _check(k: int, limbs: int) -> None:
    if k < 1:
        raise ValueError(f"gather_window_block: k {k} (at least 1)")
    if not 1 <= limbs <= MAX_LIMBS:
        raise ValueError(f"gather_window_block: limbs {limbs} (1 to "
                         f"{MAX_LIMBS})")


def gather_window_block_plain(x: torch.Tensor, idx: torch.Tensor, k: int,
                              limbs: int = 2) -> torch.Tensor:
    """Plain PyTorch form: (B, 65536) int32. Raises ValueError when a value
    of x does not fit 8 * limbs bits (the TPU kernel would drop its high
    limbs)."""
    _check(k, limbs)
    if x.numel() and (int(x.min()) < 0 or int(x.max()) >> (8 * limbs)):
        raise ValueError(f"gather_window_block: table values exceed "
                         f"{8 * limbs} bits (limbs={limbs})")
    tile = torch.arange(N, dtype=torch.int32, device=x.device) // CHUNK
    lo = (tile - (k - 1)) * CHUNK
    end = (tile + 1) * CHUNK
    got = torch.gather(x, -1, torch.clamp(idx, 0, N - 1).long())
    got = torch.where((idx >= 0) & (idx < end), got, 0)
    return torch.where(idx < lo, idx, got).to(torch.int32)


def gather_window_block(x: torch.Tensor, idx: torch.Tensor, k: int,
                        limbs: int = 2) -> torch.Tensor:
    """One windowed doubling step of (B, 65536) int32 `idx` over the table
    `x` (the decoder passes its map as both), window k x 2048 positions.
    Returns (B, 65536) int32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(k, limbs)
    if _build.on_cpu(x, idx):
        return gather_window_block_plain(x, idx, k, limbs)
    batch = x.shape[0]
    _build.require(x, torch.int32, (batch, N), "x")
    _build.require(idx, torch.int32, (batch, N), "idx")
    out = torch.empty_like(idx)
    if batch:
        rc = _build.lib().snk_gather_window(x.data_ptr(), idx.data_ptr(),
                                            out.data_ptr(), k, limbs, batch,
                                            _build.stream())
        _build.check(rc, "gather_window_block")
        gather_window_block.launches += 1
    return out


gather_window_block.launches = 0
