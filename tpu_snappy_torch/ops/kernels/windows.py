"""Encode pair-sort keys: the 4-byte little-endian window of every position.

Port of tpu_snappy/ops/pallas/windows.py:window_keys_block; the CUDA kernel
is csrc/windows.cu (one thread per position, see its note). The plain
version below is the CPU path and the kernel's reference on the card.
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/windows.cu"
REPLACES = "tpu_snappy/ops/pallas/windows.py:61"

#: Key of a position past n - 4 (sorts after every real window).
INVALID = 0xFFFFFFFF


def windows_u32(blocks: torch.Tensor) -> torch.Tensor:
    """w[i] = bytes[i:i+4] little-endian as int64, wrapping at the block end
    like jnp.roll (callers mask the last 3 positions). blocks: (B, 65536)
    uint8."""
    b = blocks.to(torch.int64)
    return (b
            | torch.roll(b, -1, dims=-1) << 8
            | torch.roll(b, -2, dims=-1) << 16
            | torch.roll(b, -3, dims=-1) << 24)


def window_keys_plain(blocks: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch window keys: (B, 65536) int64, INVALID where i > n-4."""
    iota = torch.arange(N, dtype=torch.int32, device=blocks.device)
    valid = iota <= n.to(torch.int32)[:, None] - 4
    return torch.where(valid, windows_u32(blocks), INVALID)


def window_keys(blocks: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Window keys of (B, 65536) uint8 blocks with (B,) int32 lengths.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if _build.on_cpu(blocks, n):
        return window_keys_plain(blocks, n)
    batch = blocks.shape[0]
    _build.require(blocks, torch.uint8, (batch, N), "blocks")
    _build.require(n, torch.int32, (batch,), "n")
    key = torch.empty((batch, N), dtype=torch.int64, device=blocks.device)
    if batch:
        rc = _build.lib().snk_window_keys(blocks.data_ptr(), n.data_ptr(),
                                          key.data_ptr(), batch,
                                          _build.stream())
        _build.check(rc, "window_keys")
        window_keys.launches += 1
    return key


window_keys.launches = 0
