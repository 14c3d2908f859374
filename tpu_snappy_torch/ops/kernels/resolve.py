"""Fused copy-chain resolution: out[p] = lit[fix(src)[p]] in one launch.

Port of tpu_snappy/ops/pallas/resolve.py:resolve_block, the decoder's
resolve="kernel": pointer doubling to the fixed point (at most 16 rounds,
1024-position tiles that went stable skipped), then the byte gather. The
CUDA kernel is csrc/resolve.cu: one block per row keeps the map in shared
memory as uint16 and doubles the whole row in place, one barrier a round,
skipping pairs of positions whose pointers reached their roots (see its
note). Its preconditions, as decode guarantees: 0 <= src[p] <= p, and lit
holds byte values (the kernel gathers from a byte plane). In-place
doubling then reaches the synchronous rounds' fixed point, so the bytes
are the TPU's.
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/resolve.cu"
REPLACES = "tpu_snappy/ops/pallas/resolve.py:116"

#: Doubling rounds at most (resolve.py:38): chain depth < 65536 = 2^16.
MAX_ROUNDS = 16


def resolve_block_plain(lit: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: synchronous doubling of the whole batch until no
    row moves (a row at its fixed point, like a stable tile, no longer
    changes), at most MAX_ROUNDS, then the byte gather."""
    s = src
    for _ in range(MAX_ROUNDS):
        s2 = torch.gather(s, -1, s.long())
        if torch.equal(s2, s):
            break
        s = s2
    return torch.gather(lit, -1, s.long())


def resolve_block(lit: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Resolve (B, 65536) int32 maps with 0 <= src[p] <= p against (B,
    65536) int32 `lit` holding byte values (0-255). Returns (B, 65536)
    int32. CPU tensors take the plain version; CUDA tensors launch the
    kernel (rows 16-byte aligned)."""
    if _build.on_cpu(lit, src):
        return resolve_block_plain(lit, src)
    batch = lit.shape[0]
    _build.require(lit, torch.int32, (batch, N), "lit")
    _build.require(src, torch.int32, (batch, N), "src")
    _build.require_aligned("resolve_block", lit, src)
    out = torch.empty_like(lit)
    if batch:
        rc = _build.lib().snk_resolve_block(lit.data_ptr(), src.data_ptr(),
                                            out.data_ptr(), batch,
                                            _build.stream())
        _build.check(rc, "resolve_block")
        resolve_block.launches += 1
    return out


resolve_block.launches = 0
