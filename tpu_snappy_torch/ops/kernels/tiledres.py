"""Copy-chain resolution: out[p] = lit[fix(src)[p]].

Port of tpu_snappy/ops/pallas/tiledres.py:resolve_tiled (one variant; the
"pair", "tri" and "grid" variants give the same bytes). The CUDA kernel is
csrc/tiledres.cu (tiles left to right: pointer doubling in shared memory,
then one absorb from the row's earlier, final tiles; see its note).
`src[p] <= p` must hold, as decode guarantees: it is what makes the
fixed point exist and the tile walk exact.
"""

from __future__ import annotations

import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/tiledres.cu"
REPLACES = "tpu_snappy/ops/pallas/tiledres.py:764"

#: Positions per sequential tile (tiledres.py:50).
TILE = 4096


def resolve_tiled_plain(lit: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form: global pointer doubling to the fixed point
    (depth <= 65535, so at most 16 moving rounds), then a byte gather."""
    s = src.to(torch.int64)
    for _ in range(17):
        s2 = torch.gather(s, -1, s)
        if torch.equal(s2, s):
            break
        s = s2
    return torch.gather(lit, -1, s)


def resolve_tiled(lit: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Resolve (B, 65536) int32 `src` maps against (B, 65536) int32 `lit`
    bytes. Returns (B, 65536) int32. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if _build.on_cpu(lit, src):
        return resolve_tiled_plain(lit, src)
    batch = lit.shape[0]
    _build.require(lit, torch.int32, (batch, N), "lit")
    _build.require(src, torch.int32, (batch, N), "src")
    out = torch.empty_like(lit)
    if batch:
        rc = _build.lib().snk_resolve_tiled(lit.data_ptr(), src.data_ptr(),
                                            out.data_ptr(), batch,
                                            _build.stream())
        _build.check(rc, "resolve_tiled")
        resolve_tiled.launches += 1
    return out


resolve_tiled.launches = 0
