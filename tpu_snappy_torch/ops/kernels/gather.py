"""Row-wise table gather: y[b, t] = x[b, idx[b, t]].

Port of tpu_snappy/ops/pallas/gather.py:gather_block, which the decoder's
dense pointer-doubling rounds, the "hybrid" chase, the final byte gathers
and the framed sidecar's byte gather call. The CUDA kernel is
csrc/gather.cu: four targets a thread, each an indexed load, no one-hot
decomposition (see its note). `limbs` keeps the TPU kernel's value-width
contract: values of x must fit 8 * limbs bits, which the plain version
checks; an index outside [0, S) gives 0, as the TPU's one-hot does at
limbs 1 (at limbs 2-3 the Pallas kernel returns its limb bias there; no
caller passes such an index).
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "tpu_snappy_torch/ops/kernels/csrc/gather.cu"
REPLACES = "tpu_snappy/ops/pallas/gather.py:107"

MAX_LIMBS = 3


def _check_limbs(limbs: int) -> None:
    if not 1 <= limbs <= MAX_LIMBS:
        raise ValueError(f"gather_block: limbs {limbs} (1 to {MAX_LIMBS})")


def gather_block_plain(x: torch.Tensor, idx: torch.Tensor,
                       limbs: int = 2) -> torch.Tensor:
    """Plain PyTorch form: (B, T) int32. Raises ValueError when a value of
    x does not fit 8 * limbs bits (the TPU kernel would drop its high
    limbs)."""
    _check_limbs(limbs)
    s = x.shape[-1]
    if x.numel() and (int(x.min()) < 0 or int(x.max()) >> (8 * limbs)):
        raise ValueError(f"gather_block: table values exceed {8 * limbs} "
                         f"bits (limbs={limbs})")
    inside = (idx >= 0) & (idx < s)
    got = torch.gather(x, -1, torch.clamp(idx, 0, max(s - 1, 0)).long())
    return torch.where(inside, got, 0).to(torch.int32)


def gather_block(x: torch.Tensor, idx: torch.Tensor,
                 limbs: int = 2) -> torch.Tensor:
    """Gather (B, T) int32 `idx` positions from the (B, S) int32 table `x`,
    row by row. Returns (B, T) int32. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _check_limbs(limbs)
    if _build.on_cpu(x, idx):
        return gather_block_plain(x, idx, limbs)
    batch, s = x.shape
    t = idx.shape[-1]
    _build.require(x, torch.int32, (batch, s), "x")
    _build.require(idx, torch.int32, (batch, t), "idx")
    out = torch.empty((batch, t), dtype=torch.int32, device=x.device)
    _build.require_aligned("gather_block", x, idx, out)
    if batch and t:
        rc = _build.lib().snk_gather(x.data_ptr(), idx.data_ptr(),
                                     out.data_ptr(), s, t, limbs, batch,
                                     _build.stream())
        _build.check(rc, "gather_block")
        gather_block.launches += 1
    return out


gather_block.launches = 0
