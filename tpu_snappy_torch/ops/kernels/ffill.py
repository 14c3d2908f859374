"""Multi-payload forward fill from the latest set mask position.

Port of tpu_snappy/ops/pallas/ffill.py:ffill_block (without `max_gap`,
which only the framed sidecar uses); the CUDA kernel is csrc/ffill.cu (a
block-wide max-scan of set indices, then one gather per payload, see its
note). Positions before the first set mask keep their own entry.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "tpu_snappy_torch/ops/kernels/csrc/ffill.cu"
REPLACES = "tpu_snappy/ops/pallas/ffill.py:70"

MAX_PAYLOADS = 4


def ffill_plain(mask: torch.Tensor, vals: tuple) -> tuple:
    """Plain PyTorch fill: last[i] = latest j <= i with mask[j], and
    out[i] = v[last[i]] (v[i] where there is none), along the last axis."""
    idx = torch.arange(mask.shape[-1], dtype=torch.int64,
                       device=mask.device).expand(mask.shape)
    last = torch.where(mask, idx, -1).cummax(dim=-1).values
    take = torch.where(last >= 0, last, idx)
    return tuple(torch.gather(v, -1, take) for v in vals)


def ffill(mask: torch.Tensor, vals: tuple) -> tuple:
    """Fill each (B, M) int32 payload in `vals` (1 to 4 of them) from the
    latest position where the (B, M) bool `mask` holds. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    vals = tuple(vals)
    if _build.on_cpu(mask, *vals):
        return ffill_plain(mask, vals)
    if not 1 <= len(vals) <= MAX_PAYLOADS:
        raise ValueError(f"ffill takes 1 to {MAX_PAYLOADS} payloads")
    batch, m = mask.shape
    _build.require(mask, torch.bool, (batch, m), "mask")
    for v in vals:
        _build.require(v, torch.int32, (batch, m), "payload")
    outs = tuple(torch.empty_like(v) for v in vals)
    if batch and m:
        pad = [None] * (MAX_PAYLOADS - len(vals))
        ins = [v.data_ptr() for v in vals] + pad
        ptrs = [o.data_ptr() for o in outs] + pad
        rc = _build.lib().snk_ffill(mask.data_ptr(), *ins, *ptrs, len(vals),
                                    m, batch, _build.stream())
        _build.check(rc, "ffill")
        ffill.launches += 1
    return outs


ffill.launches = 0
