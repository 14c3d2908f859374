"""Multi-payload forward fill from the latest set mask position.

Port of tpu_snappy/ops/pallas/ffill.py:ffill_block, with its `max_gap`
(the framed sidecar's split mode passes it), for any number of payloads;
the CUDA kernel is csrc/ffill.cu: each row is cut into chunks
(`fill_chunk`), a first pass writes each chunk's latest set index, and a
second max-scans each chunk from the carry of the earlier chunks and
gathers the payloads, up to LAUNCH_PAYLOADS of them a launch (see its
note; more payloads take one second-pass launch for each group of four,
all reading the first pass's indices). Positions before the first set
mask keep their own entry, and so does a position whose latest set mask
lies `fill_window(max_gap, m)` or more positions behind it.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "tpu_snappy_torch/ops/kernels/csrc/ffill.cu"
REPLACES = "tpu_snappy/ops/pallas/ffill.py:70"

#: Payloads one fill launch gathers (csrc/ffill.cu's kLaunchPayloads).
LAUNCH_PAYLOADS = 4


def fill_window(max_gap: int | None, m: int) -> int:
    """How far back a fill reaches: the TPU kernel runs L = max(1,
    bit_length(gap - 1)) Hillis-Steele levels (gap = max_gap, or the width
    m without one), which fill position i from its latest set mask j only
    when i - j < 2^L. Returns 2^L."""
    gap = m if max_gap is None else int(max_gap)
    return 1 << max(1, (gap - 1).bit_length())


def ffill_plain(mask: torch.Tensor, vals: tuple,
                max_gap: int | None = None) -> tuple:
    """Plain PyTorch fill: last[i] = latest j <= i with mask[j], and
    out[i] = v[last[i]] where i - last[i] < fill_window(max_gap, m), else
    v[i] (also where there is no such j), along the last axis."""
    m = mask.shape[-1]
    idx = torch.arange(m, dtype=torch.int64,
                       device=mask.device).expand(mask.shape)
    last = torch.where(mask, idx, -1).cummax(dim=-1).values
    near = (last >= 0) & (idx - last < fill_window(max_gap, m))
    take = torch.where(near, last, idx)
    return tuple(torch.gather(v, -1, take) for v in vals)


#: Positions of one fill segment (256 threads x 4); a chunk is 1, 2 or 4
#: segments.
SEGMENT = 1024
CHUNKS = (4 * SEGMENT, 2 * SEGMENT, SEGMENT)
#: Blocks ffill aims for: four on each SM.
FILL_BLOCKS = 4 * _build.SMS
#: Widths the kernel takes are multiples of this (the TPU kernel's rule).
WIDTH_UNIT = 128


def fill_chunk(batch: int, m: int) -> int:
    """Positions of one ffill chunk: the largest of CHUNKS whose grid
    (batch x chunks a row) reaches FILL_BLOCKS, else the smallest. At 126
    or 128 rows of 57344 or 65536 that is 4096 (1764 to 2048 blocks); at 2
    rows of 65536, 1024 (128 blocks)."""
    for chunk in CHUNKS:
        if batch * -(-m // chunk) >= FILL_BLOCKS:
            return chunk
    return CHUNKS[-1]


def ffill(mask: torch.Tensor, vals: tuple, chunk: int | None = None,
          max_gap: int | None = None) -> tuple:
    """Fill each (B, M) int32 payload in `vals` (one or more) from the
    latest position where the (B, M) bool `mask` holds (M a multiple of
    128). max_gap: the TPU kernel's bound on the distance to that position
    (None: the whole row); a position farther from it keeps its own entry
    (fill_window). CPU tensors take the plain version; CUDA tensors launch
    the kernel, with `fill_chunk`'s chunk unless `chunk` (one of CHUNKS) is
    given."""
    vals = tuple(vals)
    m = mask.shape[-1]
    if not vals:
        raise ValueError("ffill takes at least one payload")
    if m % WIDTH_UNIT:
        raise ValueError(f"ffill: width {m} is not a multiple of "
                         f"{WIDTH_UNIT}")
    if chunk is not None and chunk not in CHUNKS:
        raise ValueError(f"ffill: chunk {chunk} (one of {CHUNKS})")
    if _build.on_cpu(mask, *vals):
        return ffill_plain(mask, vals, max_gap)
    batch = mask.shape[0]
    chunk = fill_chunk(batch, m) if chunk is None else chunk
    _build.require(mask, torch.bool, (batch, m), "mask")
    for v in vals:
        _build.require(v, torch.int32, (batch, m), "payload")
    _build.require_aligned("ffill", mask, *vals)
    outs = tuple(torch.empty_like(v) for v in vals)
    if batch and m:
        last = torch.empty((batch, -(-m // chunk)), dtype=torch.int32,
                           device=mask.device)
        window = min(fill_window(max_gap, m), 1 << 30)
        for g in range(0, len(vals), LAUNCH_PAYLOADS):
            # The first group's launch also writes `last`; the others
            # read it.
            ins = [v.data_ptr() for v in vals[g:g + LAUNCH_PAYLOADS]]
            pad = [None] * (LAUNCH_PAYLOADS - len(ins))
            ptrs = [o.data_ptr() for o in outs[g:g + LAUNCH_PAYLOADS]]
            rc = _build.lib().snk_ffill(
                mask.data_ptr(), *ins, *pad, *ptrs, *pad, last.data_ptr(),
                len(ins), int(g == 0), m, chunk, window, batch,
                _build.stream())
            _build.check(rc, "ffill")
        ffill.launches += 1
    return outs


ffill.launches = 0
