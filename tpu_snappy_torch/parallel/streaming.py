"""Streaming encode for inputs larger than device memory (port of
tpu_snappy/parallel/streaming.py).

Snappy's 64 KB window makes streaming simple: the input goes through in
waves of whole blocks, each wave sharded over the mesh, and each wave's
output, put in block order from its manifest, is appended to the sink.
The output is one standard Snappy stream (one varint preamble), the same
bytes as shard.encode_dp on the whole input at any wave size. Two waves
are in flight: while a worker thread fetches and writes wave k, the main
thread reads wave k+1 into a pinned staging buffer, copies it to the
devices without blocking and encodes it. Across processes the wave's
manifest and payload gathers are the only synchronisation; they all run
on the worker thread, in wave order, so every process issues them in
the same order. A wave boundary is also the resume point.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import BinaryIO

import torch

from .. import api
from .. import format as fmt
from ..config import CodecConfig, DEFAULT_CONFIG
from . import mesh as meshlib
from . import shard


@dataclasses.dataclass
class StreamStats:
    in_bytes: int = 0
    out_bytes: int = 0
    waves: int = 0

    @property
    def ratio(self) -> float:
        return self.in_bytes / max(1, self.out_bytes)


def compress_stream(src: BinaryIO, dst: BinaryIO, total_len: int, mesh=None,
                    blocks_per_wave: int | None = None,
                    cfg: CodecConfig = DEFAULT_CONFIG,
                    resume: StreamStats | None = None, *,
                    device="cuda") -> StreamStats:
    """Compress `total_len` bytes from src to dst in double-buffered waves,
    sharded over `mesh` (default: make_mesh(device=device), every visible
    card).

    Resume: pass the StreamStats of an interrupted run (with src seeked to
    stats.in_bytes and dst positioned at stats.out_bytes) to continue;
    completed waves are never recomputed. A resume point that is not a
    whole number of waves raises ValueError; a short read raises IOError.
    """
    if mesh is None:
        mesh = meshlib.make_mesh(device=device)
    n_dev = mesh.size
    if blocks_per_wave is None:
        # One API wave (api.API_WAVE blocks, 8 MiB) a shard: the wave the
        # port's kernels are sized for on one card.
        blocks_per_wave = api.API_WAVE * n_dev
    # Every shard's share must be a whole number of its encode waves.
    jwave, blocks_per_wave = shard.layout(blocks_per_wave, n_dev)
    wave_bytes = blocks_per_wave * cfg.block_size

    if resume is not None:
        if resume.in_bytes % wave_bytes:
            raise ValueError("resume point must be a whole number of waves")
        stats = StreamStats(resume.in_bytes, resume.out_bytes, resume.waves)
    else:
        stats = StreamStats()
        dst.write(fmt.varint_encode(total_len))
        stats.out_bytes += fmt.varint_size(total_len)

    # Two staging buffers, pinned where a shard is on a card, so the copy
    # to the device does not block the host; a buffer is refilled two
    # waves later, after its wave's encode has read it.
    pin = any(d.type == "cuda" for d in mesh.devices)
    staging = [torch.empty((blocks_per_wave, fmt.BLOCK_SIZE),
                           dtype=torch.uint8, pin_memory=pin)
               for _ in range(2 if total_len > stats.in_bytes else 0)]

    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        k = 0
        remaining = total_len - stats.in_bytes
        while remaining > 0:
            take = min(wave_bytes, remaining)
            buf = src.read(take)
            if len(buf) != take:
                raise IOError("short read from source")
            remaining -= take
            stage = staging[k % 2]
            _, lengths, nblocks = shard.blocks_of(
                buf, cfg.block_size, blocks_per_wave, out=stage.numpy())
            shards, _ = shard.encode_local(mesh, stage, lengths, cfg, jwave)
            if fut is not None:
                fut.result()  # surface drain errors before queueing more
            fut = pool.submit(_drain, (shards, nblocks, take), dst, stats,
                              mesh)
            k += 1
        if fut is not None:
            fut.result()
    return stats


def _drain(pending, dst, stats: StreamStats, mesh) -> None:
    """Gather the wave's manifest, fetch its payload in block order and
    write it out."""
    shards, nblocks, take = pending
    lens_np = shard.gather_manifest(shards, mesh)
    for piece in shard.assemble_compact(shards, lens_np, nblocks, mesh):
        dst.write(piece)
        stats.out_bytes += len(piece)
    stats.in_bytes += take
    stats.waves += 1
