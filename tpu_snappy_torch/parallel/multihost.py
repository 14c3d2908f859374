"""Multi-process bootstrap and global-mesh codec entry points (port of
tpu_snappy/parallel/multihost.py).

Blocks are data-parallel over every shard of every process; each wave's
(offset, length) manifest and payload are all-gathered over
torch.distributed (gloo, on CPU tensors), and process 0 writes the
output in order. One process per card runs the cards side by side; two
processes may also share one card (each with its own shards on it), which
is how one machine with one card exercises the collective path.
"""

from __future__ import annotations

import torch.distributed as dist

from ..config import CodecConfig, DEFAULT_CONFIG
from . import mesh as meshlib
from . import shard
from . import streaming


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bring up the process group (idempotent), on the gloo backend.

    With no arguments it reads torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK); the explicit form suits manual
    bring-up:
        init_distributed("localhost:8476", num_processes=2, process_id=rank)
    """
    if dist.is_initialized():
        return
    if coordinator is None:
        dist.init_process_group("gloo", init_method="env://")
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id))


def global_mesh(*, device="cuda") -> meshlib.Mesh:
    """1-D data-parallel mesh over this process's shards of `device`
    (make_mesh's forms: "cuda" every visible card, "cuda:k" one card, a sequence of
    devices) and, once init_distributed ran, over every process of the
    world group. Processes that share a host pass each their own device,
    for example f"cuda:{local_rank}"."""
    group = dist.group.WORLD if dist.is_initialized() else None
    return meshlib.make_mesh(device=device, group=group)


def compress_multihost(src, dst, total_len: int,
                       blocks_per_wave: int | None = None,
                       cfg: CodecConfig = DEFAULT_CONFIG, *,
                       device="cuda") -> streaming.StreamStats:
    """Streaming encode over the global mesh.

    Every process must call this collectively with the same arguments;
    `src` must yield identical bytes on every process (shared filesystem),
    and only process 0's `dst` receives output (the others may pass any
    sink). The wave manifest and payload gathers are the only
    cross-process communication.
    """
    mesh = global_mesh(device=device)
    return streaming.compress_stream(
        src, dst if mesh.rank == 0 else _NullSink(), total_len, mesh,
        blocks_per_wave=blocks_per_wave, cfg=cfg)


class _NullSink:
    def write(self, b):
        return len(b)


def compress_dp_global(data: bytes, cfg: CodecConfig = DEFAULT_CONFIG, *,
                       device="cuda") -> bytes:
    """One-shot global-mesh compress (all processes call collectively);
    every process gets the whole stream."""
    return shard.encode_dp(data, global_mesh(device=device), cfg)
