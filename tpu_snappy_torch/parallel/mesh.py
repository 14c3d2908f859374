"""Device mesh for data-parallel block sharding (port of
tpu_snappy/parallel/mesh.py).

Snappy's 64 KB blocks are independent by the format's definition, so the
mesh is one data-parallel axis: every shard encodes or decodes a
contiguous run of rows on its own device, and the only communication is
the gather of the (offset, length) manifest and of the payload across
processes (parallel/shard.py). A mesh is this process's shards (one
torch.device each, in shard order; a device may appear more than once,
so several shards can share one card) and, across processes, the
torch.distributed group that joins them. Shard g of a mesh lives in process g // local
shards, which owns the g-th contiguous part of the rows.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: this process's shards, in shard order. group: the
    torch.distributed process group across which the mesh spans, or None
    in one process."""
    devices: tuple
    group: object = None

    @property
    def world(self) -> int:
        """Processes the mesh spans."""
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This process's place in the group (0 in one process)."""
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Global shard count: the processes times the local shards."""
        return self.world * len(self.devices)


def make_mesh(n_devices: int | None = None, *, device="cuda",
              group=None) -> Mesh:
    """A 1-D mesh of n_devices local shards.

    device "cuda": the first n_devices visible cards (default all), as the
    JAX package takes jax.devices()[:n]; raises when no card is visible or
    too few are. device "cpu", or one indexed device such as "cuda:0":
    n_devices shards on it (default 1); "cpu" plays the virtual host
    devices the JAX tests force. A sequence of devices: those shards, in
    order (n_devices takes the first n). group: the torch.distributed
    group the mesh spans (multihost.global_mesh passes the world)."""
    if isinstance(device, (list, tuple)):
        devs = tuple(torch.device(d) for d in device)
        if n_devices is not None:
            devs = devs[:n_devices]
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            count = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            n = count if n_devices is None else n_devices
            if not count or n > count:
                raise RuntimeError(f"mesh of {n} CUDA devices: {count} "
                                   "visible; pass device='cpu' for "
                                   "virtual CPU shards")
            devs = tuple(torch.device("cuda", i) for i in range(n))
        else:
            devs = (dev,) * (1 if n_devices is None else n_devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "for virtual CPU shards")
    return Mesh(devs, group)


def shard_rows(mesh: Mesh, n_rows: int) -> list:
    """(device, rows slice) of each of this process's shards: the mesh
    splits the leading axis into mesh.size equal contiguous parts (the
    JAX PartitionSpec("dp", None)), and n_rows must be a multiple of
    mesh.size."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split over {mesh.size} "
                         "shards; pad them")
    per = n_rows // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [(d, slice((first + i) * per, (first + i + 1) * per))
            for i, d in enumerate(mesh.devices)]
