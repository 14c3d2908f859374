"""Block data-parallelism of the port: a mesh of devices (parallel.mesh),
the sharded codec (shard), the wave-streamed encode (streaming) and the
multi-process entry points over torch.distributed (multihost)."""
