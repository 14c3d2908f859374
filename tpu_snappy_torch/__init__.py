"""tpu_snappy_torch: the PyTorch / CUDA port of tpu_snappy.

The JAX package `tpu_snappy` stays the reference; this package produces
byte-identical Snappy streams on an NVIDIA H100 through hand-written CUDA
kernels (ops/kernels/csrc/), with plain PyTorch versions of each kernel
for the CPU. It imports `torch`, never `jax`, and nothing of `tpu_snappy`:
it keeps its own copies of the framework-free modules (format, config,
reference_codec, native).

Entry points: `tpu_snappy_torch.api.compress` / `decompress` (raw
streams), `tpu_snappy_torch.framing.compress` / `decompress` (the framed
container with its decode sidecars), the data-parallel layer
`parallel.shard.encode_dp` / `decode_dp` over a `parallel.mesh` of
devices, `parallel.streaming.compress_stream`, `parallel.multihost`
(several processes over torch.distributed), the python-snappy surface
`compat`, the Hadoop container `hadoop` and the command line
`python -m tpu_snappy_torch`; on the CUDA card unless the caller passes
`device="cpu"` (`--device cpu`).
"""
