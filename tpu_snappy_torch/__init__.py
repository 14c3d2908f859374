"""tpu_snappy_torch: the PyTorch / CUDA port of tpu_snappy.

The JAX package `tpu_snappy` stays the reference; this package produces
byte-identical Snappy streams on an NVIDIA H100 through hand-written CUDA
kernels (ops/kernels/csrc/), with plain PyTorch versions of each kernel
for the CPU. It imports `torch`, never `jax`; the framework-free modules
of `tpu_snappy` (format, config, reference_codec, native) are shared.

Entry points: `tpu_snappy_torch.api.compress` / `decompress`.
"""
