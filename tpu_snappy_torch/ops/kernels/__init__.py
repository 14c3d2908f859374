"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

Each module holds one kernel's wrapper and its plain twin. A wrapper takes
the plain version for CPU tensors and launches the kernel for CUDA
tensors, counting launches in `<wrapper>.launches`. The library is built
by `_build` at first launch, never at import.
"""
