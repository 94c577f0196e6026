"""Hand-written CUDA kernels of the main path and their plain versions.

- ``ops``    wrappers: the kernel for CUDA tensors, ``ref`` for CPU ones
- ``ref``    plain PyTorch version of every kernel
- ``pack``   u8 residual + int32 base slab packing
- ``_build`` nvcc build and ctypes loading of ``csrc/*.cu``
"""
