"""Hand-written Hopper kernels (``csrc/``) behind PyTorch wrappers.

Per family: ``ref.py`` holds the plain PyTorch version (the CPU path and
the oracle the kernel is held to), ``ops.py`` the wrapper, which launches
the CUDA kernel for CUDA tensors and computes the plain version only for
CPU tensors.  ``_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` at first
use and loads the result with ``ctypes``.
"""
