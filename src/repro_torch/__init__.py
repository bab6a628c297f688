"""PyTorch/CUDA port of the ``repro`` package, slice by slice.

The JAX package under ``src/repro`` stays the reference; this package holds
the same modules for PyTorch, with every Pallas kernel on the ported path
rewritten as a hand-written CUDA kernel for Hopper (``csrc/``).  It imports
``torch`` and numpy only: never ``jax`` and nothing of ``repro``.

Entry points (``models.registry.build_model``, ``serve.PagedServeEngine``,
``launch.serve``) run on the GPU unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper computes its plain PyTorch version.
"""
