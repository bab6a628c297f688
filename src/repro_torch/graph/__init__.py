"""repro_torch.graph — the rented-pipeline graph compiler, in PyTorch.

Port of the JAX package's ``repro.graph``.  The paper's APR keeps a
running reduction resident in a pipeline register so memory sees one
write per produced result; inside one kernel the port's CUDA kernels do
that, and *between* ops every intermediate still round-trips through
device memory.  This package is the same mechanism one level up:

* :mod:`repro_torch.graph.ir`     — the op-graph IR (values + nodes, the
  JAX compiler's vocabulary),
* :mod:`repro_torch.graph.trace`  — the tracer lowering PyTorch functions
  (``models/`` forwards, the paged serving step) into graphs,
* :mod:`repro_torch.graph.passes` — fusion passes (epilogues stay in the
  producer's register tile),
* :mod:`repro_torch.graph.plan`   — the memory-traffic planner + arena
  reuse plan,
* :mod:`repro_torch.graph.executor` — cluster-at-a-time executor, with
  dispatch of recognized epilogue clusters to the fused CUDA kernels,
* :mod:`repro_torch.graph.compiler` — the one-call entry points + compile
  cache, including ``PagedServeEngine(use_graph=True)``'s steps.
"""
from .compiler import (clear_compile_cache, compile_decode_step,  # noqa: F401
                       compile_fn, compile_prefill_step)
from .executor import GraphExecutor  # noqa: F401
from .ir import Graph, Node, Value  # noqa: F401
from .passes import (all_passes, default_passes, get_pass,  # noqa: F401
                     run_passes)
from .plan import arena_plan, memory_report  # noqa: F401
from .trace import ShapeSpec, trace  # noqa: F401
