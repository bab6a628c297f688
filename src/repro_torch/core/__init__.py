"""Level-A (paper-faithful RISC-V R-extension model) + the accumulator-
residency abstraction shared with the CUDA kernels (Level B).

A copy of the JAX package's ``core/``, which is pure Python: the port keeps
its own so it never imports the reference."""

from .isa import Isa, Kind, Instr  # noqa: F401
from .simulate import simulate_model, table3, enhancement, Metrics  # noqa: F401
