"""APR (Architectural Pipeline Register) — the accumulator-residency
abstraction.

The paper's APR is a register at the MEM/WB boundary that holds a running
reduction so partial sums never round-trip through the memory system.  On
an H100 the equivalent storage class is a register (or shared-memory)
accumulator that a CUDA block keeps across its whole reduction loop.
``AccumulatorSpec`` names that mapping explicitly so every kernel in
``repro_torch.kernels`` speaks the same vocabulary, and the traffic model
quantifies what residency buys — the Level-B analogue of paper Table III's
memory columns.

Residency classes:

* ``"apr"`` — the accumulator stays on chip for the whole reduction;
  HBM sees exactly one write per output element (the ``rfsmac.s`` flush).
* ``"hbm"`` — the accumulator round-trips through HBM on every reduction
  step (the ``fmac.s``/F-extension baseline: one load + one store of the
  partial per step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Tuple

Residency = Literal["apr", "hbm"]


@dataclasses.dataclass(frozen=True)
class AccumulatorSpec:
    """Shape/dtype/residency of one kernel's running accumulator."""

    shape: Tuple[int, ...]
    dtype: str = "float32"
    residency: Residency = "apr"

    @property
    def bytes(self) -> int:
        itemsize = {"float32": 4, "bfloat16": 2, "float16": 2}[self.dtype]
        return math.prod(self.shape) * itemsize


def reduction_hbm_traffic(
    out_elems: int,
    n_steps: int,
    out_bytes_per_elem: int,
    residency: Residency,
    acc_bytes_per_elem: int = 4,
) -> int:
    """HBM bytes attributable to the *accumulator* of a blocked reduction.

    ``apr``: one final write per output element.
    ``hbm``: one read + one write of the fp32 partial per reduction step,
    plus the final write — exactly the flw/fsw-per-MAC pattern of Fig. 1(a/b)
    lifted to block granularity.
    """
    final = out_elems * out_bytes_per_elem
    if residency == "apr":
        return final
    per_step = 2 * acc_bytes_per_elem * out_elems  # read + write each step
    return n_steps * per_step + final


def traffic_reduction(out_elems: int, n_steps: int, out_bytes: int = 2) -> float:
    """Fractional HBM-traffic saving of apr vs hbm residency (Table-III
    'memory access' analogue at kernel level)."""
    apr = reduction_hbm_traffic(out_elems, n_steps, out_bytes, "apr")
    hbm = reduction_hbm_traffic(out_elems, n_steps, out_bytes, "hbm")
    return 1.0 - apr / hbm
