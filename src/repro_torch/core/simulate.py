"""Table-III evaluation: (model x ISA) -> runtime / IC / IPC / mem / L1.

The evaluator walks the loop-nest IR from ``program.py``.  Per loop level it
measures the converged cycles-per-iteration of that level's own instruction
stream with the exact pipeline model (``pipeline.steady_state_cycles``) and
multiplies by trip counts; dynamic instruction counts are exact.  Cache
effects are added from the analytic model in ``cache.py``.

This basic-block-granularity evaluation is *exact* for the pipeline term
(the streams are cyclic and the simulator converges to the true steady
state) and lets the 4x10^9-instruction ResNet/MobileNet rows of Table III be
reproduced in milliseconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Tuple

from . import calibration
from .cache import data_misses, instruction_accesses
from .isa import Instr, Isa, Kind
from .pipeline import PipelineParams, steady_state_cycles, validate_stream
from .program import CodegenParams, Layer, LoopNode, build_nest
from .workloads import MODELS

CLOCK_HZ = 1_000_000_000  # Table II: 1 GHz


@dataclass
class Counts:
    instructions: int = 0
    mem_instrs: int = 0
    cycles: float = 0.0
    redirects: int = 0          # taken control-flow transfers (L1I refetches)
    instr_bytes: int = 0

    def add(self, other: "Counts") -> None:
        self.instructions += other.instructions
        self.mem_instrs += other.mem_instrs
        self.cycles += other.cycles
        self.redirects += other.redirects
        self.instr_bytes += other.instr_bytes


def _block_stats(block: Tuple[Instr, ...], params: PipelineParams) -> Tuple[float, int, int, int]:
    """(cycles/iter, mem instrs, redirects, bytes) for one cyclic block."""
    cyc = steady_state_cycles(list(block), params)
    mem = sum(1 for i in block if i.is_mem)
    red = sum(1 for i in block if i.kind == Kind.JUMP or (i.kind == Kind.BRANCH and i.taken))
    nbytes = len(block) * params.instr_bytes
    return cyc, mem, red, nbytes


class _BlockCache:
    """Steady-state results keyed by the block's structural identity."""

    def __init__(self, params: PipelineParams):
        self.params = params
        self._memo: Dict[Tuple, Tuple[float, int, int, int]] = {}

    def stats(self, block: List[Instr]) -> Tuple[float, int, int, int]:
        key = tuple((i.kind, i.dst, i.srcs, i.taken) for i in block)
        if key not in self._memo:
            self._memo[key] = _block_stats(tuple(block), self.params)
        return self._memo[key]


def _eval_node(node: LoopNode, cache: _BlockCache) -> Counts:
    out = Counts()
    own = node.own_stream()
    cyc, mem, red, nbytes = cache.stats(own)
    out.instructions = len(own) * node.trips
    out.mem_instrs = mem * node.trips
    out.cycles = cyc * node.trips
    out.redirects = red * node.trips
    out.instr_bytes = nbytes * node.trips
    for child in node.children:
        c = _eval_node(child, cache)
        # the child body runs once per iteration of this level
        out.instructions += c.instructions * node.trips
        out.mem_instrs += c.mem_instrs * node.trips
        out.cycles += c.cycles * node.trips
        out.redirects += c.redirects * node.trips
        out.instr_bytes += c.instr_bytes * node.trips
    return out


@dataclass
class Metrics:
    """One Table III row."""

    model: str
    isa: Isa
    runtime_s: float
    instructions: int
    ipc: float
    mem_instrs: int
    l1_accesses: int
    d_misses: int = 0

    def as_row(self) -> Dict[str, float]:
        return {
            "model": self.model,
            "isa": self.isa.pretty,
            "runtime_s": round(self.runtime_s, 4),
            "IC": self.instructions,
            "IPC": round(self.ipc, 3),
            "mem_instrs": self.mem_instrs,
            "l1_accesses": self.l1_accesses,
        }


def simulate_model(
    model: str,
    isa: Isa,
    *,
    codegen: CodegenParams | None = None,
    pipeline: PipelineParams | None = None,
) -> Metrics:
    codegen = codegen or calibration.CODEGEN
    pipeline = pipeline or calibration.PIPELINE
    layers: List[Layer] = MODELS[model]()
    cache = _BlockCache(pipeline)

    total = Counts()
    d_misses = 0
    for layer in layers:
        nest = build_nest(layer, isa, codegen)
        validate_stream(nest.own_stream(), isa)
        total.add(_eval_node(nest, cache))
        d_misses += data_misses(layer)

    cycles = total.cycles + d_misses * pipeline.l1_miss_penalty
    i_acc = instruction_accesses(total.instr_bytes, total.redirects, pipeline.fetch_bytes)
    return Metrics(
        model=model,
        isa=isa,
        runtime_s=cycles / CLOCK_HZ,
        instructions=total.instructions,
        ipc=total.instructions / max(cycles, 1.0),
        mem_instrs=total.mem_instrs,
        l1_accesses=total.mem_instrs + i_acc,
        d_misses=d_misses,
    )


def table3(models: Tuple[str, ...] = ("lenet", "resnet20", "mobilenet_v1")) -> List[Metrics]:
    rows: List[Metrics] = []
    for model in models:
        for isa in (Isa.RV64F, Isa.BASELINE, Isa.RV64R):
            rows.append(simulate_model(model, isa))
    return rows


def enhancement(base: Metrics, new: Metrics) -> Dict[str, float]:
    """Paper-style enhancement percentages of ``new`` over ``base``."""
    return {
        "runtime": 100.0 * (base.runtime_s - new.runtime_s) / base.runtime_s,
        "IC": 100.0 * (base.instructions - new.instructions) / base.instructions,
        "IPC": 100.0 * (new.ipc - base.ipc) / base.ipc,
        "mem_instrs": 100.0 * (base.mem_instrs - new.mem_instrs) / base.mem_instrs,
        "l1_accesses": 100.0 * (base.l1_accesses - new.l1_accesses) / base.l1_accesses,
    }
