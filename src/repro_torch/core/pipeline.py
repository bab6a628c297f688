"""Cycle-level model of the paper's 5-stage in-order pipeline.

Models IF-ID-EX-MEM-WB with:

* single issue, in-order, full forwarding (EX->EX, MEM->EX),
* scoreboard-style stalls on RAW hazards against multi-cycle producers,
* 1-bubble load-use hazard (L1 hit data available at end of MEM),
* branches resolved in EX (taken => ``branch_penalty`` bubbles),
  unconditional jumps resolved in ID (``jump_penalty``),
* multi-cycle (pipelined) FP units with ``fp_latency`` result latency,
* the R-extension **rented pipeline**: ``rfmac.s`` multiplies in EX and
  accumulates into the APR in the rented R_EX (=MEM) stage.  The APR has a
  dedicated forwarding loop inside R_EX (paper Fig. 2), so back-to-back
  ``rfmac.s`` never stall on the accumulation dependency, and the FP-add
  latency of the accumulation is never exposed to the issue stream.
* ``rfsmac.s`` reads the APR during ID and resets it in MEM; it must wait
  for the last in-flight ``rfmac.s`` to have passed R_EX.

The simulator is trace-driven and exact for a given instruction stream.
``steady_state`` measures the converged cycles-per-iteration of a cyclic
loop body, which lets Table-III-scale workloads (10^9+ dynamic instructions)
be evaluated exactly at basic-block granularity instead of instruction by
instruction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

from .isa import Instr, Isa, Kind, instr_allowed

APR = "__apr__"  # symbolic register name for the architectural pipeline reg.


@dataclass(frozen=True)
class PipelineParams:
    """Microarchitectural constants (defaults align with paper Table II)."""

    load_use_penalty: int = 1      # bubbles for load -> immediately-dependent use
    branch_penalty: int = 2        # taken conditional branch, resolved in EX
    jump_penalty: int = 1          # unconditional jump, resolved in ID
    int_mul_latency: int = 3       # address-arithmetic integer multiply
    int_div_latency: int = 12      # unpipelined divider (j/S, k/S indexing)
    fp_latency: int = 8            # fmul.s / fadd.s / fmac.s result latency
    fp_store_latency: int = 1      # cycles before a produced FP value may be stored
    l1_hit_cycles: int = 2         # Table II: 2-cycle L1 latency
    l1_miss_penalty: int = 80      # DRAM round-trip (DDR3-1600, conservative)
    fetch_bytes: int = 32          # L1I fetch granularity per access
    instr_bytes: int = 4           # average encoded instruction size


def _producer_latency(instr: Instr, params: PipelineParams) -> int:
    """Cycles after issue at which ``instr``'s result is forwardable to EX."""
    k = instr.kind
    if k.is_load:
        return 1 + params.load_use_penalty
    if k == Kind.MUL:
        return params.int_mul_latency
    if k == Kind.DIV:
        return params.int_div_latency
    if k in (Kind.FMUL, Kind.FADD, Kind.FMAC):
        return params.fp_latency
    if k == Kind.RFMAC:
        # The register-file-visible result of rfmac.s is the APR, handled
        # separately; rfmac has no integer/FP destination register.
        return 1
    if k == Kind.RFSMAC:
        return 1  # rd is written from the APR during ID; available next cycle
    return 1


@dataclass
class SimResult:
    cycles: int
    instructions: int
    stall_cycles: int
    flush_cycles: int

    @property
    def ipc(self) -> float:
        return self.instructions / max(self.cycles, 1)


def simulate(
    stream: Sequence[Instr],
    params: PipelineParams = PipelineParams(),
    *,
    initial_ready: Dict[str, int] | None = None,
) -> Tuple[SimResult, Dict[str, int]]:
    """Exact in-order issue-time simulation of ``stream``.

    Returns the result plus the register-ready map at exit (relative to the
    final issue cycle) so that cyclic steady-state analysis can stitch
    iterations together.
    """
    ready: Dict[str, int] = dict(initial_ready or {})
    issue_prev = -1
    stalls = 0
    flushes = 0
    pending_redirect = 0  # extra bubbles imposed on the *next* instruction

    for instr in stream:
        earliest = issue_prev + 1 + pending_redirect
        pending_redirect = 0
        # RAW hazards via forwarding network.  Stores never stall on their
        # DATA operand (srcs[0]) — they wait in the store buffer and the
        # data is filled in when produced; a dependent reload instead
        # carries the producer in its own srcs (store-to-load forwarding).
        srcs = instr.srcs
        if instr.kind.is_store and len(srcs) >= 2:
            srcs = srcs[1:]
        for src in srcs:
            earliest = max(earliest, ready.get(src, 0))
        # APR consumption:
        if instr.kind == Kind.RFMAC:
            # accumulates in R_EX at issue+1; APR forward loop means the
            # constraint is apr_ready <= issue+1.
            earliest = max(earliest, ready.get(APR, 0) - 1)
        elif instr.kind == Kind.RFSMAC:
            # reads APR during ID (= issue cycle under this accounting).
            earliest = max(earliest, ready.get(APR, 0))
        stalls += max(0, earliest - (issue_prev + 1))
        issue = earliest

        if instr.dst is not None:
            ready[instr.dst] = issue + _producer_latency(instr, params)
        if instr.kind == Kind.RFMAC:
            ready[APR] = issue + 2  # after R_EX
        elif instr.kind == Kind.RFSMAC:
            ready[APR] = issue + 2  # reset completes in MEM

        if instr.kind == Kind.BRANCH and instr.taken:
            pending_redirect = params.branch_penalty
            flushes += params.branch_penalty
        elif instr.kind == Kind.JUMP:
            pending_redirect = params.jump_penalty
            flushes += params.jump_penalty

        issue_prev = issue

    total_cycles = issue_prev + 1 + pending_redirect  # drain ignored (amortised)
    # Normalise the ready map to be relative to the end of this stream.
    out_ready = {r: c - total_cycles for r, c in ready.items() if c > total_cycles}
    return (
        SimResult(
            cycles=total_cycles,
            instructions=len(stream),
            stall_cycles=stalls,
            flush_cycles=flushes,
        ),
        out_ready,
    )


def steady_state_cycles(
    block: Sequence[Instr],
    params: PipelineParams = PipelineParams(),
    *,
    warmup_reps: int = 6,
    measure_reps: int = 4,
) -> float:
    """Converged cycles per iteration of a cyclic basic block.

    Simulates ``warmup_reps + measure_reps`` repetitions and returns the
    marginal cycles of the measured repetitions; exact for loop-carried
    dependency chains expressed through register names.
    """
    if not block:
        return 0.0
    reps = warmup_reps + measure_reps

    def run(n: int) -> int:
        stream: List[Instr] = []
        for _ in range(n):
            stream.extend(block)
        res, _ = simulate(stream, params)
        return res.cycles

    c_all = run(reps)
    c_warm = run(warmup_reps)
    return (c_all - c_warm) / measure_reps


def validate_stream(stream: Iterable[Instr], isa: Isa) -> None:
    """Assert that every instruction in the stream exists under ``isa``."""
    for instr in stream:
        if not instr_allowed(instr.kind, isa):
            raise ValueError(f"{instr.kind.value} is not available under {isa.pretty}")
