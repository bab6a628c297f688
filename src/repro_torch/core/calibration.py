"""Frozen calibration constants for the Level-A simulator.

Fitted ONCE against the (LeNet, RV64F) row of paper Table III
(IC = 44,310,154; mem-type = 19,288,578; IPC = 0.666; L1 = 23,071,838)
by ``benchmarks/calibrate.py``, then held fixed for every other
(model, ISA) cell so that all cross-ISA and cross-model enhancements are
structural predictions, not fits.
"""
from .pipeline import PipelineParams
from .program import CodegenParams

CODEGEN = CodegenParams(
    spills_per_ref=1,
    mv_per_ref=0,
    extra_alu_per_mac=20,
    schedule_loads=True,
)

PIPELINE = PipelineParams(
    load_use_penalty=1,
    branch_penalty=2,
    jump_penalty=1,
    int_mul_latency=2,
    int_div_latency=12,
    fp_latency=8,
    l1_hit_cycles=2,
    l1_miss_penalty=80,
    fetch_bytes=40,
    instr_bytes=4,
)
