"""``repro_torch.cost`` -- the analytic cost model, kernel half.

Port of the kernel half of the JAX package's ``repro.cost``: per-kernel
pricing (FLOPs + memory traffic + on-chip footprint per
:class:`~repro_torch.bench.config.BlockConfig`) over named
:class:`~repro_torch.roofline.hw.HardwareProfile` s (``h100_sxm`` on the
card, ``cpu`` on the plain path; ``$REPRO_TORCH_HW_PROFILE`` selects).  The
autotuner ranks each tune space with it and times only the
cheapest-predicted top-K.  The graph half (``cost/graph.py``,
``schedule.py``, ``plan_graph``) waits for the graph compiler's port.
"""
from ..roofline.hw import (HardwareProfile, all_profiles,  # noqa: F401
                           get_profile, register_profile)
from .model import (OVERLAP_LEAK, SPILL_PENALTY, CostEstimate,  # noqa: F401
                    combine_times, estimate_kernel, rank_candidates)
