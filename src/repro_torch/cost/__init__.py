"""``repro_torch.cost`` -- the analytic cost model.

Port of the JAX package's ``repro.cost``:

* :mod:`repro_torch.cost.model` -- per-kernel pricing (FLOPs + memory
  traffic + on-chip footprint per
  :class:`~repro_torch.bench.config.BlockConfig`) over named
  :class:`~repro_torch.roofline.hw.HardwareProfile` s (``h100_sxm`` on the
  card, ``cpu`` on the plain path; ``$REPRO_TORCH_HW_PROFILE`` selects).
  The autotuner ranks each tune space with it and times only the
  cheapest-predicted top-K.
* :mod:`repro_torch.cost.graph` -- graph-level pricing: a fusion
  clustering is priced by predicted intermediate traffic
  (:func:`repro_torch.graph.plan.memory_report`); :func:`select_passes`
  keeps a rewrite only if the model predicts a traffic win.
* :mod:`repro_torch.cost.schedule` -- the chosen pass subset persists in
  the same :class:`~repro_torch.bench.config.ConfigCache` as tuned kernel
  tiles, keyed by a stable graph signature.

:func:`plan_graph` is the one-call entry the graph compiler uses:
signature -> cache lookup -> (on miss) cost-driven selection -> store.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..graph.ir import Graph
from ..graph.passes import run_passes
from ..roofline.hw import (HardwareProfile, all_profiles,  # noqa: F401
                           get_profile, register_profile)
from .graph import (GraphCostEstimate, PassDecision,  # noqa: F401
                    ScheduleDecision, candidate_passes, estimate_graph,
                    per_pass_table, select_passes)
from .model import (OVERLAP_LEAK, SPILL_PENALTY, CostEstimate,  # noqa: F401
                    combine_times, estimate_kernel, rank_candidates)
from .schedule import (SCHEDULE_KERNEL, graph_signature,  # noqa: F401
                       lookup_schedule, store_schedule)


def plan_graph(g: Graph, *, profile: Optional[HardwareProfile] = None,
               names: Optional[Sequence[str]] = None,
               cache=None, use_cache: bool = True) -> ScheduleDecision:
    """Fuse ``g`` under the cost model, consulting the schedule cache.

    On a cache hit the stored kept-pass subset is replayed (no per-pass
    re-estimation); on a miss :func:`select_passes` derives the schedule
    and persists it.  Mutates ``g`` like :func:`run_passes` and returns
    the :class:`ScheduleDecision` (``.cached`` marks hits).
    """
    prof = profile if profile is not None else get_profile()
    sig = graph_signature(g)
    if use_cache and names is None:
        cached = lookup_schedule(sig, cache)
        if cached is not None:
            unfused = estimate_graph(g, profile=prof)
            g = run_passes(g, cached)
            return ScheduleDecision(
                graph_name=g.name, signature=sig, passes=list(cached),
                decisions=[], unfused=unfused,
                fused=estimate_graph(g, profile=prof), cached=True)
    decision = select_passes(g, names=names, profile=prof, signature=sig)
    if use_cache and names is None:
        store_schedule(decision, cache)
    return decision
