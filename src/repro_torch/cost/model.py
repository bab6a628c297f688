"""Per-kernel analytic cost model: price a ``BlockConfig`` before timing it.

A copy of the JAX package's ``repro.cost.model``.  It combines the three
quantities every :class:`~repro_torch.bench.registry.KernelSpec` declares
-- analytic FLOPs, analytic memory traffic at a configuration, and
(optionally) the kernel's shared-memory footprint -- with a named
:class:`~repro_torch.roofline.hw.HardwareProfile`:

    t_compute = flops / profile.peak_flops
    t_memory  = hbm_bytes / profile.hbm_bw
    predicted = max(t_compute, t_memory) + OVERLAP_LEAK * min(t_c, t_m)

The ``OVERLAP_LEAK`` term models imperfect compute/memory overlap and makes
the prediction strictly monotone in traffic at fixed FLOPs, so the pruner
can order candidates that an exact roofline ``max()`` would tie.
Candidates whose footprint exceeds the profile's ceiling get a
multiplicative spill penalty proportional to the overflow, which sinks
them to the bottom of the ranking.

The model sees bytes and operations only: two tiles that move the same
bytes price the same, whatever the number of blocks they put on the
card's SMs.

Consumer: :func:`repro_torch.bench.autotune.autotune` ranks a tune space
with :func:`rank_candidates` and times only the cheapest-predicted top-K.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..roofline.hw import HardwareProfile, get_profile

#: Fraction of the non-dominant roofline term charged on top of the
#: dominant one (imperfect overlap); strictly positive by contract.
OVERLAP_LEAK = 0.15

#: Spill penalty per byte of on-chip overflow, relative to the ceiling.
SPILL_PENALTY = 4.0


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Analytic price of running one kernel candidate once."""

    kernel: str
    flops: float
    hbm_bytes: float
    t_compute_s: float
    t_memory_s: float
    predicted_s: float
    vmem_bytes: Optional[int]      # tile footprint, None if unmodelled
    vmem_ok: bool                  # footprint fits the profile's ceiling
    profile: str                   # HardwareProfile name used

    @property
    def predicted_us(self) -> float:
        return self.predicted_s * 1e6

    @property
    def dominant(self) -> str:
        return "compute" if self.t_compute_s >= self.t_memory_s else "memory"

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOP per byte of memory traffic."""
        return self.flops / max(self.hbm_bytes, 1.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["predicted_us"] = self.predicted_us
        d["dominant"] = self.dominant
        return d


def combine_times(t_compute: float, t_memory: float) -> float:
    """The roofline-with-leak combination."""
    hi, lo = max(t_compute, t_memory), min(t_compute, t_memory)
    return hi + OVERLAP_LEAK * lo


def estimate_kernel(spec, shape, config, *,
                    profile: Optional[HardwareProfile] = None,
                    dtype: Optional[str] = None) -> CostEstimate:
    """Price one ``(spec, shape, config)`` candidate on ``profile``.

    ``spec`` is duck-typed: anything with ``flops`` / ``hbm_bytes`` and an
    optional ``vmem_bytes``.  With ``dtype`` the traffic and footprint
    models are called with it (the port's specs take the operands' item
    size from it); without, they are called as the JAX package calls them.
    """
    prof = profile if profile is not None else get_profile()
    extra = () if dtype is None else (dtype,)
    flops = float(spec.flops(shape))
    hbm = float(spec.hbm_bytes(shape, config, *extra))
    t_c = flops / prof.peak_flops
    t_m = hbm / prof.hbm_bw
    predicted = combine_times(t_c, t_m)

    vmem = None
    vmem_ok = True
    vmem_model = getattr(spec, "vmem_bytes", None)
    if vmem_model is not None:
        vmem = int(vmem_model(shape, config, *extra))
        if vmem > prof.vmem_bytes:
            vmem_ok = False
            overflow = (vmem - prof.vmem_bytes) / prof.vmem_bytes
            predicted *= 1.0 + SPILL_PENALTY * overflow
    return CostEstimate(
        kernel=getattr(spec, "name", "?"),
        flops=flops, hbm_bytes=hbm,
        t_compute_s=t_c, t_memory_s=t_m, predicted_s=predicted,
        vmem_bytes=vmem, vmem_ok=vmem_ok, profile=prof.name,
    )


def rank_candidates(spec, shape, candidates: Sequence,
                    *, profile: Optional[HardwareProfile] = None,
                    dtype: Optional[str] = None,
                    ) -> List[Tuple[object, CostEstimate]]:
    """Order ``candidates`` cheapest-predicted first.

    The sort is stable on the original candidate order (ties keep the tune
    space's enumeration order), so pruning is deterministic run to run.
    """
    prof = profile if profile is not None else get_profile()
    priced = [(cfg, estimate_kernel(spec, shape, cfg, profile=prof,
                                    dtype=dtype))
              for cfg in candidates]
    return sorted(priced, key=lambda ce: ce[1].predicted_s)
