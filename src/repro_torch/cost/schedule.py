"""Whole-graph schedule caching: ConfigCache entries keyed by graph shape.

A copy of the JAX package's ``repro.cost.schedule``, over the port's
:class:`~repro_torch.bench.config.ConfigCache` (``$REPRO_TORCH_TUNE_CACHE``).

Choosing a fusion clustering costs a pass sweep plus a traffic estimate
per candidate rewrite; an engine that compiles the same prefill/decode
graphs at every start-up should pay that once.  This module persists a
:class:`~repro_torch.cost.graph.ScheduleDecision`'s kept-pass subset in the same
:class:`~repro_torch.bench.config.ConfigCache` that holds tuned kernel tiles, so
engines warm graph schedules exactly like block configs (scoped per
engine, JSON on disk, ``kernel|shape|dtype|backend`` keys).

Key scheme::

    __graph_schedule__|<graph signature>|-|any

The **graph signature** is a sha256 over the traced (pre-fusion) graph's
canonical structure: per value its (id, shape, dtype, kind), per node its
(op, attr names+reprs, input ids, output ids), plus the graph's I/O lists.
Const *values* are excluded — two engines with different weights but the
same architecture share a schedule — while const shapes/dtypes are
included, so e.g. an int8-quantized variant (whose weight consts are int8
and feed ``fold_quant_dequant``) signs differently from the fp32 one.
Value/node ids are deterministic tracing artifacts, and no attribute holds
a tensor or an object whose ``repr`` carries an address, which makes the
signature stable across processes for the same model geometry
(``tests/test_torch_graph_trace.py``).

The cached entry is a :class:`~repro_torch.bench.config.BlockConfig` mapping
every candidate pass name to 0/1.  A lookup whose stored pass vocabulary
differs from the current registry (a pass added or renamed since the cache
was written) is treated as a miss and re-derived — never half-applied.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

from ..bench.config import BlockConfig, ConfigCache, active_cache
from ..graph.ir import Graph
from .graph import ScheduleDecision, candidate_passes

SCHEDULE_KERNEL = "__graph_schedule__"
_DTYPE = "-"
_BACKEND = "any"


def graph_signature(g: Graph) -> str:
    """Stable content hash of a traced graph's structure (not its consts)."""
    h = hashlib.sha256()
    for vid in sorted(g.values):
        v = g.values[vid]
        h.update(f"v{v.id}:{tuple(v.shape)}:{v.dtype}:{v.kind};".encode())
    for n in g.nodes:
        attrs = ",".join(f"{k}={n.attrs[k]!r}" for k in sorted(n.attrs))
        h.update(f"n{n.op}({attrs})<{n.inputs}>{n.outputs};".encode())
    h.update(f"in{tuple(g.inputs)}out{tuple(g.outputs)}".encode())
    return h.hexdigest()


def store_schedule(decision: ScheduleDecision,
                   cache: Optional[ConfigCache] = None) -> None:
    """Persist ``decision`` under its signature in ``cache`` (default: the
    active scoped cache, i.e. the engine's own tune cache)."""
    cache = cache if cache is not None else active_cache()
    vocab = candidate_passes()
    cfg = BlockConfig.make(
        **{name: int(name in decision.passes) for name in vocab})
    cache.store(SCHEDULE_KERNEL, decision.signature, _DTYPE, _BACKEND, cfg,
                metrics={
                    "traffic_unfused": float(
                        decision.unfused.intermediate_traffic),
                    "traffic_fused": float(
                        decision.fused.intermediate_traffic),
                    "predicted_us": decision.fused.predicted_us,
                })


def lookup_schedule(signature: str,
                    cache: Optional[ConfigCache] = None
                    ) -> Optional[List[str]]:
    """The cached kept-pass list for ``signature`` in application order, or
    None on miss / stale pass vocabulary."""
    cache = cache if cache is not None else active_cache()
    cfg = cache.lookup(SCHEDULE_KERNEL, signature, _DTYPE, _BACKEND)
    if cfg is None:
        return None
    vocab = candidate_passes()
    if set(cfg.to_dict()) != set(vocab):
        return None    # schedule written against a different pass registry
    return [name for name in vocab if cfg[name]]
