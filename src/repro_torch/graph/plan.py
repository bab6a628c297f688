"""APR-style memory planner: graph-level traffic accounting + arena reuse.

A copy of the JAX package's ``repro.graph.plan``.  Two planners, both
analytic (backend-independent, like the Table-III models in
``repro_torch.core.apr``):

* :func:`memory_report` — the paper's "memory access frequency" metric at
  graph granularity: every intermediate value that materializes costs one
  write (producer flush) plus one read per consumer.  Fusion removes
  cluster-internal values from the count entirely — they live in the
  producer's register tile, the graph-level APR.  Comparing the report
  before/after fusion is the graph compiler's headline number.

* :func:`arena_plan` — for the intermediates that still materialize, a
  first-fit offset assignment over liveness intervals (value live from its
  producing node to its last consuming node), so unfused intermediates
  reuse one arena the way freed KV pages are re-rented.  ``arena_bytes``
  (the plan's high-water mark) vs ``naive_bytes`` (every intermediate its
  own buffer) quantifies the reuse.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .ir import Graph

_ALIGN = 128  # arena offsets: the JAX planner's alignment, so plans compare


@dataclasses.dataclass
class MemoryReport:
    """Graph-level traffic accounting (bytes are analytic, not measured)."""
    n_nodes: int
    n_intermediates: int
    intermediate_bytes: int      # one write per materialized intermediate
    intermediate_traffic: int    # write + one read per consumer
    output_bytes: int
    const_bytes: int

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def memory_report(g: Graph) -> MemoryReport:
    consumers = g.consumers()
    inter = g.intermediates()
    traffic = 0
    for v in inter:
        n_reads = len(consumers.get(v.id, []))
        traffic += v.nbytes * (1 + n_reads)
    return MemoryReport(
        n_nodes=len(g.nodes),
        n_intermediates=len(inter),
        intermediate_bytes=sum(v.nbytes for v in inter),
        intermediate_traffic=traffic,
        output_bytes=sum(g.values[vid].nbytes for vid in g.outputs),
        const_bytes=g.const_bytes(),
    )


@dataclasses.dataclass
class ArenaPlan:
    """First-fit arena layout for the materializing intermediates."""
    offsets: Dict[int, Tuple[int, int]]  # value id -> (offset, size)
    arena_bytes: int                     # high-water mark of the layout
    naive_bytes: int                     # sum of all intermediate sizes

    @property
    def reuse_factor(self) -> float:
        return self.naive_bytes / max(self.arena_bytes, 1)


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def arena_plan(g: Graph) -> ArenaPlan:
    """Liveness-interval first-fit over the topological node order.

    A value is live from the step of its producing node through the step
    of its last consumer (graph outputs stay live to the end).  Offsets
    are assigned greedily at the lowest gap that fits among the blocks
    live at allocation time — the classic linear-scan register allocator,
    with HBM bytes in place of registers.
    """
    order = {n.id: i for i, n in enumerate(g.nodes)}
    consumers = g.consumers()
    last_use: Dict[int, int] = {}
    for n in g.nodes:
        for vid in n.outputs:
            ends = [order[c.id] for c in consumers.get(vid, [])]
            if vid in g.outputs:
                ends.append(len(g.nodes))
            last_use[vid] = max(ends, default=order[n.id])

    offsets: Dict[int, Tuple[int, int]] = {}
    live: List[Tuple[int, int, int]] = []  # (offset, size, end_step) blocks
    arena = 0
    naive = 0
    for n in g.nodes:
        step = order[n.id]
        live = [b for b in live if b[2] >= step]
        for vid in n.outputs:
            if vid in g.outputs:
                continue  # outputs are caller-owned, not arena blocks
            size = _align(g.values[vid].nbytes)
            naive += size
            # first-fit: lowest offset gap among live blocks that fits
            taken = sorted((off, off + sz) for off, sz, _ in live)
            off = 0
            for b0, b1 in taken:
                if off + size <= b0:
                    break
                off = max(off, b1)
            live.append((off, size, last_use[vid]))
            offsets[vid] = (off, size)
            arena = max(arena, off + size)
    return ArenaPlan(offsets=offsets, arena_bytes=arena, naive_bytes=naive)
