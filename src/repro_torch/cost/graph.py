"""Graph-level cost model: price a fusion clustering by predicted traffic.

A copy of the JAX package's ``repro.cost.graph``.

A fusion clustering's value is exactly the paper's metric — how much
memory-access frequency it removes.  :func:`estimate_graph` prices any
:class:`~repro_torch.graph.ir.Graph` from the memory planner's accounting
(:func:`repro_torch.graph.plan.memory_report`: one write per materializing
intermediate plus one read per consumer, consts and outputs streamed once)
plus the analytic FLOPs of its contraction nodes, combined on a
:class:`~repro_torch.roofline.hw.HardwareProfile` with the same
roofline-with-leak rule as the kernel model.

:func:`select_passes` replaces the graph compiler's fixed pass-order
heuristic: it walks the registered ``@fusion_pass`` rewrites in canonical
order (``default_passes()`` first — order constraints like quant-folding-
before-epilogue are preserved — then any extra registrations), applies
each to the working graph, and **keeps a rewrite only if the model
predicts an HBM-traffic win** (strictly less intermediate traffic, or the
same traffic from strictly fewer clusters).  Every candidate subset of the
property-tested passes is output-preserving, so the greedy walk is legal
by construction; what it adds over the fixed pipeline is an auditable
per-pass traffic delta (`PassDecision`) and a stable
:class:`ScheduleDecision` artifact the schedule cache can persist.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..graph.ir import Graph
from ..graph.passes import all_passes, default_passes, get_pass
from ..graph.plan import memory_report
from ..roofline.hw import HardwareProfile, get_profile
from .model import combine_times

#: ops whose analytic FLOPs dominate a graph (2 * prod(contraction dims));
#: everything else is costed as memory traffic only.
_CONTRACTION_OPS = ("matmul", "quant_matmul", "conv2d")


def _node_flops(g: Graph, node) -> float:
    """Analytic FLOPs of one primitive node (fused clusters sum their
    bodies).  Contractions: 2 * output elements * reduction depth."""
    total = 0.0
    for n in node.body_nodes():
        if n.op not in _CONTRACTION_OPS:
            continue
        out = g.values.get(n.outputs[0])
        lhs = g.values.get(n.inputs[0]) if n.inputs else None
        if out is None or lhs is None:
            continue
        out_elems = 1
        for d in out.shape:
            out_elems *= int(d)
        if n.op == "conv2d":
            rhs = g.values.get(n.inputs[1])
            red = 1
            for d in (rhs.shape[:-1] if rhs is not None else ()):
                red *= int(d)          # hf * wf * c_in
        else:
            red = int(lhs.shape[-1]) if lhs.shape else 1
        total += 2.0 * out_elems * red
    return total


@dataclasses.dataclass(frozen=True)
class GraphCostEstimate:
    """Analytic price of one whole-graph execution."""

    name: str
    flops: float
    intermediate_traffic: int    # write + read-per-consumer, planner terms
    const_bytes: int             # weights streamed once
    output_bytes: int
    n_nodes: int
    n_intermediates: int
    t_compute_s: float
    t_memory_s: float
    predicted_s: float
    profile: str

    @property
    def hbm_bytes(self) -> int:
        return self.intermediate_traffic + self.const_bytes + self.output_bytes

    @property
    def predicted_us(self) -> float:
        return self.predicted_s * 1e6

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hbm_bytes"] = self.hbm_bytes
        d["predicted_us"] = self.predicted_us
        return d


def estimate_graph(g: Graph, *,
                   profile: Optional[HardwareProfile] = None
                   ) -> GraphCostEstimate:
    """Price ``g`` as compiled: cluster-internal values cost nothing
    (the graph-level APR), everything that materializes is charged the
    planner's write + read-per-consumer traffic."""
    prof = profile if profile is not None else get_profile()
    rep = memory_report(g)
    flops = sum(_node_flops(g, n) for n in g.nodes)
    hbm = rep.intermediate_traffic + rep.const_bytes + rep.output_bytes
    t_c = flops / prof.peak_flops
    t_m = hbm / prof.hbm_bw
    return GraphCostEstimate(
        name=g.name, flops=flops,
        intermediate_traffic=rep.intermediate_traffic,
        const_bytes=rep.const_bytes, output_bytes=rep.output_bytes,
        n_nodes=rep.n_nodes, n_intermediates=rep.n_intermediates,
        t_compute_s=t_c, t_memory_s=t_m,
        predicted_s=combine_times(t_c, t_m), profile=prof.name,
    )


@dataclasses.dataclass(frozen=True)
class PassDecision:
    """One pass's audit row in a schedule decision."""

    name: str
    kept: bool
    traffic_before: int
    traffic_after: int
    nodes_before: int
    nodes_after: int

    @property
    def traffic_saved(self) -> int:
        return self.traffic_before - self.traffic_after


@dataclasses.dataclass
class ScheduleDecision:
    """The chosen whole-graph schedule plus its cost audit trail.

    ``passes`` is the kept subset in application order — replaying it with
    :func:`repro_torch.graph.passes.run_passes` on the same traced graph rebuilds
    the same clustering (determinism is what makes the schedule cachable).
    """

    graph_name: str
    signature: str                   # repro_torch.cost.schedule.graph_signature
    passes: List[str]
    decisions: List[PassDecision]
    unfused: GraphCostEstimate
    fused: GraphCostEstimate
    cached: bool = False             # True when replayed from a cache hit

    @property
    def traffic_reduction(self) -> float:
        return (self.unfused.intermediate_traffic
                / max(self.fused.intermediate_traffic, 1))

    def report(self) -> str:
        """Human-readable ``--explain`` block."""
        lines = [
            f"schedule {self.graph_name} "
            f"[sig {self.signature[:12]}, profile {self.fused.profile}"
            f"{', cached' if self.cached else ''}]",
            f"  unfused: {self.unfused.n_nodes} nodes, "
            f"{self.unfused.intermediate_traffic:,} B intermediate traffic, "
            f"predicted {self.unfused.predicted_us:.1f}us",
        ]
        for d in self.decisions:
            verdict = "keep" if d.kept else "drop"
            lines.append(
                f"  pass {d.name:24s} {verdict}  "
                f"traffic {d.traffic_before:,} -> {d.traffic_after:,} B  "
                f"nodes {d.nodes_before} -> {d.nodes_after}")
        lines.append(
            f"  fused:   {self.fused.n_nodes} nodes, "
            f"{self.fused.intermediate_traffic:,} B intermediate traffic "
            f"({self.traffic_reduction:.2f}x less), "
            f"predicted {self.fused.predicted_us:.1f}us")
        return "\n".join(lines)


def candidate_passes(names: Optional[Sequence[str]] = None) -> List[str]:
    """Canonical evaluation order: ``default_passes()`` first (their
    relative order encodes real constraints), then any other registered
    passes sorted by name."""
    if names is not None:
        return list(names)
    ordered = default_passes()
    extras = sorted(set(all_passes()) - set(ordered))
    return ordered + extras


def select_passes(g: Graph, *, names: Optional[Sequence[str]] = None,
                  profile: Optional[HardwareProfile] = None,
                  signature: str = "") -> ScheduleDecision:
    """Cost-driven clustering: greedily keep each candidate rewrite iff it
    wins predicted HBM traffic.  Mutates and returns a decision over ``g``
    (passes rewrite in place, like :func:`run_passes`)."""
    prof = profile if profile is not None else get_profile()
    unfused = estimate_graph(g, profile=prof)
    kept: List[str] = []
    decisions: List[PassDecision] = []
    traffic = unfused.intermediate_traffic
    n_nodes = unfused.n_nodes
    for name in candidate_passes(names):
        g = get_pass(name)(g)
        rep = memory_report(g)
        win = (rep.intermediate_traffic < traffic
               or (rep.intermediate_traffic == traffic
                   and rep.n_nodes < n_nodes))
        decisions.append(PassDecision(
            name=name, kept=win,
            traffic_before=traffic, traffic_after=rep.intermediate_traffic,
            nodes_before=n_nodes, nodes_after=rep.n_nodes))
        # a rewrite with no predicted win leaves the graph unchanged (fusion
        # only ever *removes* intermediates, each worth > 0 traffic), so
        # "drop" and "keep" coincide on the graph — only the schedule
        # artifact records the drop
        if win:
            kept.append(name)
        traffic, n_nodes = rep.intermediate_traffic, rep.n_nodes
    return ScheduleDecision(
        graph_name=g.name, signature=signature, passes=kept,
        decisions=decisions, unfused=unfused,
        fused=estimate_graph(g, profile=prof))


def per_pass_table(decision: ScheduleDecision) -> List[Dict]:
    """JSON-ready audit rows (benchmarks and ``--explain`` consumers)."""
    return [dataclasses.asdict(d) for d in decision.decisions]
