"""Op-graph IR: SSA values + nodes in one topologically-ordered list.

A copy of the JAX package's ``repro.graph.ir``, so that the port's passes,
planner and cost model read the same structure.  A :class:`Node` is either
a single operation (``prim`` is the callable that replays it, built by
:mod:`repro_torch.graph.trace`, ``attrs`` its JAX-vocabulary attributes)
or a *fused cluster* (``body`` holds the original nodes, executed together
so their interface values never materialize — the graph-level APR).
Passes rewrite the node list; the executor only ever needs
``inputs``/``outputs`` ids plus, per primitive node, its ``prim``.

Canonical op names (``Node.op``) are the JAX compiler's vocabulary, which
the tracer lowers PyTorch's operations to, so the fusion passes
pattern-match one vocabulary:

* ``matmul``  — ``dot_general`` (any rank; attrs keep JAX-style
  ``dimension_numbers`` ``((lhs_contract, rhs_contract), (lhs_batch,
  rhs_batch))``)
* ``conv2d``  — ``conv_general_dilated`` (attrs keep
  :class:`ConvDimensionNumbers` ``lhs_spec`` / ``rhs_spec`` /
  ``out_spec``)
* everything else keeps its JAX primitive name (``add``, ``max``, ``exp``,
  ``convert_element_type``, ``gather``, ``scatter`` ...)

``Value.dtype`` is a numpy dtype or a torch dtype; :func:`itemsize` reads
either, so graphs bridged from the JAX compiler and traced ones count
bytes alike.

Fused nodes get ``op = "fused"`` and a ``pattern`` label from the pass
that built them (``matmul_epilogue`` / ``conv_epilogue`` /
``quant_matmul`` / ``elementwise_chain``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

_CANONICAL = {
    "dot_general": "matmul",
    "conv_general_dilated": "conv2d",
}

class ConvDimensionNumbers(NamedTuple):
    """The JAX ``ConvDimensionNumbers``: for lhs, rhs and out, the axis
    positions of (batch, feature, spatial...) — ``(out, in, spatial...)``
    for the rhs — so NHWC x HWIO -> NHWC is ``((0, 3, 1, 2), (3, 2, 0,
    1), (0, 3, 1, 2))``."""
    lhs_spec: Tuple[int, ...]
    rhs_spec: Tuple[int, ...]
    out_spec: Tuple[int, ...]


def itemsize(dtype) -> int:
    """Bytes an element of ``dtype``, a torch or a numpy dtype."""
    size = getattr(dtype, "itemsize", None)
    if isinstance(size, int) and not isinstance(dtype, type):
        return size
    import numpy as np
    return np.dtype(dtype).itemsize


#: Cheap ops a fusion pass may pull into a producer's cluster: elementwise
#: arithmetic plus layout-only ops whose output is a relabelling of the
#: input.  Reductions, gathers/scatters, dots and convs are never "cheap".
CHEAP_OPS = frozenset({
    "add", "sub", "mul", "div", "max", "min", "pow", "integer_pow",
    "exp", "log", "log1p", "expm1", "tanh", "logistic", "erf", "rsqrt",
    "sqrt", "neg", "sign", "abs", "floor", "ceil", "round", "clamp",
    "select_n", "and", "or", "not", "xor", "ge", "gt", "le", "lt", "eq",
    "ne", "is_finite", "stop_gradient", "square",
    "convert_element_type", "broadcast_in_dim", "reshape", "squeeze",
    "transpose", "rev", "slice", "expand_dims",
})


@dataclasses.dataclass
class Value:
    """One SSA value: an array with a fixed shape/dtype.

    ``kind`` is ``"input"`` (a traced argument), ``"const"`` (a weight or
    literal captured at trace time; ``array`` holds it, a tensor held by
    reference, never copied), or
    ``"intermediate"`` (produced by a node).
    """
    id: int
    shape: Tuple[int, ...]
    dtype: Any
    kind: str = "intermediate"
    array: Any = None

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * itemsize(self.dtype)


@dataclasses.dataclass
class Node:
    """One computation step: a primitive application or a fused cluster."""
    id: int
    op: str
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    prim: Any = None                       # replay callable (None if fused
                                           # or synthetic)
    body: Optional[List["Node"]] = None    # inner primitive nodes if fused
    pattern: Optional[str] = None          # fusion-pass label if fused

    @property
    def is_fused(self) -> bool:
        return self.body is not None

    def body_nodes(self) -> List["Node"]:
        return self.body if self.body is not None else [self]


@dataclasses.dataclass
class Graph:
    """Topologically-ordered op graph plus pytree metadata.

    ``inputs``/``outputs`` are value ids in flattened-pytree order;
    ``in_tree``/``out_tree`` let callers round-trip the original function
    signature (the executor's ``__call__`` uses them).
    """
    values: Dict[int, Value]
    nodes: List[Node]
    inputs: List[int]
    outputs: List[int]
    in_tree: Any = None
    out_tree: Any = None
    name: str = "graph"
    device: Any = None      # the device it was traced on (None: bridged)
    _node_counter: int = 0  # monotonic: ids stay unique even for nodes
                            # built before they are spliced into `nodes`

    # -- id allocation ----------------------------------------------------
    def new_value(self, shape, dtype, kind="intermediate", array=None) -> Value:
        vid = (max(self.values) + 1) if self.values else 0
        v = Value(id=vid, shape=tuple(int(d) for d in shape), dtype=dtype,
                  kind=kind, array=array)
        self.values[vid] = v
        return v

    def next_node_id(self) -> int:
        nid = max(self._node_counter,
                  max((n.id for n in self.nodes), default=-1) + 1)
        object.__setattr__(self, "_node_counter", nid + 1)
        return nid

    # -- structure queries ------------------------------------------------
    def producers(self) -> Dict[int, Node]:
        """value id -> node producing it (fused nodes count as one)."""
        out = {}
        for n in self.nodes:
            for vid in n.outputs:
                out[vid] = n
        return out

    def consumers(self) -> Dict[int, List[Node]]:
        """value id -> nodes consuming it (fused nodes count as one)."""
        out: Dict[int, List[Node]] = {vid: [] for vid in self.values}
        for n in self.nodes:
            for vid in n.inputs:
                out.setdefault(vid, []).append(n)
        return out

    def intermediates(self) -> List[Value]:
        """Values that would materialize between nodes: produced by a node,
        consumed (or returned) outside the producing cluster.  Cluster-
        internal values of fused nodes are *not* intermediates — they live
        in the producer's register tile, never in HBM."""
        out = [self.values[vid] for n in self.nodes for vid in n.outputs
               if vid not in self.outputs]
        return out

    def const_bytes(self) -> int:
        return sum(v.nbytes for v in self.values.values() if v.kind == "const")

    def summary(self) -> Dict[str, int]:
        return {
            "n_nodes": len(self.nodes),
            "n_fused": sum(1 for n in self.nodes if n.is_fused),
            "n_primitive_ops": sum(len(n.body_nodes()) for n in self.nodes),
            "n_values": len(self.values),
        }

    def pretty(self, max_nodes: int = 40) -> str:
        lines = [f"graph {self.name}: {len(self.inputs)} inputs, "
                 f"{len(self.outputs)} outputs, {len(self.nodes)} nodes"]
        for n in self.nodes[:max_nodes]:
            outs = ", ".join(f"%{v}" for v in n.outputs)
            ins = ", ".join(f"%{v}" for v in n.inputs)
            tag = f" [{n.pattern}:{len(n.body)} ops]" if n.is_fused else ""
            lines.append(f"  {outs} = {n.op}{tag}({ins})")
        if len(self.nodes) > max_nodes:
            lines.append(f"  ... {len(self.nodes) - max_nodes} more")
        return "\n".join(lines)


def canonical_op(prim_name: str) -> str:
    return _CANONICAL.get(prim_name, prim_name)


def toposort(nodes: Sequence[Node], producers: Dict[int, Node]) -> List[Node]:
    """Deterministic topological order of ``nodes`` (Kahn's with a FIFO
    ready queue — O(V + E); initial ready set keeps the given order).
    Fusion can only ever *merge* adjacent dependency chains, so passes use
    this to re-legalise the node list after a rewrite sweep."""
    import collections

    node_by_id = {id(n): n for n in nodes}
    indeg: Dict[int, int] = {id(n): 0 for n in nodes}
    dependents: Dict[int, List[int]] = {id(n): [] for n in nodes}
    for n in nodes:
        preds = set()
        for vid in n.inputs:
            p = producers.get(vid)
            if p is not None and id(p) in node_by_id and p is not n:
                preds.add(id(p))
        indeg[id(n)] = len(preds)
        for pid in preds:
            dependents[pid].append(id(n))
    ready = collections.deque(id(n) for n in nodes if indeg[id(n)] == 0)
    ordered: List[Node] = []
    while ready:
        nid = ready.popleft()
        ordered.append(node_by_id[nid])
        for did in dependents[nid]:
            indeg[did] -= 1
            if indeg[did] == 0:
                ready.append(did)
    if len(ordered) != len(nodes):
        raise ValueError("cycle in graph node list (illegal fusion?)")
    return ordered
