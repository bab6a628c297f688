"""Fusion passes — pipeline renting at graph level.

A copy of the JAX package's ``repro.graph.passes``, line for line (numpy in
place of ``jnp``), over the same JAX vocabulary, so that on one graph the
two compilers build the same clusters.  Each pass rewrites a
:class:`~repro_torch.graph.ir.Graph` by merging primitive nodes into fused
cluster nodes.  A cluster executes as ONE region (one fused CUDA kernel
when the executor recognizes the pattern, its body nodes in order
otherwise), so the values on its internal edges never materialize —
exactly the APR keeping a partial result in the rented stage instead of
writing it back every step.  The attribute ``pallas_ok`` keeps the JAX
compiler's name: it marks a cluster a fused kernel serves.

Legality rule shared by every pass (``_grow_chain``): a node may join its
producer's cluster iff

* it is the **sole consumer** of the producer's output (otherwise the
  value must materialize anyway),
* it is *cheap* (:data:`repro_torch.graph.ir.CHEAP_OPS` — elementwise or
  layout-only; reductions/dots/convs never ride an epilogue),
* its **other** inputs come from consts, graph inputs, or nodes that
  precede the cluster in topological order (so merging cannot create a
  cycle — a residual edge into ``conv + add + relu`` is fine because the
  shortcut was produced before the conv).

Passes register with :func:`fusion_pass` under a stable name, the JAX
compiler's.  Any sequence / subset of passes is legal and
output-preserving (``tests/test_torch_graph*.py`` hold them to the JAX
passes and the executor to the eager forward).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ir import CHEAP_OPS, Graph, Node, toposort

_PASSES: Dict[str, Callable[[Graph], Graph]] = {}

_EPILOGUE_MAX_OPS = 12  # longest cheap-op tail a producer may absorb


def fusion_pass(name: str):
    """Register a Graph -> Graph rewrite under ``name``."""
    def deco(fn):
        if name in _PASSES:
            raise ValueError(f"fusion pass {name!r} already registered")
        fn.pass_name = name
        _PASSES[name] = fn
        return fn
    return deco


def get_pass(name: str) -> Callable[[Graph], Graph]:
    try:
        return _PASSES[name]
    except KeyError:
        raise KeyError(
            f"no fusion pass {name!r}; known: {sorted(_PASSES)}") from None


def all_passes() -> Dict[str, Callable[[Graph], Graph]]:
    return dict(_PASSES)


def default_passes() -> List[str]:
    """The standard pipeline, in the order the compiler runs it.  Quant
    folding must precede epilogue fusion (it rewrites the matmul the
    epilogue then attaches to); the generic elementwise pass runs last to
    sweep up what the targeted passes left."""
    return ["fold_quant_dequant", "fuse_matmul_epilogue",
            "fuse_conv_epilogue", "fuse_elementwise_chains"]


def run_passes(graph: Graph, names: Optional[Sequence[str]] = None) -> Graph:
    for name in (default_passes() if names is None else names):
        graph = get_pass(name)(graph)
    return graph


# ---------------------------------------------------------------------------
# Shared chain-growing machinery.
# ---------------------------------------------------------------------------


def _node_order(g: Graph) -> Dict[int, int]:
    return {n.id: i for i, n in enumerate(g.nodes)}


def _const_subtree(g: Graph, vid: int, producers) -> Optional[List[Node]]:
    """If ``vid`` is computed purely from consts by cheap ops, return the
    producing nodes (topo-unsorted); None otherwise.  These subtrees (a
    ``broadcast_in_dim`` of a bias vector, the broadcast zero of a relu)
    are absorbed into the consuming cluster so they stop materializing and
    the epilogue's *origin* const stays visible as a cluster input."""
    nodes: List[Node] = []
    stack = [vid]
    seen = set()
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        val = g.values[v]
        if val.kind in ("const", "input"):  # leaves: depend on nothing
            continue
        prod = producers.get(v)
        if prod is None or prod.is_fused or prod.op not in CHEAP_OPS \
                or len(nodes) > _EPILOGUE_MAX_OPS:
            return None
        nodes.append(prod)
        stack.extend(prod.inputs)
    return nodes


def _depends_on(g: Graph, vid: int, forbidden_ids, producers) -> bool:
    """True if ``vid``'s producer cone touches any node in ``forbidden_ids``
    (used to keep cluster side inputs acyclic)."""
    stack = [vid]
    seen = set()
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        prod = producers.get(v)
        if prod is None:
            continue
        if prod.id in forbidden_ids:
            return True
        stack.extend(prod.inputs)
    return False


def _is_last_axis_vector(shape) -> bool:
    """All dims 1 except (at most) the last — the only layouts a glue op
    may pass through when the origin must land on the output's last axis."""
    return all(int(d) == 1 for d in shape[:-1]) if shape else True


def _const_origin(g: Graph, vid: int, producers,
                  last_axis: bool = False) -> Optional[int]:
    """Resolve ``vid`` through shape/dtype-only glue (broadcast, reshape,
    convert, squeeze, expand_dims) back to a const/input value id.

    With ``last_axis=True`` every glue step must provably keep the origin
    vector on the LAST output axis (the per-output-channel contract of the
    fused kernels' bias operand): a ``broadcast_in_dim`` must map the
    input's last dim onto the output's last dim at the same size, and
    reshapes may only move between ``(..., 1, N)``-style layouts — a
    per-ROW bias (``c[:, None]`` broadcast over columns) is rejected, so
    the cluster runs its body nodes instead of the fused kernel's
    epilogue adding along the wrong axis."""
    glue = {"broadcast_in_dim", "reshape", "convert_element_type",
            "squeeze", "expand_dims"}
    for _ in range(_EPILOGUE_MAX_OPS):
        val = g.values[vid]
        if val.kind in ("const", "input"):
            return vid
        prod = producers.get(vid)
        if prod is None or prod.is_fused or prod.op not in glue \
                or len(prod.inputs) != 1:
            return None
        if last_axis and prod.op == "broadcast_in_dim":
            in_shape = g.values[prod.inputs[0]].shape
            out_shape = val.shape
            bdims = tuple(prod.attrs.get("broadcast_dimensions", ()))
            if in_shape:  # rank-0 (scalar) broadcasts are axis-agnostic
                if not (_is_last_axis_vector(in_shape)
                        and bdims and bdims[-1] == len(out_shape) - 1
                        and int(in_shape[-1]) == int(out_shape[-1])):
                    return None
        elif last_axis and prod.op in ("reshape", "squeeze", "expand_dims"):
            in_shape = g.values[prod.inputs[0]].shape
            if not (_is_last_axis_vector(in_shape)
                    and _is_last_axis_vector(val.shape)
                    and (not in_shape or not val.shape
                         or int(in_shape[-1]) == int(val.shape[-1]))):
                return None
        vid = prod.inputs[0]
    return None


def _grow_chain(g: Graph, start: Node, consumers, producers,
                order) -> Tuple[List[Node], List[Node]]:
    """Maximal single-consumer cheap-op chain hanging off ``start``.

    Returns ``(chain, absorbed)``: the main producer-consumer path, plus
    const-only side subtrees its ops pull in (broadcast biases etc.).  A
    side input that is a real intermediate is allowed — and left outside
    the cluster — iff it does not depend on any cluster node."""
    chain = [start]
    absorbed: List[Node] = []
    cur = start
    while len(chain) <= _EPILOGUE_MAX_OPS:
        if len(cur.outputs) != 1 or cur.outputs[0] in g.outputs:
            break
        cons = consumers.get(cur.outputs[0], [])
        if len(cons) != 1:
            break
        nxt = cons[0]
        if nxt.is_fused or nxt.op not in CHEAP_OPS:
            break
        cluster_ids = {n.id for n in chain} | {n.id for n in absorbed}
        ok = True
        new_absorbed: List[Node] = []
        for vid in nxt.inputs:
            if vid == cur.outputs[0]:
                continue
            if g.values[vid].kind in ("const", "input"):
                continue
            sub = _const_subtree(g, vid, producers)
            if sub is not None:
                new_absorbed.extend(
                    n for n in sub if n.id not in cluster_ids)
            elif _depends_on(g, vid, cluster_ids, producers):
                ok = False  # side input fed by the cluster: fusing cycles
                break
        if not ok:
            break
        chain.append(nxt)
        absorbed.extend(new_absorbed)
        cur = nxt
    return chain, absorbed


def _make_cluster(g: Graph, body: List[Node], pattern: str, consumers,
                  attrs: Optional[dict] = None,
                  anchor_id: Optional[int] = None) -> Node:
    """Build the fused node replacing ``body`` (a convex node set in valid
    execution order).  ``consumers`` is the consumer map at sweep start —
    other disjoint clusters formed in the same sweep don't change whether
    a body value is used outside THIS body, so one map serves the whole
    sweep.  The caller splices the node list and re-toposorts once."""
    body_ids = {n.id for n in body}
    produced = {vid for n in body for vid in n.outputs}
    ext_inputs, seen = [], set()
    for n in body:
        for vid in n.inputs:
            if vid not in produced and vid not in seen:
                seen.add(vid)
                ext_inputs.append(vid)
    # cluster outputs: produced values still visible outside the cluster
    ext_outputs = []
    for n in body:
        for vid in n.outputs:
            used_outside = any(c.id not in body_ids
                               for c in consumers.get(vid, []))
            if used_outside or vid in g.outputs:
                ext_outputs.append(vid)
    return Node(
        id=g.next_node_id(),
        op="fused",
        inputs=tuple(ext_inputs),
        outputs=tuple(ext_outputs),
        attrs=dict(attrs or {},
                   anchor=body[0].id if anchor_id is None else anchor_id),
        body=list(body),
        pattern=pattern,
    )


def _apply_clusters(g: Graph, replacements) -> None:
    """Splice a sweep's disjoint ``(body_ids, fused_node)`` replacements
    into the node list (each fused node at its body's earliest position),
    then re-toposort once — a cluster's side inputs may sit later in the
    flat order than the cluster's first body node."""
    if not replacements:
        return
    pos_of = {}
    all_dead = set()
    for body_ids, fused in replacements:
        all_dead |= body_ids
    for i, n in enumerate(g.nodes):
        for body_ids, fused in replacements:
            if n.id in body_ids and fused.id not in pos_of:
                pos_of[fused.id] = i
    inserts = sorted(((pos, fused) for (body_ids, fused) in replacements
                      for pos in [pos_of[fused.id]]), key=lambda t: t[0])
    new_nodes: List[Node] = []
    it = iter(inserts)
    nxt = next(it, None)
    for i, n in enumerate(g.nodes):
        while nxt is not None and nxt[0] == i:
            new_nodes.append(nxt[1])
            nxt = next(it, None)
        if n.id not in all_dead:
            new_nodes.append(n)
    while nxt is not None:
        new_nodes.append(nxt[1])
        nxt = next(it, None)
    g.nodes = new_nodes
    g.nodes = toposort(g.nodes, g.producers())


def _match_epilogue(g: Graph, anchor: Node, tail: List[Node],
                    producers) -> Optional[dict]:
    """Try to describe a cheap-op tail as the fused kernels' epilogue
    (``act(anchor_out + bias)``) so the executor may dispatch the cluster
    to ``apr_matmul_fused`` / ``apr_conv2d_fused`` / ``quant_matmul_fused``.

    Recognized tails (any prefix of): optional bias add — the other
    operand resolves through broadcast/reshape glue to a per-output-channel
    const/input vector — then relu spelled as ``max(x, 0)``.  Returns
    ``{"bias": vid | None, "activation": str}`` or None when the tail does
    something else (the cluster still fuses — it just executes its body
    nodes instead of the fused kernel).
    """
    bias = None
    activation = "none"
    cur_out = anchor.outputs[0]
    for n in tail:
        other = [v for v in n.inputs if v != cur_out]
        if n.op == "add" and bias is None and activation == "none" \
                and len(other) == 1:
            origin = _const_origin(g, other[0], producers, last_axis=True)
            if origin is None:
                return None
            src = g.values[origin]
            n_out = g.values[anchor.outputs[0]].shape[-1]
            flat = 1
            for d in src.shape:
                flat *= int(d)
            if flat != n_out or not _is_last_axis_vector(src.shape) \
                    or (src.shape and int(src.shape[-1]) != n_out):
                return None  # not a per-output-channel (last-axis) bias
            bias = origin
        elif n.op == "max" and activation == "none" and len(other) == 1:
            origin = _const_origin(g, other[0], producers)
            if origin is None:
                return None
            v = g.values[origin]
            if v.kind != "const" or v.array is None \
                    or np.any(_numpy(v.array) != 0):
                return None
            activation = "relu"
        elif n.op == "convert_element_type":
            pass  # dtype glue on the main path; kernel casts at the flush
        else:
            return None
        cur_out = n.outputs[0]
    return {"bias": bias, "activation": activation}


def _is_plain_2d_matmul(g: Graph, node: Node) -> bool:
    """dot_general that the 2-D matmul kernels can serve after a row-major
    collapse: contraction = (last lhs dim) x (first rhs dim), no batch.
    Both contraction positions must be checked — a dot that contracts the
    lhs's FIRST dim (``einsum('km,kn->mn')``) is a transposed product the
    collapse would silently compute wrong."""
    if node.op != "matmul":
        return False
    dn = node.attrs.get("dimension_numbers")
    if dn is None:
        return False
    (lc, rc), (lb, rb) = dn
    lhs_rank = len(g.values[node.inputs[0]].shape)
    return (lb == () and rb == () and len(lc) == 1 and len(rc) == 1
            and rc[0] == 0 and lc[0] == lhs_rank - 1)


# ---------------------------------------------------------------------------
# The passes.
# ---------------------------------------------------------------------------


def _fuse_anchored(g: Graph, anchor_pred, pattern: str) -> Graph:
    """Generic anchored-epilogue driver: for every node matching
    ``anchor_pred``, absorb its maximal cheap tail.

    One *sweep* walks the node list once with the maps built at sweep
    start, collecting clusters that are node-disjoint (a chain touching
    an already-claimed node waits for the next sweep); all of a sweep's
    replacements are spliced and re-toposorted together, so the map
    rebuilds are O(sweeps), not O(clusters)."""
    changed = True
    while changed:
        changed = False
        order = _node_order(g)
        consumers = g.consumers()
        producers = g.producers()
        claimed: set = set()
        replacements = []
        for node in list(g.nodes):
            if node.is_fused or node.id in claimed \
                    or not anchor_pred(node):
                continue
            chain, absorbed = _grow_chain(g, node, consumers, producers,
                                          order)
            if len(chain) < 2:
                continue
            body_ids = {n.id for n in chain} | {n.id for n in absorbed}
            if body_ids & claimed:
                changed = True  # contested nodes: retry next sweep
                continue
            epi = _match_epilogue(g, node, chain[1:], producers)
            attrs = {"pallas_ok": epi is not None}
            if epi is not None:
                attrs.update(epi)
            body = sorted({n.id: n for n in chain + absorbed}.values(),
                          key=lambda n: order[n.id])
            replacements.append(
                (body_ids, _make_cluster(g, body, pattern, consumers,
                                         attrs, anchor_id=node.id)))
            claimed |= body_ids
            changed = True
        _apply_clusters(g, replacements)
    return g


@fusion_pass("fuse_matmul_epilogue")
def fuse_matmul_epilogue(g: Graph) -> Graph:
    """matmul + bias + activation -> one cluster (``apr_matmul_fused`` /
    ``quant_matmul_fused`` when the tail matches the kernels' epilogue)."""
    return _fuse_anchored(
        g, lambda n: n.op in ("matmul", "quant_matmul"), "matmul_epilogue")


@fusion_pass("fuse_conv_epilogue")
def fuse_conv_epilogue(g: Graph) -> Graph:
    """conv2d + (folded-bn scale/bias | bias | residual add) + relu -> one
    cluster (``apr_conv2d_fused`` when the tail is bias+relu)."""
    return _fuse_anchored(g, lambda n: n.op == "conv2d", "conv_epilogue")


@fusion_pass("fuse_elementwise_chains")
def fuse_elementwise_chains(g: Graph) -> Graph:
    """Sweep-up pass: any >= 2-long single-consumer chain of cheap ops
    (norm bodies, softmax tails, rope trig, dequant glue) fuses into one
    cluster so its internal values stop materializing."""
    return _fuse_anchored(
        g, lambda n: n.op in CHEAP_OPS, "elementwise_chain")


@fusion_pass("fold_quant_dequant")
def fold_quant_dequant(g: Graph) -> Graph:
    """Rewrite ``x @ dequantize(w_int8)`` into a ``quant_matmul`` node.

    The tracer lowers an int8 :class:`QuantizedTensor` weight to
    ``convert(w_q) * scale`` (+ a convert to the activation dtype) feeding
    the dot, as the JAX layers' ``materialize_weight`` does.  This pass matches that producer chain on the RHS of a plain
    2-D matmul and replaces the pair with a single ``quant_matmul`` node
    whose inputs are ``(x, w_q, scale)`` — the dequant multiply folds into
    the matmul flush (per-output-channel scales distribute over the
    contraction), the executor streams the weight at 1 byte/element, and
    the int8 weight flows through later epilogue fusion unchanged.
    Numerics follow ``kernels/quant_matmul`` (dynamic per-row activation
    quantization, int32 accumulation, scales applied once).
    """
    producers = g.producers()
    consumers = g.consumers()
    for node in list(g.nodes):
        if not _is_plain_2d_matmul(g, node) \
                or len(g.values[node.inputs[1]].shape) != 2:
            continue
        match = _match_dequant(g, node.inputs[1], producers, consumers)
        if match is None:
            continue
        wq_vid, scale_vid, dequant_nodes = match
        qnode = Node(
            id=g.next_node_id(),
            op="quant_matmul",
            inputs=(node.inputs[0], wq_vid, scale_vid),
            outputs=node.outputs,
            attrs={"out_dtype": g.values[node.outputs[0]].dtype},
        )
        dead = {n.id for n in dequant_nodes} | {node.id}
        pos = min(i for i, n in enumerate(g.nodes) if n.id in dead)
        g.nodes = ([n for n in g.nodes[:pos] if n.id not in dead]
                   + [qnode]
                   + [n for n in g.nodes[pos:] if n.id not in dead])
        producers = g.producers()
        consumers = g.consumers()
    return g


def _match_dequant(g: Graph, w_vid: int, producers, consumers):
    """Walk the weight operand's producer chain looking for
    convert(int8 const) * scale-const [-> convert].  Every node on the
    chain must feed only this chain (single consumer) so deleting it is
    safe, and the scale must be a scalar or a per-OUTPUT-channel vector
    (``(1, N)``-broadcastable) — only then does the multiply distribute
    over the contraction (``x @ (q * s) == (x @ q) * s``); a per-row
    ``(K, 1)`` scale does not, and folding it would silently change the
    product.  Returns (w_q vid, scale vid, nodes-to-delete) or None."""
    dead = []
    vid = w_vid
    # optional trailing dtype convert(s)
    for _ in range(2):
        prod = producers.get(vid)
        if prod is None or prod.is_fused:
            break
        if prod.op == "convert_element_type" and len(consumers.get(vid, [])) == 1:
            dead.append(prod)
            vid = prod.inputs[0]
        else:
            break
    prod = producers.get(vid)
    if prod is None or prod.is_fused or prod.op != "mul" \
            or len(consumers.get(vid, [])) != 1:
        return None
    dead.append(prod)
    qside = scale_vid = None
    for ivid in prod.inputs:
        v = g.values[ivid]
        p = producers.get(ivid)
        if p is not None and not p.is_fused \
                and p.op == "convert_element_type" \
                and g.values[p.inputs[0]].kind == "const" \
                and _is_int8(g.values[p.inputs[0]].dtype) \
                and len(consumers.get(ivid, [])) == 1:
            qside = p.inputs[0]
            dead.append(p)
        elif v.kind == "const":
            scale_vid = ivid
    if qside is None or scale_vid is None:
        return None
    n_out = int(g.values[w_vid].shape[-1])
    sshape = g.values[scale_vid].shape
    if sshape and not (_is_last_axis_vector(sshape)
                       and int(sshape[-1]) == n_out):
        return None  # per-row / elementwise scale: not foldable
    return qside, scale_vid, dead


def _numpy(a) -> np.ndarray:
    """A const's array as numpy: a tensor through the CPU (bf16 widened to
    fp32, which numpy lacks), anything else as it is."""
    if hasattr(a, "detach"):
        a = a.detach()
        if a.dtype.is_floating_point:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _is_int8(dtype) -> bool:
    """Whether ``dtype`` (a torch or a numpy dtype) is int8."""
    return str(dtype) in ("torch.int8", "int8")
