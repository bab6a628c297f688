"""Cluster-at-a-time graph executor.

Port of the JAX package's ``repro.graph.executor``.  Every graph node -- a
primitive or a fused cluster -- becomes one callable, built lazily and
cached per node (the executor's compile cache), and the executor walks the
node list feeding buffers.  A primitive node replays the operation the
tracer recorded (:class:`~repro_torch.graph.trace.Replay`): the same ATen
operation, or the same kernel wrapper (``apr_matmul``, ``apr_conv2d``,
``flash_decode_paged``), except that every 2-D product of two bf16 or two
fp32 matrices goes through ``apr_matmul``.  So on the CPU an unfused graph
computes what the eager function computes, bit for bit; on the card the
kernel wrappers' nodes launch what the eager path launches, with its bits,
while an eager ``x @ w`` (cuBLAS) runs as a B1 launch of its own bits.
A buffer is dropped after its last reader.

``impl="plain"`` (JAX's ``"xla"``) runs every cluster as its body nodes in
order; each ``matmul`` node goes through ``apr_matmul`` (B1 on the card)
and each folded ``quant_matmul`` through the ``quant_matmul`` wrapper (B6).
``impl="kernel"`` (JAX's ``"pallas"``; the default for a graph traced on
CUDA tensors) additionally sends *recognized* epilogue clusters to the
fused kernels: ``matmul_epilogue`` on a plain 2-D ``matmul`` to
``apr_matmul_fused`` (B7m), on a ``quant_matmul`` to
``quant_matmul_fused`` (B8); ``conv_epilogue`` of JAX's
:func:`_conv_geometry` to ``apr_conv2d_fused`` (B7).  Every other cluster
runs its body.  There is no fallback on the card: each wrapper launches
its kernel for CUDA tensors or raises, and takes its plain version only for
CPU tensors -- so over CPU tensors ``impl="kernel"`` dispatches to the
plain versions of the fused kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .ir import Graph, Node
from .passes import _is_plain_2d_matmul

IMPLS = ("plain", "kernel")


class GraphExecutor:
    """Callable wrapper around a (possibly fused) :class:`Graph`.

    Calling convention matches the traced function: positional pytree args
    flatten against the graph's ``in_tree``; the return value is rebuilt
    with ``out_tree``.  ``impl=None`` is ``"kernel"`` for a graph traced on
    CUDA tensors, else ``"plain"``.
    """

    def __init__(self, graph: Graph, *, impl: Optional[str] = None):
        if impl is None:
            dev = graph.device
            impl = ("kernel" if dev is not None
                    and torch.device(dev).type == "cuda" else "plain")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of "
                             f"{IMPLS}")
        self.graph = graph
        self.impl = impl
        self.schedule = None
        self._consts = {vid: v.array for vid, v in graph.values.items()
                        if v.kind == "const"}
        self._compiled: Dict[int, Callable] = {}  # node id -> callable
        self._dead = self._last_uses()
        #: node id -> kernel wrapper name, for the clusters dispatched to a
        #: fused kernel (filled as nodes are built)
        self.dispatched: Dict[int, str] = {}

    def _last_uses(self) -> List[Tuple[int, ...]]:
        """Per node position, the intermediates whose last reader it is."""
        keep = set(self.graph.outputs) | set(self._consts) \
            | set(self.graph.inputs)
        last: Dict[int, int] = {}
        for i, n in enumerate(self.graph.nodes):
            for vid in n.inputs:
                last[vid] = i
        dead: List[List[int]] = [[] for _ in self.graph.nodes]
        for vid, i in last.items():
            if vid not in keep:
                dead[i].append(vid)
        return [tuple(d) for d in dead]

    # -- compile cache ----------------------------------------------------
    def _fn_for(self, node: Node) -> Callable:
        fn = self._compiled.get(node.id)
        if fn is None:
            fn = self._build(node)
            self._compiled[node.id] = fn
        return fn

    def _build(self, node: Node) -> Callable:
        if self.impl == "kernel":
            fn = self._build_kernel(node)
            if fn is not None:
                return fn
        if node.op == "quant_matmul" and node.prim is None:
            # standalone folded node (no epilogue got attached to it)
            return self._quant_fn(node)
        if not node.is_fused:
            return node.prim
        steps = [(bn.inputs, bn.outputs,
                  self._quant_fn(bn) if bn.op == "quant_matmul"
                  and bn.prim is None else bn.prim)
                 for bn in node.body]
        in_ids, out_ids = node.inputs, node.outputs

        def run(*xs):
            env = dict(zip(in_ids, xs))
            for ins, outs, fn in steps:
                env.update(zip(outs, fn(*(env[i] for i in ins))))
            return tuple(env[o] for o in out_ids)
        return run

    def _quant_fn(self, node: Node) -> Callable:
        """A folded ``quant_matmul`` node through the ``quant_matmul``
        wrapper (B6 on the card, its plain version on the CPU)."""
        from ..kernels.quant_matmul import quant_matmul
        out_dtype = node.attrs["out_dtype"]
        out_shape = self.graph.values[node.outputs[0]].shape

        def run_q(x, wq, scale):
            y = quant_matmul(_as2d(x), wq, scale.reshape(1, -1),
                             out_dtype=out_dtype)
            return (y.reshape(out_shape),)
        return run_q

    # -- fused-kernel dispatch for recognized epilogue clusters -----------
    def _build_kernel(self, node: Node) -> Optional[Callable]:
        if not (node.is_fused and node.attrs.get("pallas_ok")
                and len(node.outputs) == 1):
            return None
        anchor_id = node.attrs.get("anchor", node.body[0].id)
        anchor = next(n for n in node.body if n.id == anchor_id)
        activation = node.attrs.get("activation", "none")
        bias_vid = node.attrs.get("bias")
        if bias_vid is not None and bias_vid not in node.inputs:
            return None  # bias origin not visible at the cluster boundary
        bias_pos = (node.inputs.index(bias_vid) if bias_vid in node.inputs
                    else None)
        out_shape = self.graph.values[node.outputs[0]].shape
        out_dtype = self.graph.values[node.outputs[0]].dtype

        def bias_of(xs):
            return (xs[bias_pos].reshape(-1) if bias_pos is not None
                    else None)

        if node.pattern == "matmul_epilogue" and anchor.op == "matmul":
            if not (_is_plain_2d_matmul(self.graph, anchor)
                    and self._plain_operands(anchor)):
                return None
            from ..kernels.apr_matmul import apr_matmul_fused
            x_pos = node.inputs.index(anchor.inputs[0])
            w_pos = node.inputs.index(anchor.inputs[1])

            def run_mm(*xs):
                y = apr_matmul_fused(_as2d(xs[x_pos]), xs[w_pos],
                                     bias=bias_of(xs), activation=activation,
                                     out_dtype=out_dtype)
                return (y.reshape(out_shape),)
            self.dispatched[node.id] = "apr_matmul_fused"
            return run_mm

        if node.pattern == "matmul_epilogue" and anchor.op == "quant_matmul":
            from ..kernels.quant_matmul import quant_matmul_fused
            x_pos = node.inputs.index(anchor.inputs[0])
            w_pos = node.inputs.index(anchor.inputs[1])
            s_pos = node.inputs.index(anchor.inputs[2])

            def run_qmm(*xs):
                y = quant_matmul_fused(
                    _as2d(xs[x_pos]), xs[w_pos], xs[s_pos].reshape(1, -1),
                    bias=bias_of(xs), activation=activation,
                    out_dtype=out_dtype)
                return (y.reshape(out_shape),)
            self.dispatched[node.id] = "quant_matmul_fused"
            return run_qmm

        if node.pattern == "conv_epilogue" and anchor.op == "conv2d":
            geo = _conv_geometry(anchor)
            if geo is None or anchor.attrs.get("kernel") != "apr_conv2d" \
                    or "residency" in anchor.attrs:
                return None
            stride, padding = geo
            from ..kernels.apr_conv import apr_conv2d_fused
            x_pos = node.inputs.index(anchor.inputs[0])
            f_pos = node.inputs.index(anchor.inputs[1])

            def run_conv(*xs):
                y = apr_conv2d_fused(xs[x_pos], xs[f_pos], bias=bias_of(xs),
                                     activation=activation, stride=stride,
                                     padding=padding)
                return (y.to(out_dtype).reshape(out_shape),)
            self.dispatched[node.id] = "apr_conv2d_fused"
            return run_conv
        return None

    def _plain_operands(self, anchor: Node) -> bool:
        """Whether the fused matmul kernel takes the anchor's operands as
        they are: two bf16 or two fp32 matrices, the weight not an int8
        one on its way through the dequant chain."""
        x, w = (self.graph.values[v] for v in anchor.inputs[:2])
        if x.dtype != w.dtype or str(x.dtype) not in (
                "torch.bfloat16", "torch.float32"):
            return False
        prod = self.graph.producers().get(anchor.inputs[1])
        return not (prod is not None and any(
            getattr(n.prim, "lazy", False) for n in prod.body_nodes()))

    # -- execution --------------------------------------------------------
    def __call__(self, *args):
        flat, in_tree = pytree.tree_flatten(args)
        if in_tree != self.graph.in_tree:
            raise TypeError(
                f"argument pytree mismatch: expected {self.graph.in_tree}, "
                f"got {in_tree}")
        buf = dict(self._consts)
        buf.update(zip(self.graph.inputs, flat))
        for node, dead in zip(self.graph.nodes, self._dead):
            outs = self._fn_for(node)(*(buf[i] for i in node.inputs))
            buf.update(zip(node.outputs, outs))
            for vid in dead:
                del buf[vid]
        out_flat = [buf[vid] for vid in self.graph.outputs]
        return pytree.tree_unflatten(out_flat, self.graph.out_tree)

    def kernel_clusters(self) -> List[Tuple[str, str, bool]]:
        """``(pattern, activation, has bias)`` of every cluster this
        executor sends to a fused kernel (under ``impl="kernel"``), as the
        passes annotated it; builds the nodes' callables."""
        out = []
        for n in self.graph.nodes:
            self._fn_for(n)
            if n.id in self.dispatched:
                out.append((n.pattern, n.attrs.get("activation", "none"),
                            n.attrs.get("bias") is not None))
        return out


def _as2d(x):
    """Collapse leading dims for the 2-D matmul kernels."""
    return x.reshape(-1, x.shape[-1])


def _conv_geometry(node: Node) -> Optional[Tuple[int, int]]:
    """(stride, padding) if the conv matches apr_conv2d's contract
    (NHWC x HWIO, square stride, symmetric padding, no dilation/groups)."""
    a = node.attrs
    dn = a.get("dimension_numbers")
    spec = (getattr(dn, "lhs_spec", None), getattr(dn, "rhs_spec", None),
            getattr(dn, "out_spec", None))
    if spec != ((0, 3, 1, 2), (3, 2, 0, 1), (0, 3, 1, 2)):  # NHWC,HWIO,NHWC
        return None
    if a.get("feature_group_count", 1) != 1 or a.get("batch_group_count", 1) != 1:
        return None
    if tuple(a.get("lhs_dilation", (1, 1))) != (1, 1):
        return None
    if tuple(a.get("rhs_dilation", (1, 1))) != (1, 1):
        return None
    strides = tuple(a.get("window_strides", (1, 1)))
    pads = tuple(tuple(p) for p in a.get("padding", ((0, 0), (0, 0))))
    if strides[0] != strides[1]:
        return None
    p = pads[0][0]
    if any(x != p for pair in pads for x in pair):
        return None
    return strides[0], p
