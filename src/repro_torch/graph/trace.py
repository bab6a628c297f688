"""PyTorch -> op-graph tracer.

``trace(fn, *example_args)`` runs ``fn`` once on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no data, no launches) under
a ``TorchDispatchMode`` that records every ATen operation it reaches, and
lowers each to the :mod:`repro_torch.graph.ir` vocabulary -- the JAX
compiler's -- one node per operation.  What makes the result the same IR
the JAX tracer builds:

* **JAX's names and decompositions.**  ``mm``/``bmm`` are ``matmul`` with
  JAX-style ``dimension_numbers``, ``view`` is ``reshape``, ``permute``
  ``transpose``, ``_to_copy`` ``convert_element_type``, ``where``
  ``select_n`` ...; ``relu`` is ``max(x, 0)`` with a zero const, which the
  epilogue matcher recognises; ``mean`` is ``reduce_sum`` + ``div``;
  ``addmm`` is ``matmul`` + ``add``.  A node replays the operation as it
  was called (a decomposed one replays whole in its first node and passes
  the value through the rest), except a product: every ``matmul`` of two
  bf16 or two fp32 matrices replays through ``apr_matmul`` (B1 on the
  card), and ``addmm``'s add is an add.  On the CPU, where ``apr_matmul``
  is ``torch.matmul``, an executed graph computes what the eager function
  computes, bit for bit (an ``addmm`` aside); on the card so does every
  node that calls a kernel wrapper below, while an eager ``x @ w``
  (cuBLAS) becomes a B1 launch with its own bits.
* **The port's kernel entry points are single nodes.**  The wrappers
  marked :func:`~repro_torch.kernels._leaf.graph_leaf` (``apr_matmul``,
  ``matmul_ref``, ``apr_conv2d`` (NHWC x HWIO), MobileNet's
  ``depthwise``, the paged decode attention) record one node --
  ``matmul``, ``conv2d`` or an opaque ``flash_decode_paged`` -- and
  replay by calling the wrapper, so the card launches the kernels the
  eager path launches there.  An int8
  :class:`~repro_torch.quant.QuantizedTensor` weight reaches its ``matmul``
  as JAX's chain ``convert(int8) * scale -> convert``, so that
  ``fold_quant_dequant`` folds what the JAX pass folds; the chain replays
  lazily and the matmul gets the int8 weight, as ``apr_matmul`` takes it.
* **Weights become graph consts by reference.**  A tensor ``fn`` closes
  over (the params) is a ``Value(kind="const")`` whose ``array`` is that
  tensor: nothing is copied.
* **In-place writes keep value semantics.**  ``index_put_`` on a KV pool
  is a ``scatter`` node whose output is a new value of the pool's shape
  (counted as JAX counts it); later readers read that value.  The replay
  writes in place, into the caller's pool.

Trace on the device the graph will run on: the model code branches on
``x.is_cuda`` (the grouped norm mean, ``tp_einsum``, the kernel branches),
and fake tensors keep their device.  A read of tensor data on the host
(``.item()``, a data-dependent shape, as MoE's expert counts) cannot be
traced and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _leaf
from ..quant import QuantizedTensor
from .ir import ConvDimensionNumbers, Graph, Node

aten = torch.ops.aten

#: ATen operation (overload packet name) -> JAX primitive name
_JAX_NAMES = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min", "pow": "pow", "exp": "exp",
    "log": "log", "log1p": "log1p", "expm1": "expm1", "tanh": "tanh",
    "sigmoid": "logistic", "erf": "erf", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "neg": "neg", "sign": "sign", "abs": "abs", "floor": "floor",
    "ceil": "ceil", "round": "round", "clamp": "clamp",
    "reciprocal": "div", "square": "square", "cos": "cos", "sin": "sin",
    "where": "select_n", "logical_and": "and", "bitwise_and": "and",
    "logical_or": "or", "bitwise_or": "or", "logical_not": "not",
    "bitwise_not": "not", "bitwise_xor": "xor", "ge": "ge", "gt": "gt",
    "le": "le", "lt": "lt", "eq": "eq", "ne": "ne", "isfinite": "is_finite",
    "_to_copy": "convert_element_type", "view": "reshape",
    "_unsafe_view": "reshape", "reshape": "reshape",
    "permute": "transpose", "t": "transpose", "transpose": "transpose",
    "expand": "broadcast_in_dim", "unsqueeze": "expand_dims",
    "squeeze": "squeeze", "flip": "rev", "slice": "slice",
    "select": "slice", "sum": "reduce_sum", "amax": "reduce_max",
    "amin": "reduce_min", "argmax": "argmax", "argmin": "argmin",
    "index": "gather", "index_put": "scatter", "index_put_": "scatter",
    "copy_": "scatter",
    "cat": "concatenate", "arange": "iota", "mm": "matmul", "bmm": "matmul",
    "convolution": "conv2d", "_softmax": "softmax", "clone": "copy",
    "floor_divide": "floor_divide", "remainder": "rem",
    "scalar_tensor": "broadcast_in_dim", "full": "broadcast_in_dim",
}

#: operations whose output is their input under another name: no node
_ALIASES = ("alias", "detach", "lift_fresh")

#: JAX's conv dimension numbers of the port's NHWC x HWIO -> NHWC convs
NHWC_HWIO = ConvDimensionNumbers((0, 3, 1, 2), (3, 2, 0, 1), (0, 3, 1, 2))
#: and of ``F.conv2d``'s NCHW x OIHW -> NCHW
NCHW_OIHW = ConvDimensionNumbers((0, 1, 2, 3), (0, 1, 2, 3), (0, 1, 2, 3))


def _mm_dims(lhs_rank: int) -> tuple:
    """JAX ``dimension_numbers`` of a row-major product: the lhs's last
    axis against the rhs's first, no batch (``mm``), or with the leading
    axis as batch (``bmm``)."""
    if lhs_rank == 2:
        return (((1,), (0,)), ((), ()))
    return (((2,), (1,)), ((0,), (0,)))


# ---------------------------------------------------------------------------
# Replay: how the executor runs one node.
# ---------------------------------------------------------------------------


class _Slot:
    """A tensor position of a traced call: input ``k`` of the node."""
    __slots__ = ("k",)

    def __init__(self, k: int):
        self.k = k


class LazyDequant:
    """An int8 weight on its way to a ``matmul``: the codes, then codes x
    scales, then in the activation dtype, held unmaterialized so that the
    matmul's wrapper gets the :class:`QuantizedTensor` (the card's
    int8-weight kernel).  :meth:`materialize` is the dequantized tensor,
    bit for bit ``QuantizedTensor.dequantize(dtype)``, for any other
    reader."""
    __slots__ = ("q", "scale", "dtype")

    def __init__(self, q, scale=None, dtype=None):
        self.q, self.scale, self.dtype = q, scale, dtype

    def materialize(self) -> torch.Tensor:
        t = self.q.float()
        if self.scale is not None:
            t = t * self.scale
        return t if self.dtype is None else t.to(self.dtype)

    def quantized(self) -> QuantizedTensor:
        return QuantizedTensor(q=self.q, scale=self.scale)


def _real(x):
    return x.materialize() if isinstance(x, LazyDequant) else x


class Replay:
    """Calls ``fn(*args, **kwargs)`` with each tensor of the traced call
    taken from the node's inputs; returns the call's tensors, in order, as
    a tuple.  ``lazy`` replays pass :class:`LazyDequant` inputs through;
    every other replay materializes them first."""
    __slots__ = ("fn", "args", "kwargs", "slots", "lazy", "passthrough")

    def __init__(self, fn, args, kwargs, lazy: bool = False,
                 passthrough: bool = False):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.slots = _has_slot(args) or _has_slot(kwargs)
        self.lazy = lazy
        self.passthrough = passthrough   # the value of input 0, unchanged

    def __call__(self, *inputs) -> tuple:
        if self.passthrough:
            return (inputs[0],)
        if not self.lazy:
            inputs = tuple(_real(x) for x in inputs)
        args = _fill(self.args, inputs) if self.slots else self.args
        kwargs = _fill(self.kwargs, inputs) if self.slots else self.kwargs
        out = self.fn(*args, **kwargs)
        if isinstance(out, (torch.Tensor, LazyDequant, QuantizedTensor)):
            return (out,)
        return tuple(t for t in pytree.tree_leaves(out)
                     if isinstance(t, torch.Tensor))

    def __repr__(self) -> str:
        return f"Replay({getattr(self.fn, '__name__', self.fn)})"


def _has_slot(obj) -> bool:
    if isinstance(obj, _Slot):
        return True
    if isinstance(obj, (list, tuple)):
        return any(_has_slot(a) for a in obj)
    if isinstance(obj, dict):
        return any(_has_slot(a) for a in obj.values())
    return False


def _fill(obj, inputs):
    if isinstance(obj, _Slot):
        return inputs[obj.k]
    if isinstance(obj, tuple):
        return tuple(_fill(a, inputs) for a in obj)
    if isinstance(obj, list):
        return [_fill(a, inputs) for a in obj]
    if isinstance(obj, dict):
        return {k: _fill(a, inputs) for k, a in obj.items()}
    return obj


def _codes(q):
    return LazyDequant(q)


def _scaled(codes: LazyDequant, scale):
    return LazyDequant(codes.q, scale)


def _cast_to(dtype):
    def cast(w: LazyDequant):
        return LazyDequant(w.q, w.scale, dtype)
    cast.__name__ = "dequant_cast"
    return cast


# ---------------------------------------------------------------------------
# The tracer.
# ---------------------------------------------------------------------------


class _Tracer(TorchDispatchMode):
    """Records every ATen call below it into ``graph``; the kernel
    wrappers' :meth:`leaf` calls record one node each."""

    def __init__(self, graph: Graph):
        super().__init__()
        self.g = graph
        self.ids: Dict[int, int] = {}   # id(tensor) -> value id
        self.keep: List[torch.Tensor] = []   # holds bound ids alive
        self.paused = False

    # -- values -------------------------------------------------------------
    def bind(self, t: torch.Tensor, vid: int) -> None:
        self.ids[id(t)] = vid
        self.keep.append(t)

    def vid(self, t: torch.Tensor) -> int:
        v = self.ids.get(id(t))
        if v is None:
            from torch._subclasses.fake_tensor import FakeTensor
            if isinstance(t, FakeTensor):
                raise RuntimeError(
                    "graph tracer: a tensor made outside the traced "
                    "operations reached one of them")
            # a tensor the function closes over: a const, by reference
            v = self.g.new_value(t.shape, t.dtype, kind="const", array=t).id
            self.bind(t, v)
        return v

    def const(self, value, dtype, device) -> int:
        """A scalar const (the zero of ``relu``): a real tensor, made
        outside the fake mode."""
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            t = torch.tensor(value, dtype=dtype)
        return self.g.new_value((), dtype, kind="const", array=t).id

    def fresh(self, shape, dtype, device) -> torch.Tensor:
        """A fake tensor standing for a leaf's output."""
        with self.pause():
            return torch.empty(tuple(shape), dtype=dtype, device=device)

    def pause(self):
        tracer = self

        class _Paused:
            def __enter__(self):
                tracer.paused = True

            def __exit__(self, *exc):
                tracer.paused = False
        return _Paused()

    # -- recording ------------------------------------------------------------
    def template(self, obj, inputs: List[int]):
        """``obj`` with every tensor replaced by a :class:`_Slot` into
        ``inputs`` (value ids, one slot per distinct tensor)."""
        if isinstance(obj, torch.Tensor):
            vid = self.vid(obj)
            if vid not in inputs:
                inputs.append(vid)
            return _Slot(inputs.index(vid))
        if isinstance(obj, tuple):
            return tuple(self.template(a, inputs) for a in obj)
        if isinstance(obj, list):
            return [self.template(a, inputs) for a in obj]
        if isinstance(obj, dict):
            return {k: self.template(a, inputs) for k, a in obj.items()}
        return obj

    def node(self, op: str, inputs, outputs, attrs, prim) -> Node:
        n = Node(id=self.g.next_node_id(), op=op, inputs=tuple(inputs),
                 outputs=tuple(outputs), attrs=dict(attrs), prim=prim)
        self.g.nodes.append(n)
        return n

    def out_values(self, outs: Sequence[torch.Tensor]) -> List[int]:
        ids = []
        for t in outs:
            v = self.g.new_value(t.shape, t.dtype)
            self.bind(t, v.id)
            ids.append(v.id)
        return ids

    # -- ATen operations ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused or func.namespace == "prim":
            return func(*args, **kwargs)
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException, DynamicOutputShapeException)
        try:
            out = func(*args, **kwargs)
        except (DataDependentOutputException,
                DynamicOutputShapeException) as e:
            raise NotImplementedError(
                f"graph tracer: {func} reads tensor data on the host, which "
                f"a graph traced at fixed shapes cannot hold ({e})") from e
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        name = func.overloadpacket.__name__
        if name in _ALIASES:
            src = next(a for a in pytree.tree_leaves((args, kwargs))
                       if isinstance(a, torch.Tensor))
            self.bind(outs[0], self.vid(src))
            return out
        inputs: List[int] = []
        t_args = self.template(args, inputs)
        t_kwargs = self.template(kwargs, inputs)
        replay = Replay(func, t_args, t_kwargs)
        lower = _LOWER.get(name, _lower_generic)
        lower(self, func, name, args, kwargs, inputs, outs, replay)
        return out

    # -- kernel wrappers --------------------------------------------------------
    def leaf(self, wrapper, args, kwargs):
        name = wrapper.__name__
        lower = _LEAVES.get(name)
        if lower is None:
            raise NotImplementedError(
                f"graph tracer: no lowering of the kernel wrapper {name}")
        return lower(self, wrapper, args, kwargs)


# ---------------------------------------------------------------------------
# ATen lowerings: (tracer, func, name, args, kwargs, input ids, outputs,
# replay) -> record the node(s).
# ---------------------------------------------------------------------------


def _attrs_for(name: str, func, args, kwargs, outs) -> dict:
    """The JAX attributes of the operation (those the passes read, and
    what distinguishes one shape of it from another)."""
    attrs: Dict[str, Any] = {}
    out = outs[0]
    if name in ("view", "_unsafe_view", "reshape"):
        attrs["new_sizes"] = tuple(out.shape)
    elif name in ("permute",):
        attrs["permutation"] = tuple(int(d) for d in args[1])
    elif name in ("t", "transpose"):
        rank = args[0].dim()
        perm = list(range(rank))
        if name == "t":
            perm = perm[::-1]
        else:
            a, b = int(args[1]) % rank, int(args[2]) % rank
            perm[a], perm[b] = perm[b], perm[a]
        attrs["permutation"] = tuple(perm)
    elif name == "expand":
        in_rank, out_rank = args[0].dim(), out.dim()
        attrs["shape"] = tuple(out.shape)
        attrs["broadcast_dimensions"] = tuple(range(out_rank - in_rank,
                                                    out_rank))
    elif name == "unsqueeze":
        attrs["dimensions"] = (int(args[1]) % out.dim(),)
    elif name == "_to_copy":
        attrs["new_dtype"] = out.dtype
    elif name in ("slice", "select"):
        attrs["index"] = tuple(a for a in args[1:])
    elif name in ("sum", "amax", "amin", "argmax", "argmin", "_softmax"):
        attrs["axes"] = tuple(a for a in args[1:] if not isinstance(
            a, torch.Tensor))
    elif name in ("mm", "bmm"):
        attrs["dimension_numbers"] = _mm_dims(args[0].dim())
        attrs["preferred_element_type"] = out.dtype
    elif name == "convolution":
        stride, padding, dilation = args[3], args[4], args[5]
        attrs.update(
            window_strides=tuple(stride), lhs_dilation=(1, 1),
            rhs_dilation=tuple(dilation),
            padding=tuple((int(p), int(p)) for p in padding),
            dimension_numbers=NCHW_OIHW, feature_group_count=int(args[8]),
            batch_group_count=1)
    elif name in ("arange", "full", "scalar_tensor"):
        attrs["shape"] = tuple(out.shape)
        attrs["dtype"] = out.dtype
    if name not in _JAX_NAMES or name in ("select", "reciprocal", "rsub",
                                          "_to_copy", "clone"):
        attrs["aten"] = str(func)
    return attrs


def _lower_generic(tr, func, name, args, kwargs, inputs, outs, replay):
    """One node of the JAX name.  An in-place write (``index_put_`` on a
    KV pool) keeps value semantics: its output is a new value, and since
    the operation returns the written tensor itself, binding the output
    makes that tensor the new value for every later reader.  The replay
    writes in place."""
    op = _JAX_NAMES.get(name, name)
    attrs = _attrs_for(name, func, args, kwargs, outs)
    tr.node(op, inputs, tr.out_values(outs), attrs, replay)


def _lower_relu(tr, func, name, args, kwargs, inputs, outs, replay):
    """``relu(x)`` / ``clamp_min(x, c)`` -> ``max(x, c)``: JAX's relu,
    with ``c`` a const input (replayed as the operation was called)."""
    x = args[0]
    c = 0 if name == "relu" else args[1]
    if isinstance(c, torch.Tensor):
        return _lower_generic(tr, func, name, args, kwargs, inputs, outs,
                              replay)
    zero = tr.const(c, x.dtype, x.device)
    tr.node("max", inputs + [zero], tr.out_values(outs),
            {"aten": str(func)}, replay)


def _product_replay(a, b, out_dtype, plain: Replay,
                    slots=(_Slot(0), _Slot(1))) -> Replay:
    """How a traced ``a @ b`` replays: through ``apr_matmul`` for two bf16
    or two fp32 matrices, as every 2-D product of the graph runs (B1 on the
    card); for other dtypes ``plain`` (the ATen call) on the CPU, while the
    card, which has no kernel for them, refuses the trace."""
    if a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float32):
        from ..kernels.apr_matmul import apr_matmul
        return Replay(apr_matmul, tuple(slots), {"out_dtype": out_dtype})
    if a.is_cuda:
        raise NotImplementedError(
            f"graph tracer: a {a.dtype} x {b.dtype} product has no kernel "
            f"on the card (apr_matmul takes two bf16 or two fp32 matrices)")
    return plain


def _lower_mm(tr, func, name, args, kwargs, inputs, outs, replay):
    """``x @ w`` -> a ``matmul`` node (see :func:`_product_replay`)."""
    out = outs[0]
    tr.node("matmul", inputs, tr.out_values(outs),
            {"dimension_numbers": _mm_dims(2),
             "preferred_element_type": out.dtype, "aten": str(func)},
            _product_replay(args[0], args[1], out.dtype, replay,
                            replay.args[:2]))


def _lower_bmm(tr, func, name, args, kwargs, inputs, outs, replay):
    """A batched product -> a ``matmul`` node with a batch axis, replaying
    ``bmm`` on the CPU.  The card has no kernel for it (the model's
    attention products run inside the decode-attention node there), so a
    trace on CUDA tensors refuses it rather than replay cuBLAS."""
    if args[0].is_cuda:
        raise NotImplementedError(
            "graph tracer: a batched product has no kernel on the card")
    _lower_generic(tr, func, name, args, kwargs, inputs, outs, replay)


def _lower_mean(tr, func, name, args, kwargs, inputs, outs, replay):
    """``mean`` -> ``reduce_sum`` + ``div``, JAX's decomposition; the sum
    node replays the whole mean, the div passes it on."""
    out = outs[0]
    s = tr.g.new_value(out.shape, out.dtype).id
    tr.node("reduce_sum", inputs, [s],
            {"axes": tuple(a for a in args[1:]), "aten": str(func)}, replay)
    tr.node("div", [s], tr.out_values(outs), {},
            Replay(None, (), {}, passthrough=True))


def _lower_addmm(tr, func, name, args, kwargs, inputs, outs, replay):
    """``addmm(bias, a, b)`` -> ``matmul(a, b)`` + ``add(., bias)``: the
    matmul replays as :func:`_lower_mm`'s does, the add adds, so the
    product runs on B1 on the card (the eager ``addmm`` is one cuBLAS
    call, so its bits are not the graph's).  ``beta`` / ``alpha`` other
    than 1 are refused."""
    bias, a, b = args[0], args[1], args[2]
    if kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1:
        raise NotImplementedError(
            "graph tracer: addmm with beta or alpha other than 1")
    out = outs[0]
    mm = tr.g.new_value(out.shape, out.dtype).id
    tr.node("matmul", [tr.vid(a), tr.vid(b)], [mm],
            {"dimension_numbers": _mm_dims(2),
             "preferred_element_type": out.dtype, "aten": str(func)},
            _product_replay(a, b, out.dtype,
                            Replay(aten.mm.default, (_Slot(0), _Slot(1)),
                                   {})))
    tr.node("add", [mm, tr.vid(bias)], tr.out_values(outs), {},
            Replay(aten.add.Tensor, (_Slot(0), _Slot(1)), {}))


_LOWER: Dict[str, Callable] = {
    "relu": _lower_relu, "clamp_min": _lower_relu, "mean": _lower_mean,
    "addmm": _lower_addmm, "mm": _lower_mm, "bmm": _lower_bmm,
}


# ---------------------------------------------------------------------------
# Kernel-wrapper lowerings.
# ---------------------------------------------------------------------------


def _split_args(wrapper, args, kwargs, names):
    """Positional-or-keyword arguments ``names`` of a call, then the rest of
    the keywords."""
    got = list(args)
    vals = []
    for i, n in enumerate(names):
        if i < len(got):
            vals.append(got[i])
        else:
            vals.append(kwargs.get(n))
    rest = {k: v for k, v in kwargs.items() if k not in names}
    return vals, rest


def _leaf_matmul(tr, wrapper, args, kwargs):
    """``apr_matmul(x, y, ...)`` / ``matmul_ref(x, y, out_dtype)``: one
    ``matmul`` node of ``out_dtype``; an int8 ``y`` arrives through JAX's
    dequant chain."""
    (x, y), rest = _split_args(wrapper, args, kwargs, ("x", "y"))
    if wrapper.__name__ == "matmul_ref":
        out_dtype = args[2] if len(args) > 2 else kwargs.get(
            "out_dtype", torch.float32)
    else:
        out_dtype = kwargs.get("out_dtype", torch.float32)
    n = y.shape[1]
    out = tr.fresh((x.shape[0], n), out_dtype, x.device)
    xv = tr.vid(x)
    if isinstance(y, QuantizedTensor):
        q, scale = y.q, y.scale
        c = tr.g.new_value(q.shape, torch.float32).id
        tr.node("convert_element_type", [tr.vid(q)], [c],
                {"new_dtype": torch.float32},
                Replay(_codes, (_Slot(0),), {}, lazy=True))
        s = tr.g.new_value(q.shape, torch.float32).id
        tr.node("mul", [c, tr.vid(scale)], [s], {},
                Replay(_scaled, (_Slot(0), _Slot(1)), {}, lazy=True))
        w = tr.g.new_value(q.shape, x.dtype).id
        tr.node("convert_element_type", [s], [w], {"new_dtype": x.dtype},
                Replay(_cast_to(x.dtype), (_Slot(0),), {}, lazy=True))
        replay = Replay(_matmul_quantized(wrapper), (_Slot(0), _Slot(1)),
                        dict(rest), lazy=True)
    else:
        w = tr.vid(y)
        replay = Replay(wrapper, (_Slot(0), _Slot(1)) + tuple(args[2:]),
                        dict(rest))
    attrs = {"dimension_numbers": _mm_dims(2),
             "preferred_element_type": out_dtype, "kernel": wrapper.__name__}
    tr.node("matmul", [xv, w], tr.out_values([out]), attrs, replay)
    return out


def _matmul_quantized(wrapper):
    """The replay of a matmul over a lazily dequantized int8 weight: the
    wrapper gets the :class:`QuantizedTensor`, as the eager call gave it."""
    def run(x, w, **kw):
        x = _real(x)
        if isinstance(w, LazyDequant):
            w = w.quantized()
        return wrapper(x, w, **kw)
    run.__name__ = wrapper.__name__
    return run


def _conv_out_shape(x, f, stride: int, padding: int):
    b, h, w, _ = x.shape
    hf, wf, _, m = f.shape
    return (b, (h + 2 * padding - hf) // stride + 1,
            (w + 2 * padding - wf) // stride + 1, m)


def _leaf_conv(tr, wrapper, args, kwargs):
    """``apr_conv2d(x, f, stride=, padding=)``: one ``conv2d`` node with
    JAX's NHWC x HWIO dimension numbers (fp32 out)."""
    (x, f), rest = _split_args(wrapper, args, kwargs, ("x", "f"))
    stride, padding = int(rest.get("stride", 1)), int(rest.get("padding", 0))
    out = tr.fresh(_conv_out_shape(x, f, stride, padding), torch.float32,
                   x.device)
    attrs = dict(window_strides=(stride, stride),
                 padding=((padding, padding), (padding, padding)),
                 lhs_dilation=(1, 1), rhs_dilation=(1, 1),
                 dimension_numbers=NHWC_HWIO, feature_group_count=1,
                 batch_group_count=1, kernel=wrapper.__name__)
    if rest.get("residency", "apr") != "apr":
        attrs["residency"] = rest["residency"]
    tr.node("conv2d", [tr.vid(x), tr.vid(f)], tr.out_values([out]), attrs,
            Replay(wrapper, (_Slot(0), _Slot(1)), dict(rest)))
    return out


def _leaf_depthwise(tr, wrapper, args, kwargs):
    """``models.cnn.depthwise(x, f, stride)``: one NHWC ``conv2d`` node
    with ``feature_group_count = C`` (3x3, padding 1), the JAX model's
    grouped conv; JAX's ``_conv_geometry`` never dispatches it."""
    (x, f, stride), _ = _split_args(wrapper, args, kwargs,
                                    ("x", "f", "stride"))
    b, h, w, c = x.shape
    out = tr.fresh((b, (h - 1) // stride + 1, (w - 1) // stride + 1, c),
                   x.dtype, x.device)
    attrs = dict(window_strides=(stride, stride), padding=((1, 1), (1, 1)),
                 lhs_dilation=(1, 1), rhs_dilation=(1, 1),
                 dimension_numbers=NHWC_HWIO, feature_group_count=int(c),
                 batch_group_count=1, kernel=wrapper.__name__)
    tr.node("conv2d", [tr.vid(x), tr.vid(f)], tr.out_values([out]), attrs,
            Replay(wrapper, (_Slot(0), _Slot(1), stride), {}))
    return out


def _leaf_attention(tr, wrapper, args, kwargs):
    """``flash_decode_paged(q, pools, lengths, tables, ...)``: one opaque
    node named after it, q's shape and dtype out."""
    q = args[0]
    out = tr.fresh(q.shape, q.dtype, q.device)
    inputs: List[int] = []
    t_args = tr.template(tuple(args), inputs)
    t_kwargs = tr.template(dict(kwargs), inputs)
    tr.node(wrapper.__name__, inputs, tr.out_values([out]),
            {"kernel": wrapper.__name__}, Replay(wrapper, t_args, t_kwargs))
    return out


_LEAVES: Dict[str, Callable] = {
    "apr_matmul": _leaf_matmul,
    "matmul_ref": _leaf_matmul,
    "apr_conv2d": _leaf_conv,
    "depthwise": _leaf_depthwise,
    "flash_decode_paged": _leaf_attention,
}


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------


class ShapeSpec:
    """An example argument by shape, dtype and device alone (JAX's
    ``ShapeDtypeStruct``)."""

    def __init__(self, shape, dtype, device="cpu"):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.device = torch.device(device)


def trace(fn: Callable, *example_args, name: str = "graph") -> Graph:
    """Lower ``fn(*example_args)`` to a :class:`~repro_torch.graph.ir.Graph`.

    ``example_args`` are pytrees of tensors (only their shapes, dtypes and
    devices are read; nothing is computed on them or written to them) or
    :class:`ShapeSpec` s.  Tensors ``fn`` closes over become graph consts;
    the graph's ``in_tree``/``out_tree`` record the pytree signature so
    that the executor can be called exactly like ``fn``.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    flat, in_tree = pytree.tree_flatten(example_args)
    g = Graph(values={}, nodes=[], inputs=[], outputs=[], in_tree=in_tree,
              name=name)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    tracer = _Tracer(g)
    with mode:
        fakes = []
        for a in flat:
            if isinstance(a, ShapeSpec):
                fakes.append(torch.empty(a.shape, dtype=a.dtype,
                                         device=a.device))
            elif isinstance(a, torch.Tensor):
                fakes.append(mode.from_tensor(a))
            else:
                raise TypeError(f"graph tracer: example argument {a!r} is "
                                "not a tensor or a ShapeSpec")
        g.device = fakes[0].device if fakes else None
        for f in fakes:
            v = g.new_value(f.shape, f.dtype, kind="input")
            tracer.bind(f, v.id)
            g.inputs.append(v.id)
        args = pytree.tree_unflatten(fakes, in_tree)
        if _leaf.active_tracer() is not None:
            raise RuntimeError("graph tracer: a trace is already running")
        _leaf.set_tracer(tracer)
        try:
            with tracer:
                out = fn(*args)
        finally:
            _leaf.set_tracer(None)
    out_flat, out_tree = pytree.tree_flatten(out)
    for t in out_flat:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"graph tracer: {name} returns {type(t)}, not "
                            "tensors")
        g.outputs.append(tracer.vid(t))
    g.out_tree = out_tree
    return g
