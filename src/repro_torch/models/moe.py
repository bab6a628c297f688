"""Mixture-of-Experts layer, in PyTorch.

Port of the single-shard path of the JAX package's ``repro.models.moe``:
``moe_params``, the capacity rule, top-k routing with capacity drops,
the expert SwiGLU and the weighted combine.  Expert parallelism over a
mesh (the JAX ``ep_axis`` branch, two all-to-alls) is not ported and is
refused by name.

Routing repeats the JAX arithmetic step by step: the router product in
the activations' dtype cast to fp32, ``softmax`` written out as
``exp(x - max) / sum`` in fp32, the ``k`` largest gates with the lower
expert index first on equal gates (``jax.lax.top_k``'s order; a stable
descending sort here, as ``torch.topk`` promises no order on ties), each
dispatch's rank in its expert's queue from a stable argsort of the flat
selections, and the dispatches ranked at or past ``capacity`` dropped.
Every row routes, padded rows and empty slots included, as JAX routes
all ``B·T`` rows of ``moe_block``.

The JAX layer runs every expert over a dense ``(E, C, d)`` buffer.  The
port's path (:func:`moe_ffn_local`) runs only the experts whose queue is
not empty, each on the rows of its queue: one device-to-host read of the
experts' dispatch counts per MoE layer (:func:`expert_counts`), the rows of
every non-empty queue gathered back to back, then, queue by queue,
``w_gate`` and ``w_up`` through ``linear`` and ``w_down`` through
``tp_einsum`` (the ``apr_matmul`` kernel on the card).  A row's result
does not depend on the rows beside it, and an empty queue's rows are never
gathered, so this equals the dense form (:func:`_route_and_dispatch`,
:func:`_expert_ffn_dense`, :func:`_combine`, kept for the tests).  The
combine is an ordered sum from zero over the ``k`` dispatches of a token
in top-k order, rounding to the activations' dtype at every product and
add, as the JAX scatter-add computes it (no ``index_add_`` with repeated
indices, whose order the card does not fix).

Under a gradient (training) each stacked expert leaf's products run
through :class:`ExpertMatmulFunction`: the same calls forward, and a
backward that writes the leaf's gradient as one tensor of the leaf's
shape -- expert ``e``'s ``dW = Xₑᵀ·dYₑ`` on ``apr_matmul`` straight into
slice ``e``, zeros only on the experts whose queue is empty -- so no
select of an expert's weight leaves a whole-leaf gradient per expert
behind it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.apr_matmul import ops as mm_ops
from ..quant import QuantizedTensor
from .layers import (ParamSpecs, Params, fan_in_scale, grad_wanted, linear,
                     silu, swiglu, tp_einsum)

#: the stacked expert leaves of an MoE layer
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
#: a queue of the training path: (expert, its first row, its rows)
Queue = Tuple[int, int, int]


def moe_params(prefix: str, cfg: ModelConfig,
               layers: Optional[int]) -> ParamSpecs:
    """Shapes and init scales of one (or ``layers`` stacked) MoE blocks,
    name for name as the JAX ``moe_params``: the router ``(d, E)``, the
    experts' ``w_gate`` / ``w_up`` ``(E, d, ff)`` and ``w_down`` ``(E, ff,
    d)``, and arctic's dense residual ``res_*``."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if layers is None else (layers,)
    shapes = {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
              "w_down": (e, ff, d)}
    if cfg.dense_residual_ff:
        fr = cfg.dense_residual_ff
        shapes.update(res_gate=(d, fr), res_up=(d, fr), res_down=(fr, d))
    return {f"{prefix}.{name}": (lead + shape, fan_in_scale(shape))
            for name, shape in shapes.items()}


def _capacity(tokens_local: int, cfg: ModelConfig, ep: int = 1) -> int:
    """Slots per expert queue: the JAX rule, in the same Python float
    arithmetic (``ep`` is unused there too)."""
    per_expert = tokens_local * cfg.experts_per_token / max(cfg.num_experts, 1)
    return max(1, int(per_expert * cfg.moe_capacity_factor + 0.999))


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest values of each row and their indices, largest
    first, the lower index first among equal values (``jax.lax.top_k``)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@dataclasses.dataclass
class Routing:
    """The routing of ``t`` tokens, per dispatch ``j = token · k + i`` (the
    token's ``i``-th choice): the JAX combine metadata ``token_id``,
    ``slot`` (``expert · capacity + rank``, rank 0 where dropped),
    ``keep`` (rank < capacity) and ``weight`` (the normalised gate, in the
    activations' dtype), plus ``expert`` (the flat selections), ``order``
    (the stable argsort of ``expert``: each expert's dispatches in rank
    order) and ``counts`` (dispatches per expert, dropped ones
    included)."""
    token_id: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    expert: torch.Tensor
    order: torch.Tensor
    counts: torch.Tensor
    capacity: int

    @property
    def meta(self):
        """``(token_id, slot, keep, weight)``, the JAX ``meta`` tuple."""
        return self.token_id, self.slot, self.keep, self.weight


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
          capacity: int) -> Routing:
    """Top-k routing of the rows of ``x`` (t, d) with ``capacity`` slots a
    queue, as the JAX ``_route_and_dispatch`` computes its metadata."""
    t = x.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = linear(x, router_w).float()
    weights, sel = top_k(softmax(logits), k)                   # (t, k)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    flat_sel = sel.reshape(-1)                                 # (t·k,)
    order = torch.argsort(flat_sel, stable=True)
    counts = torch.bincount(flat_sel, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    arange = torch.arange(t * k, device=x.device)
    rank = torch.empty_like(flat_sel)
    rank[order] = arange - starts[flat_sel[order]]
    keep = rank < capacity
    slot = flat_sel * capacity + torch.where(keep, rank, 0)
    token_id = torch.arange(t, device=x.device).repeat_interleave(k)
    return Routing(token_id=token_id, slot=slot, keep=keep,
                   weight=weights.reshape(-1).to(x.dtype), expert=flat_sel,
                   order=order, counts=counts, capacity=capacity)


def expert_counts(r: Routing) -> List[int]:
    """Dispatches per expert (dropped ones included), read to the host:
    the one device-to-host read of an MoE layer, which picks the experts
    to launch and where their queues start in ``r.order``."""
    return r.counts.tolist()


def _route_and_dispatch(x: torch.Tensor, router_w: torch.Tensor,
                        cfg: ModelConfig, capacity: int):
    """The JAX function: the ``(E, C, d)`` dispatch buffer (a kept
    dispatch's token row at its slot, zeros elsewhere) and the combine
    metadata."""
    r = route(x, router_w, cfg, capacity)
    e, d = cfg.num_experts, x.shape[1]
    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    rows = torch.where(r.keep, r.slot, e * capacity)
    vals = torch.where(r.keep[:, None], x[r.token_id], 0).to(x.dtype)
    buf.index_put_((rows,), vals, accumulate=True)
    return buf[:e * capacity].reshape(e, capacity, d), r.meta


def _combine(expert_out: torch.Tensor, meta, t: int) -> torch.Tensor:
    """The JAX weighted combine of a dense ``(E, C, d)`` expert output:
    each token's ``k`` weighted values summed from zero in top-k order."""
    e, c, d = expert_out.shape
    token_id, slot, keep, w = meta
    vals = expert_out.reshape(e * c, d)[torch.where(keep, slot, 0)]
    vals = torch.where(keep[:, None], vals, 0).to(expert_out.dtype)
    return _ordered_sum(vals, w, t)


def _ordered_sum(vals: torch.Tensor, w: torch.Tensor, t: int) -> torch.Tensor:
    """``sum_i vals[token·k + i] · w[token·k + i]`` from zero, in ``i``
    order, every product and add rounded to ``vals``' dtype."""
    k = vals.shape[0] // t
    vals, w = vals.reshape(t, k, -1), w.reshape(t, k, 1)
    out = torch.zeros((t, vals.shape[-1]), dtype=vals.dtype,
                      device=vals.device)
    for i in range(k):
        out = out + vals[:, i] * w[:, i]
    return out


def _expert(p: Params, prefix: str, e: int, xs: torch.Tensor) -> torch.Tensor:
    """Expert ``e``'s SwiGLU on the rows ``xs`` (n, d): ``w_gate`` and
    ``w_up`` through ``linear``, ``w_down`` through ``tp_einsum``."""
    g = linear(xs, p[f"{prefix}.w_gate"][e])
    u = linear(xs, p[f"{prefix}.w_up"][e])
    return tp_einsum(silu(g) * u, p[f"{prefix}.w_down"][e])


def _expert_ffn_dense(p: Params, prefix: str,
                      xs: torch.Tensor) -> torch.Tensor:
    """Every expert over its whole ``(C, d)`` queue, empty slots included:
    the JAX ``_expert_ffn``'s shape ``(E, C, d)``."""
    return torch.stack([_expert(p, prefix, e, xs[e])
                        for e in range(xs.shape[0])])


def expert_products(x: torch.Tensor, w, queues: Sequence[Queue],
                    product: Callable) -> torch.Tensor:
    """``product(x[queue], w[e])`` queue by queue (``product`` is ``linear``
    or ``tp_einsum``, ``w`` a stacked expert leaf, int8 ones included), the
    results back to back in the rows of ``x``."""
    y = torch.empty((x.shape[0], w.shape[-1]), dtype=x.dtype,
                    device=x.device)
    for e, s, n in queues:
        y[s:s + n] = product(x[s:s + n], w[e])
    return y


class ExpertMatmulFunction(torch.autograd.Function):
    """The products of one stacked expert leaf ``w`` (E, K, N) under
    autograd.  ``x`` (rows, K) holds the queues' rows back to back;
    ``queues`` lists ``(e, first row, rows)`` of each non-empty queue.  The
    forward is :func:`expert_products`, as serving runs it.  The
    backward, as :class:`~repro_torch.kernels.apr_matmul.AprMatmulFunction`
    computes a product's, on ``apr_matmul`` (the kernel on the card, the
    plain version on the CPU), each only when asked for::

        dXₑ = apr_matmul(dYₑ, W[e]ᵀ, out_dtype=x.dtype)
        dW[e] = apr_matmul(Xₑᵀ, dYₑ, out_dtype=w.dtype)

    with ``dW`` made once, the leaf's shape, each ``dW[e]`` written into its
    slice (``out=``) and the slices of experts with an empty queue set to
    zero: the one tensor of that shape the backward makes."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                queues: Sequence[Queue],
                product: Callable) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.queues = queues
        return expert_products(x, w, queues, product)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.empty_like(x)
            for e, s, n in ctx.queues:
                mm_ops.apr_matmul(dy[s:s + n], w[e].t().contiguous(),
                                  out_dtype=x.dtype, out=dx[s:s + n])
        if ctx.needs_input_grad[1]:
            dw = torch.empty_like(w)
            ran = {e for e, _, _ in ctx.queues}
            empty = [e for e in range(w.shape[0]) if e not in ran]
            if empty:
                dw.index_fill_(0, torch.tensor(empty, device=w.device), 0)
            for e, s, n in ctx.queues:
                mm_ops.apr_matmul(x[s:s + n].t().contiguous(), dy[s:s + n],
                                  out_dtype=w.dtype, out=dw[e])
        return dx, dw, None, None


def _queues(r: Routing) -> List[Tuple[int, torch.Tensor]]:
    """``(e, dispatches)`` of every expert with a non-empty queue: the
    first ``capacity`` of its dispatches in rank order, after the one host
    read of the counts (:func:`expert_counts`)."""
    out, start = [], 0
    for e, count in enumerate(expert_counts(r)):
        n = min(count, r.capacity)
        if n:
            out.append((e, r.order[start:start + n]))
        start += count
    return out


def _experts(p: Params, prefix: str, r: Routing,
             queues: List[Tuple[int, torch.Tensor]],
             x: torch.Tensor) -> torch.Tensor:
    """Every non-empty queue's rows gathered back to back, the SwiGLU by
    :func:`expert_products` a stacked leaf (through
    :class:`ExpertMatmulFunction` under a gradient), and each dispatch's
    value at its place (zeros where dropped)."""
    w_gate, w_up, w_down = (p[f"{prefix}.{name}"] for name in EXPERT_LEAVES)
    products = expert_products
    if grad_wanted(x, *(w for w in (w_gate, w_up, w_down)
                        if isinstance(w, torch.Tensor))):
        if any(isinstance(w, QuantizedTensor)
               for w in (w_gate, w_up, w_down)):
            raise TypeError("moe: an int8 QuantizedTensor expert weight has "
                            "no gradient; train bf16 or fp32 parameters")
        products = ExpertMatmulFunction.apply
    spans, first = [], 0
    for e, idx in queues:
        spans.append((e, first, idx.shape[0]))
        first += idx.shape[0]
    idx = torch.cat([idx for _, idx in queues])
    xs = x[r.token_id[idx]]
    g = products(xs, w_gate, spans, linear)
    u = products(xs, w_up, spans, linear)
    y = products(silu(g) * u, w_down, spans, tp_einsum)
    vals = torch.zeros((r.expert.shape[0], x.shape[1]), dtype=x.dtype,
                       device=x.device)
    return vals.index_copy(0, idx, y)


def moe_ffn_local(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
                  ep_axis: Optional[str] = None) -> torch.Tensor:
    """The MoE FFN over the rows of ``x`` (t, d): route, run each expert
    with a non-empty queue on its queue's rows (:func:`_experts`),
    combine."""
    if ep_axis is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh (ep_axis) is not ported")
    t = x.shape[0]
    r = route(x, p[f"{prefix}.router"], cfg, _capacity(t, cfg))
    return _ordered_sum(_experts(p, prefix, r, _queues(r), x), r.weight, t)


def moe_block(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
              pctx=None, *, closing: bool = False) -> torch.Tensor:
    """x: (B, T, d).  Every row routes (padded ones too); arctic's dense
    residual (``res_*``) is added after the experts' combine, as
    ``moe_out + swiglu(x)`` (``closing`` passed on to it: the block's last
    FFN).  A parallel context with a mesh is refused: the expert-parallel
    path is not ported."""
    if pctx is not None and getattr(pctx, "mesh", None) is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh (moe_block with a mesh) is not "
            "ported")
    b, t, d = x.shape
    out = moe_ffn_local(p, prefix, cfg, x.reshape(b * t, d)).reshape(b, t, d)
    if cfg.dense_residual_ff:
        out = out + swiglu(x, p[f"{prefix}.res_gate"], p[f"{prefix}.res_up"],
                           p[f"{prefix}.res_down"], closing=closing)
    return out
