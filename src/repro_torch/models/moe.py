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
experts' dispatch counts per MoE layer (:func:`expert_counts`), then, per
non-empty expert, ``w_gate`` and ``w_up`` through ``linear`` and ``w_down`` through
``tp_einsum`` (the ``apr_matmul`` kernel on the card).  A row's result
does not depend on the rows beside it, and an empty queue's rows are never
gathered, so this equals the dense form (:func:`_route_and_dispatch`,
:func:`_expert_ffn_dense`, :func:`_combine`, kept for the tests).  The
combine is an ordered sum from zero over the ``k`` dispatches of a token
in top-k order, rounding to the activations' dtype at every product and
add, as the JAX scatter-add computes it (no ``index_add_`` with repeated
indices, whose order the card does not fix).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..configs.base import ModelConfig
from .layers import (ParamSpecs, Params, fan_in_scale, linear, silu, swiglu,
                     tp_einsum)


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


def moe_ffn_local(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
                  ep_axis: Optional[str] = None) -> torch.Tensor:
    """The MoE FFN over the rows of ``x`` (t, d): route, run each expert
    with a non-empty queue on its queue's rows, combine."""
    if ep_axis is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh (ep_axis) is not ported")
    t, d = x.shape
    r = route(x, p[f"{prefix}.router"], cfg, _capacity(t, cfg))
    vals = torch.zeros((r.expert.shape[0], d), dtype=x.dtype, device=x.device)
    start = 0
    for e, count in enumerate(expert_counts(r)):
        n = min(count, r.capacity)      # the queue: its first n in rank order
        if n:
            idx = r.order[start:start + n]
            vals.index_copy_(0, idx,
                             _expert(p, prefix, e, x[r.token_id[idx]]))
        start += count
    return _ordered_sum(vals, r.weight, t)


def moe_block(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
              pctx=None) -> torch.Tensor:
    """x: (B, T, d).  Every row routes (padded ones too); arctic's dense
    residual (``res_*``) is added after the experts' combine, as
    ``moe_out + swiglu(x)``.  A parallel context with a mesh is refused:
    the expert-parallel path is not ported."""
    if pctx is not None and getattr(pctx, "mesh", None) is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh (moe_block with a mesh) is not "
            "ported")
    b, t, d = x.shape
    out = moe_ffn_local(p, prefix, cfg, x.reshape(b * t, d)).reshape(b, t, d)
    if cfg.dense_residual_ff:
        out = out + swiglu(x, p[f"{prefix}.res_gate"], p[f"{prefix}.res_up"],
                           p[f"{prefix}.res_down"])
    return out
