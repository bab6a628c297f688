"""One-call compile entry points + the process compile cache.

Port of the JAX package's ``repro.graph.compiler``.  :func:`compile_fn` is
the generic path: trace -> fusion passes ->
:class:`~repro_torch.graph.executor.GraphExecutor`.  Pass ``key=`` to
memoize the built executor in the process-wide compile cache (repeated
``compile_fn`` calls for the same shapes skip retracing; the executor's
own per-node cache handles repeated *calls*).

:func:`compile_prefill_step` / :func:`compile_decode_step` are the
serving integration: ``PagedServeEngine(use_graph=True)`` routes its
chunked-prefill step and its batched T=1 decode tick through them.  The
model's paged decode contract is traced at the engine's fixed shapes
(prefill: B=1, T=chunk; decode: B=slots, T=1) on the engine's device --
the port's layers already run unrolled, layer by layer -- the cost model
(or the default pass pipeline) fuses it, and the wrappers keep the
engine's ``(params, cache, tokens, lengths, counts, block_tables)`` call
signature.  Params are baked into the graph as consts, by reference, at
compile time -- the serving deployment shape (weights never change under
an engine); the KV pools stay graph inputs, written in place.

The dense family is served; the other families raise
``NotImplementedError`` by name: moe reads its expert counts on the host,
which a graph at fixed shapes cannot hold, and the vlm, recurrent and
audio families are not ported to the graph path yet.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from .executor import GraphExecutor
from .passes import run_passes
from .trace import ShapeSpec, trace

_COMPILE_CACHE: Dict[Hashable, GraphExecutor] = {}

_COST_MODEL_ENV = "REPRO_TORCH_COST_MODEL"

#: the model families the graph-compiled serving steps take
GRAPH_FAMILIES = ("dense",)


def _cost_model_enabled(flag: Optional[bool]) -> bool:
    """Explicit flag > ``$REPRO_TORCH_COST_MODEL`` (``0``/``off``/``false``
    disables) > on by default."""
    if flag is not None:
        return flag
    return os.environ.get(_COST_MODEL_ENV, "").strip().lower() not in (
        "0", "off", "false", "no")


def clear_compile_cache() -> None:
    _COMPILE_CACHE.clear()


def compile_fn(fn: Callable, *example_args,
               passes: Optional[Sequence[str]] = None,
               fused: bool = True,
               impl: Optional[str] = None,
               key: Optional[Hashable] = None,
               cost_model: Optional[bool] = None,
               name: str = "graph") -> GraphExecutor:
    """Trace ``fn`` at ``example_args``, fuse, and wrap in an executor.

    ``fused=False`` skips the passes entirely — every primitive runs as
    its own call, materializing every intermediate (the memory-resident
    baseline).  ``passes`` selects/orders a subset of
    :func:`repro_torch.graph.passes.default_passes` and bypasses the cost
    model (an explicit pipeline is an override, not a candidate set).

    With the cost model on (the default; ``cost_model=False`` or
    ``$REPRO_TORCH_COST_MODEL=off`` reverts to the fixed pipeline) the
    fused path routes through :func:`repro_torch.cost.plan_graph`: the
    schedule cache in the active
    :class:`~repro_torch.bench.config.ConfigCache` is consulted by graph
    signature, and on a miss each registered rewrite is kept only on a
    predicted traffic win.  The chosen
    :class:`~repro_torch.cost.ScheduleDecision` is attached to the
    executor as ``.schedule`` (None on the other paths) for ``--explain``.
    ``impl`` is the executor's (``None``: ``"kernel"`` for a graph traced
    on CUDA tensors, else ``"plain"``).
    """
    if key is not None and key in _COMPILE_CACHE:
        return _COMPILE_CACHE[key]
    g = trace(fn, *example_args, name=name)
    schedule = None
    if fused:
        if passes is None and _cost_model_enabled(cost_model):
            # lazy import: repro_torch.cost imports this package's modules
            from ..cost import plan_graph
            schedule = plan_graph(g, profile=_profile(g))
        else:
            g = run_passes(g, passes)
    ex = GraphExecutor(g, impl=impl)
    ex.schedule = schedule
    if key is not None:
        _COMPILE_CACHE[key] = ex
    return ex


def _profile(g):
    """The hardware profile of the device ``g`` was traced on."""
    from ..roofline.hw import get_profile
    return get_profile(device=g.device)


def _check_family(bundle) -> None:
    fam = bundle.cfg.family
    if fam not in GRAPH_FAMILIES:
        raise NotImplementedError(
            f"the graph-compiled serving step takes the "
            f"{', '.join(GRAPH_FAMILIES)} family, not {fam!r} "
            f"({bundle.cfg.name}); serve it with use_graph=False")


def _compile_step(bundle, params, cache, *, rows: int, t: int,
                  table_width: int, fused, impl, passes, cost_model,
                  name) -> Callable:
    _check_family(bundle)

    def step(cache, tokens, lengths, counts, block_tables):
        return bundle.decode_paged(params, cache, tokens, lengths, counts,
                                   block_tables)

    dev = bundle.device
    example = (
        dict(cache),
        ShapeSpec((rows, t), torch.int32, dev),
        ShapeSpec((rows,), torch.int32, dev),
        ShapeSpec((rows,), torch.int32, dev),
        ShapeSpec((rows, table_width), torch.int32, dev),
    )
    ex = compile_fn(step, *example, passes=passes, fused=fused, impl=impl,
                    cost_model=cost_model, name=name)

    def run(_params, cache, tokens, lengths, counts, block_tables):
        return ex(dict(cache), tokens, lengths, counts, block_tables)

    run.executor = ex  # introspection: metrics and reports read the graph
    return run


def compile_prefill_step(bundle, params, cache, *, chunk: int,
                         table_width: int,
                         fused: bool = True, impl: Optional[str] = None,
                         passes: Optional[Sequence[str]] = None,
                         cost_model: Optional[bool] = None,
                         name: Optional[str] = None) -> Callable:
    """Graph-compile one chunked-prefill step of the paged serve contract.

    Returns a callable with the engine's forward signature ``(params,
    cache, tokens, lengths, counts, block_tables) -> logits``; the
    ``params`` argument is accepted for signature compatibility but
    ignored — the graph baked this engine's params in as consts (int8
    :class:`~repro_torch.quant.QuantizedTensor` entries included, which is
    what lets ``fold_quant_dequant`` see the int8 payloads).  The cache's
    pools are written in place, as the eager step writes them.
    """
    return _compile_step(
        bundle, params, cache, rows=1, t=chunk, table_width=table_width,
        fused=fused, impl=impl, passes=passes, cost_model=cost_model,
        name=name or f"{bundle.cfg.name}-prefill-t{chunk}")


def compile_decode_step(bundle, params, cache, *, slots: int,
                        table_width: int,
                        fused: bool = True, impl: Optional[str] = None,
                        passes: Optional[Sequence[str]] = None,
                        cost_model: Optional[bool] = None,
                        name: Optional[str] = None) -> Callable:
    """Graph-compile the batched T=1 decode tick of the paged serve
    contract — :func:`compile_prefill_step`'s sibling at the decode shapes
    (B=slots, T=1).  Same wrapper contract: params baked in as consts,
    ``.executor`` exposed for graph introspection.

    The engine refuses the *hybrid* family here, as the JAX engine does.
    """
    return _compile_step(
        bundle, params, cache, rows=slots, t=1, table_width=table_width,
        fused=fused, impl=impl, passes=passes, cost_model=cost_model,
        name=name or f"{bundle.cfg.name}-decode-b{slots}")
