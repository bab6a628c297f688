"""Test-side bridge between the JAX graph compiler and the port's.

* :func:`jax_graph_shim` lays two attributes over the *loaded* JAX tracer
  module so that it runs on jax 0.9 (whose ``jax.extend.core`` has no
  ``DropVar``, and whose fallback ``jax.core`` has no ``Literal``; and
  which names the pjit primitive ``jit``).  It goes through pytest's
  ``MonkeyPatch`` only, scoped to a module by :func:`jax_shim`, and is
  undone at teardown: nothing of ``src/repro/`` changes, and a worker that
  runs ``tests/test_graph.py`` later sees the module as it was.
  ``import repro.graph.trace`` would yield the *function* ``trace`` that
  ``repro/graph/__init__.py`` re-exports, so the module comes from
  ``sys.modules``.
* :func:`to_port` converts a JAX-traced graph into the port's IR: values,
  shapes, numpy dtypes, kinds, ops and the attributes the passes read,
  consts as tensors, the node counter -- so the port's passes run on the
  very graph the JAX passes run on.
* :func:`summarize` / :func:`plan_summary` / :func:`decision_summary`
  reduce either compiler's results to plain tuples to compare.
* :func:`own_tune_caches` gives a test tune caches of its own for its
  whole extent.
"""
import contextlib
import dataclasses
import sys
import types

import numpy as np
import pytest

#: the JAX engine geometry of the traffic figures compared (un-quantized
#: bf16 smoke params, the JAX engine's page size and chunk, 2 slots)
LLM_GEO = dict(slots=2, page_size=16, prefill_chunk=16)


@contextlib.contextmanager
def own_tune_caches(tmp_path, monkeypatch):
    """Both packages' tune caches under ``tmp_path`` while the block runs.
    The env variables steer only a cache built later: the port's
    process-wide default, which an earlier test in the same process may
    have built from the package's own ``_tune/tune_cache.json``, is
    replaced outright by a fresh one and put back after.  Without it a
    schedule stored by an earlier run is replayed (no per-pass audit), and
    this test's schedules land in the package's file."""
    from repro_torch.bench import ConfigCache, set_default_cache
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    prev = set_default_cache(ConfigCache(tmp_path / "torch.json"))
    try:
        yield
    finally:
        set_default_cache(prev)


def jax_graph_shim(mp) -> None:
    import jax
    import jax.extend.core as jec
    from jax._src import core as jsc

    import repro.graph  # noqa: F401  (loads repro.graph.trace)
    tr = sys.modules["repro.graph.trace"]
    mp.setattr(tr, "jcore", types.SimpleNamespace(
        Literal=jec.Literal, DropVar=jsc.DropVar,
        ClosedJaxpr=jec.ClosedJaxpr))
    if "jit" not in tr._INLINE_CALLS:
        mp.setattr(tr, "_INLINE_CALLS", tr._INLINE_CALLS + ("jit",))
    assert jax is not None


@pytest.fixture(scope="module")
def jax_shim():
    with pytest.MonkeyPatch.context() as mp:
        jax_graph_shim(mp)
        yield


def _attr(v):
    from repro_torch.graph.ir import ConvDimensionNumbers
    if hasattr(v, "lhs_spec"):
        return ConvDimensionNumbers(tuple(v.lhs_spec), tuple(v.rhs_spec),
                                    tuple(v.out_spec))
    if isinstance(v, tuple):
        return tuple(_attr(a) for a in v)
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return np.dtype(v)
    except TypeError:
        return repr(v)


def _node(n):
    from repro_torch.graph.ir import Node
    return Node(id=n.id, op=n.op, inputs=tuple(n.inputs),
                outputs=tuple(n.outputs),
                attrs={k: _attr(v) for k, v in n.attrs.items()},
                body=None if n.body is None else [_node(b) for b in n.body],
                pattern=n.pattern)


def to_port(jg):
    """The port's IR of the JAX graph ``jg`` (before or after passes)."""
    from repro_torch.bridge import tensor_from_numpy
    from repro_torch.graph.ir import Graph, Value
    values = {}
    for vid, v in jg.values.items():
        arr = None
        if v.array is not None:
            arr = tensor_from_numpy(np.asarray(v.array))
        values[vid] = Value(id=v.id, shape=tuple(int(d) for d in v.shape),
                            dtype=np.dtype(v.dtype), kind=v.kind, array=arr)
    return Graph(values=values, nodes=[_node(n) for n in jg.nodes],
                 inputs=list(jg.inputs), outputs=list(jg.outputs),
                 name=jg.name, _node_counter=jg._node_counter)


def copy_graph(g):
    """A copy the passes may rewrite (they replace nodes and add values,
    never edit one in place); consts are shared."""
    return dataclasses.replace(g, values=dict(g.values), nodes=list(g.nodes))


def _dtype_str(d):
    """``float32`` of a numpy or a torch dtype."""
    return None if d is None else str(d).rsplit(".", 1)[-1]


def summarize(g):
    """Every node as a tuple: ids, op, pattern, body, the dispatch
    attributes."""
    out = []
    for n in g.nodes:
        a = n.attrs
        out.append((
            n.id, n.op, n.pattern, tuple(n.inputs), tuple(n.outputs),
            tuple((b.id, b.op) for b in n.body) if n.body else None,
            a.get("pallas_ok"), a.get("activation"), a.get("bias"),
            a.get("anchor"), _dtype_str(a.get("out_dtype"))))
    return out


def plan_summary(g, memory_report, arena_plan):
    plan = arena_plan(g)
    return (memory_report(g).to_dict(), dict(plan.offsets),
            plan.arena_bytes, plan.naive_bytes)


def decision_summary(d):
    return (list(d.passes),
            [(r.name, r.kept, r.traffic_before, r.traffic_after,
              r.nodes_before, r.nodes_after) for r in d.decisions],
            d.unfused.intermediate_traffic, d.fused.intermediate_traffic,
            d.traffic_reduction)


def jax_kernel_clusters(g):
    """``(pattern, activation, has bias)`` of the clusters the JAX
    executor's ``impl="pallas"`` sends to a fused kernel."""
    from repro.graph.executor import _conv_geometry
    from repro.graph.passes import _is_plain_2d_matmul
    out = []
    for n in g.nodes:
        if not (n.is_fused and n.attrs.get("pallas_ok")
                and len(n.outputs) == 1):
            continue
        bias = n.attrs.get("bias")
        if bias is not None and bias not in n.inputs:
            continue
        anchor = next(b for b in n.body if b.id == n.attrs["anchor"])
        ok = ((n.pattern == "matmul_epilogue" and anchor.op == "matmul"
               and _is_plain_2d_matmul(g, anchor))
              or (n.pattern == "matmul_epilogue"
                  and anchor.op == "quant_matmul")
              or (n.pattern == "conv_epilogue" and anchor.op == "conv2d"
                  and _conv_geometry(anchor) is not None))
        if ok:
            out.append((n.pattern, n.attrs.get("activation", "none"),
                        bias is not None))
    return sorted(out)


# ---------------------------------------------------------------- models
def jax_llama():
    """The JAX llama3-8b smoke bundle and its params at PRNGKey(0)."""
    import jax
    from repro.configs import get_config
    from repro.models import build_model
    bundle = build_model(get_config("llama3-8b", smoke=True))
    return bundle, bundle.init_params(jax.random.PRNGKey(0))


def jax_llm_graphs(bundle, params, *, int8: bool, geo=None):
    """The JAX-traced (unfused) prefill and decode graphs of the paged
    serving step at ``geo`` (default :data:`LLM_GEO`)."""
    from repro.graph.compiler import compile_decode_step, compile_prefill_step
    from repro.parallel import ParallelContext
    from repro.serve import PagedServeEngine
    geo = dict(LLM_GEO if geo is None else geo)
    pctx = ParallelContext(None)
    eng = PagedServeEngine(bundle, params, pctx, **geo)
    if int8:
        params = bundle.quantize_params(params)
    chunk, slots = geo["prefill_chunk"], geo["slots"]
    pre = compile_prefill_step(bundle, params, eng.cache, chunk=chunk,
                               table_width=eng._table_width(chunk),
                               pctx=pctx, fused=False)
    dec = compile_decode_step(bundle, params, eng.cache, slots=slots,
                              table_width=eng._table_width(1), pctx=pctx,
                              fused=False)
    return pre.executor.graph, dec.executor.graph


def torch_params(jparams):
    """The JAX params bridged to the port, int8 weights as
    :class:`~repro_torch.quant.QuantizedTensor` s."""
    from repro.quant import QuantizedTensor as JaxQT
    from repro_torch.bridge import params_from_numpy
    return params_from_numpy({
        k: ((np.asarray(v.q), np.asarray(v.scale)) if isinstance(v, JaxQT)
            else np.asarray(v)) for k, v in jparams.items()})


# ------------------------------------------------- engines
#: test_engine_identity.py's geometry and trace
PAGED_KW = dict(slots=2, page_size=8, num_pages=16, prefill_chunk=8)
HEAD = [2 + (j % 5) for j in range(16)]


def drain(eng, request_cls):
    """Serve the 3-request trace on ``eng``; the greedy tokens."""
    reqs = [request_cls(rid=i, prompt=HEAD + [50 + i] * 4, max_new_tokens=6)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def jax_engines(weights: str, graph: bool):
    """The JAX golden (plain paged engine, un-quantized weights cast to
    fp32) and, with ``graph``, the JAX graph engine on ``weights``; plus
    the JAX params of ``weights``."""
    import jax
    import jax.numpy as jnp
    from repro.parallel import ParallelContext
    from repro.serve import PagedServeEngine as JaxEngine
    from repro.serve import Request as JaxRequest
    bundle, params = jax_llama()
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    pctx = ParallelContext(None)
    golden = drain(JaxEngine(bundle, params, pctx, **PAGED_KW), JaxRequest)
    if weights == "int8":
        params = bundle.quantize_params(params)
    jgraph = (drain(JaxEngine(bundle, params, pctx, use_graph=True,
                              **PAGED_KW), JaxRequest) if graph else None)
    return golden, jgraph, params


def port_engine(tparams, **kw):
    """The port's llama smoke paged engine on the CPU at :data:`PAGED_KW`."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServeEngine
    bundle = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    return PagedServeEngine(bundle, tparams, device="cpu", **PAGED_KW, **kw)
