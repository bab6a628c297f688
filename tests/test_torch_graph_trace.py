"""The port's graph tracer against the JAX tracer.

The port's own LeNet-5, ResNet-20 and llama3-8b smoke serving steps are
traced on the CPU from weights bridged from the JAX package's, and held to
the JAX tracer's graphs of the JAX functions (under the test-side jax 0.9
shim): equal ``matmul`` / ``conv2d`` / ``quant_matmul`` counts, equal
multisets of the clusters the executors send to a fused kernel, the CNNs'
intermediate-bytes reductions within 5 % of the JAX compiler's, the llama
steps' schedules reducing traffic; ``graph_signature`` is stable across
traces and moves with the shape.
"""
import collections

import jax
import numpy as np
import pytest
import torch
from _torch_graph_bridge import (LLM_GEO, jax_kernel_clusters, jax_llama,
                                 jax_llm_graphs, jax_shim, own_tune_caches,
                                 torch_params)

from repro_torch.configs import get_config
from repro_torch.cost import graph_signature
from repro_torch.graph import compile_fn, memory_report, run_passes, trace
from repro_torch.graph.compiler import (compile_decode_step,
                                        compile_prefill_step)
from repro_torch.models import build_model
from repro_torch.models import cnn

assert jax_shim  # the module-scoped fixture the tests below request

ANCHORS = ("matmul", "conv2d", "quant_matmul")
CNN_BATCH = {"lenet": 8, "resnet20": 2}


def _counts(g):
    ops = collections.Counter(b.op for n in g.nodes for b in n.body_nodes())
    return {op: ops[op] for op in ANCHORS}


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """Schedules and tiles go to caches of this test's own."""
    with own_tune_caches(tmp_path, monkeypatch):
        yield


@pytest.fixture(scope="module", params=["lenet", "resnet20"])
def cnn_pair(request, jax_shim):
    """(name, JAX graph unfused, JAX graph fused, the port's traced
    function and example input) on the same weights."""
    from repro.graph import run_passes as j_run, trace as j_trace
    from repro.models import cnn as jax_cnn
    from repro_torch.bridge import params_from_numpy
    name = request.param
    spec = jax_cnn.CNNS[name]
    jp = spec["params"](jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(
        (CNN_BATCH[name],) + spec["input"]).astype(np.float32)
    jfn = lambda xx: spec["forward"](jp, xx)  # noqa: E731
    ju = j_trace(jfn, jax.numpy.asarray(x))
    jf = j_run(j_trace(jfn, jax.numpy.asarray(x)))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    fwd = cnn.CNNS[name]["forward"]
    return name, ju, jf, (lambda xx: fwd(tp, xx)), torch.from_numpy(x)


def test_cnn_anchor_counts_equal(cnn_pair):
    _, ju, _, fn, x = cnn_pair
    assert _counts(trace(fn, x)) == _counts(ju)


def test_cnn_dispatched_clusters_equal(cnn_pair):
    """LeNet-5: two FC + relu clusters to B7m; ResNet-20: ten conv + relu
    clusters to B7 -- in both compilers."""
    name, _, jf, fn, x = cnn_pair
    ex = compile_fn(fn, x, impl="kernel", cost_model=False)
    got = sorted(ex.kernel_clusters())
    assert got == jax_kernel_clusters(jf)
    want = {"lenet": [("matmul_epilogue", "relu", False)] * 2,
            "resnet20": [("conv_epilogue", "relu", False)] * 10}[name]
    assert got == want


def test_cnn_traffic_reduction_within_5_percent(cnn_pair):
    from repro.graph import memory_report as j_memory
    name, ju, jf, fn, x = cnn_pair
    g = trace(fn, x)
    unfused = memory_report(g).intermediate_bytes
    fused = memory_report(run_passes(g)).intermediate_bytes
    mine = unfused / fused
    theirs = (j_memory(ju).intermediate_bytes
              / j_memory(jf).intermediate_bytes)
    print(f"{name}: port {mine:.3f} ({unfused} / {fused}), JAX {theirs:.3f}")
    assert abs(mine / theirs - 1) <= 0.05


@pytest.fixture(scope="module")
def llm(jax_shim):
    """The JAX llama smoke graphs and the port's bundle, params and cache
    at the same geometry (the same weights, bridged)."""
    from repro_torch.serve import PagedServeEngine
    jbundle, jparams = jax_llama()
    out = {}
    tb = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    for w in ("bf16", "int8"):
        jp = jbundle.quantize_params(jparams) if w == "int8" else jparams
        pre, dec = jax_llm_graphs(jbundle, jparams, int8=(w == "int8"))
        tp = torch_params(jp)
        eng = PagedServeEngine(tb, tp, device="cpu", **LLM_GEO)
        out[w] = (pre, dec, tp, eng.cache, eng.kv.max_pages_per_slot)
    return tb, out


def _port_steps(tb, tp, cache, width, chunk=LLM_GEO["prefill_chunk"]):
    pre = compile_prefill_step(tb, tp, cache, chunk=chunk,
                               table_width=width)
    dec = compile_decode_step(tb, tp, cache, slots=LLM_GEO["slots"],
                              table_width=width)
    return pre.executor, dec.executor


@pytest.mark.parametrize("w", ["bf16", "int8"])
def test_llm_steps_equal_anchor_counts_and_kernels(llm, w):
    """31 matmul a step (q, k, v, w_gate, w_up, wo and w_down as 4 split-K
    chunks each, the two attention products, the head); with int8 weights
    the schedule folds the head alone into a ``quant_matmul``, as the JAX
    one does.  No cluster goes to a fused kernel in either."""
    from repro.cost import select_passes
    from _torch_graph_bridge import copy_graph
    tb, steps = llm
    jpre, jdec, tp, cache, width = steps[w]
    pre, dec = _port_steps(tb, tp, cache, width)
    upre, udec = (s.executor for s in (
        compile_prefill_step(tb, tp, cache, chunk=LLM_GEO["prefill_chunk"],
                             table_width=width, fused=False),
        compile_decode_step(tb, tp, cache, slots=LLM_GEO["slots"],
                            table_width=width, fused=False)))
    for label, ex, unfused, jg in (("prefill", pre, upre, jpre),
                                   ("decode", dec, udec, jdec)):
        assert _counts(unfused.graph) == _counts(jg) == {
            "matmul": 31, "conv2d": 0, "quant_matmul": 0}, label
        jfused = copy_graph(jg)
        jd = select_passes(jfused)
        assert _counts(ex.graph) == _counts(jfused), label
        assert _counts(ex.graph)["quant_matmul"] == (w == "int8")
        assert sorted(ex.kernel_clusters()) == jax_kernel_clusters(
            jfused) == []
        d = ex.schedule
        print(f"llama {w} {label}: port schedule {d.passes} traffic "
              f"{d.traffic_reduction:.3f}x, JAX {jd.passes} "
              f"{jd.traffic_reduction:.3f}x")
        assert d.traffic_reduction > 1.0
        assert d.passes == jd.passes


def test_graph_signature_stable_and_shape_keyed(llm):
    tb, steps = llm
    _, _, tp, cache, width = steps["bf16"]

    def sig(chunk):
        def step(c, t, l, n, bt):
            return tb.decode_paged(tp, c, t, l, n, bt)
        ex = [torch.zeros((1, chunk), dtype=torch.int32),
              torch.zeros((1,), dtype=torch.int32),
              torch.zeros((1,), dtype=torch.int32),
              torch.zeros((1, width), dtype=torch.int32)]
        g = trace(step, dict(cache), *ex)
        # nothing in the signed attributes carries an address, so the
        # signature holds across processes too
        assert not [(n.op, k) for n in g.nodes for k, v in n.attrs.items()
                    if " at 0x" in repr(v)]
        return graph_signature(g)

    a, b = sig(16), sig(16)
    assert a == b
    assert sig(8) != a
