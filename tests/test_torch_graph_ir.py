"""The port's graph passes, planner and schedule selection held to the JAX
compiler's on the JAX compiler's own graphs.

Each graph is traced by the JAX tracer (under the test-side jax 0.9 shim,
``_torch_graph_bridge.jax_shim``), converted into the port's IR, and run
through the port's passes -- the default pipeline and subsets in several
orders -- beside the JAX passes on the same graph: node lists, patterns,
bodies, ``pallas_ok`` / ``activation`` / ``bias``, ``memory_report``,
``arena_plan`` and ``select_passes``' kept passes and traffic figures must
be identical.  Graphs: the MLP and the negative cases of
``tests/test_graph.py`` (per-row bias, per-row dequant scale, transposed
contraction), LeNet-5 (batch 8), ResNet-20 (batch 2), and the llama3-8b
smoke prefill (B=1, T=16) and decode (B=2, T=1) steps with bf16 and int8
weights.
"""
import jax
import jax.numpy as jnp
import pytest
from _torch_graph_bridge import (copy_graph, decision_summary, jax_llama,
                                 jax_llm_graphs, jax_shim, plan_summary,
                                 summarize, to_port)

import repro_torch.cost as tcost
import repro_torch.graph.passes as tpasses
from repro_torch.graph.plan import arena_plan as t_arena
from repro_torch.graph.plan import memory_report as t_memory

assert jax_shim  # the module-scoped fixture the tests below request

#: subsets and orders of the four passes run beside the default pipeline
SUBSETS = [
    None,
    ["fuse_elementwise_chains"],
    ["fuse_matmul_epilogue", "fuse_conv_epilogue"],
    ["fuse_elementwise_chains", "fuse_matmul_epilogue", "fold_quant_dequant"],
    ["fuse_conv_epilogue", "fold_quant_dequant", "fuse_elementwise_chains",
     "fuse_matmul_epilogue"],
]

#: the JAX compiler's own figures on these graphs: intermediate bytes
#: unfused / fused (CNNs; LeNet-5's is ``BENCH_graph.json``'s) and the
#: cost model's schedule traffic reduction (llama steps)
EXPECTED = {"lenet": 2.368, "resnet20": 2.366, "llama-bf16-prefill": 1.965,
            "llama-bf16-decode": 1.705, "llama-int8-prefill": 2.405,
            "llama-int8-decode": 2.363}


def _small_graphs():
    from repro.graph import trace
    from repro.quant import quantize_channelwise
    k = jax.random.split(jax.random.PRNGKey(0), 12)
    x = jax.random.normal(k[0], (4, 24))
    w1, b1 = jax.random.normal(k[1], (24, 32)), jax.random.normal(k[2], (32,))
    w2, b2 = jax.random.normal(k[3], (32, 8)), jax.random.normal(k[4], (8,))
    qt = quantize_channelwise(jax.random.normal(k[5], (24, 32)))
    qrow = quantize_channelwise(jax.random.normal(k[6], (24, 24)), axis=-1)
    qsq = quantize_channelwise(jax.random.normal(k[7], (16, 16)))
    c = jax.random.normal(k[8], (4,))
    w4 = jax.random.normal(k[9], (24, 4))
    xsq = jax.random.normal(k[10], (16, 16))

    def deq(q):
        return (q.q.astype(jnp.float32) * q.scale).astype(jnp.float32)

    fns = {
        "mlp": (lambda x: jax.nn.relu(x @ w1 + b1) @ w2 + b2, x),
        "qmlp": (lambda x: jax.nn.relu(x @ deq(qt) + b1) @ w2, x),
        "per_row_bias": (lambda x: jnp.maximum(x @ w4 + c[:, None], 0.0), x),
        "per_row_scale": (lambda x: x @ deq(qrow), x),
        "transposed": (lambda x: jax.nn.relu(
            jnp.einsum("km,kn->mn", x, deq(qsq)) + 1.0), xsq),
    }
    return {name: trace(fn, a) for name, (fn, a) in fns.items()}


def _cnn_graph(net, batch):
    from repro.graph import trace
    from repro.models.cnn import CNNS
    spec = CNNS[net]
    p = spec["params"](jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (batch,) + spec["input"])
    return trace(lambda xx: spec["forward"](p, xx), x)


@pytest.fixture(scope="module")
def graphs(jax_shim):
    out = dict(_small_graphs())
    out["lenet"] = _cnn_graph("lenet", 8)
    out["resnet20"] = _cnn_graph("resnet20", 2)
    bundle, params = jax_llama()
    for w in ("bf16", "int8"):
        pre, dec = jax_llm_graphs(bundle, params, int8=(w == "int8"))
        out[f"llama-{w}-prefill"], out[f"llama-{w}-decode"] = pre, dec
    return out


NAMES = ["mlp", "qmlp", "per_row_bias", "per_row_scale", "transposed",
         "lenet", "resnet20", "llama-bf16-prefill", "llama-bf16-decode",
         "llama-int8-prefill", "llama-int8-decode"]


@pytest.mark.parametrize("name", NAMES)
def test_unfused_graph_converts_exactly(graphs, name):
    """The bridged IR is the JAX graph: same nodes, same planner figures."""
    from repro.graph import arena_plan, memory_report
    jg = graphs[name]
    tg = to_port(jg)
    assert summarize(tg) == summarize(jg)
    assert plan_summary(tg, t_memory, t_arena) == plan_summary(
        jg, memory_report, arena_plan)


@pytest.mark.parametrize("subset", range(len(SUBSETS)))
@pytest.mark.parametrize("name", NAMES)
def test_passes_identical_to_jax(graphs, name, subset):
    """The port's passes, default pipeline and subsets in several orders,
    build the JAX passes' clusters node for node, and plan the same
    bytes."""
    from repro.graph import arena_plan, memory_report, run_passes
    names = SUBSETS[subset]
    jg = run_passes(copy_graph(graphs[name]), names)
    tg = tpasses.run_passes(to_port(graphs[name]), names)
    assert summarize(tg) == summarize(jg)
    assert plan_summary(tg, t_memory, t_arena) == plan_summary(
        jg, memory_report, arena_plan)


@pytest.mark.parametrize("name", NAMES)
def test_select_passes_identical_to_jax(graphs, name):
    """``select_passes``: the same kept passes, per-pass traffic and node
    counts, and traffic reduction; the recorded JAX figures reproduce."""
    from repro.cost import select_passes
    jd = select_passes(copy_graph(graphs[name]))
    td = tcost.select_passes(to_port(graphs[name]))
    assert decision_summary(td) == decision_summary(jd)
    if name.startswith("llama"):
        print(f"{name}: schedule {td.passes}, traffic reduction "
              f"{td.traffic_reduction:.3f} (JAX {jd.traffic_reduction:.3f})")
        assert round(td.traffic_reduction, 3) == EXPECTED[name]
        if "int8" in name:
            assert "fold_quant_dequant" in td.passes


@pytest.mark.parametrize("name", ["lenet", "resnet20"])
def test_cnn_intermediate_bytes_reduction(graphs, name):
    """The CNNs' headline figure: intermediate bytes unfused / fused under
    the default pipeline, equal to the JAX compiler's."""
    from repro.graph import memory_report, run_passes
    unfused = t_memory(to_port(graphs[name])).intermediate_bytes
    fused = t_memory(tpasses.run_passes(to_port(graphs[name]))
                     ).intermediate_bytes
    j_fused = memory_report(run_passes(copy_graph(graphs[name]))
                            ).intermediate_bytes
    assert fused == j_fused
    print(f"{name}: {unfused} / {fused} = {unfused / fused:.3f}")
    assert round(unfused / fused, 3) == EXPECTED[name]


def test_negative_cases_stay_negative(graphs):
    """The per-row bias is no kernel epilogue, the per-row scale and the
    transposed contraction do not fold -- in the port as in JAX."""
    g = tpasses.run_passes(to_port(graphs["per_row_bias"]))
    assert all(n.attrs.get("bias") is None for n in g.nodes if n.is_fused)
    for name in ("per_row_scale", "transposed"):
        g = tpasses.run_passes(to_port(graphs[name]))
        assert not any(b.op == "quant_matmul" for n in g.nodes
                       for b in n.body_nodes())
    g = tpasses.run_passes(to_port(graphs["qmlp"]), ["fold_quant_dequant"])
    assert sum(n.op == "quant_matmul" for n in g.nodes) == 1


def test_plan_graph_caches_by_signature(graphs, tmp_path):
    """``plan_graph`` stores the schedule under the graph's signature and
    replays it from the cache on the next call."""
    from repro_torch.bench.config import ConfigCache
    cache = ConfigCache(tmp_path / "tc.json")
    first = tcost.plan_graph(to_port(graphs["mlp"]), cache=cache)
    second = tcost.plan_graph(to_port(graphs["mlp"]), cache=cache)
    assert not first.cached and second.cached
    assert second.passes == first.passes
    assert tcost.lookup_schedule(first.signature, cache) == first.passes
    assert "schedule" in first.report()
