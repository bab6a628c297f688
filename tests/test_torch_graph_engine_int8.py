"""The port's graph-compiled paged engine with int8 weights against the
JAX engines and the port's plain engine (the fp32 half and the refusals
are in ``test_torch_graph_engine.py``).

``fold_quant_dequant`` folds the head -- the one int8 weight that reaches
its dot as a const, as in the JAX graph -- into a ``quant_matmul`` node
(dynamic int8 activations, the B6/B8 path on the card); the greedy tokens
stay those of the JAX golden, the JAX graph engine and the port's plain
int8-weight engine, with prefix sharing off and on.
"""
import pytest
from _torch_graph_bridge import (drain, jax_engines, jax_shim,
                                 own_tune_caches, port_engine, torch_params)

from repro_torch.serve import Request

assert jax_shim  # the module-scoped fixture the tests below request


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """Schedules and tiles go to caches of this test's own."""
    with own_tune_caches(tmp_path, monkeypatch):
        yield


@pytest.fixture(scope="module")
def int8(jax_shim, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tc") / "jax.json"))
        golden, jgraph, jparams = jax_engines("int8", graph=True)
    return golden, jgraph, torch_params(jparams)


@pytest.mark.parametrize("sharing", [False, True])
def test_graph_engine_tokens_int8(int8, sharing):
    golden, jgraph, tparams = int8
    eng = port_engine(tparams, use_graph=True, prefix_sharing=sharing)
    got = drain(eng, Request)
    assert got == golden == jgraph
    assert got == drain(port_engine(tparams, prefix_sharing=sharing),
                        Request)
    for step in (eng._prefill, eng._decode_step):
        ex = step.executor
        assert "fold_quant_dequant" in ex.schedule.passes
        folded = [b for n in ex.graph.nodes for b in n.body_nodes()
                  if b.op == "quant_matmul"]
        assert len(folded) == 1
        assert tuple(ex.graph.values[folded[0].inputs[1]].shape) == (64, 256)
