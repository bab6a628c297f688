"""The port's graph-compiled paged engine (``use_graph=True``) against the
JAX engines and the port's plain engine, fp32 weights; the refusals.

On the llama3-8b smoke engine with ``test_engine_identity.py``'s geometry
and 3-request trace (a shared two-page head, more requests than slots),
the port's graph engine gives the greedy tokens of the JAX plain paged
engine (the golden), of the JAX graph engine (under the test-side jax 0.9
shim) and of the port's plain engine, with prefix sharing off and on.
``test_torch_graph_engine_int8.py`` holds the int8-weight half.
"""
import contextlib
import io

import pytest
from _torch_graph_bridge import (drain, jax_engines, jax_shim,
                                 own_tune_caches, port_engine, torch_params)

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import PagedServeEngine, Request

assert jax_shim  # the module-scoped fixture the tests below request


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """Schedules and tiles go to caches of this test's own."""
    with own_tune_caches(tmp_path, monkeypatch):
        yield


@pytest.fixture(scope="module")
def fp32(jax_shim, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tc") / "jax.json"))
        golden, jgraph, jparams = jax_engines("fp32", graph=True)
    return golden, jgraph, torch_params(jparams)


@pytest.mark.parametrize("sharing", [False, True])
def test_graph_engine_tokens_fp32(fp32, sharing):
    golden, jgraph, tparams = fp32
    eng = port_engine(tparams, use_graph=True, prefix_sharing=sharing)
    got = drain(eng, Request)
    assert got == golden == jgraph
    assert got == drain(port_engine(tparams, prefix_sharing=sharing),
                         Request)
    ex = eng._prefill.executor
    assert ex.impl == "plain" and ex.schedule is not None
    assert ex.schedule.passes == ["fuse_matmul_epilogue",
                                  "fuse_elementwise_chains"]
    assert "[prefill] schedule" in eng.graph_schedule_report()
    m = eng.metrics
    assert m.prefill_calls >= 3 and m.decode_calls >= 5
    if sharing:
        assert m.prefix_hit_requests > 0


def test_graph_engine_without_cost_model_runs_the_fixed_pipeline(fp32):
    golden, _, tparams = fp32
    eng = port_engine(tparams, use_graph=True, graph_cost_model=False)
    assert drain(eng, Request) == golden
    assert eng._prefill.executor.schedule is None
    assert eng.graph_schedule_report() == ""


def _bundle(arch):
    return build_model(get_config(arch, smoke=True), device="cpu")


def test_hybrid_is_refused_as_in_jax():
    b = _bundle("zamba2-1.2b")
    with pytest.raises(ValueError, match="use_graph.*hybrid"):
        PagedServeEngine(b, b.init_params(), device="cpu", use_graph=True)


@pytest.mark.parametrize("arch", ["arctic-480b", "rwkv6-3b"])
def test_other_families_are_refused_by_name(arch):
    b = _bundle(arch)
    with pytest.raises(NotImplementedError, match=repr(b.cfg.family)):
        PagedServeEngine(b, b.init_params(), device="cpu", use_graph=True,
                         slots=2, page_size=8)


def test_speculative_engine_refuses_use_graph():
    from repro_torch.spec import NgramDraft, SpeculativeServeEngine
    b = _bundle("llama3-8b")
    with pytest.raises(NotImplementedError, match="use_graph"):
        SpeculativeServeEngine(b, b.init_params(), device="cpu",
                               draft=NgramDraft(), use_graph=True)


def test_launcher_explain_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--device", "cpu", "--graph-prefill", "--explain",
                           "--int8-weights", "--requests", "2",
                           "--max-new", "2"])
    text = out.getvalue()
    assert "[prefill] schedule" in text and "[decode] schedule" in text
    assert "pass fold_quant_dequant       keep" in text
    assert "served 2/2 requests on cpu" in text


@pytest.mark.parametrize("argv,match", [
    (["--arch", "zamba2-1.2b"], "hybrid"),
    (["--engine", "slot"], "paged engine"),
    (["--draft-model", "ngram"], "draft-model"),
])
def test_launcher_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        launch_serve.main(["--device", "cpu", "--graph-prefill"] + argv)


def test_launcher_explain_without_graph():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--device", "cpu", "--explain", "--requests", "1",
                           "--max-new", "1"])
    assert "no graph schedules to explain" in out.getvalue()
