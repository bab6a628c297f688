"""The port's graph executor against the port's eager functions (bit for
bit, on the CPU) and the JAX forwards (within ``test_torch_cnn``'s
tolerance).

LeNet-5, ResNet-20 and MobileNet-V1 through ``compile_fn`` -- unfused,
the default pipeline, the cost model's schedule and pass subsets, each
under ``impl="plain"`` and ``impl="kernel"`` (whose dispatch goes to the
fused kernels' plain versions over CPU tensors) -- and the llama3-8b smoke
paged serving steps: logits and the KV pools they write.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_graph_bridge import (LLM_GEO, jax_llama, own_tune_caches,
                                 torch_params)

from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.graph import GraphExecutor, compile_fn, trace
from repro_torch.graph.compiler import (compile_decode_step,
                                        compile_prefill_step)
from repro_torch.models import build_model
from repro_torch.models.cnn import CNNS

#: the logits bound of tests/test_torch_cnn.py
LOGITS_RTOL = 1e-4
#: (passes, fused, cost_model) of each compiled variant
VARIANTS = {
    "unfused": (None, False, False),
    "default": (None, True, False),
    "cost_model": (None, True, True),
    "epilogues": (["fuse_conv_epilogue", "fuse_matmul_epilogue"], True,
                  False),
    "chains_first": (["fuse_elementwise_chains", "fold_quant_dequant",
                      "fuse_matmul_epilogue"], True, False),
}


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """Schedules and tiles go to caches of this test's own."""
    with own_tune_caches(tmp_path, monkeypatch):
        yield


@pytest.fixture(scope="module", params=["lenet", "resnet20", "mobilenet_v1"])
def net(request):
    """(name, port forward on bridged JAX weights, input, JAX logits)."""
    from repro.models import cnn as jax_cnn
    name = request.param
    spec = jax_cnn.CNNS[name]
    params = spec["params"](jax.random.PRNGKey(0))
    if name == "mobilenet_v1":   # as tests/test_torch_cnn.py scales them
        params = {k: v * (np.sqrt(v.shape[2]) / 3) if k.startswith("dw")
                  else v for k, v in params.items()}
    x = np.random.default_rng(1).standard_normal(
        ({"lenet": 8}.get(name, 2),) + spec["input"]).astype(np.float32)
    tp = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    jp = ({k: v.reshape(3, 3, 1, -1) if k.startswith("dw") else v
           for k, v in params.items()} if name == "mobilenet_v1" else params)
    ref = np.asarray(spec["forward"](jp, jax.numpy.asarray(x),
                                     conv_impl="xla"))
    fwd = CNNS[name]["forward"]
    return name, (lambda xx: fwd(tp, xx)), tensor_from_numpy(x), ref


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cnn_graph_equals_eager_and_jax(net, variant, impl):
    name, fn, x, ref = net
    passes, fused, cost_model = VARIANTS[variant]
    ex = compile_fn(fn, x, passes=passes, fused=fused, impl=impl,
                    cost_model=cost_model)
    got = ex(x)
    assert torch.equal(got, fn(x))
    assert np.abs(got.numpy() - ref).max() <= LOGITS_RTOL * np.abs(ref).max()
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


def test_mobilenet_depthwise_is_never_dispatched():
    """Its 13 depthwise convs are NHWC ``conv2d`` nodes with
    ``feature_group_count = C``, which ``_conv_geometry`` rejects, as in
    the JAX compiler; its first and pointwise convs with their relu (14)
    go to B7."""
    from repro_torch.models import cnn
    p = cnn.mobilenet_params(device="cpu")
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    fn = lambda xx: cnn.mobilenet_forward(p, xx)  # noqa: E731
    ex = compile_fn(fn, x, impl="kernel", cost_model=False)
    convs = [b for n in ex.graph.nodes for b in n.body_nodes()
             if b.op == "conv2d"]
    assert sum(b.attrs["feature_group_count"] > 1 for b in convs) == 13
    assert ex.kernel_clusters() == [("conv_epilogue", "relu", False)] * 14
    assert torch.equal(ex(x), fn(x))


def test_executor_checks_the_argument_tree(net):
    _, fn, x, _ = net
    ex = GraphExecutor(trace(fn, x))
    with pytest.raises(TypeError):
        ex(x, x)


# ---------------------------------------------------------------- llama
@pytest.fixture(scope="module")
def llm():
    """The port's llama smoke bundle, bf16 and int8 params bridged from
    the JAX ones, and a cache of random pools with an input batch."""
    jbundle, jparams = jax_llama()
    tb = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    params = {"bf16": torch_params(jparams),
              "int8": torch_params(jbundle.quantize_params(jparams))}
    gen = torch.Generator().manual_seed(0)
    cache = tb.init_paged_cache(33, LLM_GEO["page_size"])
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    return tb, params, cache


def _inputs(rows, t, width):
    rng = np.random.default_rng(rows * 100 + t)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    tables = rng.permutation(np.arange(1, 33))[:rows * width].reshape(
        rows, width)
    return (as_t(rng.integers(1, 256, (rows, t))),
            as_t(rng.integers(0, 40, (rows,))),
            as_t(rng.integers(1, t + 1, (rows,))), as_t(tables))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("w", ["bf16", "int8"])
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_llm_step_graph_equals_eager(llm, step, w, variant):
    """Logits and the pools written: bit for bit, except the int8 head
    folded into ``quant_matmul`` (dynamic int8 activations), whose logits
    stay within 2 % of the largest (one int8 rounding of each activation
    row, ~0.4 % a product)."""
    tb, params, cache = llm
    tp = params[w]
    passes, fused, cost_model = VARIANTS[variant]
    width = 4
    if step == "prefill":
        comp = compile_prefill_step(tb, tp, cache, chunk=16,
                                    table_width=width, passes=passes,
                                    fused=fused, cost_model=cost_model)
        args = _inputs(1, 16, width)
    else:
        comp = compile_decode_step(tb, tp, cache, slots=2, table_width=width,
                                   passes=passes, fused=fused,
                                   cost_model=cost_model)
        args = _inputs(2, 1, width)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    graph_cache = {k: v.clone() for k, v in cache.items()}
    ref = tb.decode_paged(tp, eager_cache, *args)
    got = comp(tp, graph_cache, *args)
    for k in cache:
        assert torch.equal(graph_cache[k], eager_cache[k]), k
    folded = any(b.op == "quant_matmul" for n in comp.executor.graph.nodes
                 for b in n.body_nodes())
    # the chains pass run first swallows the dequant chain before the fold
    # sees it, as in the JAX compiler (whose default order folds first)
    assert folded == (w == "int8" and variant in ("default", "cost_model"))
    if folded:
        err = (got.float() - ref.float()).abs().max()
        assert err <= 0.02 * ref.float().abs().max()
    else:
        assert torch.equal(got, ref)


def test_int8_epilogue_dispatches_to_quant_matmul_fused():
    """``relu(x @ dequant(w_int8) + b) @ w2``, the JAX tests' int8 MLP:
    the fold turns the dequant chain into ``quant_matmul`` and the bias +
    relu tail rides it to ``quant_matmul_fused`` (B8) under
    ``impl="kernel"``; the output equals the plain executor's on the same
    folded graph (the same int8 math) and the eager float forward within
    the activation quantization."""
    from repro_torch.quant import quantize_channelwise
    gen = torch.Generator().manual_seed(1)
    qt = quantize_channelwise(torch.randn((24, 32), generator=gen))
    b1 = torch.randn((32,), generator=gen)
    w2 = torch.randn((32, 8), generator=gen)
    x = torch.randn((4, 24), generator=gen)

    def fn(x):
        w1 = (qt.q.float() * qt.scale).to(x.dtype)
        return torch.relu(x @ w1 + b1) @ w2

    kern = compile_fn(fn, x, impl="kernel", cost_model=False)
    plain = compile_fn(fn, x, impl="plain", cost_model=False)
    assert kern.kernel_clusters() == [("matmul_epilogue", "relu", True)]
    assert list(kern.dispatched.values()) == ["quant_matmul_fused"]
    got = kern(x)
    assert torch.allclose(got, plain(x), rtol=1e-5, atol=1e-5)
    ref = fn(x)
    assert (got - ref).abs().max() <= 0.05 * ref.abs().max()


def test_addmm_lowers_to_an_apr_matmul_product_and_an_add():
    """``torch.addmm(b, x, w)`` is JAX's ``matmul`` + ``add``: the matmul
    node replays through ``apr_matmul`` (B1 on the card), the add node
    adds the bias, and the graph's output equals ``x @ w + b`` as the
    two calls give it, bit for bit, and ``addmm`` within fp32 rounding."""
    from repro_torch.kernels.apr_matmul import apr_matmul
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((6, 24), generator=gen)
    w = torch.randn((24, 16), generator=gen)
    b = torch.randn((16,), generator=gen)

    def fn(x):
        return torch.addmm(b, x, w)

    g = trace(fn, x)
    assert [n.op for n in g.nodes] == ["matmul", "add"]
    assert g.nodes[0].prim.fn is apr_matmul
    assert g.nodes[1].inputs == (g.nodes[0].outputs[0],
                                 next(v for v, val in g.values.items()
                                      if val.kind == "const"
                                      and val.array is b))
    for impl in ("plain", "kernel"):
        got = GraphExecutor(g, impl=impl)(x)
        assert torch.equal(got, apr_matmul(x, w, out_dtype=torch.float32)
                           + b)
        assert torch.allclose(got, fn(x), rtol=1e-5, atol=1e-5)


def test_a_trace_holds_only_its_own_threads_kernel_calls():
    """The active tracer is the tracing thread's: a kernel wrapper called
    by another thread while a trace runs computes its result, and the
    trace records none of that call."""
    import threading

    from repro_torch.kernels.apr_matmul import apr_matmul
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 8), generator=gen)
    w = torch.randn((8, 8), generator=gen)
    ready, done = threading.Event(), threading.Event()
    other = {}

    def worker():
        ready.wait()
        other["y"] = apr_matmul(x, w, out_dtype=torch.float32)
        done.set()

    def fn(x):
        ready.set()
        assert done.wait(30)
        return apr_matmul(x, w, out_dtype=torch.float32)

    t = threading.Thread(target=worker)
    t.start()
    g = trace(fn, x)
    t.join()
    assert [n.op for n in g.nodes] == ["matmul"]
    assert not type(other["y"]).__name__.startswith("Fake")
    assert torch.equal(other["y"], x @ w)
