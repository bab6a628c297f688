"""Port parity, the MoE layer: ``repro_torch.models.moe`` against the JAX
package's ``repro.models.moe`` on the arctic-480b (top-2, dense residual)
and llama4-maverick (top-1) smoke configs, with the same inputs (numpy
seed) and weights (JAX-initialised, bridged).

Routing is held bit for bit: the dispatch buffer, ``token_id``, ``slot``
and ``keep`` equal JAX's in fp32 and bf16, at the published capacity
factor (padded all-zero rows overfill a queue and dispatches drop),
drop-free with padded rows, and with router
columns duplicated so that gates tie (the lower expert index wins).  The
normalised gate weights equal JAX's in bf16 and lie within
``GATE_ULPS`` fp32 ulps in fp32: XLA's fp32 ``exp`` and sum differ from
torch's in the last bits (ROADMAP C.0), which the test's inputs cannot
avoid.  The layer output is held to 1e-5 in fp32 and, in bf16, to a bf16
ulp of each rounded term it sums (the experts' combine, arctic's dense
residual) and of itself: the two frameworks' matmuls sum in other orders,
and where the residual cancels the combine one ulp of a term is several of
the output."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.quant import quantize_params as jax_quantize_params
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import lm, moe
from repro_torch.quant import QuantizedTensor, quantize_params

ARCHS = ["arctic-480b", "llama4-maverick-400b-a17b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: fp32 gate weights (in [0, 1]): XLA's exp and sum against torch's, in
#: fp32 ulps of 1.0
GATE_ULPS = 4
#: layer output in fp32: the same sums in two frameworks' orders
FP32_ATOL = 1e-5
#: the published capacity factor (the smoke configs run drop-free at 64)
PUBLISHED_FACTOR = 1.25


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


def _cfgs(arch, **over):
    return (dataclasses.replace(get_config(arch, smoke=True), **over),
            dataclasses.replace(jax_get_config(arch, smoke=True), **over))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(arch, the JAX smoke model's first MoE layer params in fp32 as JAX
    arrays keyed ``moe.*``, the same bridged to torch)."""
    arch = request.param
    jcfg = jax_get_config(arch, smoke=True)
    params = jax_lm.build_params(jcfg).build(jax.random.PRNGKey(0))
    me = max(jcfg.moe_every, 1)
    pre = f"blk.{me - 1}."
    jp = {k[len(pre):]: np.asarray(v.astype(jnp.float32))[0]
          for k, v in params.items() if k.startswith(pre + "moe.")}
    return arch, jp


def _inputs(cfg, t=40, padded=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    x[t - padded:] = 0.0          # padded rows: every gate ties
    return x


# ----------------------------------------------------------- layout, rules
@pytest.mark.parametrize("arch", ARCHS)
def test_params_equal_the_jax_builders(arch):
    """Names, shapes and init scales of the whole LM, MoE layers included,
    equal the JAX ``build_params``'s."""
    cfg, jcfg = _cfgs(arch)
    pb = jax_lm.build_params(jcfg)
    specs = lm.build_params(cfg)
    assert set(specs) == set(pb._defs)
    for name, (shape, scale) in specs.items():
        jshape, _, jscale = pb._defs[name]
        assert (shape, scale) == (jshape, jscale), name
    n_sb, me = lm.super_block(cfg)
    assert (n_sb, me) == {"arctic-480b": (2, 1),
                          "llama4-maverick-400b-a17b": (2, 2)}[arch]
    assert specs["blk.0.attn.wq"][0][0] == n_sb
    moe_names = [n for n in specs if ".moe." in n]
    assert moe_names and all(n.startswith(f"blk.{cfg.moe_every - 1}.")
                             for n in moe_names)
    assert any(".res_" in n for n in moe_names) == bool(
        cfg.dense_residual_ff)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("factor", [1.0, PUBLISHED_FACTOR, 2.0, 64.0, 128.0])
def test_capacity_equals_jax(arch, smoke, factor):
    cfg = dataclasses.replace(get_config(arch, smoke),
                              moe_capacity_factor=factor)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke),
                               moe_capacity_factor=factor)
    for t in (1, 2, 3, 4, 5, 16, 20, 64, 100, 1024):
        assert moe._capacity(t, cfg) == jax_moe._capacity(t, jcfg, 1), t


# --------------------------------------------------------------- routing
ROUTE_CASES = ["published_factor", "padded_rows", "tied_gates"]


@pytest.mark.parametrize("case", ROUTE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_route_and_dispatch_equals_jax(layer, case, dtype):
    arch, jp = layer
    factor = PUBLISHED_FACTOR if case != "padded_rows" else 64.0
    cfg, jcfg = _cfgs(arch, moe_capacity_factor=factor)
    router = jp["moe.router"].copy()
    if case == "tied_gates":      # pairs of equal columns: equal gates
        router[:, 1::2] = router[:, 0::2]
    x = _inputs(cfg, padded=0 if case == "tied_gates" else 8)
    t = x.shape[0]
    cap = jax_moe._capacity(t, jcfg, 1)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(router, dtype)
    jbuf, jmeta = jax_moe._route_and_dispatch(jx, jw, jcfg, cap)
    tbuf, tmeta = moe._route_and_dispatch(tx, tw, cfg, cap)
    assert tbuf.dtype == DTYPES[dtype][1] and tbuf.shape == jbuf.shape
    np.testing.assert_array_equal(_np(tbuf), _np(jbuf))
    for name, a, b in zip(("token_id", "slot", "keep"), tmeta[:3], jmeta[:3]):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    w, jw_ = _np(tmeta[3]), _np(jmeta[3])
    if dtype == "bfloat16":
        np.testing.assert_array_equal(w, jw_)
    else:
        # weights lie in [0, 1]: an ulp of 1.0 is the scale of their error
        assert np.abs(w - jw_).max() <= GATE_ULPS * np.spacing(np.float32(1))
    dropped = int((~tmeta[2]).sum())
    if case == "published_factor":  # the padded rows overfill a queue
        assert dropped > 0
    if factor != PUBLISHED_FACTOR:
        assert dropped == 0
    if case == "tied_gates":        # the lower index of the tied pair first
        sel = (tmeta[1] // cap).reshape(t, -1)
        assert bool((sel[:, 0] % 2 == 0).all())
        if sel.shape[1] > 1:
            assert bool((sel[:, 1] == sel[:, 0] + 1).all())
    if case == "padded_rows":       # all-zero rows pick experts 0..k-1
        k = cfg.experts_per_token
        sel = (tmeta[1] // cap).reshape(t, k)[-8:]
        assert sel.tolist() == [list(range(k))] * 8


def test_top_k_takes_the_lower_index_on_ties():
    g = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0]])
    values, idx = moe.top_k(g, 3)
    assert idx.tolist() == [[1, 3, 0]] and values.tolist() == [[0.5, 0.5,
                                                                0.25]]


# ------------------------------------------------------- combine and block
def _block_inputs(arch, dtype, factor):
    cfg, jcfg = _cfgs(arch, moe_capacity_factor=factor)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, cfg.d_model)).astype(np.float32)
    x[2, 8:] = 0.0
    return cfg, jcfg, _pair(x, dtype)


def _layer_params(jp, dtype):
    jdt, _ = DTYPES[dtype]
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in jp.items()}
    tparams = params_from_numpy({k: np.asarray(v.astype(jnp.float32))
                                 for k, v in jparams.items()})
    if dtype == "bfloat16":
        tparams = {k: v.to(torch.bfloat16) for k, v in tparams.items()}
    return jparams, tparams


def _hold(got, ref, dtype, terms=()):
    """fp32: within FP32_ATOL.  bf16: within a bf16 ulp (<= 2^-7 relative)
    of each rounded term the output sums (``terms``: the experts' combine
    and arctic's dense residual, from the JAX layer) and of the output."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=FP32_ATOL)
    else:
        scale = np.abs(ref) + sum(np.abs(_np(t)).reshape(ref.shape)
                                  for t in terms)
        assert (np.abs(got - ref) <= 2.0 ** -7 * scale).all(), \
            np.abs(got - ref).max()


@pytest.mark.parametrize("factor", [PUBLISHED_FACTOR, 64.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_block_equals_jax(layer, dtype, factor):
    """``moe_block`` (route, the non-empty experts, combine, arctic's dense
    residual) against the JAX layer, eager, on (B, T, d) = (3, 12, d) with
    padded rows; at the published factor some dispatches drop."""
    arch, jp = layer
    cfg, jcfg, (jx, tx) = _block_inputs(arch, dtype, factor)
    jparams, tparams = _layer_params(jp, dtype)
    with jax.disable_jit():
        ref = jax_moe.moe_block(jparams, "moe", jcfg, jx)
        terms = [jax_moe.moe_ffn_local(jparams, "moe", jcfg,
                                       jx.reshape(-1, cfg.d_model))]
        if cfg.dense_residual_ff:
            terms.append(jax_layers.swiglu(
                jx, jparams["moe.res_gate"], jparams["moe.res_up"],
                jparams["moe.res_down"], jcfg))
    got = moe.moe_block(tparams, "moe", cfg, tx)
    assert got.dtype == DTYPES[dtype][1]
    _hold(got, ref, dtype, terms)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_combine_equals_jax(layer, dtype):
    """The JAX ``_combine`` and the port's on the same expert outputs and
    metadata: bit for bit (an ordered sum from zero in top-k order)."""
    arch, jp = layer
    cfg, jcfg, (jx, tx) = _block_inputs(arch, dtype, PUBLISHED_FACTOR)
    jparams, tparams = _layer_params(jp, dtype)
    t = 36
    cap = moe._capacity(t, cfg)
    _, tmeta = moe._route_and_dispatch(tx.reshape(t, -1),
                                       tparams["moe.router"], cfg, cap)
    rng = np.random.default_rng(5)
    out = rng.standard_normal((cfg.num_experts, cap, cfg.d_model)).astype(
        np.float32)
    jo, to = _pair(out, dtype)
    jmeta = tuple(jnp.asarray(_np(m)).astype(
        DTYPES[dtype][0] if i == 3 else jnp.int32 if i < 2 else bool)
        for i, m in enumerate(tmeta))
    ref = jax_moe._combine(jo, jmeta, t)
    got = moe._combine(to, tmeta, t)
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_non_empty_experts_equal_the_dense_form(layer, dtype):
    """On the CPU the pass over non-empty experts gives the bits of the
    dense ``(E, C, d)`` form (every expert over its whole queue, empty
    slots included), the JAX layer's shape; only the non-empty experts
    run, in each of the three stacked leaves' products."""
    arch, jp = layer
    cfg, _, (_, tx) = _block_inputs(arch, dtype, PUBLISHED_FACTOR)
    _, tparams = _layer_params(jp, dtype)
    x = tx.reshape(-1, cfg.d_model)
    t = x.shape[0]
    cap = moe._capacity(t, cfg)
    buf, meta = moe._route_and_dispatch(x, tparams["moe.router"], cfg, cap)
    dense = moe._combine(moe._expert_ffn_dense(tparams, "moe", buf), meta, t)
    ran = []
    products = moe.expert_products

    def counting(xs, w, queues, product):
        ran.append([(e, n) for e, _, n in queues])
        return products(xs, w, queues, product)

    moe.expert_products = counting
    try:
        got = moe.moe_ffn_local(tparams, "moe", cfg, x)
    finally:
        moe.expert_products = products
    assert torch.equal(got, dense)
    r = moe.route(x, tparams["moe.router"], cfg, cap)
    lengths = torch.clamp_max(r.counts, cap).tolist()
    assert ran == [[(e, n) for e, n in enumerate(lengths) if n]] * 3


def test_expert_parallelism_is_refused_by_name():
    cfg = get_config("arctic-480b", smoke=True)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        moe.moe_ffn_local({}, "moe", cfg, torch.zeros(2, cfg.d_model),
                          ep_axis="data")

    class Mesh:
        mesh = object()

    with pytest.raises(NotImplementedError, match="expert parallelism"):
        moe.moe_block({}, "moe", cfg, torch.zeros(1, 2, cfg.d_model), Mesh())


# ------------------------------------------------------------------- int8
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_expert_codes_equal_jax(arch):
    """``quantize_params`` on the whole smoke model: every expert weight's
    int8 codes and scales bit-equal to JAX's, the router kept full
    precision in both."""
    jcfg = jax_get_config(arch, smoke=True)
    params = jax_lm.build_params(jcfg).build(jax.random.PRNGKey(0))
    jq = jax_quantize_params(params)
    tq = quantize_params(params_from_numpy(
        {k: np.asarray(v.astype(jnp.float32)) for k, v in params.items()}))
    experts = [k for k in jq if ".moe.w_" in k]
    assert experts
    for k in experts:
        assert isinstance(tq[k], QuantizedTensor)
        np.testing.assert_array_equal(tq[k].q.numpy(), np.asarray(jq[k].q))
        np.testing.assert_array_equal(tq[k].scale.numpy(),
                                      np.asarray(jq[k].scale))
    router = [k for k in jq if k.endswith(".moe.router")]
    assert router and all(not isinstance(tq[k], QuantizedTensor)
                          for k in router)
