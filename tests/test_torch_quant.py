"""Port parity, int8 serving: ``repro_torch.quant`` against ``repro.quant``
(codes and scales bit for bit), the int8-weight ``apr_matmul`` and the
int8-KV ``flash_decode_paged`` plain versions against the JAX oracles and
the JAX Pallas kernel (interpret mode), the int8 branches of the layers and
of ``lm_decode_paged`` against the JAX model, and the int8
``PagedServeEngine`` against the JAX engine.  The CUDA kernels are held to
these plain versions on the card by ``chip_smoke.py``."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_decode import flash_decode_paged as jax_flash_paged
from repro.kernels.flash_decode.ref import \
    paged_decode_attention_q_ref as jax_paged_q_ref
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.parallel import ParallelContext
from repro.quant import QuantizedTensor as JaxQT
from repro.quant import quantize_channelwise as jax_quantize
from repro.quant import quantize_params as jax_quantize_params
from repro.quant import weight_bytes as jax_weight_bytes
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                              paged_decode_attention_q_ref,
                                              paged_decode_attention_ref)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.quant import (QuantizedTensor, quantize_channelwise,
                               quantize_params, weight_bytes)
from repro_torch.serve import PagedServeEngine, Request

ARCH = "llama3-8b"
BF16_EPS = 2.0 ** -7   # one bf16 ulp, relative
PCTX = ParallelContext(None)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _both(a, dtype="float32"):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _bridge(params):
    """JAX params (plain or quantized) -> the port's, leaf for leaf."""
    return params_from_numpy({
        k: (np.asarray(v.q), np.asarray(v.scale)) if isinstance(v, JaxQT)
        else np.asarray(v) for k, v in params.items()})


def _quantized(params, dtype):
    """The JAX int8-weight params of ``params`` cast to ``dtype``."""
    return jax_quantize_params(jax.tree.map(lambda a: a.astype(dtype), params))


@pytest.fixture(scope="module")
def smoke():
    cfg = jax_get_config(ARCH, smoke=True)
    bundle = jax_build_model(cfg)
    return cfg, bundle, bundle.init_params(jax.random.PRNGKey(0))


# ----------------------------------------------------------- quantization
def _tricky_weight(shape, seed):
    """Seeded normals with an all-zero output channel and a channel whose
    scale is exactly 1 (amax 127) holding exact .5 ties of both signs."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., :, 0] = 0.0
    ties = np.array([127.0, 0.5, -0.5, 1.5, -2.5, 2.5, 126.5, -126.5])
    col = np.resize(ties, shape[-2])
    w[..., :, 1] = col
    w[..., 0, 1] = 127.0
    return w


@pytest.mark.parametrize("shape,axis", [((64, 48), -2), ((3, 40, 24), -2),
                                        ((2, 5, 4, 16), -1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_channelwise_is_bit_equal(shape, axis, dtype):
    w = _tricky_weight(shape, seed=len(shape))
    if axis == -1:
        w = np.swapaxes(w, -1, -2).copy()   # zero and tie rows on the head dim
    wj, wt = _both(w, dtype)
    ref, got = jax_quantize(wj, axis=axis), quantize_channelwise(wt, axis=axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    # the tie channel really holds ties: round half to even
    if axis == -2:
        col = got.q.numpy()[..., :, 1].reshape(-1, shape[-2])[0]
        assert list(col[:8]) == [127, 0, 0, 2, -2, 2, 126, -126]
    np.testing.assert_array_equal(
        got.dequantize(torch.float32).numpy(),
        np.asarray(ref.dequantize(jnp.float32)))


def test_quantize_params_picks_the_jax_names(smoke):
    _, bundle, params = smoke
    ref = bundle.quantize_params(params)
    tparams = _bridge(params)
    got = build_model(get_config(ARCH, smoke=True),
                      device="cpu").quantize_params(tparams)
    assert {k for k, v in got.items() if isinstance(v, QuantizedTensor)} == \
        {k for k, v in ref.items() if isinstance(v, JaxQT)}
    for name, v in ref.items():
        if isinstance(v, JaxQT):    # stacked weights quantize layer by layer
            np.testing.assert_array_equal(got[name].q.numpy(),
                                          np.asarray(v.q))
            np.testing.assert_array_equal(got[name].scale.numpy(),
                                          np.asarray(v.scale))
        else:
            assert got[name] is tparams[name]


def test_weight_bytes_match_jax(smoke):
    _, bundle, params = smoke
    assert weight_bytes(_bridge(params)) == jax_weight_bytes(params)
    got = weight_bytes(quantize_params(_bridge(params)))
    assert got == jax_weight_bytes(bundle.quantize_params(params))
    # BENCH_quant.json: 3.785x fewer streamed bytes than fp32, 1.892x than bf16
    assert round(got["bytes_fp32"] / got["bytes_actual"], 3) == 3.785
    assert round(got["bytes_bf16"] / got["bytes_actual"], 3) == 1.892


# ------------------------------------------------------- int8 apr_matmul
@pytest.mark.parametrize("m,k,n", [(3, 100, 37), (4, 64, 256), (16, 128, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    xj, xt = _both(rng.standard_normal((1, m, k)), dtype)
    wj = jax_quantize(jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k),
                                  jnp.float32).astype(dtype))
    wt = QuantizedTensor(q=tensor_from_numpy(np.asarray(wj.q)),
                         scale=tensor_from_numpy(np.asarray(wj.scale)))
    ref = _np(jnp.einsum("btd,dk->btk", xj, jl.materialize_weight(wj, xj.dtype)))
    got = _np(tl.linear(xt, wt))
    # both dequantize to x.dtype with the same rounding and sum exact
    # products in fp32; only the order of the fp32 sum differs
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=BF16_EPS, atol=1e-6))
    np.testing.assert_allclose(got, ref, **tol)
    # tp_einsum (wo, w_down) materializes first, as the JAX layer does
    ref = _np(jax.jit(lambda x, w: jl.tp_einsum("btk,kd->btd", x, w))(xj, wj))
    np.testing.assert_allclose(_np(tl.tp_einsum(xt, wt)), ref, **tol)


def test_int8_apr_matmul_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 70))).to(torch.bfloat16)
    w = quantize_channelwise(torch.from_numpy(rng.standard_normal((70, 33))))
    before = (apr_matmul.launches, apr_matmul.int8_launches)
    got = apr_matmul(x, w, out_dtype=torch.bfloat16)
    assert torch.equal(got, matmul_ref(x, w.dequantize(torch.bfloat16),
                                       torch.bfloat16))
    assert (apr_matmul.launches, apr_matmul.int8_launches) == before


def test_int8_apr_matmul_never_takes_the_plain_path_off_the_cpu():
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    w = QuantizedTensor(q=torch.zeros((8, 8), dtype=torch.int8),
                        scale=torch.ones((1, 8)))
    with pytest.raises(ValueError):
        apr_matmul(x, w)


# ------------------------------------------------- int8 flash_decode_paged
def _paged_q_case(b, hq, hkv, d, ps, p_max, lengths, seed):
    """int8 pools quantized per (page slot, head) by the JAX scheme, pages
    scattered, padding routed to null page 0; the same payloads for both
    frameworks (fp32 q)."""
    rng = np.random.default_rng(seed)
    need = [-(-n // ps) for n in lengths]
    p_pool = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, p_pool))
    tables = np.zeros((b, p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    q = jnp.asarray(rng.standard_normal((b, hq, d)), jnp.float32)
    kq = jax_quantize(jnp.asarray(rng.standard_normal((p_pool, ps, hkv, d)),
                                  jnp.float32), axis=-1)
    vq = jax_quantize(jnp.asarray(rng.standard_normal((p_pool, ps, hkv, d)),
                                  jnp.float32), axis=-1)
    jargs = [q, kq.q, vq.q, kq.scale[..., 0], vq.scale[..., 0],
             jnp.asarray(lengths, jnp.int32), jnp.asarray(tables)]
    targs = [tensor_from_numpy(np.asarray(a)) for a in jargs]
    return jargs, targs


PAGED_Q_CASES = [
    # b, hq, hkv, d, ps, p_max, lengths
    (4, 8, 2, 32, 8, 4, [0, 1, 8, 9]),
    (3, 4, 4, 16, 4, 6, [23, 4, 0]),
    (2, 32, 8, 64, 16, 3, [40, 17]),
]


@pytest.mark.parametrize("case", PAGED_Q_CASES)
def test_paged_q_ref_matches_jax_oracle(case):
    jargs, targs = _paged_q_case(*case[:6], case[6], seed=1)
    got = _np(paged_decode_attention_q_ref(*targs))
    ref = _np(jax_paged_q_ref(*jargs))
    live = np.asarray(case[6]) > 0
    # fp32 q: the dequantized pools stay fp32 on both sides; the softmax
    # differs only in where it normalises
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-5, atol=1e-5)
    assert not got[~live].any()   # the paged kernels' zero rows


@pytest.mark.parametrize("case", PAGED_Q_CASES[:2])
def test_paged_q_ref_matches_jax_pallas_kernel(case):
    """The JAX Pallas paged kernel with scale pools (interpret mode), on
    every row, idle ones included."""
    jargs, targs = _paged_q_case(*case[:6], case[6], seed=2)
    q, kp, vp, ks, vs, lens, tables = jargs
    ref = _np(jax_flash_paged(q, kp, vp, lens, tables, k_scales=ks,
                              v_scales=vs, chunk=case[4]))
    got = _np(paged_decode_attention_q_ref(*targs))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_paged_q_ref_is_the_float_ref_on_dequantized_pools():
    _, targs = _paged_q_case(*PAGED_Q_CASES[0][:6], PAGED_Q_CASES[0][6], 3)
    q, kp, vp, ks, vs, lens, tables = targs
    q = q.to(torch.bfloat16)
    got = paged_decode_attention_q_ref(q, kp, vp, ks, vs, lens, tables)
    ref = paged_decode_attention_ref(
        q, (kp.float() * ks[..., None]).to(torch.bfloat16),
        (vp.float() * vs[..., None]).to(torch.bfloat16), lens, tables)
    assert torch.equal(got, ref)


def test_int8_flash_decode_paged_on_cpu_is_the_plain_version():
    _, targs = _paged_q_case(*PAGED_Q_CASES[0][:6], PAGED_Q_CASES[0][6], 4)
    q, kp, vp, ks, vs, lens, tables = targs
    before = (flash_decode_paged.launches, flash_decode_paged.int8_launches)
    got = flash_decode_paged(q, kp, vp, lens, tables, k_scales=ks, v_scales=vs)
    assert torch.equal(got, paged_decode_attention_q_ref(*targs))
    assert (flash_decode_paged.launches,
            flash_decode_paged.int8_launches) == before
    with pytest.raises(ValueError):
        flash_decode_paged(q, kp, vp, lens, tables, k_scales=ks)
    with pytest.raises(ValueError):
        flash_decode_paged(torch.empty(q.shape, dtype=torch.bfloat16,
                                       device="meta"), kp, vp, lens, tables,
                           k_scales=ks, v_scales=vs)


# ---------------------------------------------------------------- layers
def _layer_params(params, i=0):
    lp = {k[len("blk.0."):]: v[i] if not isinstance(v, JaxQT)
          else JaxQT(q=v.q[i], scale=v.scale[i])
          for k, v in params.items() if k.startswith("blk.0.")}
    return lp, _bridge(lp)


def test_attention_decode_paged_int8_writes_and_attends(smoke):
    """A chunk of 3 tokens into two slots (one padded) over int8 pools,
    int8 weights, fp32 activations: output, codes and scales against the
    JAX layer."""
    cfg, bundle, params = smoke
    fp32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jp, tp = _layer_params(bundle.quantize_params(fp32))
    rng = np.random.default_rng(5)
    ps, hkv, dh = 4, cfg.num_kv_heads, cfg.resolved_head_dim
    pools = [jnp.zeros((7, ps, hkv, dh), jnp.int8) for _ in range(2)] + \
        [jnp.zeros((7, ps, hkv), jnp.float32) for _ in range(2)]
    tpools = [tensor_from_numpy(np.asarray(a)) for a in pools]
    xj, xt = _both(rng.standard_normal((2, 3, cfg.d_model)))
    lengths = np.array([5, 2], np.int32)
    counts = np.array([3, 2], np.int32)
    tables = np.array([[3, 1, 0], [5, 0, 0]], np.int32)
    out_j, *pools_j = jax.jit(
        lambda p, x, k, v, ks, vs, *a: jl.attention_decode_paged(
            p, "attn", cfg, x, k, v, *a, k_scales=ks, v_scales=vs))(
        jp, xj, *pools, jnp.asarray(lengths), jnp.asarray(counts),
        jnp.asarray(tables))
    out_t = tl.attention_decode_paged(
        tp, "attn", cfg, xt, tpools[0], tpools[1], torch.from_numpy(lengths),
        torch.from_numpy(counts), torch.from_numpy(tables),
        k_scales=tpools[2], v_scales=tpools[3])
    live = np.array([[1, 1, 1], [1, 1, 0]], bool)   # padded row is garbage
    np.testing.assert_allclose(_np(out_t)[live], _np(out_j)[live],
                               rtol=1e-4, atol=1e-5)
    # page 0 holds whatever padding wrote last; every live page must match
    for got, ref in zip(tpools[:2], pools_j[:2]):
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(ref)[1:])
    for got, ref in zip(tpools[2:], pools_j[2:]):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(ref)[1:],
                                   rtol=1e-6, atol=0)


# -------------------------------------------------------- lm_decode_paged
def _run_lm_int8(params_j, cfg, dtype):
    """One prefill chunk (two slots, one padded) then 3 decode steps with
    int8 weights and an int8 cache, each side fed the JAX greedy tokens.
    Returns per-step (port, JAX) logits and both final caches."""
    qparams = _quantized(params_j, dtype)
    tparams = _bridge(qparams)
    jcache = jlm.init_paged_cache(cfg, 9, 8, kv_dtype="int8")
    tcache = tlm.init_paged_cache(get_config(ARCH, smoke=True), 9, 8,
                                  kv_dtype="int8")
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = np.zeros(2, np.int32)
    counts = np.array([8, 5], np.int32)
    jf = jax.jit(lambda p, c, t, l, n, bt: jlm.lm_decode_paged(
        p, cfg, PCTX, c, t, l, n, bt))
    steps = []
    for _ in range(4):
        args = [np.asarray(a) for a in (tokens, lengths, counts, tables)]
        lj, jcache = jf(qparams, jcache, *[jnp.asarray(a) for a in args])
        lt = tlm.lm_decode_paged(tparams, get_config(ARCH, smoke=True),
                                 tcache, *[torch.from_numpy(a) for a in args])
        rows = counts - 1
        steps.append((_np(lt)[[0, 1], rows], _np(lj)[[0, 1], rows]))
        nxt = np.asarray(jnp.argmax(lj[jnp.arange(2), rows], axis=-1))
        lengths = lengths + counts
        counts = np.ones(2, np.int32)
        tokens = nxt[:, None].astype(np.int32)
    return steps, tcache, jcache


def test_lm_decode_paged_int8_fp32(smoke):
    cfg, _, params = smoke
    steps, tcache, jcache = _run_lm_int8(params, cfg, jnp.float32)
    for got, ref in steps:
        # fp32 activations on the same int8 weights: only the order of fp32
        # sums differs
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tcache[name].numpy()[:, :, 1:],
                                      np.asarray(jcache[name])[:, :, 1:])
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tcache[name].numpy()[:, :, 1:],
                                   np.asarray(jcache[name])[:, :, 1:],
                                   rtol=1e-6, atol=0)


#: bf16 bound on |logits_port - logits_jax|, as for the bf16 model
#: (test_torch_model.py): the frameworks may land one bf16 ulp apart where
#: an fp32 sum sits on a rounding boundary, and int8 KV codes then round
#: from those values; the measured maximum is printed
BF16_LOGITS_BOUND = 0.125


def test_lm_decode_paged_int8_bf16_greedy_equal(smoke):
    cfg, _, params = smoke
    steps, _, _ = _run_lm_int8(params, cfg, jnp.bfloat16)
    err = max(float(np.abs(got - ref).max()) for got, ref in steps)
    print(f"bf16 int8 lm_decode_paged: max |logits diff| = {err:.4g}")
    for got, ref in steps:
        assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.isfinite(err) and err <= BF16_LOGITS_BOUND


# ---------------------------------------------------------------- engine
def _serve(engine, prompts, request_cls, max_new=6):
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_engine_matches_jax_engine(smoke, dtype):
    """int8 weights and int8 KV, 3 ragged requests on 2 slots: the same
    greedy tokens and pool bytes as the JAX engine."""
    _, jbundle, params = smoke
    qparams = _quantized(params, getattr(jnp, dtype))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 12, 9)]
    kw = dict(slots=2, page_size=8, prefill_chunk=8, kv_dtype="int8")
    jeng = JaxEngine(jbundle, qparams, PCTX, **kw)
    ref = _serve(jeng, prompts, JaxRequest)
    eng = PagedServeEngine(build_model(get_config(ARCH, smoke=True),
                                       device="cpu"),
                           _bridge(qparams), device="cpu", **kw)
    assert _serve(eng, prompts, Request) == ref
    assert eng.kv_pool_bytes() == jeng.kv_pool_bytes()


def test_kv_pool_bytes_int8_vs_bf16():
    bundle = build_model(get_config(ARCH, smoke=True), device="cpu")
    params = bundle.init_params()
    got = {kv: PagedServeEngine(bundle, params, device="cpu",
                                kv_dtype=kv).kv_pool_bytes()
           for kv in ("bfloat16", "int8")}
    # BENCH_quant.json (4 slots, page size 16): 266,240 and 166,400 bytes
    assert got == {"bfloat16": 266240, "int8": 166400}


def test_launcher_serves_int8_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--device", "cpu", "--requests", "3",
                           "--max-new", "4", "--slots", "2",
                           "--int8-weights", "--kv-dtype", "int8"])
    text = out.getvalue()
    assert "served 3/3 requests on cpu" in text
    assert "kv pool int8: " in text
