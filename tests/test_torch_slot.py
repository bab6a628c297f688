"""Port parity, slot engine: the contiguous-cache decode attention
(``decode_attention_ref`` against the JAX oracle and the JAX Pallas
``flash_decode`` kernel in interpret mode, ``lengths == 0`` rows included),
``attention_decode`` and ``lm_decode_step`` against the JAX model, and the
port's ``ServeEngine`` against the JAX ``ServeEngine`` and the port's own
``PagedServeEngine``.  The CUDA kernel is held to its plain version on the
card by ``chip_smoke.py``."""
import asyncio
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ref import \
    decode_attention_ref as jax_decode_ref
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.parallel import ParallelContext
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.flash_decode import decode_attention_ref, flash_decode
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.serve import (AsyncServeFrontend, PagedServeEngine, Request,
                               ServeEngine)

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


@pytest.fixture(scope="module")
def smoke():
    """JAX smoke bundle and params at PRNGKey(0), in fp32 and bf16, with
    the same params bridged to the port."""
    cfg = jax_get_config(ARCH, smoke=True)
    bundle = jax_build_model(cfg)
    params = bundle.init_params(jax.random.PRNGKey(0))
    out = {}
    for dtype in ("float32", "bfloat16"):
        p = jax.tree.map(lambda a: a.astype(dtype), params)
        out[dtype] = (p, params_from_numpy({k: np.asarray(v)
                                            for k, v in p.items()}))
    return cfg, bundle, out


# -------------------------------------------------- contiguous attention
def _contig_case(b, hq, hkv, d, s, lengths, seed, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape) for shape in
              ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    pairs = [_both(a, dtype) for a in arrays]
    lens = np.asarray(lengths, np.int32)
    return ([p[0] for p in pairs] + [jnp.asarray(lens)],
            [p[1] for p in pairs] + [torch.from_numpy(lens)])


CONTIG_CASES = [
    # b, hq, hkv, d, s, lengths
    (4, 8, 2, 32, 64, [0, 1, 33, 64]),      # empty, one token, ragged, full
    (3, 4, 4, 16, 32, [17, 0, 5]),          # MHA with an empty row
    (2, 32, 8, 64, 128, [40, 100]),         # llama3 group of 4
]


@pytest.mark.parametrize("case", CONTIG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_jax_oracle(case, dtype):
    """Every row, ``lengths == 0`` included: there both return the mean of
    V over all S positions (ROADMAP C.0)."""
    jargs, targs = _contig_case(*case, seed=1, dtype=dtype)
    got = _np(decode_attention_ref(*targs))
    ref = _np(jax_decode_ref(*jargs))
    # fp32: the same softmax with the normalisation after the value sum
    # instead of before; bf16: both work in fp32 and round the output once
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=BF16_EPS, atol=1e-3))
    np.testing.assert_allclose(got, ref, **tol)
    empty = np.asarray(case[5]) == 0
    v_mean = _np(targs[2]).mean(axis=1)                       # (B, Hkv, D)
    g = case[1] // case[2]
    np.testing.assert_allclose(
        got[empty], np.repeat(v_mean, g, axis=1)[empty], **tol)


@pytest.mark.parametrize("case", CONTIG_CASES[:2])
def test_decode_ref_matches_jax_pallas_kernel(case):
    """The JAX Pallas ``flash_decode`` kernel (interpret mode) on every row;
    it does not zero dead lanes either."""
    jargs, targs = _contig_case(*case, seed=2, dtype="float32")
    ref = _np(jax_flash_decode(*jargs, chunk=16, interpret=True))
    got = _np(decode_attention_ref(*targs))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_flash_decode_on_cpu_is_the_plain_version():
    _, targs = _contig_case(*CONTIG_CASES[0], seed=3, dtype="bfloat16")
    before = flash_decode.launches
    assert torch.equal(flash_decode(*targs), decode_attention_ref(*targs))
    assert flash_decode.launches == before


def test_flash_decode_never_takes_the_plain_path_off_the_cpu():
    _, targs = _contig_case(*CONTIG_CASES[0], seed=3, dtype="bfloat16")
    targs[0] = torch.empty(targs[0].shape, dtype=torch.bfloat16,
                           device="meta")
    with pytest.raises(ValueError):
        flash_decode(*targs)


# ---------------------------------------------------------- model layers
def test_attention_decode_writes_and_attends(smoke):
    """One token into each of three slots (one of them reused from
    length 0) against the JAX layer: the output and both caches."""
    cfg, _, weights = smoke
    jparams, tparams = weights["float32"]
    lp_j = {k[len("blk.0."):]: v[0] for k, v in jparams.items()
            if k.startswith("blk.0.")}
    lp_t = {k[len("blk.0."):]: v[0] for k, v in tparams.items()
            if k.startswith("blk.0.")}
    rng = np.random.default_rng(4)
    s, hkv, dh = 16, cfg.num_kv_heads, cfg.resolved_head_dim
    kj, kt = _both(rng.standard_normal((3, s, hkv, dh)), "bfloat16")
    vj, vt = _both(rng.standard_normal((3, s, hkv, dh)), "bfloat16")
    xj, xt = _both(rng.standard_normal((3, 1, cfg.d_model)))
    lengths = np.array([0, 7, 15], np.int32)
    out_j, kj, vj = jax.jit(
        lambda p, *a: jl.attention_decode(p, "attn", cfg, *a))(
        lp_j, xj, kj, vj, jnp.asarray(lengths))
    out_t = tl.attention_decode(lp_t, "attn", cfg, xt, kt, vt,
                                torch.from_numpy(lengths))
    # fp32 activations over a bf16 cache, as in JAX: sums in another order
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_array_equal(_np(vt), _np(vj))


def _run_decode_step(smoke, dtype):
    """Four tokens decoded into 2 slots from a fresh cache (the slot
    engine's prefill-through-decode), each side fed the JAX greedy tokens.
    Returns per-step (port, JAX) logits and both final caches."""
    cfg, _, weights = smoke
    jparams, tparams = weights[dtype]
    tcfg = get_config(ARCH, smoke=True)
    jcache = jlm.init_cache(cfg, 2, 16)
    tcache = tlm.init_cache(tcfg, 2, 16)
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
    lengths = np.array([0, 3], np.int32)
    jf = jax.jit(lambda p, c, t, l: jlm.lm_decode_step(p, cfg, PCTX, c, t, l))
    steps = []
    for _ in range(4):
        lj, jcache = jf(jparams, jcache, jnp.asarray(tokens),
                        jnp.asarray(lengths))
        lt = tlm.lm_decode_step(tparams, tcfg, tcache,
                                torch.from_numpy(tokens),
                                torch.from_numpy(lengths))
        steps.append((_np(lt)[:, 0], _np(lj)[:, 0]))
        tokens = np.asarray(jnp.argmax(lj[:, 0], axis=-1))[:, None].astype(
            np.int32)
        lengths = lengths + 1
    return steps, tcache, jcache


def test_lm_decode_step_fp32(smoke):
    steps, tcache, jcache = _run_decode_step(smoke, "float32")
    for got, ref in steps:
        # fp32 activations, but the slot cache is bf16 in both packages: an
        # fp32 K/V value ~1e-7 apart between the two can round to bf16 one
        # ulp apart (one value in 2,048 here), which moves these O(1)
        # logits by ~2e-3; greedy tokens stay equal
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
        assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    for name in ("k", "v"):   # bf16 roundings of values ~1e-7 apart
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=BF16_EPS, atol=1e-6)


#: bf16 bound on |logits_port - logits_jax|, as for ``lm_decode_paged``
#: (test_torch_model.py); the measured maximum is printed
BF16_LOGITS_BOUND = 0.125


def test_lm_decode_step_bf16_error_is_bounded(smoke):
    steps, _, _ = _run_decode_step(smoke, "bfloat16")
    err = max(float(np.abs(got - ref).max()) for got, ref in steps)
    print(f"bf16 lm_decode_step: max |logits diff| = {err:.4g}")
    for got, ref in steps:
        assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.isfinite(err) and err <= BF16_LOGITS_BOUND


# ---------------------------------------------------------------- engine
def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in lens]


def _serve(engine, prompts, request_cls, max_new=6):
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _slot_engine(tparams, **kw):
    bundle = build_model(get_config(ARCH, smoke=True), device="cpu")
    return ServeEngine(bundle, tparams, device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_engine_matches_jax_and_paged_engines(smoke, dtype):
    """3 ragged requests on 2 slots (the third reuses a slot): greedy tokens
    equal to the JAX slot engine's and to the port's paged engine's
    (ROADMAP A.3's gate); fp32 and bf16 weights (the slot cache is bf16
    either way, so the paged engine runs bf16 pools too)."""
    _, jbundle, weights = smoke
    jparams, tparams = weights[dtype]
    prompts = _prompts([5, 12, 9])
    ref = _serve(JaxServeEngine(jbundle, jparams, PCTX, slots=2, max_seq=32),
                 prompts, JaxRequest)
    assert _serve(_slot_engine(tparams, slots=2, max_seq=32), prompts,
                  Request) == ref
    paged = PagedServeEngine(build_model(get_config(ARCH, smoke=True),
                                         device="cpu"), tparams,
                             device="cpu", slots=2, page_size=8,
                             prefill_chunk=8, kv_dtype="bfloat16")
    assert _serve(paged, prompts, Request) == ref


def test_slot_engine_stops_at_max_seq_and_rejects_long_prompts(smoke):
    _, _, weights = smoke
    eng = _slot_engine(weights["float32"][1], slots=1, max_seq=12)
    req = Request(rid=0, prompt=[3, 4, 5, 6], max_new_tokens=50)
    eng.submit(req)
    eng.run_until_drained()
    assert req.done and len(req.output) == 12 - 1 - 4 + 1
    with pytest.raises(ValueError):
        eng.submit(Request(rid=1, prompt=[1] * 12, max_new_tokens=1))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=2, prompt=[], max_new_tokens=1))


def test_async_frontend_drives_the_slot_engine(smoke):
    _, _, weights = smoke
    prompts = _prompts([4, 7, 5], seed=3)
    ref = _serve(_slot_engine(weights["float32"][1], slots=2, max_seq=32),
                 prompts, Request, max_new=4)
    eng = _slot_engine(weights["float32"][1], slots=2, max_seq=32)

    async def go():
        async with AsyncServeFrontend(eng) as front:
            streams = [await front.submit(p, max_new_tokens=4)
                       for p in prompts]
            return await asyncio.gather(*(s.drain() for s in streams))

    assert asyncio.run(go()) == ref


def test_launcher_serves_on_the_slot_engine_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--device", "cpu", "--requests", "3",
                           "--max-new", "4", "--slots", "2",
                           "--engine", "slot", "--kv-dtype", "int8"])
    text = out.getvalue()
    assert "served 3/3 requests on cpu" in text
    assert "only applies to the paged engine" in text
