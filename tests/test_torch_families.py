"""Port parity, the moe and vlm families on ``models/lm.py``: arctic-480b
(top-2 MoE with a dense residual, every layer), llama4-maverick (top-1 MoE
on every 2nd layer, super-blocks of 2) and internvl2-1b (the vlm, a vision
prefix before the text) at their smoke configs, against the JAX package on
the same weights (JAX-initialised and bridged; the all-zero norm offsets
filled from a numpy seed in both, so they carry signal).

fp32: logits within 1e-4; bf16: within 0.125 of JAX run op by op (layers
unrolled, eager; ROADMAP C.0) with greedy tokens equal.  The smoke configs
route drop-free (capacity factor 64), as the JAX package sizes them, so a
token's output does not depend on the rows beside it; the published
factor's drops are held in ``tests/test_torch_moe.py``.  Then the engines:
the port's ``PagedServeEngine`` and ``ServeEngine`` against the JAX
engines in fp32 and against each other, the n-gram speculative engine against the plain one, and
the launcher on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro.parallel import ParallelContext
from repro.quant import quantize_params as jax_quantize_params
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.spec import NgramDraft, SpeculativeServeEngine

ARCHS = ["arctic-480b", "llama4-maverick-400b-a17b", "internvl2-1b"]
PCTX = ParallelContext(None)
FP32_LOGITS_ATOL = 1e-4
BF16_LOGITS_BOUND = 0.125


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, the JAX bundle with its layers unrolled, {dtype: (JAX params,
    torch params)}) for fp32 and bf16."""
    arch = request.param
    jbundle = jax_build_model(dataclasses.replace(
        jax_get_config(arch, smoke=True), scan_layers=False))
    rng = np.random.default_rng(0)
    base = {}
    for name, a in sorted(jbundle.init_params(jax.random.PRNGKey(0)).items()):
        a = np.asarray(a.astype(jnp.float32))
        if not a.any():
            a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        base[name] = a
    params = {}
    for dtype in ("float32", "bfloat16"):
        jp = {k: jnp.asarray(v).astype(dtype) for k, v in base.items()}
        params[dtype] = (jp, params_from_numpy(
            {k: np.asarray(v) for k, v in jp.items()}))
    return arch, jbundle, params


def _jax(fn, dtype):
    """``fn`` jitted for fp32 (speed), op by op for bf16 (numerics)."""
    return jax.jit(fn) if dtype == "float32" else fn


def _close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                   atol=FP32_LOGITS_ATOL)
        return
    err = float(np.abs(_np(got) - _np(ref)).max())
    assert np.isfinite(err) and err <= BF16_LOGITS_BOUND, err
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(ref).argmax(-1))


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, t)
                                                ).astype(np.int32)


def _prefix(cfg, b, dtype, seed=1):
    """The vlm's stubbed vision embeddings (B, vision_tokens, d), or
    none for the moe family."""
    if not cfg.vision_tokens:
        return None, None
    pe = np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    j = jnp.asarray(pe).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("module", ["arctic_480b", "llama4_maverick_400b",
                                    "internvl2_1b", "deepseek_coder_33b"])
def test_config_modules_equal_jax(module):
    """The ``--arch`` modules: ``CONFIG`` and ``SMOKE_CONFIG`` field for
    field the JAX modules'."""
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    jmod = importlib.import_module(f"repro.configs.{module}")
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(mod, name)) == \
            dataclasses.asdict(getattr(jmod, name))


# ------------------------------------------------------------------ caches
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_equal_jax(arch):
    """``(n_sb, me, ...)`` slot and paged caches (bf16 and int8 pools with
    their scales): the JAX shapes and dtypes."""
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    jb = jax_build_model(jcfg)
    pairs = [(bundle.init_cache(3, 20), jb.init_cache(3, 20))]
    for kv in ("bfloat16", "float32", "int8"):
        pairs.append((bundle.init_paged_cache(9, 8, kv),
                      jb.init_paged_cache(9, 8, kv)))
    for got, ref in pairs:
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert tuple(got[k].shape) == ref[k].shape, k
            assert str(got[k].dtype)[6:] == str(ref[k].dtype), k
    me = max(cfg.moe_every, 1)
    assert pairs[0][0]["k"].shape[:2] == (cfg.num_layers // me, me)


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_flags_equal_jax(arch):
    """The paged-KV and int8-weight flags of the JAX bundle; int8 weights
    keep the router full precision."""
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    jb = jax_build_model(jax_get_config(arch, smoke=True))
    for flag in ("supports_paged_kv", "supports_paged_state",
                 "supports_paged_serving", "supports_int8_weights"):
        assert getattr(bundle, flag) == getattr(jb, flag), flag
    q = bundle.quantize_params(bundle.init_params())
    assert all(isinstance(v, torch.Tensor) for k, v in q.items()
               if k.endswith(".router"))


# ----------------------------------------------------- whole-sequence paths
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill(model, dtype):
    """``forward`` over (2, 7) tokens (after 8 vision embeddings for the
    vlm) and ``prefill`` into a cache of max_seq S + 4: logits and the
    prefilled K/V (the prefix's positions included), zero past S."""
    arch, jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 7)
    jpe, tpe = _prefix(cfg, 2, dtype)
    s = 7 + (cfg.vision_tokens or 0)
    batch = {"tokens": jnp.asarray(toks)}
    if jpe is not None:
        batch["vision_embeds"] = jpe
    ref = _jax(lambda p, b: jbundle.forward(p, b, PCTX), dtype)(jp, batch)
    got = bundle.forward(tp, torch.from_numpy(toks), prefix_embeds=tpe)
    jl_, jcache = _jax(lambda p, b: jbundle.prefill(
        p, b, PCTX, max_seq=s + 4), dtype)(jp, batch)
    tl_, tcache = bundle.prefill(tp, torch.from_numpy(toks), max_seq=s + 4,
                                 prefix_embeds=tpe)
    assert got.shape == ref.shape == (2, s, cfg.padded_vocab)
    assert tl_.shape == jl_.shape == (2, 1, cfg.padded_vocab)
    _close(got, ref, dtype)
    _close(tl_, jl_, dtype)
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert tcache[k].dtype == torch.bfloat16
        assert not tcache[k][:, :, :, s:].any()
        # bf16 K/V of fp32 (or bf16) activations: an fp32 sum order apart
        # may round to the neighbouring bf16 value
        np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]),
                                   rtol=2 ** -7, atol=2 ** -7 if
                                   dtype == "float32" else 2e-2)
    np.testing.assert_array_equal(_np(tl_[:, 0]), _np(got[:, -1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_hands_off_to_decode_step(model, dtype):
    """Three slot-cache decode steps from each side's own prefilled cache
    (the vlm's with its vision prefix), each fed the JAX greedy tokens."""
    arch, jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 5, seed=2)
    jpe, tpe = _prefix(cfg, 2, dtype, seed=3)
    s = 5 + (cfg.vision_tokens or 0)
    batch = {"tokens": jnp.asarray(toks)}
    if jpe is not None:
        batch["vision_embeds"] = jpe
    jl_, jcache = _jax(lambda p, b: jbundle.prefill(
        p, b, PCTX, max_seq=s + 4), dtype)(jp, batch)
    _, tcache = bundle.prefill(tp, torch.from_numpy(toks), max_seq=s + 4,
                               prefix_embeds=tpe)
    step = _jax(lambda p, c, t, n: jbundle.decode_step(p, c, t, n, PCTX),
                dtype)
    nxt = np.asarray(jnp.argmax(jl_[:, -1], axis=-1))[:, None].astype(
        np.int32)
    lengths = np.full(2, s, np.int32)
    for _ in range(3):
        jl_, jcache = step(jp, jcache, jnp.asarray(nxt), jnp.asarray(lengths))
        tl_ = bundle.decode_step(tp, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(lengths))
        _close(tl_, jl_, dtype)
        nxt = np.asarray(jnp.argmax(jl_[:, -1], axis=-1))[:, None].astype(
            np.int32)
        lengths = lengths + 1


# --------------------------------------------------------- paged decoding
@pytest.mark.parametrize("variant", ["float32", "bfloat16", "int8_kv",
                                     "int8_weights_kv"])
def test_decode_paged_equals_jax(model, variant):
    """One prefill chunk (two slots, one padded: its padded rows route
    too) then 3 decode ticks over paged pools, each side fed the JAX
    greedy tokens: bf16/fp32 pools of that dtype's model, int8 pools under
    the bf16 model, and int8 weights (the router full precision) with
    int8 pools."""
    arch, _, params = model
    dtype = "float32" if variant == "float32" else "bfloat16"
    jp, tp = params[dtype]
    kv = {"int8_kv": "int8", "int8_weights_kv": "int8"}.get(variant, dtype)
    if variant == "int8_weights_kv":
        jp, tp = jax_quantize_params(jp), build_model(
            get_config(arch, smoke=True), device="cpu").quantize_params(tp)
    cfg = get_config(arch, smoke=True)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               scan_layers=False)
    jcache = jax_lm.init_paged_cache(jcfg, 9, 8, kv_dtype=kv)
    tcache = build_model(cfg, device="cpu").init_paged_cache(9, 8, kv)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    tokens = _tokens(cfg, 2, 8, seed=7)
    lengths, counts = np.zeros(2, np.int32), np.array([8, 5], np.int32)
    jf = _jax(lambda p, c, t, l, n, bt: jax_lm.lm_decode_paged(
        p, jcfg, PCTX, c, t, l, n, bt), dtype)
    for _ in range(4):
        args = [np.asarray(a) for a in (tokens, lengths, counts, tables)]
        lj, jcache = jf(jp, jcache, *[jnp.asarray(a) for a in args])
        lt = build_model(cfg, device="cpu").decode_paged(
            tp, tcache, *[torch.from_numpy(a) for a in args])
        rows = counts - 1
        _close(lt[[0, 1], torch.from_numpy(rows).long()],
               _np(lj)[[0, 1], rows], dtype)
        nxt = np.asarray(jnp.argmax(lj[jnp.arange(2), rows], axis=-1))
        lengths, counts = lengths + counts, np.ones(2, np.int32)
        tokens = nxt[:, None].astype(np.int32)


# ----------------------------------------------------------------- engines
def _serve(engine, prompts, request_cls, max_new=5):
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]


def test_engines_match_jax_engines(model):
    """fp32 params, 3 ragged requests on 2 slots (one admitted mid-flight),
    pages and chunks of 8: the port's paged engine on fp32 pools gives the
    JAX paged engine's greedy tokens, its slot engine the JAX slot
    engine's, and its paged engine on bf16 pools the slot engine's (the
    slot cache is bf16 in both packages, so fp32 pools may part from it
    at a near-tie: on llama4-maverick they do, in JAX as in the port)."""
    arch, jbundle, params = model
    jp, tp = params["float32"]
    cfg = get_config(arch, smoke=True)
    prompts = _prompts(cfg, [5, 12, 9])
    kw = dict(slots=2, page_size=8, prefill_chunk=8)
    slot_kw = dict(slots=2, max_seq=32)
    bundle = build_model(cfg, device="cpu")
    jpaged = _serve(JaxEngine(jbundle, jp, PCTX, kv_dtype="float32", **kw),
                    prompts, JaxRequest)
    paged = _serve(PagedServeEngine(bundle, tp, device="cpu",
                                    kv_dtype="float32", **kw),
                   prompts, Request)
    assert paged == jpaged
    jslot = _serve(JaxServeEngine(jbundle, jp, PCTX, **slot_kw), prompts,
                   JaxRequest)
    slot = _serve(ServeEngine(bundle, tp, device="cpu", **slot_kw), prompts,
                  Request)
    assert slot == jslot
    paged_bf16 = _serve(PagedServeEngine(bundle, tp, device="cpu",
                                         kv_dtype="bfloat16", **kw),
                        prompts, Request)
    assert paged_bf16 == slot


def test_ngram_spec_engine_equals_the_plain_engine():
    """arctic-480b (smoke, bf16): the n-gram ``SpeculativeServeEngine``
    gives the plain paged engine's tokens (verify steps of spec_k + 1 rows
    route drop-free, so a row's output is its decode tick's)."""
    cfg = get_config("arctic-480b", smoke=True)
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg, [6, 11, 3], seed=4)
    prompts[1] = prompts[1][:4] * 3        # repeats for the n-gram to find
    kw = dict(device="cpu", slots=2, page_size=8, prefill_chunk=8)
    plain = _serve(PagedServeEngine(bundle, params, **kw), prompts, Request,
                   max_new=8)
    spec = SpeculativeServeEngine(bundle, params, spec_k=3,
                                  draft=NgramDraft(), **kw)
    assert _serve(spec, prompts, Request, max_new=8) == plain
    assert spec.metrics.spec_steps > 0


@pytest.mark.parametrize("arch,extra", [
    ("arctic-480b", []), ("internvl2-1b", ["--engine", "slot"]),
    ("llama4-maverick-400b-a17b", ["--int8-weights", "--kv-dtype", "int8"])])
def test_launcher_serves_the_families_on_the_cpu(arch, extra, capsys):
    launch_serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                       "--max-new", "3", "--slots", "2"] + extra)
    assert "served 2/2 requests on cpu" in capsys.readouterr().out
