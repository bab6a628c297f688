"""Port parity, the audio family (whisper, ``models/encdec.py``):
``encode``, ``encdec_forward``, ``encdec_prefill`` (its logits and all four
cache leaves) and ``encdec_decode_step`` against the JAX package's on the
smoke config (2 encoder and 2 decoder layers over 16 frames), with the same
weights (JAX-initialised and bridged; the norm offsets, zero in both
packages, filled with the same seeded numbers so every norm carries
signal) and the same seeded frames.  fp32: logits and outputs within 1e-4;
bf16: greedy tokens equal and logits within 0.125 of JAX run op by op (the
layers unrolled and eager: a jitted bf16 body drops roundings, ROADMAP
C.0).  Also ``gelu`` bit for bit against ``jax.nn.gelu``, the slot
engine's tokens against the JAX slot engine's, the paged engine's and the
launcher's refusal of the family, and a CPU run of the launcher."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro.parallel import ParallelContext
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import encdec as tencdec
from repro_torch.models.layers import gelu
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

ARCH = "whisper-large-v3"
PCTX = ParallelContext(None)
#: fp32: the same products summed in another order (XLA's dot against the
#: port's fp32 matmul, the canonical split-K of tp_einsum on both)
FP32_ATOL = 1e-4
#: bf16: one-ulp roundings at different places, compounded over the layers
BF16_LOGITS_BOUND = 0.125
#: a value computed in fp32 and stored bf16 (the caches) may round one bf16
#: ulp apart where the two fp32 values straddle a rounding boundary
BF16_STORE_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def model():
    """JAX smoke bundle (layers unrolled) and its PRNGKey(0) params with
    the all-zero norm offsets filled from a numpy seed, in fp32 and bf16,
    bridged to the port."""
    jbundle = jax_build_model(dataclasses.replace(
        jax_get_config(ARCH, smoke=True), scan_layers=False))
    rng = np.random.default_rng(0)
    base = {}
    for name, a in sorted(jbundle.init_params(jax.random.PRNGKey(0)).items()):
        a = np.asarray(a.astype(jnp.float32))
        if not a.any():
            a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        base[name] = a
    out = {}
    for dtype in ("float32", "bfloat16"):
        jp = {k: jnp.asarray(v).astype(dtype) for k, v in base.items()}
        out[dtype] = (jp, params_from_numpy({k: np.asarray(v)
                                             for k, v in jp.items()}))
    return jbundle, out


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, t)
                                                ).astype(np.int32)


def _frames(cfg, b, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def _close(got, ref, dtype, atol=FP32_ATOL):
    """fp32: within ``atol``; bf16: within the bound, greedy tokens
    equal."""
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=atol)
        return
    err = float(np.abs(_np(got) - _np(ref)).max())
    assert err <= BF16_LOGITS_BOUND, err
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(ref).argmax(-1))


def _jax(fn, dtype):
    """``fn`` jitted in fp32 (speed); op by op in bf16, for its
    numerics."""
    return jax.jit(fn) if dtype == "float32" else fn


def test_param_specs_match_jax():
    """Names, shapes and init scales of the port's ``build_params`` equal
    the JAX ``ParamBuilder``'s, at smoke and full width (1.645 B
    parameters)."""
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke=smoke)
        specs = tencdec.build_params(cfg)
        jdefs = jencdec.build_params(jax_get_config(ARCH, smoke=smoke))._defs
        assert {k: (tuple(s), pytest.approx(sc)) for k, (s, sc)
                in specs.items()} == {k: (s, sc) for k, (s, _, sc)
                                      in jdefs.items()}
    full = tencdec.build_params(get_config(ARCH))
    assert sum(int(np.prod(s)) for s, _ in full.values()) == 1_645_114_880


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_equals_jax(dtype):
    """``layers.gelu`` against ``jax.nn.gelu`` (approximate) on 2^16
    values: bit for bit in bf16, within 2 fp32 ulps of |x| in fp32 (XLA's
    and PyTorch's tanh differ in the last bits)."""
    x = (np.random.default_rng(0).standard_normal(1 << 16) * 4).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = _np(jax.nn.gelu(jx))
    got = _np(gelu(torch.from_numpy(_np(jx)).to(getattr(torch, dtype))))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2 * 2.0 ** -23 * np.abs(x).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_forward(model, dtype):
    """``encode`` of (2, 16) frames and the teacher-forced forward over a
    (2, 7) prompt."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    jcfg = jbundle.cfg
    frames, toks = _frames(cfg, 2), _tokens(cfg, 2, 7)
    ref = _jax(lambda p, f: jencdec.encode(p, jcfg, f, scan_layers=False),
               dtype)(jp, jnp.asarray(frames))
    got = tencdec.encode(tp, cfg, torch.from_numpy(frames))
    assert got.shape == ref.shape == (2, 16, cfg.d_model)
    assert got.dtype == getattr(torch, str(ref.dtype))
    _close(got, ref, dtype)
    bundle = build_model(cfg, device="cpu")
    ref = _jax(lambda p, t, f: jbundle.forward(
        p, {"tokens": t, "frames": f}, PCTX), dtype)(
            jp, jnp.asarray(toks), jnp.asarray(frames))
    got = bundle.forward(tp, torch.from_numpy(toks),
                         frames=torch.from_numpy(frames))
    assert got.shape == ref.shape == (2, 7, cfg.padded_vocab)
    _close(got, ref, dtype)


def _check_cache(tcache, jcache, dtype):
    assert sorted(tcache) == sorted(jcache)
    for k, v in jcache.items():
        assert tuple(tcache[k].shape) == v.shape, k
        assert tcache[k].dtype == torch.bfloat16 == getattr(torch,
                                                            str(v.dtype)), k
        if dtype == "float32":
            np.testing.assert_allclose(_np(tcache[k]), _np(v),
                                       **BF16_STORE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode(model, dtype):
    """``prefill`` of a (2, 6) prompt into a 12-position cache (logits and
    every leaf: the self K/V zero past the prompt, the cross K/V of the
    encoded frames), then 4 decode steps from that cache, each side fed
    the JAX tokens: logits and every leaf after each step."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    frames, toks = _frames(cfg, 2), _tokens(cfg, 2, 6, seed=1)
    jl, jcache = _jax(lambda p, t, f: jbundle.prefill(
        p, {"tokens": t, "frames": f}, PCTX, max_seq=12), dtype)(
            jp, jnp.asarray(toks), jnp.asarray(frames))
    tl, tcache = bundle.prefill(tp, torch.from_numpy(toks), 12,
                                frames=torch.from_numpy(frames))
    assert tl.shape == jl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl, dtype)
    _check_cache(tcache, jcache, dtype)
    assert not tcache["self_k"][:, :, 6:].any()
    lengths = np.full(2, 6, np.int32)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jcache = _jax(lambda p, c, t, n: jbundle.decode_step(
            p, c, t, n, PCTX), dtype)(jp, jcache, jnp.asarray(nxt),
                                      jnp.asarray(lengths))
        tl = bundle.decode_step(tp, tcache, torch.from_numpy(nxt),
                                torch.from_numpy(lengths))
        _close(tl, jl, dtype)
        _check_cache(tcache, jcache, dtype)
        lengths = lengths + 1


def test_int8_weights_decode_matches_jax(model):
    """The int8-weight variant (the JAX package's audio family has one):
    fp32 activations over the same int8 codes, a decode step from a zero
    cache, within the fp32 bound."""
    jbundle, params = model
    jp, tp = params["float32"]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    assert bundle.supports_int8_weights
    jq = jbundle.quantize_params(jp)
    tq = bundle.quantize_params(tp)
    toks = _tokens(cfg, 2, 1, seed=4)
    lengths = np.array([0, 3], np.int32)
    jl, _ = jbundle.decode_step(jq, jbundle.init_cache(2, 8),
                                jnp.asarray(toks), jnp.asarray(lengths), PCTX)
    tl = bundle.decode_step(tq, bundle.init_cache(2, 8),
                            torch.from_numpy(toks), torch.from_numpy(lengths))
    _close(tl, jl, "float32")


def test_cache_shapes_match_jax():
    """The zero cache of the JAX shapes and dtype, at smoke and full width
    (the cross K/V 1500 frames long)."""
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke=smoke)
        ref = jencdec.init_cache_abstract(jax_get_config(ARCH, smoke=smoke),
                                          3, 40)
        got = tencdec.init_cache(cfg, 3, 40, device="meta")
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
            {k: (v.shape, torch.bfloat16) for k, v in ref.items()}


def _serve(engine, prompts, request_cls, max_new=5):
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_engine_matches_jax_slot_engine(model, dtype):
    """3 ragged requests on 2 slots (one admitted mid-flight): the port's
    slot engine gives the JAX slot engine's greedy tokens (in bf16 the JAX
    engine runs op by op, ``jax.disable_jit``, as its jitted step drops
    roundings).  No frames reach either engine: both decode against the
    zero cross K/V of the cache."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 9, 4)]
    kw = dict(slots=2, max_seq=24)
    with jax.disable_jit(dtype == "bfloat16"):
        jtoks = _serve(JaxServeEngine(jbundle, jp, PCTX, **kw), prompts,
                       JaxRequest)
    ttoks = _serve(ServeEngine(build_model(cfg, device="cpu"), tp,
                               device="cpu", **kw), prompts, Request)
    assert ttoks == jtoks


def test_paged_serving_is_refused_by_name(model):
    """The JAX package pages no audio cache: the bundle, the paged engine
    and the launcher's paged engine refuse the family by name."""
    _, params = model
    bundle = build_model(get_config(ARCH, smoke=True), device="cpu")
    assert not bundle.supports_paged_serving
    with pytest.raises(ValueError, match="'audio' family"):
        PagedServeEngine(bundle, params["float32"][1], device="cpu")
    with pytest.raises(ValueError, match="'audio' family"):
        bundle.init_paged_cache(4, 4)
    with pytest.raises(SystemExit, match="--engine slot"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(ValueError, match="needs frames"):
        bundle.forward(params["float32"][1],
                       torch.ones((1, 2), dtype=torch.long))


def test_launcher_serves_whisper_on_the_cpu(capsys):
    """``launch/serve.py --arch whisper-large-v3 --engine slot`` serves
    every request on the CPU."""
    launch_serve.main(["--arch", ARCH, "--engine", "slot", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert "served 3/3 requests on cpu" in capsys.readouterr().out
