"""Port parity, model: every ported layer against ``repro.models.layers``,
and ``lm_decode_paged`` on the llama3-8b smoke config against the JAX
``lm_decode_paged``, on the same inputs made from a numpy seed and the same
(JAX-initialised, bridged) weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SMOKE as JAX_SMOKE
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.parallel import ParallelContext
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import ARCHS, SMOKE, get_config
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm

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
    """JAX smoke bundle + params at PRNGKey(0), and the same params as
    numpy arrays for the bridge."""
    cfg = jax_get_config(ARCH, smoke=True)
    bundle = jax_build_model(cfg)
    params = bundle.init_params(jax.random.PRNGKey(0))
    return cfg, bundle, params, {k: np.asarray(v) for k, v in params.items()}


# ------------------------------------------------------------- configs etc.
def test_configs_are_field_equal():
    assert ARCHS.keys() == JAX_ARCHS.keys()
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(SMOKE[name]) == \
            dataclasses.asdict(JAX_SMOKE[name])


def test_param_layout_matches_jax(smoke):
    cfg, bundle, params, _ = smoke
    tparams = build_model(get_config(ARCH, smoke=True),
                          device="cpu").init_params()
    assert tparams.keys() == params.keys()
    for name, a in params.items():
        assert tuple(tparams[name].shape) == a.shape, name
        assert tparams[name].dtype == torch.bfloat16
    # norms start at zero offset, like the JAX builder's scale-0 params
    assert not tparams["blk.0.ln1"].float().any()


def test_bridge_is_bit_exact_for_bf16(smoke):
    _, _, params, arrays = smoke
    tparams = params_from_numpy(arrays)
    for name, a in arrays.items():
        assert tparams[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tparams[name].view(torch.uint16).numpy(), a.view(np.uint16))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((2, 5, 64)) * 3, dtype)
    wj, wt = _both(1 + 0.1 * rng.standard_normal(64), dtype)
    got, ref = _np(tl.rms_norm(xt, wt)), _np(jl.rms_norm(xj, wj))
    # fp32: rsqrt and mean in another order; bf16: the rounding before the
    # weight multiply is shared, so values agree to one bf16 ulp per round
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
           else dict(rtol=2 * BF16_EPS, atol=0))
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((2, 6, 4, 16)))
    pos = rng.integers(0, 64, (2, 6)).astype(np.int32)
    got = _np(tl.rope(xt, torch.from_numpy(pos), 500_000.0, fraction))
    ref = _np(jax.jit(jl.rope, static_argnums=(2, 3))(
        xj, jnp.asarray(pos), 500_000.0, fraction))
    # fp32 angles up to 64 rad: pow/sin/cos of two libraries, ~1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [64, 100, 30, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_einsum_canonical_split_k(k, dtype):
    rng = np.random.default_rng(k)
    xj, xt = _both(rng.standard_normal((2, 3, k)), dtype)
    wj, wt = _both(rng.standard_normal((k, 24)) / np.sqrt(k), dtype)
    got = _np(tl.tp_einsum(xt, wt))
    ref = _np(jax.jit(lambda x, w: jl.tp_einsum("btk,kd->btd", x, w))(xj, wj))
    # same slices, same tree, same single rounding; only the fp32 order
    # inside a slice differs
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=BF16_EPS, atol=1e-6))
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    rng = np.random.default_rng(2)
    d, ff = 64, 128
    xj, xt = _both(rng.standard_normal((2, 3, d)), dtype)
    ws = [_both(rng.standard_normal(s) / np.sqrt(s[0]), dtype)
          for s in ((d, ff), (d, ff), (ff, d))]
    got = _np(tl.swiglu(xt, *[w[1] for w in ws]))
    ref = _np(jax.jit(jl.swiglu)(xj, *[w[0] for w in ws]))
    # bf16: the same op sequence rounds at the same places, so only a
    # gate/up value on a rounding boundary can differ (by one ulp)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2 * BF16_EPS, atol=2e-3))
    np.testing.assert_allclose(got, ref, **tol)


def _layer_params(arrays, i=0, dtype=None):
    lp = {k[len("blk.0."):]: v[i] for k, v in arrays.items()
          if k.startswith("blk.0.")}
    j = {k: jnp.asarray(v).astype(dtype or v.dtype) for k, v in lp.items()}
    t = params_from_numpy({k: np.asarray(v) for k, v in j.items()})
    return j, t


def test_project_qkv(smoke):
    cfg, _, _, arrays = smoke
    jp, tp = _layer_params(arrays, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    xj, xt = _both(rng.standard_normal((2, 5, cfg.d_model)))
    pos = rng.integers(0, 40, (2, 5)).astype(np.int32)
    for got, ref in zip(
            tl.project_qkv(tp, "attn", cfg, xt, torch.from_numpy(pos)),
            jax.jit(lambda p, x, q: jl.project_qkv(p, "attn", cfg, x, q))(
                jp, xj, jnp.asarray(pos))):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_scores_attend(dtype):
    rng = np.random.default_rng(4)
    qj, qt = _both(rng.standard_normal((2, 3, 4, 16)), dtype)
    kj, kt = _both(rng.standard_normal((2, 7, 2, 16)), dtype)
    vj, vt = _both(rng.standard_normal((2, 7, 2, 16)), dtype)
    mask = np.tril(np.ones((3, 7), bool), 4)[None, None, None]
    got = _np(tl.gqa_scores_attend(qt, kt, vt, torch.from_numpy(mask)))
    ref = _np(jax.jit(jl.gqa_scores_attend)(qj, kj, vj, jnp.asarray(mask)))
    # bf16: scores, probabilities and output each round once to bf16
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=4 * BF16_EPS, atol=2e-2))
    np.testing.assert_allclose(got, ref, **tol)


def test_attention_decode_paged_writes_and_attends(smoke):
    """A chunk of 3 tokens into two slots (one padded), against the JAX
    layer: the output, and both pools after the in-place writes --
    including the padded position routed to null page 0."""
    cfg, _, _, arrays = smoke
    jp, tp = _layer_params(arrays, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    ps, hkv, dh = 4, cfg.num_kv_heads, cfg.resolved_head_dim
    kpj, kpt = _both(rng.standard_normal((7, ps, hkv, dh)))
    vpj, vpt = _both(rng.standard_normal((7, ps, hkv, dh)))
    xj, xt = _both(rng.standard_normal((2, 3, cfg.d_model)))
    lengths = np.array([5, 2], np.int32)
    counts = np.array([3, 2], np.int32)
    tables = np.array([[3, 1, 0], [5, 0, 0]], np.int32)
    out_j, kpj, vpj = jax.jit(
        lambda p, *a: jl.attention_decode_paged(p, "attn", cfg, *a))(
        jp, xj, kpj, vpj, jnp.asarray(lengths), jnp.asarray(counts),
        jnp.asarray(tables))
    out_t = tl.attention_decode_paged(
        tp, "attn", cfg, xt, kpt, vpt, torch.from_numpy(lengths),
        torch.from_numpy(counts), torch.from_numpy(tables))
    live = np.array([[1, 1, 1], [1, 1, 0]], bool)   # padded row is garbage
    np.testing.assert_allclose(_np(out_t)[live], _np(out_j)[live],
                               rtol=1e-4, atol=1e-5)
    # page 0 holds whatever padding wrote last; every live page must match
    np.testing.assert_allclose(_np(kpt)[1:], _np(kpj)[1:], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(vpt)[1:], _np(vpj)[1:], rtol=1e-5, atol=1e-6)


def test_mask_vocab_logits():
    rng = np.random.default_rng(6)
    lj, lt = _both(rng.standard_normal((2, 1, 256)))
    np.testing.assert_array_equal(_np(tl.mask_vocab_logits(lt, 250)),
                                  _np(jl.mask_vocab_logits(lj, 250)))
    assert tl.mask_vocab_logits(lt, 256) is lt


# --------------------------------------------------------- lm_decode_paged
def _run_lm(smoke, dtype):
    """One prefill chunk (two slots, one padded) then 3 decode steps, each
    side fed the JAX greedy tokens.  Returns per-step logits of both and
    the final pools."""
    cfg, _, params, _ = smoke
    kv = jnp.dtype(dtype).name
    jparams = jax.tree.map(lambda a: a.astype(dtype), params)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    jcache = jlm.init_paged_cache(cfg, 9, 8, kv_dtype=kv)
    tcache = tlm.init_paged_cache(get_config(ARCH, smoke=True), 9, 8,
                                  kv_dtype=kv)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = np.zeros(2, np.int32)
    counts = np.array([8, 5], np.int32)
    jf = jax.jit(lambda p, c, t, l, n, bt: jlm.lm_decode_paged(
        p, cfg, PCTX, c, t, l, n, bt))
    steps = []
    for step in range(4):
        args = [np.asarray(a) for a in (tokens, lengths, counts, tables)]
        lj, jcache = jf(jparams, jcache, *[jnp.asarray(a) for a in args])
        lt = tlm.lm_decode_paged(tparams, get_config(ARCH, smoke=True),
                                 tcache, *[torch.from_numpy(a) for a in args])
        rows = counts - 1
        steps.append((_np(lt)[[0, 1], rows], _np(lj)[[0, 1], rows]))
        nxt = np.asarray(jnp.argmax(lj[jnp.arange(2), rows], axis=-1))
        lengths = lengths + counts
        counts = np.ones(2, np.int32)
        tokens = nxt[:, None].astype(np.int32)
    return steps, tcache, jcache


def test_lm_decode_paged_fp32(smoke):
    steps, tcache, jcache = _run_lm(smoke, jnp.float32)
    for got, ref in steps:
        # fp32 throughout: only the order of fp32 sums differs
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name])[:, :, 1:],
                                   _np(jcache[name])[:, :, 1:],
                                   rtol=1e-4, atol=1e-4)


#: bf16 bound on |logits_port - logits_jax| (logits of the smoke model are
#: O(1)).  The two frameworks round bf16 at the same places but may land one
#: ulp apart wherever an fp32 sum sits on a rounding boundary, and such a
#: flip propagates through 2 layers; the measured maximum on this input is
#: printed by the test.
BF16_LOGITS_BOUND = 0.125


def test_lm_decode_paged_bf16_error_is_bounded(smoke):
    steps, _, _ = _run_lm(smoke, jnp.bfloat16)
    err = max(float(np.abs(got - ref).max()) for got, ref in steps)
    scale = max(float(np.abs(ref).max()) for _, ref in steps)
    print(f"bf16 lm_decode_paged: max |logits diff| = {err:.4g} "
          f"(max |logit| {scale:.3g})")
    assert np.isfinite(err) and err <= BF16_LOGITS_BOUND
