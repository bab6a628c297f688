"""Port parity, the zamba2 hybrid family (``models/hybrid.py``):
``hybrid_forward``, the registry's hybrid prefill, ``hybrid_decode_step``
and ``hybrid_decode_paged`` against the JAX package's on the smoke config
(2 super-blocks of 2 mamba layers and the shared attention, 1 tail layer),
with the same weights (JAX-initialised and bridged; the parameters JAX
initialises to zero -- norm offsets, ``a_log``, ``d_skip``, ``dt_bias`` --
filled with the same seeded numbers in both packages so that every path
carries signal).  fp32: logits within 5e-4, states and pools within 1e-4;
bf16: greedy tokens equal and logits within 0.125 of JAX run op by op (the
layers unrolled and eager: a jitted bf16 body drops roundings, ROADMAP
C.0).  Also the zero carries and pools against the JAX shapes and dtypes,
and the slot engine's admission, which must leave the other rows' KV and
state untouched."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import hybrid as jhybrid
from repro.parallel import ParallelContext
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import hybrid as thybrid
from repro_torch.serve import Request, ServeEngine

ARCH = "zamba2-1.2b"
PCTX = ParallelContext(None)
#: fp32: XLA's exp and cumsum differ from torch's in the last bit and sums
#: run in another order (test_torch_recurrent.py's tolerances)
FP32_LOGITS_ATOL = 5e-4
FP32_STATE_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16: one-ulp roundings at different places, compounded over the layers
BF16_LOGITS_BOUND = 0.125
#: an fp32 value stored bf16 (the slot engine's KV cache) may round one
#: bf16 ulp apart where the two fp32 values straddle a rounding boundary;
#: where a K or V value is a sum that cancels to ~1e-4, the two fp32 sums
#: differ by ~1e-6 absolute and may land two ulps apart, hence the atol
BF16_STORE_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
#: int8 state pools: a state element within an fp32 ulp of a rounding
#: boundary takes the neighbouring code on one side (one code is amax/127
#: of its head's state), and the next token's O(1) logits and fp32 leaves
#: move by up to ~1e-3 (8.2e-4 and 6.8e-4 on this input)
INT8_STATE_ATOL = 1e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def model():
    """JAX smoke bundle (layers unrolled) and its PRNGKey(0) params with
    the all-zero ones filled from a numpy seed, in fp32 and bf16, bridged
    to the port."""
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


def _jax(fn, dtype):
    """``fn`` jitted for the fp32 whole-sequence forward (speed), op by op
    otherwise: bf16 for its numerics, and the fp32 per-token decode paths
    because op by op they run faster here than they compile (eager fp32
    is within 1e-5 of jitted)."""
    return jax.jit(fn) if dtype == "float32" else fn


def _logits_ok(got, ref, dtype, atol=FP32_LOGITS_ATOL):
    """fp32: within ``atol``; bf16: within the bound, greedy tokens
    equal."""
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=atol)
        return
    err = float(np.abs(_np(got) - _np(ref)).max())
    assert err <= BF16_LOGITS_BOUND, err
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(ref).argmax(-1))


def test_layout_and_params():
    """The smoke and full layouts, and the parameter names the bridge
    maps (held name for name in test_torch_state.py)."""
    assert thybrid._layout(get_config(ARCH, smoke=True)) == \
        jhybrid._layout(jax_get_config(ARCH, smoke=True)) == (2, 2, 1)
    assert thybrid._layout(get_config(ARCH)) == (6, 6, 2)
    names = set(thybrid.build_params(get_config(ARCH, smoke=True)))
    assert {"sb.0.ssm.w_in", "sb.1.ln", "tail.0.ssm.w_out", "tail.0.ln",
            "shared.attn.wq", "shared.attn.wo", "shared.ln", "final_norm",
            "lm_head", "embed"} <= names
    assert not any(n.startswith("sb.2.") or n.startswith("tail.1.")
                   for n in names)
    for t in (1, 256, 8192, 8193, 32768):
        assert thybrid.adaptive_chunk(t) == jhybrid.adaptive_chunk(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill(model, dtype):
    """``forward`` over a (2, 21) batch and ``prefill``'s last-position
    logits, which are forward's last row with no cache (the JAX registry's
    hybrid prefill)."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 21)
    ref = _jax(lambda p, t: jbundle.forward(p, {"tokens": t}, PCTX),
               dtype)(jp, jnp.asarray(toks))
    got = bundle.forward(tp, torch.from_numpy(toks))
    assert got.shape == ref.shape == (2, 21, cfg.padded_vocab)
    _logits_ok(got, ref, dtype)
    jl, jcache = _jax(lambda p, t: jbundle.prefill(p, {"tokens": t}, PCTX),
                      dtype)(jp, jnp.asarray(toks))
    tl, tcache = bundle.prefill(tp, torch.from_numpy(toks), max_seq=32)
    assert jcache is None and tcache is None
    _logits_ok(tl, jl, dtype)
    np.testing.assert_array_equal(_np(tl), _np(got[:, -1:]))


def _check_state(tstate, jstate, dtype):
    assert sorted(tstate) == sorted(jstate)
    for k, v in jstate.items():
        assert tstate[k].dtype == getattr(torch, str(v.dtype)), k
        if dtype == "float32" and v.dtype == jnp.bfloat16:
            np.testing.assert_allclose(_np(tstate[k]), _np(v),
                                       **BF16_STORE_TOL)
        elif dtype == "float32":
            np.testing.assert_allclose(_np(tstate[k]), _np(v),
                                       **FP32_STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step(model, dtype):
    """A 6-token prompt decoded token by token from zeros (rows at
    different lengths: row 1 starts 2 positions later), then 3 greedy
    tokens, each side fed the JAX tokens: logits and every leaf of the
    carry after each step (the KV caches written in place on the port's
    side)."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    jstate = jhybrid.init_state(cfg, 2, 16)
    tstate = bundle.init_cache(2, 16)
    def step(p, s, t, n):
        return jbundle.decode_step(p, s, t, n, PCTX)

    prompt = _tokens(cfg, 2, 6, seed=1)
    lengths = np.array([0, 2], np.int32)
    nxt = prompt[:, :1]
    for i in range(9):
        jl, jstate = step(jp, jstate, jnp.asarray(nxt), jnp.asarray(lengths))
        tl = bundle.decode_step(tp, tstate, torch.from_numpy(nxt),
                                torch.from_numpy(lengths))
        _logits_ok(tl, jl, dtype)
        _check_state(tstate, jstate, dtype)
        lengths = lengths + 1
        nxt = (prompt[:, i + 1:i + 2] if i + 1 < prompt.shape[1] else
               np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
                   np.int32))
    # the KV caches hold each row's positions, zeros past them
    assert tstate["attn_k"][:, 0, 9:].abs().sum() == 0
    assert tstate["attn_k"][:, 1, 11:].abs().sum() == 0
    assert tstate["attn_k"][:, 1, 2:11].abs().sum() > 0


def _tables(kv_pages, reads, writes):
    """The engine's combined table: KV page columns, the state read
    column, the T state write columns."""
    return np.concatenate([np.asarray(kv_pages, np.int32),
                           np.asarray(reads, np.int32)[:, None],
                           np.asarray(writes, np.int32)], axis=1)


@pytest.mark.parametrize("dtype,kv_dtype,state_dtype", [
    ("float32", "bfloat16", "float32"), ("float32", "int8", "float32"),
    ("float32", "bfloat16", "int8"), ("float32", "float32", "float32"),
    ("bfloat16", "bfloat16", "float32"), ("bfloat16", "int8", "float32")])
def test_decode_paged(model, dtype, kv_dtype, state_dtype):
    """One prefill chunk of 6 over pages of 4 (row 1 padded after 4 tokens;
    its post-token state goes to slot 3, row 0's to slot 2, the rest to the
    trash slot 1; its padded K/V to the null page 0), then two decode
    ticks reading and writing slots 2 and 3 on pages that cross a page
    boundary: live logits, and every pool -- KV pages past the null page
    (int8 codes and scales included) and the live state slots -- after
    each call.  ``kv_dtype="float32"`` gives bf16 pools in both packages."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    jcache = jbundle.init_paged_cache(7, 4, kv_dtype, state_slots=6,
                                      state_dtype=state_dtype)
    tcache = bundle.init_paged_cache(7, 4, kv_dtype, state_slots=6,
                                     state_dtype=state_dtype)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in
            tcache.items()} == {k: (v.shape, str(v.dtype))
                                for k, v in jcache.items()}
    toks = _tokens(cfg, 2, 6, seed=2)
    counts = np.array([6, 4], np.int32)
    lengths = np.zeros(2, np.int32)
    pages = [[1, 2, 3], [4, 5, 6]]
    tables = _tables(pages, [0, 0], [[1, 1, 1, 1, 1, 2], [1, 1, 1, 3, 1, 1]])
    def fwd(p, c, *a):
        return jbundle.decode_paged(p, c, *a, PCTX)

    for _ in range(3):
        args = (toks, lengths, counts, tables)
        jl, jcache = fwd(jp, jcache, *map(jnp.asarray, args))
        tl = bundle.decode_paged(tp, tcache, *map(torch.from_numpy, args))
        rows = np.arange(2), counts - 1
        int8_state = state_dtype == "int8"
        _logits_ok(tl[rows], jl[rows], dtype, atol=(
            INT8_STATE_ATOL if int8_state else FP32_LOGITS_ATOL))
        if dtype == "float32":
            for k in jcache:
                got, ref = _np(tcache[k]), _np(jcache[k])
                if k in ("conv", "ssm", "ssm_scale"):
                    got, ref = got[:, 2:4], ref[:, 2:4]  # 0, 1: null, trash
                else:
                    got, ref = got[:, :, 1:], ref[:, :, 1:]   # null page
                if tcache[k].dtype == torch.int8:   # codes: one step apart
                    diff = np.abs(got - ref)        # at most, and rarely
                    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
                else:
                    np.testing.assert_allclose(got, ref, **(
                        dict(rtol=0, atol=INT8_STATE_ATOL) if int8_state
                        else FP32_STATE_TOL))
        nxt = np.asarray(jnp.argmax(jl[rows], axis=-1)).astype(np.int32)
        toks = nxt[:, None]
        lengths = lengths + counts
        counts = np.ones(2, np.int32)
        tables = _tables(pages, [2, 3], [[2], [3]])


def test_init_state_and_pools_match_jax():
    """Zero carries and pools of the JAX shapes and dtypes, at smoke and
    full width, for every KV and state dtype (KV pools bf16 for every
    ``kv_dtype`` but int8, as in the JAX package)."""
    for smoke in (True, False):
        jcfg, tcfg = jax_get_config(ARCH, smoke), get_config(ARCH, smoke)
        pairs = [(jhybrid.init_state_abstract(jcfg, 3, 40),
                  thybrid.init_state(tcfg, 3, 40, device="meta"))]
        for kv in ("bfloat16", "float32", "int8"):
            for sd in ("float32", "int8"):
                pairs.append((
                    jhybrid.init_paged_cache_abstract(jcfg, 9, 16, kv, 10,
                                                      sd),
                    thybrid.init_paged_cache(tcfg, 9, 16, kv, 10, sd,
                                             device="meta")))
        for jtree, ttree in pairs:
            assert sorted(jtree) == sorted(ttree)
            for k, s in jtree.items():
                assert tuple(ttree[k].shape) == s.shape, k
                assert str(ttree[k].dtype) == f"torch.{s.dtype}", k
    full = thybrid.init_paged_cache(get_config(ARCH), 9, 16, "float32",
                                    device="meta")
    assert full["k"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="state_dtype"):
        thybrid.init_paged_cache(get_config(ARCH, smoke=True), 9, 16,
                                 state_dtype="bfloat16")


def test_slot_admission_leaves_other_rows_untouched(model):
    """The slot engine prefills a newly admitted request through the decode
    path over the whole slot batch, so every row's recurrence and KV are
    advanced and written; the other rows' conv, SSD state and KV must come
    back bit for bit as they were, with the mid-flight request's tokens
    unchanged."""
    _, params = model
    tp = params["float32"][1]
    bundle = build_model(get_config(ARCH, smoke=True), device="cpu")

    def run(second_at):
        eng = ServeEngine(bundle, tp, device="cpu", slots=2, max_seq=32)
        first = Request(rid=0, prompt=[3, 4, 5, 6, 7], max_new_tokens=8)
        eng.submit(first)
        snap = None
        for tick in range(12):
            if tick == second_at:
                eng.submit(Request(rid=1, prompt=[9, 10, 11, 12],
                                   max_new_tokens=3))
                row = eng.active.index(first)
                snap = {k: v[:, row].clone() for k, v in eng.cache.items()}
                eng._admit()
                assert eng.active[1 - row].rid == 1
                for k, v in snap.items():
                    assert torch.equal(eng.cache[k][:, row], v), k
            eng.step()
        return first.output

    assert run(second_at=3) == run(second_at=None)
