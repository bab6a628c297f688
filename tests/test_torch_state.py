"""Port parity, recurrent-state serving: the state-pool helpers
(``gather_state``/``scatter_state`` with int8 leaves, ``copy_state_slot``,
``copy_kv_page``, ``split_state_tables``) against the JAX functions, the
copied ``StateCache`` driven in lockstep with the JAX copy, the port's paged
and slot engines against the JAX slot engine's greedy tokens on the rwkv6,
mamba2 and zamba2 smoke configs, the engines' state choreography
(preemption, defrag, truncate, rejections), and the bundle, bridge and
configs of the three families.  The zamba2 hybrid's paged engine holds KV
pages and a state slot behind one block table; its golden is the JAX slot
engine, not the JAX paged engine (a red cell, ROADMAP C.1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import paged_state as jps
from repro.parallel import ParallelContext
from repro.serve import PagedServeEngine as JaxPagedEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.state_cache import OutOfStateSlots as JaxOutOfStateSlots
from repro.serve.state_cache import StateCache as JaxStateCache
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import paged_state as tps
from repro_torch.models.registry import param_specs
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.serve.state_cache import (NULL_STATE, TRASH_STATE,
                                           OutOfStateSlots, StateCache)

PCTX = ParallelContext(None)
RECURRENT = ["rwkv6-3b", "mamba2-2.7b"]
ARCHS = RECURRENT + ["zamba2-1.2b"]
#: the JAX identity matrix's trace and paged geometry
#: (tests/test_engine_identity.py): a shared 16-token head, 2 slots, so the
#: third request is admitted mid-flight
HEAD = [2 + (j % 5) for j in range(16)]
PAGED_KW = dict(slots=2, page_size=8, num_pages=16, prefill_chunk=8)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------ state-pool helpers
def _pools(state_dtype, seed=0):
    """A small mixed cache: rwkv6-like state pools (slot axis 1), one KV
    page pool (page axis 2), random contents, in both frameworks."""
    rng = np.random.default_rng(seed)
    arrays = {"tmix_x": rng.standard_normal((2, 6, 8)),
              "k": rng.standard_normal((2, 1, 5, 4, 2, 8))}
    if state_dtype == "int8":
        arrays["wkv"] = rng.integers(-127, 128, (2, 6, 3, 4, 4))
        arrays["wkv_scale"] = rng.uniform(0.01, 0.1, (2, 6, 3))
    else:
        arrays["wkv"] = rng.standard_normal((2, 6, 3, 4, 4))
    dtypes = {"tmix_x": "bfloat16", "k": "bfloat16", "wkv_scale": "float32",
              "wkv": "int8" if state_dtype == "int8" else "float32"}
    j = {k: jnp.asarray(a).astype(dtypes[k]) for k, a in arrays.items()}
    return j, {k: tensor_from_numpy(np.asarray(v)) for k, v in j.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_gather_and_scatter_state_match_jax(state_dtype):
    """Gather at ids [3, 0], scatter a new state to [4, 1, 1] (duplicate
    trash writes with equal values): the gathered state and every pool
    after the scatter, int8 codes and scales included, equal JAX's."""
    jcache, tcache = _pools(state_dtype)
    ids = np.array([3, 0], np.int32)
    jst = jps.gather_state(jcache, jnp.asarray(ids))
    tst = tps.gather_state(tcache, torch.from_numpy(ids))
    assert sorted(tst) == sorted(jst) == ["tmix_x", "wkv"]
    for k in jst:
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), rtol=1e-6)
    rng = np.random.default_rng(1)
    new = {"tmix_x": rng.standard_normal((2, 3, 8)),
           "wkv": rng.standard_normal((2, 3, 3, 4, 4))}
    new["tmix_x"][:, 2] = new["tmix_x"][:, 1]
    new["wkv"][:, 2] = new["wkv"][:, 1]
    jnew = {k: jnp.asarray(v, jnp.float32) for k, v in new.items()}
    tnew = {k: torch.tensor(v, dtype=torch.float32) for k, v in new.items()}
    ids = np.array([4, 1, 1], np.int32)
    jcache = jps.scatter_state(jcache, jnew, jnp.asarray(ids))
    assert tps.scatter_state(tcache, tnew, torch.from_numpy(ids)) is tcache
    for k in jcache:
        assert str(tcache[k].dtype) == f"torch.{jcache[k].dtype}"
        np.testing.assert_array_equal(_np(tcache[k]), _np(jcache[k]))


def test_quantize_state_matches_jax_bit_for_bit():
    """Divide-and-round-half-to-even int8 quantization, ties and an
    all-zero head included."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    v[0, 0] = 0.0
    v[1, 1, 0, 0] = 2.54
    v[1, 1, 0, 1] = -2.54
    v[1, 1, 1, 1] = 0.01 * 127
    jq, js = jps._quantize(jnp.asarray(v))
    tq, ts = tps._quantize(torch.from_numpy(v))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_split_and_copy_helpers_match_jax():
    tables = np.arange(2 * 7, dtype=np.int32).reshape(2, 7)
    for t in (1, 3):
        for got, ref in zip(tps.split_state_tables(torch.from_numpy(tables),
                                                   t),
                            jps.split_state_tables(jnp.asarray(tables), t)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for fn_t, fn_j, src, dst in ((tps.copy_state_slot, jps.copy_state_slot,
                                  3, 5),
                                 (tps.copy_kv_page, jps.copy_kv_page, 2, 4)):
        jcache, tcache = _pools("int8", seed=3)
        jcache = fn_j(jcache, src, dst)
        assert fn_t(tcache, src, dst) is tcache
        for k in jcache:
            np.testing.assert_array_equal(_np(tcache[k]), _np(jcache[k]))


# ------------------------------------------------------ StateCache lockstep
def _drive_state_caches(slots, ring, seed):
    """The same random alloc/commit/snapshot/truncate/free/defrag sequence
    on both copies; every observable must match."""
    rng = np.random.default_rng(seed)
    j, t = (JaxStateCache(slots=slots, ring_depth=ring),
            StateCache(slots=slots, ring_depth=ring))
    assert t.pool_slots == j.pool_slots
    for _ in range(150):
        slot = int(rng.integers(slots))
        op = rng.choice(["alloc", "commit", "snapshot", "snapshot_empty",
                         "truncate", "free", "defrag"])
        grow = int(rng.integers(1, 4))
        res = []
        for c in (j, t):
            try:
                if op == "alloc":
                    res.append(c.alloc(slot))
                elif op == "commit":
                    res.append(c.commit(slot, c.length(slot) + grow))
                elif op in ("snapshot", "snapshot_empty"):
                    res.append(c.snapshot(slot, copy=op == "snapshot"))
                elif op == "truncate":
                    counts = c.snapshot_counts(slot) + (c.length(slot),)
                    res.append(c.truncate(slot, counts[0]))
                elif op == "free":
                    res.append(c.free_slot(slot))
                else:
                    res.append(c.defrag())
            except (ValueError, JaxOutOfStateSlots, OutOfStateSlots) as e:
                res.append((type(e).__name__, str(e)))
        assert res[0] == res[1], op
        assert t.pop_state_copies() == j.pop_state_copies()
        assert t.stats == j.stats
        for s in range(slots):
            assert (t.cur(s), t.read_id(s), t.length(s),
                    t.snapshot_counts(s)) == (j.cur(s), j.read_id(s),
                                              j.length(s),
                                              j.snapshot_counts(s))
        assert (t.free_slots, t.used_slots) == (j.free_slots, j.used_slots)


@pytest.mark.parametrize("slots,ring,seed", [(2, 1, 0), (3, 2, 1),
                                             (4, 1, 2)])
def test_state_cache_matches_jax_copy(slots, ring, seed):
    _drive_state_caches(slots, ring, seed)


def test_state_cache_reserved_ids():
    assert (NULL_STATE, TRASH_STATE) == (0, 1)
    c = StateCache(slots=4, ring_depth=1)
    assert c.pool_slots == 2 + 4 * 2      # the engine's pool at 4 slots


# ------------------------------------------------------------------ engines
def _trace(cls, n=3, max_new=6):
    return [cls(rid=i, prompt=HEAD + [50 + i] * 4, max_new_tokens=max_new)
            for i in range(n)]


def _drain(engine, cls, **kw):
    reqs = _trace(cls, **kw)
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """JAX smoke bundle (layers unrolled, as the port runs them) and its
    PRNGKey(0) params in fp32 and bf16, bridged to the port."""
    arch = request.param
    jbundle = jax_build_model(dataclasses.replace(
        jax_get_config(arch, smoke=True), scan_layers=False))
    base = jbundle.init_params(jax.random.PRNGKey(0))
    params = {}
    for dtype in ("float32", "bfloat16"):
        jp = jax.tree.map(lambda a: a.astype(dtype), base)
        params[dtype] = (jp, params_from_numpy({k: np.asarray(v)
                                                for k, v in jp.items()}))
    return arch, jbundle, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engines_match_jax_slot_engine(family, dtype):
    """The JAX identity matrix's trace on the port's PagedServeEngine (its
    StateCache, chunked prefill through the per-token recurrence) and its
    slot ServeEngine: greedy tokens equal to the JAX slot engine's.  In
    bf16 the JAX engine runs op by op (``jax.disable_jit``): jitted, XLA
    drops bf16 roundings inside its fusions, which moves bf16 logits by up
    to 0.07 on these models (test_torch_recurrent.py)."""
    arch, jbundle, params = family
    jp, tp = params[dtype]
    if dtype == "float32":
        golden = _drain(JaxServeEngine(jbundle, jp, PCTX, slots=2,
                                       max_seq=64), JaxRequest)
    else:
        with jax.disable_jit():
            golden = _drain(JaxServeEngine(jbundle, jp, PCTX, slots=2,
                                           max_seq=64), JaxRequest)
    bundle = build_model(get_config(arch, smoke=True), device="cpu")
    paged = PagedServeEngine(bundle, tp, device="cpu", **PAGED_KW)
    assert _drain(paged, Request) == golden, (arch, dtype, "paged")
    # drained leak-free: every state slot and page back in the pools
    assert paged.state.used_slots == 0 and paged.kv.used_pages == 0
    slot = ServeEngine(bundle, tp, device="cpu", slots=2, max_seq=64)
    assert _drain(slot, Request) == golden, (arch, dtype, "slot")


@pytest.mark.parametrize("state_dtype", ["int8"])
@pytest.mark.parametrize("family", RECURRENT, indirect=True)
def test_paged_engine_matches_jax_paged_engine(family, state_dtype):
    """fp32 params, int8 state pools: greedy tokens and the state pools'
    bytes equal to the JAX PagedServeEngine's (int8 state is lossy across
    steps, so it is held to the JAX int8 engine, not to the slot engine; the
    fp32 pools' shapes are held to JAX's in test_torch_recurrent.py)."""
    arch, jbundle, params = family
    jp, tp = params["float32"]
    jeng = JaxPagedEngine(jbundle, jp, PCTX, state_dtype=state_dtype,
                          **PAGED_KW)
    golden = _drain(jeng, JaxRequest)
    bundle = build_model(get_config(arch, smoke=True), device="cpu")
    eng = PagedServeEngine(bundle, tp, device="cpu", state_dtype=state_dtype,
                           **PAGED_KW)
    assert _drain(eng, Request) == golden
    assert eng.kv_pool_bytes() == jeng.kv_pool_bytes()


def test_preemption_and_defrag_keep_tokens(family):
    """A pool of 6 pages for 3 requests of 26-token spans on 2 slots forces
    preemption with recompute; a defrag of the page and state pools between
    ticks moves live state slots.  Tokens stay those of the roomy engine."""
    arch, _, params = family
    tp = params["float32"][1]
    bundle = build_model(get_config(arch, smoke=True), device="cpu")
    golden = _drain(PagedServeEngine(bundle, tp, device="cpu", **PAGED_KW),
                    Request)
    eng = PagedServeEngine(bundle, tp, device="cpu",
                           **dict(PAGED_KW, num_pages=6))
    reqs = _trace(Request)
    for r in reqs:
        eng.submit(r)
    moved = 0
    for _ in range(200):
        if eng.step() == 0 and not eng.sched.waiting:
            break
        moved += eng.defrag()
    assert [r.output for r in reqs] == golden
    assert eng.metrics.preemptions > 0 and moved > 0
    assert eng.state.used_slots == 0


def test_truncate_restores_the_checkpointed_state(family):
    """``_truncate_slot`` rolls a slot back to a ring checkpoint: the state
    slot's contents return to the snapshot's, copied on the device pools."""
    arch, _, params = family
    tp = params["float32"][1]
    bundle = build_model(get_config(arch, smoke=True), device="cpu")
    eng = PagedServeEngine(bundle, tp, device="cpu", **PAGED_KW)
    req = Request(rid=0, prompt=HEAD[:8], max_new_tokens=8)
    eng.submit(req)
    eng.step()                     # prefill chunk, then one decode tick
    slot = req.slot
    n0, cur = eng.state.length(slot), eng.state.cur(slot)
    saved = {k: v[:, cur].clone() for k, v in eng.cache.items()
             if k in tps.STATE_POOL_KEYS}
    eng.state.snapshot(slot)       # queued copy cur -> a ring id
    eng._sync_state_copies()
    eng.step()                     # one more token
    assert eng.state.length(slot) == n0 + 1
    assert any(not torch.equal(eng.cache[k][:, cur], v)
               for k, v in saved.items())
    eng._truncate_slot(slot, n0)
    for k, v in saved.items():
        assert torch.equal(eng.cache[k][:, eng.state.cur(slot)], v), k
    assert eng.state.length(slot) == n0 and eng.kv.length(slot) == n0


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_rejections(arch):
    bundle = build_model(get_config(arch, smoke=True), device="cpu")
    params = bundle.init_params()
    with pytest.raises(ValueError, match="prefix_sharing"):
        PagedServeEngine(bundle, params, device="cpu", prefix_sharing=True)
    with pytest.raises(ValueError, match="state_dtype"):
        PagedServeEngine(bundle, params, device="cpu",
                         state_dtype="bfloat16")


# ------------------------------------------------- bundle, bridge, configs
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_maps_params_name_for_name(arch):
    """The JAX params dict bridges to the port name for name, shape for
    shape and bit for bit, and its names and shapes are the port's own
    parameter specs: the bridge needs nothing family-specific."""
    jbundle = jax_build_model(jax_get_config(arch, smoke=True))
    jp = jbundle.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    specs = param_specs(get_config(arch, smoke=True))
    assert sorted(tp) == sorted(jp) == sorted(specs)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape == specs[k][0]
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].view(torch.int16).numpy(),
                                      np.asarray(v).view(np.int16))
    # the port's own init draws at the JAX scales: zeros where JAX has them
    own = build_model(get_config(arch, smoke=True), device="cpu").init_params()
    for k, v in jp.items():
        assert bool(own[k].any()) == bool(np.asarray(v).any()), k


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_capabilities(arch):
    """The JAX bundle's flags: state families (the hybrid among them) page
    through the StateCache and not through ``supports_paged_kv`` alone, and
    have no int8-weight path; the dense family pages KV, and has every
    whole-sequence entry point since the dense forward was ported."""
    bundle = build_model(get_config(arch, smoke=True), device="cpu")
    jbundle = jax_build_model(jax_get_config(arch, smoke=True))
    for flag in ("supports_paged_state", "supports_paged_serving",
                 "supports_paged_kv", "supports_int8_weights"):
        assert getattr(bundle, flag) == getattr(jbundle, flag), flag
    assert bundle.supports_paged_state and bundle.supports_paged_serving
    assert not bundle.supports_paged_kv
    assert not bundle.supports_int8_weights
    with pytest.raises(ValueError, match="int8-weight"):
        bundle.quantize_params(bundle.init_params())
    dense = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    assert dense.supports_paged_kv and not dense.supports_paged_state
    logits = dense.forward(dense.init_params(),
                           torch.ones((1, 2), dtype=torch.long))
    assert logits.shape == (1, 2, dense.cfg.padded_vocab)


@pytest.mark.parametrize("arch", ["whisper-large-v3"])
def test_unported_families_raise_by_name(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match=cfg.family):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_configs_reach_both_families(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke))
    from repro.configs import rwkv6_3b as jax_rwkv6_3b
    from repro.configs import zamba2_1p2b as jax_zamba2_1p2b
    from repro_torch.configs import rwkv6_3b, zamba2_1p2b
    for mod, jmod in ((rwkv6_3b, jax_rwkv6_3b),
                      (zamba2_1p2b, jax_zamba2_1p2b)):
        assert dataclasses.asdict(mod.CONFIG) == \
            dataclasses.asdict(jmod.CONFIG)
        assert dataclasses.asdict(mod.SMOKE_CONFIG) == \
            dataclasses.asdict(jmod.SMOKE_CONFIG)


def test_rwkv_head_padding_is_refused():
    """The JAX layer's tensor-parallel head padding is not ported; a config
    that asks for it is refused by name rather than run unpadded."""
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                              rwkv_pad_heads_to=16)
    with pytest.raises(NotImplementedError, match="rwkv_pad_heads_to"):
        build_model(cfg, device="cpu")
