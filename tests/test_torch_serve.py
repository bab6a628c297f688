"""Port parity, serving: the port's ``PagedServeEngine`` against the JAX
``PagedServeEngine`` (greedy tokens identical in fp32), prefix sharing on
vs off, the copied host-side allocator and scheduler driven in lockstep
with the JAX copies, the async front end, and the launcher on the CPU."""
import asyncio
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.parallel import ParallelContext
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve.paged_cache import OutOfPages as JaxOutOfPages
from repro.serve.paged_cache import PagedKVCache as JaxPagedKVCache
from repro.serve.scheduler import FifoScheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import (AsyncServeFrontend, OutOfPages, PagedKVCache,
                               PagedServeEngine, Request)
from repro_torch.serve.scheduler import FifoScheduler

ARCH = "llama3-8b"


@pytest.fixture(scope="module")
def fp32_params():
    """JAX smoke params at PRNGKey(0), cast to fp32, in both frameworks."""
    cfg = jax_get_config(ARCH, smoke=True)
    bundle = jax_build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          bundle.init_params(jax.random.PRNGKey(0)))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    return bundle, params, tparams


def _prompts(n, lens, seed=0, head=()):
    rng = np.random.default_rng(seed)
    return [list(head) + rng.integers(1, 256, size=l).tolist() for l in lens]


def _torch_engine(tparams, **kw):
    bundle = build_model(get_config(ARCH, smoke=True), device="cpu")
    return PagedServeEngine(bundle, tparams, device="cpu", **kw)


def _serve(engine, prompts, request_cls, max_new=6):
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def test_engine_tokens_match_jax_engine_fp32(fp32_params):
    """3 ragged requests on 2 slots (the third is admitted mid-flight),
    page size 8, prefill chunks of 8: greedy tokens identical."""
    jbundle, jparams, tparams = fp32_params
    prompts = _prompts(3, [5, 12, 9])
    kw = dict(slots=2, page_size=8, prefill_chunk=8, kv_dtype="float32")
    ref = _serve(JaxEngine(jbundle, jparams, ParallelContext(None), **kw),
                 prompts, JaxRequest)
    eng = _torch_engine(tparams, **kw)
    got = _serve(eng, prompts, Request)
    assert got == ref
    m = eng.metrics
    assert m.requests_done == 3 and m.decode_tokens == 3 * 5
    assert m.prefill_tokens == sum(len(p) for p in prompts)
    assert m.decode_calls >= 5 and m.prefill_calls >= 4


def test_prefix_sharing_keeps_tokens(fp32_params):
    """Shared 16-token head, 2 slots, 4 requests: later admissions attach
    the published pages (and COW-split the partial one); tokens equal the
    sharing-off engine's, and tokens and the effective-KV multiplier equal
    the JAX engine's with sharing on."""
    jbundle, jparams, tparams = fp32_params
    prompts = _prompts(4, [3, 6, 5, 9], seed=1, head=range(2, 18))
    kw = dict(slots=2, page_size=8, prefill_chunk=8, kv_dtype="float32")
    off = _serve(_torch_engine(tparams, **kw), prompts, Request)
    eng = _torch_engine(tparams, prefix_sharing=True, **kw)
    on = _serve(eng, prompts, Request)
    assert on == off
    m = eng.metrics
    assert m.prefix_hit_requests > 0 and m.effective_kv_multiplier > 1.0
    jeng = JaxEngine(jbundle, jparams, ParallelContext(None),
                     prefix_sharing=True, **kw)
    assert _serve(jeng, prompts, JaxRequest) == on
    jm = jeng.metrics
    assert (m.prefix_hit_tokens, m.cow_copies, m.prompt_pages_logical,
            m.prompt_pages_unique) == (jm.prefix_hit_tokens, jm.cow_copies,
                                       jm.prompt_pages_logical,
                                       jm.prompt_pages_unique)


def test_defrag_keeps_pools_consistent(fp32_params):
    """Defrag mid-run moves pages on the device pools with the tables:
    the tokens stay those of an undisturbed run."""
    _, _, tparams = fp32_params
    prompts = _prompts(3, [10, 4, 7], seed=2)
    kw = dict(slots=2, page_size=4, prefill_chunk=4, kv_dtype="float32")
    ref = _serve(_torch_engine(tparams, **kw), prompts, Request)
    eng = _torch_engine(tparams, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    moved = 0
    for _ in range(200):
        if eng.step() == 0 and not eng.sched.waiting:
            break
        moved += eng.defrag()
    assert moved > 0
    assert [r.output for r in reqs] == ref


def test_async_frontend_streams_engine_tokens(fp32_params):
    _, _, tparams = fp32_params
    prompts = _prompts(3, [4, 7, 5], seed=3)
    kw = dict(slots=2, page_size=8, prefill_chunk=8, kv_dtype="float32")
    ref = _serve(_torch_engine(tparams, **kw), prompts, Request, max_new=4)
    eng = _torch_engine(tparams, **kw)

    async def go():
        async with AsyncServeFrontend(eng) as front:
            streams = [await front.submit(p, max_new_tokens=4)
                       for p in prompts]
            return await asyncio.gather(*(s.drain() for s in streams))

    assert asyncio.run(go()) == ref


def test_launcher_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--device", "cpu", "--requests", "3",
                           "--prompt-len", "24", "--page-size", "8",
                           "--prefill-chunk", "8", "--max-new", "4",
                           "--slots", "2", "--prefix-sharing"])
    text = out.getvalue()
    assert "served 3/3 requests on cpu" in text
    assert "prefix cache: hits=" in text


# ------------------------------------------- host-side copies in lockstep
def _drive_allocators(seed, sharing):
    """The same random admit/allocate/commit/register/truncate/free/defrag
    sequence on both allocators; every observable must match."""
    rng = np.random.default_rng(seed)
    kw = dict(slots=3, num_pages=10, page_size=4, max_pages_per_slot=5,
              enable_sharing=sharing)
    j, t = JaxPagedKVCache(**kw), PagedKVCache(**kw)
    toks = [[], [], []]
    for _ in range(120):
        slot = int(rng.integers(3))
        op = rng.choice(["grow", "grow", "truncate", "free", "defrag"])
        if op == "grow":
            if not toks[slot] and sharing:
                toks[slot] = rng.integers(0, 3, size=9).tolist()
                assert t.match_prefix(slot, toks[slot]) == \
                    j.match_prefix(slot, toks[slot])
            n = t.length(slot) + int(rng.integers(1, 6))
            res = []
            for a in (j, t):
                try:
                    res.append(a.allocate(slot, n))
                except (JaxOutOfPages, OutOfPages) as e:
                    res.append(type(e).__name__)
            assert res[0] == res[1]
            if isinstance(res[0], list):
                for a in (j, t):
                    a.commit(slot, n)
                    a.register_prefix(slot, toks[slot] + [7] * n)
        elif op == "truncate":
            n = int(rng.integers(0, t.length(slot) + 1))
            assert t.truncate(slot, n) == j.truncate(slot, n)
        elif op == "free":
            assert t.free_slot(slot) == j.free_slot(slot)
            toks[slot] = []
        else:
            assert t.defrag() == j.defrag()
        assert t.pop_page_copies() == j.pop_page_copies()
        np.testing.assert_array_equal(t.block_tables, j.block_tables)
        assert t.stats == j.stats
        assert [t.length(s) for s in range(3)] == \
            [j.length(s) for s in range(3)]
        assert t.available_pages == j.available_pages


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sharing", [False, True])
def test_paged_cache_matches_jax_copy(seed, sharing):
    _drive_allocators(seed, sharing)


def test_scheduler_matches_jax_copy():
    j, t = JaxScheduler(prefill_chunk=4, prefill_budget=6), \
        FifoScheduler(prefill_chunk=4, prefill_budget=6)
    reqs = {}
    for cls, s in ((JaxRequest, j), (Request, t)):
        rs = [cls(rid=i, prompt=[1] * (3 + 2 * i), slo="ttft" if i % 2
                  else "throughput") for i in range(6)]
        for r in rs:
            s.submit(r)
        reqs[cls] = rs
    for step in range(4):
        pj = j.admit([step, 9])
        pt = t.admit([step, 9])
        assert [(s, r.rid) for s, r in pj] == [(s, r.rid) for s, r in pt]
        plan_j = j.prefill_plan([r for _, r in pj])
        plan_t = t.prefill_plan([r for _, r in pt])
        assert [(r.rid, n) for r, n in plan_j] == \
            [(r.rid, n) for r, n in plan_t]
    assert [r.skips for r in reqs[JaxRequest]] == \
        [r.skips for r in reqs[Request]]
