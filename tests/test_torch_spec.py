"""Port parity, speculative decoding (``repro_torch.spec``): the verify plan
of the port's scheduler, ``NgramDraft`` proposals against the JAX class's,
the draft-pair checks, the port's ``SpeculativeServeEngine`` against the
JAX one in fp32 (greedy tokens and acceptance counts, n-gram and model
drafts) and against the port's plain paged engine in bf16 (jitted JAX in
bf16 is no golden, ROADMAP C.0), preemption, ``spec_k = 0``, int8 KV
rollback, and all-rejected rollback on the recurrent and hybrid families,
whose state pools stay bit-equal to the plain engine's tick by tick.  The
zamba2 tokens are held to the JAX slot engine (the JAX spec and paged
zamba2 cells are red, ROADMAP C.1)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_draft_config as jax_get_draft_config
from repro.models import build_model as jax_build_model
from repro.parallel import ParallelContext
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.spec import DraftProposer as JaxDraftProposer
from repro.spec import NgramDraft as JaxNgramDraft
from repro.spec import SpeculativeServeEngine as JaxSpecEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_draft_config
from repro_torch.models import build_draft_model, build_model, \
    check_draft_pair
from repro_torch.models.paged_state import STATE_POOL_KEYS
from repro_torch.serve import PagedKVCache, PagedServeEngine, Request
from repro_torch.serve.scheduler import DECODING, FifoScheduler
from repro_torch.spec import (DraftProposer, ModelDraft, NgramDraft,
                              SpeculativeServeEngine)

PCTX = ParallelContext(None)
ARCH = "llama3-8b"


def _trace(cls, n=3, prompt_len=8, max_new=10):
    """The JAX spec tests' trace: repetitive prompts, 3 requests."""
    return [cls(rid=i,
                prompt=[1 + i] + [2 + (j % 5) for j in range(prompt_len - 1)],
                max_new_tokens=max_new)
            for i in range(n)]


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _bridge(params, dtype):
    jp = jax.tree.map(lambda a: a.astype(dtype), params)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()})


@pytest.fixture(scope="module")
def dense():
    """The smoke llama3-8b (PRNGKey(0)) and its smoke draft (PRNGKey(1)),
    JAX bundles and params in fp32 and bf16, bridged to the port's CPU
    bundles."""
    jb = jax_build_model(jax_get_config(ARCH, smoke=True))
    jdb = jax_build_model(jax_get_draft_config(ARCH, smoke=True))
    base = jb.init_params(jax.random.PRNGKey(0))
    dbase = jdb.init_params(jax.random.PRNGKey(1))
    return dict(
        jbundle=jb, jdraft=jdb,
        bundle=build_model(get_config(ARCH, smoke=True), device="cpu"),
        draft=build_draft_model(get_config(ARCH, smoke=True),
                                get_draft_config(ARCH, smoke=True),
                                device="cpu"),
        params={d: _bridge(base, d) for d in ("float32", "bfloat16")},
        dparams={d: _bridge(dbase, d) for d in ("float32", "bfloat16")})


@pytest.fixture(scope="module")
def plain_bf16(dense):
    """The port's plain paged engine's bf16 tokens on the trace."""
    eng = PagedServeEngine(dense["bundle"], dense["params"]["bfloat16"][1],
                           device="cpu", slots=2)
    return _drain(eng, _trace(Request))


# ----------------------------------------------------------- verify plan
class TestVerifyPlan:
    """The port's ``FifoScheduler.verify_plan`` (a copy of the JAX one):
    the JAX spec tests' cases, each also equal to the JAX scheduler's."""

    def _decoding(self, n, max_new=32, output_len=1):
        reqs = _trace(Request, n, max_new=max_new)
        for i, r in enumerate(reqs):
            r.state = DECODING
            r.admit_seq = i
            r.output = list(range(output_len))
        return reqs

    def _plan(self, reqs, spec_k, **kw):
        from repro.serve.scheduler import FifoScheduler as JaxScheduler
        got = [(r.admit_seq, k) for r, k in FifoScheduler(
            prefill_chunk=4, **kw).verify_plan(reqs, spec_k=spec_k)]
        ref = [(r.admit_seq, k) for r, k in JaxScheduler(
            prefill_chunk=4, **kw).verify_plan(reqs, spec_k=spec_k)]
        assert got == ref
        return got

    def test_full_k_without_budget(self):
        assert self._plan(self._decoding(3), 4) == [(0, 4), (1, 4), (2, 4)]

    def test_k_capped_by_remaining_quota(self):
        reqs = self._decoding(1, max_new=8, output_len=6)  # 2 tokens left
        assert self._plan(reqs, 4) == [(0, 1)]

    def test_budget_rows_in_admission_order(self):
        plan = self._plan(self._decoding(3), 4, verify_budget=7)
        assert plan == [(0, 4), (1, 1)]

    def test_zero_k_degenerates_to_plain_rows(self):
        assert self._plan(self._decoding(2), 0) == [(0, 0), (1, 0)]


# ------------------------------------------------------------ NgramDraft
NGRAM_CASES = [  # (max_n, history, k, the JAX tests' expected or None)
    (4, [5, 6, 7], 3, [7, 7, 7]),
    (3, [1, 8, 9, 10, 11, 3, 8, 9], 2, [10, 11]),
    (2, [4, 4], 3, [4, 4, 4]),
    (3, [1, 2, 1, 2, 1], 4, [2, 1, 2, 1]),
    (4, [1, 2], 0, []),
    (4, [9], 2, [9, 9]),
    (4, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 9, 2], 5, None),
    (2, [7, 7, 8, 7, 7, 8, 7], 6, None),
]


@pytest.mark.parametrize("max_n,hist,k,want", NGRAM_CASES)
def test_ngram_proposals_equal_jax(max_n, hist, k, want):
    got = NgramDraft(max_n=max_n)._continue(list(hist), k)
    assert got == JaxNgramDraft(max_n=max_n)._continue(list(hist), k)
    if want is not None:
        assert got == want


def test_ngram_random_histories_equal_jax():
    """200 random histories over a 6-token alphabet, every max_n and k up
    to 5, through ``propose`` on both classes."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        hist = rng.integers(0, 6, size=int(rng.integers(1, 30))).tolist()
        max_n, k = int(rng.integers(1, 5)), int(rng.integers(0, 6))
        reqs = [(Request(rid=0, prompt=hist[:1], max_new_tokens=64),
                 JaxRequest(rid=0, prompt=hist[:1], max_new_tokens=64))]
        for tr, jr in reqs:
            tr.output = jr.output = hist[1:]
        got = NgramDraft(max_n).propose([(0, reqs[0][0], k)])
        ref = JaxNgramDraft(max_n).propose([(0, reqs[0][1], k)])
        assert got == ref


def test_ngram_rejects_zero_max_n():
    with pytest.raises(ValueError, match="max_n"):
        NgramDraft(max_n=0)


# ------------------------------------------------------------ draft pair
class TestDraftPair:
    def test_registered_pair_validates(self):
        tgt = get_config(ARCH, smoke=True)
        draft = get_draft_config(ARCH, smoke=True)
        assert draft is not None and draft.vocab_size == tgt.vocab_size
        check_draft_pair(tgt, draft)        # no raise
        full = get_draft_config(ARCH)
        assert (full.num_layers, full.d_model, full.num_kv_heads,
                full.resolved_head_dim, full.vocab_size) == \
            (4, 1024, 2, 64, 128256)
        check_draft_pair(get_config(ARCH), full)

    def test_vocab_mismatch_rejected(self):
        tgt = get_config(ARCH, smoke=True)
        bad = get_config("chatglm3-6b", smoke=False)  # different vocab
        with pytest.raises(ValueError, match="tokenizer"):
            check_draft_pair(tgt, bad)

    def test_unpaged_family_rejected(self):
        tgt = get_config(ARCH, smoke=True)
        for arch in ("rwkv6-3b", "zamba2-1.2b"):
            with pytest.raises(ValueError, match="paged"):
                check_draft_pair(tgt, get_config(arch, smoke=True))

    def test_unregistered_target_has_no_draft(self):
        assert get_draft_config("whisper-large-v3") is None

    def test_explicit_name_does_not_resolve_pairings(self):
        assert get_draft_config(ARCH, pairing=False) is None
        draft = get_draft_config("llama3-8b-draft", smoke=True, pairing=False)
        assert draft is not None and draft.num_layers == 1

    def test_build_draft_model(self):
        tgt = get_config(ARCH, smoke=True)
        draft = get_draft_config(ARCH, smoke=True)
        b = build_draft_model(tgt, draft, device="cpu")
        assert b.cfg == draft and b.device == torch.device("cpu")
        with pytest.raises(ValueError, match="tokenizer"):
            build_draft_model(tgt, get_config("chatglm3-6b"), device="cpu")


# --------------------------------------------------------- spec engines
def _spec_engines(dense, dtype, draft, **kw):
    """(port engine, JAX engine) of ``draft`` ("ngram" or "model") at
    ``dtype``; the JAX one is None outside fp32."""
    jp, tp = dense["params"][dtype]
    jdp, tdp = dense["dparams"][dtype]
    tkw = dict(kw)
    jkw = dict(kw)
    if draft == "model":
        tkw.update(draft_bundle=dense["draft"], draft_params=tdp)
        jkw.update(draft_bundle=dense["jdraft"], draft_params=jdp)
    eng = SpeculativeServeEngine(dense["bundle"], tp, device="cpu", **tkw)
    jeng = (JaxSpecEngine(dense["jbundle"], jp, PCTX, **jkw)
            if dtype == "float32" else None)
    return eng, jeng


def _counts(m):
    return (m.spec_steps, m.draft_proposed, m.draft_accepted,
            m.decode_tokens)


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_fp32_tokens_and_acceptance_equal_jax(dense, draft):
    """fp32 params and KV pages: greedy tokens, and the verify steps,
    proposals and accepted proposals, equal to the JAX spec engine's."""
    kw = dict(slots=2, spec_k=3, kv_dtype="float32")
    eng, jeng = _spec_engines(dense, "float32", draft, **kw)
    assert _drain(eng, _trace(Request)) == _drain(jeng, _trace(JaxRequest))
    assert _counts(eng.metrics) == _counts(jeng.metrics)
    assert eng.metrics.spec_steps > 0 and eng.metrics.draft_proposed > 0
    assert isinstance(eng.draft, ModelDraft if draft == "model"
                      else NgramDraft)
    if draft == "model":
        # the draft cache stayed in lockstep and was released on finish
        assert all(eng.draft.kv.length(s) == 0 for s in range(2))


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_bf16_tokens_equal_plain_engine(dense, plain_bf16, draft):
    eng, _ = _spec_engines(dense, "bfloat16", draft, slots=2, spec_k=2)
    assert _drain(eng, _trace(Request)) == plain_bf16


def test_ngram_spec_metrics_accounting(dense):
    eng, _ = _spec_engines(dense, "bfloat16", "ngram", slots=2, spec_k=3)
    reqs = _trace(Request)
    _drain(eng, reqs)
    m = eng.metrics
    assert m.spec_steps > 0
    assert 0 <= m.draft_accepted <= m.draft_proposed
    assert 0.0 <= m.acceptance_rate <= 1.0
    # every verify step emits at least the target's own token
    assert m.decode_tokens >= m.spec_steps
    assert m.decode_calls > 0 and m.decode_calls <= m.spec_steps
    assert {"spec_steps", "draft_proposed", "draft_accepted", "draft_time_s",
            "acceptance_rate", "tokens_per_step",
            "spec_decode_tps"} <= m.summary().keys()
    assert sum(r.spec_steps for r in reqs) == m.spec_steps
    assert sum(r.draft_proposed for r in reqs) == m.draft_proposed
    assert sum(r.draft_accepted for r in reqs) == m.draft_accepted
    assert all(0.0 <= r.acceptance_rate <= 1.0 for r in reqs)
    # the plain engine reports no speculative fields
    plain = PagedServeEngine(dense["bundle"], dense["params"]["bfloat16"][1],
                             device="cpu", slots=2)
    _drain(plain, _trace(Request, n=1, max_new=2))
    assert "spec_steps" not in plain.metrics.summary()


def test_identical_under_preemption(dense, plain_bf16):
    """A pool too small for 3 concurrent requests forces preemption and
    recompute mid-speculation; tokens stay the plain engine's."""
    eng, _ = _spec_engines(dense, "bfloat16", "model", slots=2, spec_k=3,
                           page_size=4, num_pages=8)
    assert _drain(eng, _trace(Request)) == plain_bf16
    assert eng.metrics.preemptions > 0


def test_spec_k_zero_matches_plain(dense, plain_bf16):
    eng, _ = _spec_engines(dense, "bfloat16", "ngram", slots=2, spec_k=0)
    assert _drain(eng, _trace(Request)) == plain_bf16
    assert eng.metrics.draft_proposed == 0
    assert eng.metrics.tokens_per_step == 1.0


def test_engine_arguments_are_checked(dense):
    tp = dense["params"]["bfloat16"][1]
    with pytest.raises(ValueError, match="not both"):
        SpeculativeServeEngine(dense["bundle"], tp, device="cpu", slots=2,
                               draft=NgramDraft(),
                               draft_bundle=dense["draft"], draft_params=tp)
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeServeEngine(dense["bundle"], tp, device="cpu", spec_k=-1)
    with pytest.raises(ValueError, match="paged KV"):
        ModelDraft(build_model(get_config("rwkv6-3b", smoke=True),
                               device="cpu"), None, slots=2)


def test_int8_kv_tokens_equal_plain(dense):
    """int8 KV pages: the spec engine's tokens equal the plain int8
    engine's (rollback leaves stale payload and scale slots that are
    masked by length and rewritten in lockstep)."""
    tp = dense["params"]["bfloat16"][1]
    plain = PagedServeEngine(dense["bundle"], tp, device="cpu", slots=2,
                             kv_dtype="int8")
    ref = _drain(plain, _trace(Request))
    eng, _ = _spec_engines(dense, "bfloat16", "ngram", slots=2, spec_k=3,
                           kv_dtype="int8")
    assert _drain(eng, _trace(Request)) == ref


def test_int8_scale_slots_consistent_after_rollback(dense):
    """Write a committed prefix, write rejected candidates over the next
    positions (across a page boundary), truncate, then write the accepted
    continuation: the logits are bit-identical to a run that never wrote
    the rejected tokens, so every (page slot, head) scale stays paired with
    its payload across the rewrite."""
    bundle, tp = dense["bundle"], dense["params"]["bfloat16"][1]
    page_size, chunk = 4, 4

    def prefill(kv, cache, toks, pos):
        kv.allocate(0, pos + len(toks))
        padded = list(toks) + [0] * (chunk - len(toks))
        logits = bundle.decode_paged(
            tp, cache, torch.tensor([padded], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32),
            torch.tensor([len(toks)], dtype=torch.int32),
            torch.from_numpy(kv.block_tables[0:1].copy()))
        kv.commit(0, pos + len(toks))
        return logits[0, :len(toks)].clone()

    def run(with_rejected):
        kv = PagedKVCache(slots=1, num_pages=8, page_size=page_size)
        cache = bundle.init_paged_cache(kv.pool_pages, page_size,
                                        kv_dtype="int8")
        prefill(kv, cache, [5, 6, 7, 8], 0)             # committed prefix
        if with_rejected:
            prefill(kv, cache, [9, 10, 11], 4)
            kv.truncate(0, 4)
        return prefill(kv, cache, [12, 13], 4)          # accepted path

    assert torch.equal(run(with_rejected=True), run(with_rejected=False))


# ------------------------------ recurrent-state rollback (state cache)
class _WrongDraft(DraftProposer):
    """Always proposes one constant token that the plain engine never
    emits on the trace, so every verify tick rejects at position 0 and
    rolls the slot back: KV pages truncated and the paired state
    checkpoint restored."""

    def __init__(self, token: int):
        self.token = token

    def propose(self, plan):
        return {slot: [self.token] * k for slot, _req, k in plan}


class _JaxWrongDraft(JaxDraftProposer):
    def __init__(self, token: int):
        self.token = token

    def propose(self, plan):
        return {slot: [self.token] * k for slot, _req, k in plan}


STATE_KW = dict(slots=2, page_size=8, num_pages=16)
#: the recurrent families' trace: 3 requests, 6 new tokens each
STATE_NEW = 6


@pytest.fixture(scope="module", params=["rwkv6-3b", "mamba2-2.7b",
                                        "zamba2-1.2b"])
def state_family(request):
    arch = request.param
    jb = jax_build_model(dataclasses.replace(
        jax_get_config(arch, smoke=True), scan_layers=False))
    jp, tp = _bridge(jb.init_params(jax.random.PRNGKey(0)), "float32")
    return arch, jb, jp, tp, build_model(get_config(arch, smoke=True),
                                         device="cpu")


def _live_states(eng):
    """Each active slot's current state, every state leaf."""
    return {r.rid: {k: eng.cache[k][:, eng.state.cur(r.slot)].clone()
                    for k in eng.cache if k in STATE_POOL_KEYS}
            for r in eng.active if r is not None}


def test_all_rejected_rollback_keeps_state_pools(state_family):
    """Every proposal rejected: each verify step emits one token, as a
    plain decode tick does, so the spec and plain engines run in lockstep,
    and after every tick each live slot's state (every leaf) is bit-equal
    to the plain engine's.  Tokens equal the JAX spec engine's under the
    same adversarial draft (rwkv6, mamba2) or the JAX slot engine's
    (zamba2, whose JAX spec cell is red)."""
    arch, jb, jp, tp, bundle = state_family
    emitted = set(sum(_drain(PagedServeEngine(bundle, tp, device="cpu",
                                              **STATE_KW),
                             _trace(Request, max_new=STATE_NEW)), []))
    token = min(set(range(3, 3 + len(emitted) + 1)) - emitted)
    plain = PagedServeEngine(bundle, tp, device="cpu", **STATE_KW)
    eng = SpeculativeServeEngine(bundle, tp, device="cpu", spec_k=3,
                                 draft=_WrongDraft(token), **STATE_KW)
    assert eng.state.ring_depth == 4 and plain.state.ring_depth == 1
    reqs = {name: _trace(Request, max_new=STATE_NEW)
            for name in ("plain", "spec")}
    for name, e in (("plain", plain), ("spec", eng)):
        for r in reqs[name]:
            e.submit(r)
    checked = 0
    for _ in range(200):
        n = plain.step()
        eng.step()
        got, ref = _live_states(eng), _live_states(plain)
        assert got.keys() == ref.keys()
        for rid in ref:
            for k in ref[rid]:
                assert torch.equal(got[rid][k], ref[rid][k]), (arch, rid, k)
                checked += 1
        if n == 0 and not plain.sched.waiting:
            break
    outs = [r.output for r in reqs["spec"]]
    assert outs == [r.output for r in reqs["plain"]]
    assert checked > 0
    assert eng.metrics.draft_accepted == 0
    assert eng.state.stats["restores"] >= eng.metrics.spec_steps - 3
    assert eng.state.stats["restores"] > 0
    assert eng.state.used_slots == 0 and eng.kv.used_pages == 0
    if arch == "zamba2-1.2b":
        golden = _drain(JaxServeEngine(jb, jp, PCTX, slots=2, max_seq=64),
                        _trace(JaxRequest, max_new=STATE_NEW))
    else:
        golden = _drain(JaxSpecEngine(jb, jp, PCTX, spec_k=3,
                                      draft=_JaxWrongDraft(token),
                                      **STATE_KW),
                        _trace(JaxRequest, max_new=STATE_NEW))
    assert outs == golden


def test_mixed_acceptance_rollback_keeps_tokens(state_family):
    """Mixed acceptance (the n-gram draft on the repetitive trace): slots
    land mid-ring, and on zamba2 one ``_truncate_slot`` rolls back KV pages
    and state together; tokens equal the plain engine's, and both pools
    drain leak-free."""
    arch, _, _, tp, bundle = state_family
    ref = _drain(PagedServeEngine(bundle, tp, device="cpu", **STATE_KW),
                 _trace(Request, max_new=STATE_NEW))
    eng = SpeculativeServeEngine(bundle, tp, device="cpu", spec_k=3,
                                 **STATE_KW)
    assert _drain(eng, _trace(Request, max_new=STATE_NEW)) == ref
    assert eng.state.stats["restores"] > 0
    assert eng.state.used_slots == 0 and eng.kv.used_pages == 0


def test_table_width_matches_the_tables(state_family, dense):
    """The combined block table a forward over T positions gets is the KV
    page columns, plus one read and T write columns on a state engine (the
    verify step's T = spec_k + 1), with the page table and the read ids
    in place."""
    arch, _, _, tp, bundle = state_family
    for b, prm, t in ((bundle, tp, 4),
                      (dense["bundle"], dense["params"]["bfloat16"][1], 4)):
        eng = SpeculativeServeEngine(b, prm, device="cpu", spec_k=t - 1,
                                     **STATE_KW)
        writes = np.full((eng.slots, t), 7, np.int32)
        pages = eng.kv.max_pages_per_slot
        for width_t in (1, t):
            got = eng._tables(range(eng.slots), writes[:, :width_t])
            assert got.shape == (eng.slots, pages + (
                1 + width_t if b.supports_paged_state else 0))
            np.testing.assert_array_equal(got[:, :pages],
                                          eng.kv.block_tables)
            if b.supports_paged_state:
                np.testing.assert_array_equal(
                    got[:, pages], [eng.state.read_id(s)
                                    for s in range(eng.slots)])
                assert (got[:, pages + 1:] == 7).all()
