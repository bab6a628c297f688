"""Speculative decoding on the port's paged serving engine.

Port of the JAX package's ``repro.spec.engine``.
:class:`SpeculativeServeEngine` replaces the one-token decode tick of
:class:`~repro_torch.serve.engine.PagedServeEngine` with a draft-and-verify
step: a draft proposes ``k`` tokens, the target scores all ``k + 1``
positions (pending token + proposals) in ONE batched ``decode_paged``
forward, and greedy verification accepts the longest proposal prefix that
matches the target's own argmaxes, plus one token from the target itself.
Every rejected token costs a host-side rollback: ``PagedKVCache.truncate``
drops the KV page suffix, and on the recurrent-state families (rwkv6,
mamba2, zamba2) the ``StateCache`` checkpoint the verify forward wrote is
restored in the same ``_truncate_slot`` call.

Targets are the paged families: the attention ones (dense, moe, vlm) and
the recurrent-state ones.  On an MoE target a verify step routes its
``slots x (spec_k + 1)`` rows together, so its tokens equal the plain
engine's where the routing drops nothing (a capacity factor of ``E / k``);
at the published factor a token's routing depends on the rows beside it,
as in the JAX package.

Token identity with the plain engine: row ``i`` of the verify logits is
computed from the state the plain engine would have after emitting the
first ``i`` tokens, and emission stops at the first position where the
proposal disagrees with the target's argmax.  On the card this holds bit
for bit because a row's bits do not depend on the batch: the verify step
runs ``apr_matmul`` at M = slots x (spec_k + 1) at the split counts of the
decode tick (they follow K and N alone), and its attention is one
``flash_decode_paged`` launch over slots x (spec_k + 1) rows at the decode
tick's split count (it follows Hkv and the table width alone), each row at
the length its decode tick would give it (``layers.paged_attention_folded``).
A tuned configuration cache keys ``apr_matmul`` by M, so a tuned engine can
break this; the identity holds untuned.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..bench.specs import spec_verify_shapes
from ..models.registry import ModelBundle, check_draft_pair
from ..serve.engine import PagedServeEngine
from ..serve.scheduler import DECODING, DONE, Request
from ..serve.state_cache import TRASH_STATE
from .draft import DraftProposer, ModelDraft, NgramDraft


class SpeculativeServeEngine(PagedServeEngine):
    """Draft-and-verify continuous batching over the paged KV cache.

    ``draft`` is any :class:`~repro_torch.spec.draft.DraftProposer`; with
    neither ``draft`` nor ``draft_bundle`` an :class:`NgramDraft` is used;
    ``draft_bundle`` / ``draft_params`` build a :class:`ModelDraft` (the
    pair checked by ``check_draft_pair``, the draft on the engine's
    device).  ``spec_k`` is the per-slot proposal budget (``spec_k=0``
    degenerates to the plain engine, one verify row per slot);
    ``verify_budget`` caps the verify rows one tick may spend across slots
    (:meth:`~repro_torch.serve.scheduler.FifoScheduler.verify_plan`).  The
    other keywords are :class:`PagedServeEngine`'s.
    """

    def __init__(self, bundle: ModelBundle, params, *, spec_k: int = 4,
                 draft: Optional[DraftProposer] = None,
                 draft_bundle: Optional[ModelBundle] = None,
                 draft_params=None, verify_budget: Optional[int] = None,
                 **kwargs):
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if draft is not None and draft_bundle is not None:
            raise ValueError("pass either draft= or draft_bundle=, not both")
        if kwargs.get("use_graph"):
            raise NotImplementedError(
                "use_graph=True is not ported to the speculative engine: its "
                "verify step (T = spec_k + 1) has no graph-compiled form; "
                "serve it with use_graph=False")
        self.spec_k = spec_k  # set before super().__init__ sizes the ring
        super().__init__(bundle, params, **kwargs)
        self.sched.verify_budget = verify_budget
        if draft_bundle is not None:
            check_draft_pair(bundle.cfg, draft_bundle.cfg)
            if draft_bundle.device != self.device:
                raise ValueError(f"draft device {draft_bundle.device} differs "
                                 f"from the engine's {self.device}")
            draft = ModelDraft(draft_bundle, draft_params, slots=self.slots,
                               page_size=self.page_size,
                               num_pages=self.kv.num_pages,
                               max_pages_per_slot=self.kv.max_pages_per_slot,
                               chunk=self.prefill_chunk,
                               kv_dtype=self.kv_dtype)
        self.draft: DraftProposer = (draft if draft is not None
                                     else NgramDraft())

    def _decode_kernel_shapes(self):
        """Plain decode shapes plus the widened verify-batch GEMM (the
        verify attention reuses the paged family's shape)."""
        return (super()._decode_kernel_shapes()
                + spec_verify_shapes(self.bundle.cfg, self.slots, self.spec_k))

    # -- draft lifecycle hooks -------------------------------------------
    def _on_admit(self, slot: int, req: Request) -> None:
        self.draft.admit(slot, req)

    def _preempt(self, req: Request) -> None:
        slot = req.slot
        super()._preempt(req)
        self.draft.release(slot)

    def _finish(self, req: Request) -> None:
        slot = req.slot
        super()._finish(req)
        self.draft.release(slot)

    # -- the speculative tick --------------------------------------------
    def _decode_tick(self) -> None:
        decoding = [r for r in self._active_requests() if r.state == DECODING]
        if not decoding:
            return
        plan = self.sched.verify_plan(decoding, self.spec_k)
        # reserve pages for the worst case (k proposals + the pending token
        # all written) before drafting; reservation may preempt a younger
        # sibling that is itself in the plan, so re-check liveness after
        alive: List[Tuple[Request, int]] = []
        for req, k in plan:
            if self.active[req.slot] is not req or req.state != DECODING:
                continue
            if self._ensure_pages(req, self.kv.length(req.slot) + k + 1):
                alive.append((req, k))
        alive = [(r, k) for r, k in alive
                 if self.active[r.slot] is r and r.state == DECODING]
        self._sync_page_copies()   # reservation may have COW-split a shared
                                   # boundary page (prefix sharing)
        if not alive:
            return

        self._sync()
        t0 = time.perf_counter()
        proposals = self.draft.propose([(r.slot, r, k) for r, k in alive])
        self._sync()
        self.metrics.draft_time_s += time.perf_counter() - t0

        t_verify = self.spec_k + 1
        tokens = np.zeros((self.slots, t_verify), np.int32)
        counts = np.zeros((self.slots,), np.int32)
        props = {}
        lengths = np.array([self.kv.length(s) for s in range(self.slots)],
                           np.int32)
        write_ids = None
        if self.state is not None:
            # recurrent state cannot drop a suffix: every verify position
            # writes its post-token state into a fresh ring checkpoint, so
            # the rollback below restores the checkpoint at the accepted
            # count instead of truncating
            write_ids = np.full((self.slots, t_verify), TRASH_STATE,
                                np.int32)
        for req, k in alive:
            p = [int(t) for t in proposals.get(req.slot, [])[:k]]
            props[req.slot] = p
            tokens[req.slot, 0] = self.last_tokens[req.slot]
            tokens[req.slot, 1:1 + len(p)] = p
            counts[req.slot] = 1 + len(p)
            if self.state is not None:
                for t in range(1 + len(p)):
                    write_ids[req.slot, t] = self.state.snapshot(
                        req.slot, int(lengths[req.slot]) + t + 1, copy=False)
        self._sync()
        t0 = time.perf_counter()
        logits = self._forward(tokens, lengths, counts,
                               self._tables(range(self.slots), write_ids))
        self._sync()
        self.metrics.decode_time_s += time.perf_counter() - t0
        self.metrics.decode_calls += 1
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()     # (slots, T)

        for req, _k in alive:
            slot = req.slot
            p = props[slot]
            # greedy[slot, i] is what plain decode would emit at position i;
            # accept proposals while they agree, then emit the target's own
            # token (correction on mismatch, bonus after full acceptance)
            emitted: List[int] = []
            accepted = 0
            for i, d in enumerate(p):
                g = int(greedy[slot, i])
                emitted.append(g)
                if g != d:
                    break
                accepted += 1
            else:
                emitted.append(int(greedy[slot, len(p)]))
            n_emitted = 0
            for tok in emitted:
                req.output.append(tok)
                self.last_tokens[slot] = tok
                self.metrics.decode_tokens += 1
                n_emitted += 1
                self._maybe_finish(req, tok)
                if req.state == DONE:
                    break     # later candidates are past eos/max_new
            # acceptance is credited only for tokens actually emitted, so
            # acceptance_rate and tokens_per_step agree
            accepted = min(accepted, n_emitted)
            self.metrics.spec_steps += 1
            req.spec_steps += 1
            self.metrics.draft_proposed += len(p)
            req.draft_proposed += len(p)
            self.metrics.draft_accepted += accepted
            req.draft_accepted += accepted
            if req.state == DONE:
                continue      # _finish freed the pages and the draft slot
            # the cache holds KV for the pending token + every written
            # proposal; only pending + accepted proposals are real.  The
            # last emitted token was never fed: it is the new pending one.
            # On state engines the same call restores the checkpoint.
            self._truncate_slot(slot, int(lengths[slot]) + 1 + accepted)
            self.draft.observe(slot, req, int(lengths[slot]) + 1 + accepted)
