"""Draft proposers for speculative decoding, in PyTorch.

Port of the JAX package's ``repro.spec.draft``.  A proposer's job each
speculative tick: given the committed token history of every DECODING
request, propose up to ``k`` continuation tokens per slot for the target
model to verify in one batched forward.

* :class:`NgramDraft` -- self-drafting (no second model): propose the
  continuation of the longest recent n-gram match in the request's own
  history.  Pure host code, the same as the JAX class.
* :class:`ModelDraft` -- a small paired model (``configs.DRAFT_FOR``,
  validated by ``models.registry.check_draft_pair``) with its own paged KV
  cache kept in lockstep with the target's: catch-up tokens are prefilled
  in chunks, proposals come from batched T = 1 ``decode_paged`` steps, and
  rejected proposals are rolled back with ``PagedKVCache.truncate``.  On
  the card its forwards run the same kernels as the target's (``apr_matmul``
  and ``flash_decode_paged``) at the draft's shapes.

The engine talks to proposers through four hooks (``admit`` / ``propose`` /
``observe`` / ``release``); acceptance bookkeeping lives on the engine and
the :class:`~repro_torch.serve.scheduler.Request`, not here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.registry import ModelBundle
from ..serve.paged_cache import OutOfPages, PagedKVCache
from ..serve.scheduler import Request

#: one verify plan entry: (slot, request, k proposals wanted)
PlanEntry = Tuple[int, Request, int]


class DraftProposer:
    """Base proposer: lifecycle hooks are no-ops, ``propose`` is abstract.

    ``propose`` returns ``{slot: [tokens...]}``; a slot may receive *fewer*
    than ``k`` proposals (down to zero -- the engine then verifies just the
    pending token, which is exactly a plain decode step), so a proposer can
    always degrade instead of failing.
    """

    def admit(self, slot: int, req: Request) -> None:
        """A request was placed in ``slot`` (fresh or after preemption)."""

    def release(self, slot: int) -> None:
        """``slot``'s request finished or was preempted; drop its state."""

    def observe(self, slot: int, req: Request, new_len: int) -> None:
        """Post-verify: the target cache was truncated to ``new_len`` KV
        entries; bring any draft-side state back in sync."""

    def propose(self, plan: Sequence[PlanEntry]) -> Dict[int, List[int]]:
        raise NotImplementedError


class NgramDraft(DraftProposer):
    """Self-drafting n-gram proposer.

    For each request, find the longest ``n <= max_n`` suffix of its history
    (prompt + generated tokens, last token = the pending one) that occurred
    earlier in the same history, and propose the tokens that followed that
    earlier occurrence; with no match the last token is repeated.
    """

    def __init__(self, max_n: int = 4):
        if max_n < 1:
            raise ValueError("max_n must be >= 1")
        self.max_n = max_n

    def propose(self, plan: Sequence[PlanEntry]) -> Dict[int, List[int]]:
        return {slot: self._continue(req.prompt + req.output, k)
                for slot, req, k in plan}

    def _continue(self, hist: List[int], k: int) -> List[int]:
        if k <= 0 or not hist:
            return []
        for n in range(min(self.max_n, len(hist) - 1), 0, -1):
            pattern = hist[-n:]
            # newest earlier occurrence of the suffix (rightmost match whose
            # continuation is still inside the history)
            for j in range(len(hist) - n - 1, -1, -1):
                if hist[j:j + n] == pattern:
                    # copy forward from the match; past the end of the
                    # history the copy runs over the proposals themselves,
                    # so a period-p cycle extends as the cycle
                    virtual = list(hist)
                    out: List[int] = []
                    for i in range(k):
                        out.append(virtual[j + n + i])
                        virtual.append(out[-1])
                    return out
        return [hist[-1]] * k


class ModelDraft(DraftProposer):
    """Small paired draft model with its own paged KV cache, on the draft
    bundle's device.

    The draft cache mirrors the target's committed state (``C - 1`` entries
    when the request has ``C`` committed tokens, the pending token not yet
    written -- the same off-by-one the target keeps).  Each tick:

    1. *Catch-up*: chunked prefill of committed tokens the draft has not
       seen (one token after a fully accepted step, the whole prompt after
       admit or preemption recompute), batched across slots.
    2. *Generate*: ``k`` batched T = 1 ``decode_paged`` steps -- feed the
       pending token, then each of its own proposals, collecting argmaxes.
    3. *Rollback* (``observe``): truncate the draft cache to the verified
       length, as the engine truncates the target cache.

    On ``OutOfPages`` the slot's draft state is dropped and no proposals are
    returned for it this tick (the engine degrades to plain decode there).
    """

    def __init__(self, bundle: ModelBundle, params, *, slots: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 chunk: int = 16, kv_dtype: str = "bfloat16"):
        if not bundle.supports_paged_kv:
            raise ValueError(
                f"{bundle.cfg.family!r} draft family has no paged KV cache")
        self.bundle = bundle
        self.params = params
        self.device = bundle.device
        self.slots = slots
        self.page_size = page_size
        self.chunk = chunk
        if num_pages is None:
            num_pages = slots * max(256 // page_size, 1)
        if max_pages_per_slot is None:
            max_pages_per_slot = min(num_pages, max(256 // page_size, 1))
        self.kv = PagedKVCache(slots=slots, num_pages=num_pages,
                               page_size=page_size,
                               max_pages_per_slot=max_pages_per_slot)
        self.cache = bundle.init_paged_cache(self.kv.pool_pages, page_size,
                                             kv_dtype=kv_dtype)

    def _step(self, tokens, lengths, counts) -> torch.Tensor:
        """One draft forward over every slot (T = 1 generation or T = chunk
        catch-up); writes the draft cache in place, returns the logits."""
        return self.bundle.decode_paged(
            self.params, self.cache, *[
                torch.from_numpy(np.asarray(a, np.int32)).to(self.device)
                for a in (tokens, lengths, counts, self.kv.block_tables)])

    def _lengths(self) -> np.ndarray:
        return np.array([self.kv.length(s) for s in range(self.slots)],
                        np.int32)

    # -- lifecycle --------------------------------------------------------
    def admit(self, slot: int, req: Request) -> None:
        self.kv.free_slot(slot)   # fresh slate; full catch-up on first tick

    def release(self, slot: int) -> None:
        self.kv.free_slot(slot)

    def observe(self, slot: int, req: Request, new_len: int) -> None:
        # after full acceptance the draft is one token *behind* the target
        # (it never fed the last proposal); never truncate upward
        self.kv.truncate(slot, min(self.kv.length(slot), new_len))

    # -- proposing --------------------------------------------------------
    def _sync_all(self, entries: List[Tuple[int, List[int]]]) -> set:
        """Chunk-prefill every listed slot's draft cache up to
        ``len(committed) - 1`` entries (everything but the pending token),
        batched across slots -- one ``(slots, chunk)`` forward per round,
        idle slots masked by ``new_counts = 0``.  Returns the slots dropped
        on ``OutOfPages``."""
        failed: set = set()
        while True:
            toks = np.zeros((self.slots, self.chunk), np.int32)
            counts = np.zeros((self.slots,), np.int32)
            for slot, committed in entries:
                if slot in failed:
                    continue
                pos = self.kv.length(slot)
                n = min(self.chunk, len(committed) - 1 - pos)
                if n <= 0:
                    continue
                try:
                    self.kv.allocate(slot, pos + n)
                except OutOfPages:
                    self.kv.free_slot(slot)   # full resync next time it fits
                    failed.add(slot)
                    continue
                toks[slot, :n] = committed[pos:pos + n]
                counts[slot] = n
            if not counts.any():
                return failed
            lengths = self._lengths()
            self._step(toks, lengths, counts)
            for slot in np.flatnonzero(counts):
                self.kv.commit(slot, int(lengths[slot] + counts[slot]))

    def propose(self, plan: Sequence[PlanEntry]) -> Dict[int, List[int]]:
        committed = {slot: req.prompt + req.output for slot, req, _ in plan}
        failed = self._sync_all(list(committed.items()))
        out: Dict[int, List[int]] = {}
        live: List[Tuple[int, int]] = []          # (slot, k)
        feed = np.zeros((self.slots, 1), np.int32)
        for slot, req, k in plan:
            if slot in failed:
                continue
            try:
                # room for the pending token + k-1 written proposals
                self.kv.allocate(slot, len(committed[slot]) - 1 + max(k, 1))
            except OutOfPages:
                self.kv.free_slot(slot)   # full resync next time it fits
                continue
            out[slot] = []
            if k > 0:
                live.append((slot, k))
                feed[slot, 0] = committed[slot][-1]
        for j in range(max((k for _, k in live), default=0)):
            counts = np.zeros((self.slots,), np.int32)
            for slot, k in live:
                if j < k:
                    counts[slot] = 1
            logits = self._step(feed, self._lengths(), counts)
            greedy = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            for slot, k in live:
                if j < k:
                    self.kv.commit(slot, self.kv.length(slot) + 1)
                    tok = int(greedy[slot])
                    out[slot].append(tok)
                    feed[slot, 0] = tok
        return out
