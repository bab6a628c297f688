"""(A copy of the JAX package's ``repro.serve.paged_cache``: the allocator is
host-side numpy, so both packages share its semantics exactly.)

Paged KV cache: fixed-size pages, per-slot block tables, alloc/free/defrag,
and refcounted **prefix sharing** with copy-on-write.

The serving analogue of the paper's APR residency story: the APR keeps a
running reduction resident near the ALU so the memory system sees one write
per output element; a paged KV cache keeps the *decode working set* resident
in fixed-size, reusable pages so decode attention touches only live pages —
no slot ever holds ``max_seq`` worth of zeros it will never fill.  Freeing a
request's pages on completion is the allocator-level ``rfsmac.s``: the
accumulated state is flushed (sampled tokens already emitted) and the
storage returns to the pool in one step.

Prefix sharing pushes the same residency argument *across requests*: two
requests whose prompts share a prefix would materialize byte-identical KV
pages (KV content is a deterministic function of the token prefix under
greedy serving), so with ``enable_sharing=True`` the allocator dedupes them
— identical prefixes resolve to the *same* physical pages, refcounted, and
a slot only gets a private copy when it is about to **write** into a shared
page (copy-on-write).  Under shared-system-prompt traffic this multiplies
effective KV capacity the way the paper's APR multiplies effective memory
bandwidth: the hot state is kept once and rented to every consumer.

This module is the *host-side* allocator: pure python/numpy bookkeeping
(free list, block tables, refcounts, the prefix index).  The device-side
page pools — ``(n_sb, me, num_pages, page_size, hkv, dh)`` arrays — are
owned by the engine (`repro_torch.serve.engine.PagedServeEngine`) and by the
model's paged decode path (`repro_torch.models.lm.lm_decode_paged`); the
allocator only decides *which* page indices they use.  The one device
consequence of sharing is the COW split: the allocator queues ``(src, dst)``
page copies that the engine must mirror on every pool
(:meth:`PagedKVCache.pop_page_copies`) before the next forward.

Layout invariants
-----------------
* Page ``0`` is the reserved **null page**: never allocated, used as the
  scatter target for padded prefill positions and idle slots, and as the
  block-table filler for unallocated entries.  Garbage written there is
  never read back (attention masks by length before any null-page position
  becomes visible).
* ``block_tables[slot, i]`` holds the physical page backing logical tokens
  ``[i * page_size, (i+1) * page_size)`` of that slot.  The same logical ->
  physical mapping is shared by every layer (each layer has its own storage
  at the same page index), so one int32 table drives the whole model.
* A slot storing ``n`` tokens references exactly ``ceil(n / page_size)``
  pages; with sharing, several slots may reference the *same* physical page
  (its refcount counts the referencing slots) but a slot's reference run is
  always prefix-closed: if a slot holds page ``i`` it holds pages
  ``0..i-1`` too, so a shared page can never outlive its shared parent.
* **Shared pages are read-only.**  Every write path goes through
  :meth:`allocate`, which COW-splits the page containing the write boundary
  when its refcount exceeds one (and unregisters it from the prefix index
  when it does not, since its content is about to diverge).  ``truncate``
  and ``free_slot`` only *drop references* — a page returns to the free
  list exactly when its refcount hits zero, **unless** it is published in
  the prefix index, in which case it parks in an LRU *evictable* pool
  instead: its KV content stays valid and matchable after every referent
  finished (the cache survives between request waves), and the page is
  lazily evicted — unregistered and recycled — only when an allocation
  finds the free list empty.  Prefix-closure makes lazy eviction safe: a
  parked page's registered descendants are necessarily parked too (a live
  child would imply a live parent), so evicting a page evicts its whole
  subtree and no trie entry can ever dangle under a recycled page id.
* **int8 storage** (``kv_dtype="int8"`` on the engine / model cache): the
  device pools hold int8 payloads plus fp32 scale pools of shape
  ``(..., num_pages + 1, page_size, hkv)`` — one symmetric scale per (page
  slot, kv head), written together with its payload so a slot is always
  self-consistent and rewrites stay idempotent.  Nothing here changes: the
  allocator tracks *pages*, not bytes; the same block tables drive the int8
  pools and their scale pools, and a COW/defrag page move applies to
  payload and scale pools alike (the page axis is shared).  See
  ``docs/quantization.md``.

Prefix index
------------
Registered pages form a trie keyed by content: a page is registered under
``(parent_page, tokens)`` where ``parent_page`` is the physical page backing
the preceding ``page_size`` tokens (``NULL_PAGE`` for the first page) and
``tokens`` is the exact token tuple the page stores.  Because a registered
page's id *is* its trie node, lookup is exact — no hash collisions can ever
splice two different prefixes together.  ``match_prefix`` walks the trie
page by page and finishes with a **partial-page** match: the best
common-prefix child of the last matched node is attached shared, and the
first divergent append COW-splits it.  Entries are evicted when their page's
refcount reaches zero (content is about to be recycled) or when its owner
writes into it while unshared (content is about to diverge).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

NULL_PAGE = 0

_KV_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def kv_token_bytes(hkv: int, head_dim: int, kv_dtype: str = "bfloat16") -> int:
    """Analytic KV-cache bytes one token costs per layer tensor (K or V):
    payload at ``kv_dtype`` width plus, for int8, the per-(token, head)
    fp32 scale.  Used by the quantization benchmark's bandwidth model."""
    payload = hkv * head_dim * _KV_ITEMSIZE[kv_dtype]
    scales = hkv * 4 if kv_dtype == "int8" else 0
    return payload + scales


class OutOfPages(Exception):
    """Raised by ``allocate`` when the pool cannot cover a reservation."""


@dataclasses.dataclass
class PageTableView:
    """Immutable snapshot handed to device code / tests."""
    block_tables: np.ndarray      # (slots, max_pages_per_slot) int32
    lengths: np.ndarray           # (slots,) int32 tokens stored per slot


#: trie key: (parent physical page, exact token tuple the page stores)
_TrieKey = Tuple[int, Tuple[int, ...]]


class PagedKVCache:
    """Fixed-size-page allocator with per-slot block tables and (optional)
    refcounted prefix sharing.

    ``num_pages`` counts *usable* pages; one extra null page is always
    appended at index 0, so device pools must be sized ``num_pages + 1``
    (see :attr:`pool_pages`).

    Refcounting is always on (``truncate`` / ``free_slot`` drop references
    and only recycle a page at refcount zero); ``enable_sharing=True``
    additionally activates the prefix index so :meth:`match_prefix` /
    :meth:`register_prefix` can create refcounts above one.  With sharing
    off every refcount stays at one and behavior is identical to the
    pre-sharing allocator.
    """

    def __init__(self, *, slots: int, num_pages: int, page_size: int,
                 max_pages_per_slot: Optional[int] = None,
                 enable_sharing: bool = False):
        if page_size <= 0 or num_pages <= 0 or slots <= 0:
            raise ValueError("slots, num_pages, page_size must be positive")
        self.slots = slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot or num_pages
        self.enable_sharing = enable_sharing
        # physical ids 1..num_pages are allocatable; 0 is the null page
        self._free: List[int] = list(range(num_pages, 0, -1))  # pop() -> 1 first
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._lengths = np.zeros((slots,), np.int32)
        self.block_tables = np.zeros((slots, self.max_pages_per_slot), np.int32)
        # page refcounts: number of slots referencing each physical page
        self._ref = np.zeros((num_pages + 1,), np.int32)
        # prefix index (trie over page contents; see module docstring)
        self._index: Dict[_TrieKey, int] = {}
        self._children: Dict[int, Set[int]] = {}
        self._page_meta: Dict[int, _TrieKey] = {}
        # pages of a slot already offered to register_prefix (avoids
        # rehashing the whole prefix every chunk)
        self._next_reg: List[int] = [0] * slots
        # registered pages whose refcount hit zero, kept matchable until
        # memory pressure evicts them; dict = insertion-ordered, oldest
        # first (suffix-first release order makes a chain's deepest page
        # oldest, so LRU eviction trims subtrees leaf-first)
        self._evictable: Dict[int, None] = {}
        # COW page copies the engine must mirror on the device pools before
        # the next forward (drained via pop_page_copies, FIFO-safe)
        self._pending_copies: List[Tuple[int, int]] = []
        #: cumulative sharing counters (never reset; consumers take deltas):
        #: fresh_pages = pages drawn from the free list, shared_attached =
        #: references added by match_prefix, cow_splits = COW page copies,
        #: dedup_reclaimed = private pages retired by retro-dedup in
        #: register_prefix (a page found byte-identical to an already-
        #: published one).  fresh_pages - dedup_reclaimed is the *unique*
        #: page cost of the traffic served so far.
        self.stats: Dict[str, int] = {"fresh_pages": 0, "shared_attached": 0,
                                      "cow_splits": 0, "dedup_reclaimed": 0,
                                      "evictions": 0}

    # -- capacity queries -------------------------------------------------
    @property
    def pool_pages(self) -> int:
        """Physical pages device pools must allocate (incl. null page)."""
        return self.num_pages + 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Parked prefix-cache pages: registered, refcount zero, reclaimed
        lazily under pressure.  Always zero with sharing disabled."""
        return len(self._evictable)

    @property
    def available_pages(self) -> int:
        """Pages an allocation can draw on: free plus lazily evictable."""
        return len(self._free) + len(self._evictable)

    @property
    def used_pages(self) -> int:
        """Unique physical pages referenced by at least one slot (a shared
        page counts once; parked prefix-cache pages don't count)."""
        return self.num_pages - self.available_pages

    def utilization(self) -> float:
        return self.used_pages / self.num_pages

    def max_tokens_per_slot(self) -> int:
        return self.max_pages_per_slot * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def refcount(self, page: int) -> int:
        """Number of slots currently referencing ``page`` (0 = free)."""
        return int(self._ref[page])

    def _cow_pages_needed(self, slot: int, n_tokens: int) -> int:
        """Extra pages a grow-to-``n_tokens`` needs for COW splits: writing
        starts at the committed length, so only the page containing that
        boundary can be both owned and shared (later owned pages are always
        private over-allocations, earlier ones are not written)."""
        length = int(self._lengths[slot])
        if n_tokens <= length or length % self.page_size == 0:
            return 0
        boundary = length // self.page_size
        owned = self._owned[slot]
        if boundary < len(owned) and self._ref[owned[boundary]] > 1:
            return 1
        return 0

    def can_grow(self, slot: int, n_tokens: int) -> bool:
        """Could ``slot`` hold ``n_tokens`` total without preempting anyone?
        Accounts for any COW split the first write would force; parked
        prefix-cache pages count as reclaimable."""
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_slot:
            return False
        grow = max(need - len(self._owned[slot]), 0)
        return (grow + self._cow_pages_needed(slot, n_tokens)
                <= self.available_pages)

    # -- alloc / free -----------------------------------------------------
    def _take_free(self) -> int:
        """Pop a free page, lazily evicting the oldest parked prefix-cache
        page (and, via prefix-closure, its parked subtree) when the free
        list is empty.  Callers must have checked ``available_pages``."""
        if not self._free:
            victim = next(iter(self._evictable))
            self._drop_subtree(victim)
            self.stats["evictions"] += 1
        return self._free.pop()

    def _drop_subtree(self, page: int) -> None:
        """Unregister ``page`` and every registered descendant — their trie
        entries continue a prefix that is about to diverge or be recycled,
        so leaving any behind would let a future match splice stale KV onto
        a new context (page ids are reused; a dangling child under a reused
        id aliases the new registration).  Parked descendants return to the
        free list; live ones (possible only when dropping a *diverging*
        page, whose still-running referents share a now-unpublished prefix)
        keep serving their slots read-only but stop being matchable."""
        for child in list(self._children.get(page, ())):
            self._drop_subtree(child)
        self._unregister(page)
        if page in self._evictable:
            del self._evictable[page]
            self._free.append(page)

    def allocate(self, slot: int, n_tokens: int) -> List[int]:
        """Grow ``slot`` so it can store ``n_tokens`` tokens total, and make
        the write range exclusively owned.

        Returns the newly assigned page ids (possibly empty).  Raises
        :class:`OutOfPages` without side effects if the pool cannot cover
        the growth, so callers can preempt and retry.

        Callers invoke this exactly when they are about to *write* tokens
        ``[length, n_tokens)``, so this is also the copy-on-write point: if
        the page containing the committed-length boundary is shared, it is
        split — a fresh page replaces it in this slot's table, the copy is
        queued for the engine (:meth:`pop_page_copies`), and the original
        keeps serving its other referents read-only.  If that boundary page
        is unshared but published in the prefix index, it is unregistered
        instead (its content is about to diverge from the registered
        prefix).
        """
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_slot:
            raise OutOfPages(
                f"slot {slot}: {n_tokens} tokens needs {need} pages "
                f"> max_pages_per_slot={self.max_pages_per_slot}")
        owned = self._owned[slot]
        grow = max(need - len(owned), 0)
        cow = self._cow_pages_needed(slot, n_tokens)
        if grow + cow > self.available_pages:
            raise OutOfPages(
                f"slot {slot}: need {grow + cow} pages "
                f"({grow} growth + {cow} COW), {self.available_pages} "
                "available")
        length = int(self._lengths[slot])
        if n_tokens > length and length % self.page_size != 0:
            boundary = length // self.page_size
            if boundary < len(owned):
                src = owned[boundary]
                if self._ref[src] > 1:
                    dst = self._take_free()
                    self._ref[src] -= 1
                    self._ref[dst] = 1
                    owned[boundary] = dst
                    self.block_tables[slot, boundary] = dst
                    self._pending_copies.append((src, dst))
                    self.stats["cow_splits"] += 1
                elif src in self._page_meta:
                    # unshared but published: content is about to diverge,
                    # so the page — and every registered continuation of
                    # the prefix it anchored — leaves the index
                    self._drop_subtree(src)
        if grow == 0:
            return []
        new = [self._take_free() for _ in range(grow)]
        for p in new:
            self._ref[p] = 1
        base = len(owned)
        owned.extend(new)
        self.block_tables[slot, base:base + grow] = new
        self.stats["fresh_pages"] += grow
        return new

    def commit(self, slot: int, n_tokens: int) -> None:
        """Record that ``slot`` now stores ``n_tokens`` tokens (post-write)."""
        assert self.pages_for(n_tokens) <= len(self._owned[slot]), \
            (slot, n_tokens, len(self._owned[slot]))
        self._lengths[slot] = n_tokens

    def pop_page_copies(self) -> List[Tuple[int, int]]:
        """Drain queued COW page copies as ``[(src, dst), ...]`` for the
        engine to mirror on every device pool
        (``pool[:, :, dst] = pool[:, :, src]``) **before the
        next forward**.  Applying them in order is safe: a src is only ever
        recycled as a later copy's dst, never overwritten in between
        (device pages are written only by forwards, which happen after the
        drain)."""
        moves, self._pending_copies = self._pending_copies, []
        return moves

    def _release(self, page: int) -> bool:
        """Drop one reference to ``page``.  At refcount zero the page is
        recycled — or, if it is published in the prefix index, *parked* in
        the evictable pool so its content stays matchable until memory
        pressure reclaims it.  Returns True when the page left live use
        (freed or parked)."""
        self._ref[page] -= 1
        assert self._ref[page] >= 0, f"page {page}: negative refcount"
        if self._ref[page] > 0:
            return False
        if page in self._page_meta:
            self._evictable[page] = None
        else:
            self._free.append(page)
        return True

    def truncate(self, slot: int, n_tokens: int) -> List[int]:
        """Roll ``slot`` back so it stores exactly ``n_tokens`` tokens,
        dropping its reference to every page past ``ceil(n / page_size)``.

        This is the rollback primitive speculative decoding needs
        (the JAX package's ``repro.spec``): a verify step writes K+1 candidate tokens into the
        slot's pages, then the rejected suffix is discarded by truncating to
        the accepted length.  ``n_tokens`` is bounded by the slot's currently
        *allocated* capacity, not its committed length — a verify step
        allocates and writes before it knows how much survives, so truncate
        doubles as the commit of the accepted prefix.

        Refcount semantics: dropped pages leave live use only when this
        slot held the last reference — a page still backing another slot's
        prefix survives untouched (rollback never mutates shared state; the
        *write* that follows a rollback into a still-shared kept page is
        what triggers the COW split, inside :meth:`allocate`).  References
        are dropped suffix-first so a shared child is always released before
        its parent.  Returns the page ids whose refcount hit zero — freed
        to the pool, or (if published in the prefix index) parked in the
        evictable prefix cache.

        Stale KV left in the kept partial page (offsets past ``n_tokens``)
        is never read: attention masks by length, and the offsets are
        overwritten by the next append (COW-splitting first if the page is
        shared).  Freed pages may be re-rented immediately (their stale
        contents are masked by the new owner's length the same way).
        """
        if n_tokens < 0:
            raise ValueError(f"slot {slot}: cannot truncate to {n_tokens}")
        keep = self.pages_for(n_tokens)
        owned = self._owned[slot]
        if keep > len(owned):
            raise ValueError(
                f"slot {slot}: truncate to {n_tokens} tokens needs {keep} "
                f"pages but only {len(owned)} are allocated")
        dropped = owned[keep:]
        self._owned[slot] = owned[:keep]
        freed = [p for p in reversed(dropped) if self._release(p)]
        self.block_tables[slot, keep:] = NULL_PAGE
        self._lengths[slot] = n_tokens
        self._next_reg[slot] = min(self._next_reg[slot],
                                   n_tokens // self.page_size)
        return freed

    def free_slot(self, slot: int) -> int:
        """Drop all of ``slot``'s page references; returns how many pages
        left live use — returned to the pool or parked in the prefix cache
        (shared pages survive with their other referents)."""
        pages = self._owned[slot]
        n = sum(self._release(p) for p in reversed(pages))
        self._owned[slot] = []
        self._lengths[slot] = 0
        self._next_reg[slot] = 0
        self.block_tables[slot, :] = NULL_PAGE
        return n

    def length(self, slot: int) -> int:
        return int(self._lengths[slot])

    def owned_pages(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._owned[slot])

    def view(self) -> PageTableView:
        return PageTableView(block_tables=self.block_tables.copy(),
                             lengths=self._lengths.copy())

    # -- prefix sharing ---------------------------------------------------
    def _attach(self, page: int) -> None:
        """Take a reference on a registered page, un-parking it if it was
        sitting in the evictable prefix cache."""
        if self._ref[page] == 0:
            del self._evictable[page]
        self._ref[page] += 1

    def _register(self, page: int, key: _TrieKey) -> None:
        self._index[key] = page
        self._children.setdefault(key[0], set()).add(page)
        self._page_meta[page] = key

    def _unregister(self, page: int) -> None:
        key = self._page_meta.pop(page)
        del self._index[key]
        kids = self._children.get(key[0])
        if kids is not None:
            kids.discard(page)
            if not kids:
                del self._children[key[0]]

    @property
    def registered_pages(self) -> int:
        """Pages currently published in the prefix index (test hook)."""
        return len(self._page_meta)

    def match_prefix(self, slot: int, tokens: List[int]) -> int:
        """Attach the longest already-cached prefix of ``tokens`` to the
        empty ``slot`` and return how many tokens it covers.

        Walks the prefix trie a full page at a time, then finishes with the
        best *partial* match among the last node's children (a shared page
        whose content starts with the remaining tokens) — the attached
        partial page is shared read-only and the first divergent append
        COW-splits it.  The match is capped at ``len(tokens) - 1``: at least
        one prompt token must run through prefill so the engine gets
        next-token logits (the KV of matched tokens is reused, their logits
        were never kept).

        The slot's committed length is set to the matched token count —
        callers resume prefill from there.  Returns 0 with sharing disabled.
        """
        if not self.enable_sharing:
            return 0
        assert not self._owned[slot] and self._lengths[slot] == 0, \
            f"match_prefix: slot {slot} is not empty"
        limit = min(len(tokens) - 1, self.max_tokens_per_slot())
        ps = self.page_size
        attached: List[int] = []
        parent = NULL_PAGE
        while (len(attached) + 1) * ps <= limit:
            base = len(attached) * ps
            page = self._index.get((parent, tuple(tokens[base:base + ps])))
            if page is None:
                break
            attached.append(page)
            parent = page
        matched = len(attached) * ps
        remaining = limit - matched
        if remaining > 0:
            best, best_r = None, 0
            want = tokens[matched:matched + remaining]
            for q in self._children.get(parent, ()):
                have = self._page_meta[q][1]
                r = 0
                for a, b in zip(have, want):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best, best_r = q, r
            if best is not None:
                attached.append(best)
                matched += best_r
        for i, p in enumerate(attached):
            self._attach(p)
            self._owned[slot].append(p)
            self.block_tables[slot, i] = p
        self._lengths[slot] = matched
        # full attached pages are already published; the engine's
        # register_prefix calls start after them (a partially-matched tail
        # page belongs to its original publisher, and this slot's divergent
        # copy of it re-registers — or retro-dedups — once complete)
        self._next_reg[slot] = matched // ps
        self.stats["shared_attached"] += len(attached)
        return matched

    def register_prefix(self, slot: int, tokens: List[int]) -> None:
        """Publish ``slot``'s fully-written pages in the prefix index so
        later requests can share them.  ``tokens`` is the slot's full token
        history; only pages completely covered by the committed length are
        published (a partial page's content is still growing).

        Idempotent and incremental: pages already offered are skipped.  If
        an identical page is already published by another slot
        (simultaneous admissions compute the same prefix independently),
        this slot's private copy is retired and its reference is repointed
        at the canonical page (**retro-dedup**) — contents are byte-
        identical by construction, so no device copy is needed.
        """
        if not self.enable_sharing:
            return
        ps = self.page_size
        owned = self._owned[slot]
        full = min(int(self._lengths[slot]) // ps, len(tokens) // ps,
                   len(owned))
        for i in range(self._next_reg[slot], full):
            page_toks = tuple(tokens[i * ps:(i + 1) * ps])
            parent = owned[i - 1] if i else NULL_PAGE
            key = (parent, page_toks)
            cur = self._index.get(key)
            if cur is None:
                if page_toks and owned[i] not in self._page_meta:
                    self._register(owned[i], key)
            elif cur != owned[i] and self._ref[owned[i]] == 1:
                # retro-dedup: identical content already published; retire
                # the private copy and share the canonical page
                private = owned[i]
                self._attach(cur)
                owned[i] = cur
                self.block_tables[slot, i] = cur
                self._release(private)
                self.stats["dedup_reclaimed"] += 1
        self._next_reg[slot] = full

    # -- defrag -----------------------------------------------------------
    def defrag(self) -> List[Tuple[int, int]]:
        """Compact live pages — slot-owned or parked in the prefix cache —
        onto the lowest physical ids, preserving sharing (a page referenced
        by several slots moves once and every referent's table is rewritten
        to the new id; the prefix trie and the evictable pool are remapped
        with it, so cached prefixes stay matchable across compaction).

        Returns ``[(src, dst), ...]`` moves for the engine to mirror on the
        device pools (``pool[:, :, dst] = pool[:, :, src]``).
        After compaction the live pages occupy ids ``1..used + cached``, so
        a long-running engine can shrink its device pools by slicing off
        the tail.  Moves are ordered so applying them sequentially is safe
        (every dst is drawn from the free set before its src is released).
        Queued-but-undrained COW copies are remapped to the new ids.
        """
        live = sorted({p for owned in self._owned for p in owned}
                      | set(self._evictable))
        mapping: Dict[int, int] = {}
        moves: List[Tuple[int, int]] = []
        for want, src in enumerate(live, start=1):
            if src != want:
                mapping[src] = want
                moves.append((src, want))
        if not moves:
            return []
        for slot in range(self.slots):
            self._owned[slot] = [mapping.get(p, p) for p in self._owned[slot]]
            n = len(self._owned[slot])
            self.block_tables[slot, :n] = self._owned[slot]
        new_ref = np.zeros_like(self._ref)
        for p in live:
            new_ref[mapping.get(p, p)] = self._ref[p]
        self._ref = new_ref
        # remap the prefix trie: both node ids (pages) and parent links
        remap = lambda p: mapping.get(p, p)  # noqa: E731
        self._index = {(remap(parent), toks): remap(page)
                       for (parent, toks), page in self._index.items()}
        self._children = {remap(parent): {remap(q) for q in kids}
                          for parent, kids in self._children.items()}
        self._page_meta = {remap(page): (remap(parent), toks)
                           for page, (parent, toks) in self._page_meta.items()}
        self._pending_copies = [(remap(s), remap(d))
                                for s, d in self._pending_copies]
        self._evictable = {remap(p): None for p in self._evictable}
        n_live = len(live)
        self._free = list(range(self.num_pages, n_live, -1))
        return moves
