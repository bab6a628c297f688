"""(A copy of the JAX package's ``repro.serve.state_cache``: the allocator is
host-side Python, so both packages share its semantics exactly.)

Paged cache for fixed-size recurrent state (the software APR).

Attention KV grows with the sequence, so ``PagedKVCache`` pages it.  A
recurrent layer's state — rwkv6's wkv matrix + token-shift rows, mamba2's
SSD state + causal-conv window — is a *fixed-size register file* per
sequence: the paper's architectural pipeline register, in software.  It
cannot shrink by dropping pages (every state is a running reduction over
the whole history), so rollback needs *checkpoints*: a bounded ring of
state snapshots per slot, and ``truncate`` restores the snapshot taken at
the target token count instead of freeing a page suffix.

:class:`StateCache` is the host-side allocator for a device-side pool of
physical state slots (axis 1 of every state leaf in the paged cache).  It
mirrors the ``PagedKVCache`` contract — alloc / commit / truncate /
free_slot / defrag / pop_*_copies / refcount / stats — so the engine
drives both through the same tick choreography; hybrid (zamba2) slots hold
KV pages *and* a state slot, rolled back atomically by the engine's
``_truncate_slot``.

Physical slot ids:

* ``NULL_STATE`` (0) — pristine zero state, read-only: the gather target
  for slots that have not produced any state yet (first prefill chunk).
  Nothing may ever scatter into it.
* ``TRASH_STATE`` (1) — write sink: padded / inactive positions in a
  decode or verify tick scatter their garbage state here so the null slot
  stays zero.  Never read.
* ``2 ..`` — allocatable: one *current* id per active logical slot plus a
  snapshot ring of up to ``ring_depth`` checkpoints.

The cache never shares state between slots (a state is a lossy running
summary — there is no page boundary at which two histories coincide), so
refcounts are only ever 0 or 1; the accessor exists for contract parity
and leak checks.  Device data moves only through ``pop_state_copies()``
(truncate restores, defrag moves, explicit copy-snapshots), which the
engine mirrors onto its device pools in place — the cache itself never
touches device memory.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

#: physical id of the pristine zero state (read-only)
NULL_STATE = 0
#: physical id of the write sink for padded positions (never read)
TRASH_STATE = 1
#: first allocatable physical id
_FIRST = 2


class OutOfStateSlots(Exception):
    """The physical state-slot pool is exhausted."""


class StateCache:
    """Host-side bookkeeping for a pool of physical recurrent-state slots.

    ``slots`` logical slots, each holding one *current* state plus a ring
    of at most ``ring_depth`` snapshots, so the pool never runs dry:
    ``num_slots = slots * (1 + ring_depth)`` allocatable ids (plus the two
    reserved ids — ``pool_slots`` is the device axis size).
    """

    def __init__(self, *, slots: int, ring_depth: int = 1):
        if slots < 1:
            raise ValueError("need at least one slot")
        if ring_depth < 1:
            raise ValueError("ring_depth must be >= 1")
        self.slots = slots
        self.ring_depth = ring_depth
        self.num_slots = slots * (1 + ring_depth)
        # pop() hands out low ids first
        self._free: List[int] = list(
            range(_FIRST + self.num_slots - 1, _FIRST - 1, -1))
        self._cur: List[int] = [NULL_STATE] * slots
        self._len: List[int] = [0] * slots
        #: per logical slot, ascending ``(token_count, physical_id)``
        self._ring: List[List[Tuple[int, int]]] = [[] for _ in range(slots)]
        self._ref: Dict[int, int] = {}
        self._pending: List[Tuple[int, int]] = []
        self.stats: Dict[str, int] = {
            "allocs": 0, "snapshots": 0, "restores": 0, "ring_evictions": 0,
        }

    # -- geometry ---------------------------------------------------------
    @property
    def pool_slots(self) -> int:
        """Device state-pool axis size (reserved ids included)."""
        return _FIRST + self.num_slots

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def used_slots(self) -> int:
        return self.num_slots - len(self._free)

    # -- per-slot accessors ----------------------------------------------
    def cur(self, slot: int) -> int:
        """Physical id of ``slot``'s current state (0 if unallocated)."""
        return self._cur[slot]

    def length(self, slot: int) -> int:
        """Committed token count reflected by the current state."""
        return self._len[slot]

    def read_id(self, slot: int) -> int:
        """Physical id a forward pass should gather ``slot``'s state from:
        the current state once any tokens are committed, else the pristine
        zero slot (a freshly-allocated physical slot holds stale data)."""
        return self._cur[slot] if self._len[slot] > 0 else NULL_STATE

    def refcount(self, sid: int) -> int:
        return self._ref.get(sid, 0)

    def snapshot_counts(self, slot: int) -> Tuple[int, ...]:
        """Token counts with a restorable checkpoint, ascending."""
        return tuple(c for c, _ in self._ring[slot])

    # -- allocation -------------------------------------------------------
    def _take(self) -> int:
        if not self._free:
            raise OutOfStateSlots(
                f"state pool exhausted ({self.num_slots} physical slots)")
        sid = self._free.pop()
        self._ref[sid] = 1
        return sid

    def _release(self, sid: int) -> None:
        self._ref[sid] -= 1
        assert self._ref[sid] == 0, "state slots are never shared"
        del self._ref[sid]
        self._free.append(sid)

    def alloc(self, slot: int) -> int:
        """Give ``slot`` a fresh current state (length 0).  The physical
        slot is *not* zeroed on device — reads before the first commit go
        to ``NULL_STATE`` instead (see :meth:`read_id`)."""
        if self._cur[slot] != NULL_STATE:
            raise ValueError(f"slot {slot} already has a state")
        sid = self._take()
        self._cur[slot] = sid
        self._len[slot] = 0
        self.stats["allocs"] += 1
        return sid

    def commit(self, slot: int, n_tokens: int) -> None:
        """The current state now reflects ``n_tokens`` committed tokens."""
        if self._cur[slot] == NULL_STATE:
            raise ValueError(f"slot {slot} has no state")
        self._len[slot] = n_tokens

    # -- snapshots --------------------------------------------------------
    def snapshot(self, slot: int, n_tokens: int = None, *,
                 copy: bool = True) -> int:
        """Checkpoint ``slot`` at ``n_tokens`` (default: current length).

        With ``copy=True`` a device copy current -> snapshot is queued (a
        plain checkpoint of state the slot already holds).  With
        ``copy=False`` the snapshot id is handed out *empty* for a forward
        pass to scatter into — the speculative verify tick allocates one
        per drafted position and writes the post-token state directly,
        so rejected tokens never touch the current state.

        The ring keeps at most ``ring_depth`` entries per slot; the oldest
        (lowest token count) is evicted first.  A snapshot at an existing
        count replaces it.
        """
        if self._cur[slot] == NULL_STATE:
            raise ValueError(f"slot {slot} has no state")
        if n_tokens is None:
            n_tokens = self._len[slot]
        # release before taking: a slot at full ring occupancy (the spec
        # engine's steady state at full acceptance) holds exactly its
        # 1 + ring_depth pool share, so the fresh id must come from an
        # eviction, not from headroom the pool does not have
        ring = self._ring[slot]
        for i, (c, old) in enumerate(ring):
            if c == n_tokens:
                self._release(old)
                del ring[i]
                break
        while len(ring) >= self.ring_depth:
            _, old = ring.pop(0)
            self._release(old)
            self.stats["ring_evictions"] += 1
        sid = self._take()
        if copy:
            self._pending.append((self._cur[slot], sid))
        ring.append((n_tokens, sid))
        ring.sort()
        self.stats["snapshots"] += 1
        return sid

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Roll ``slot`` back (or commit it forward) to ``n_tokens``.

        Unlike KV pages there is no suffix to drop: the state at
        ``n_tokens`` must exist as a ring checkpoint, and restoring queues
        a device copy snapshot -> current.  ``n_tokens == length`` is a
        no-op apart from dropping newer checkpoints (the verify tick's
        "nothing accepted" case).  Like ``PagedKVCache.truncate``,
        ``n_tokens`` may exceed the committed length when the target state
        was written ahead by a verify pass — truncate doubles as the
        commit of the accepted prefix.
        """
        if self._cur[slot] == NULL_STATE:
            raise ValueError(f"slot {slot} has no state")
        ring = self._ring[slot]
        hit = next((sid for c, sid in ring if c == n_tokens), None)
        if hit is None:
            if n_tokens == self._len[slot]:
                self._drop_after(slot, n_tokens)
                return
            raise ValueError(
                f"slot {slot}: no state checkpoint at {n_tokens} tokens "
                f"(ring holds {self.snapshot_counts(slot)}); recurrent "
                f"state cannot be truncated without a snapshot")
        self._pending.append((hit, self._cur[slot]))
        self.stats["restores"] += 1
        self._len[slot] = n_tokens
        self._drop_after(slot, n_tokens)

    def _drop_after(self, slot: int, n_tokens: int) -> None:
        ring = self._ring[slot]
        keep, drop = [], []
        for c, sid in ring:
            (keep if c <= n_tokens else drop).append((c, sid))
        for _, sid in drop:
            self._release(sid)
        self._ring[slot] = keep

    def free_slot(self, slot: int) -> None:
        """Release ``slot``'s current state and every checkpoint."""
        if self._cur[slot] != NULL_STATE:
            self._release(self._cur[slot])
            self._cur[slot] = NULL_STATE
        for _, sid in self._ring[slot]:
            self._release(sid)
        self._ring[slot] = []
        self._len[slot] = 0

    # -- device traffic ---------------------------------------------------
    def pop_state_copies(self) -> List[Tuple[int, int]]:
        """Drain queued device copies as ``(src_id, dst_id)`` pairs, in
        order.  The engine mirrors them into the device pool before the
        next forward pass reads any state."""
        out, self._pending = self._pending, []
        return out

    def defrag(self) -> List[Tuple[int, int]]:
        """Compact live physical slots to the low end of the pool; returns
        the ``(src, dst)`` moves (also queued on the pending list).  Safe
        in one pass: live ids are remapped in ascending order to ascending
        targets, so every destination is free before its source moves."""
        live = sorted(self._ref)
        mapping: Dict[int, int] = {}
        moves: List[Tuple[int, int]] = []
        for want, sid in enumerate(live, start=_FIRST):
            mapping[sid] = want
            if want != sid:
                moves.append((sid, want))
        if not moves:
            return []
        for slot in range(self.slots):
            if self._cur[slot] != NULL_STATE:
                self._cur[slot] = mapping[self._cur[slot]]
            self._ring[slot] = [(c, mapping[sid])
                                for c, sid in self._ring[slot]]
        self._ref = {mapping[sid]: n for sid, n in self._ref.items()}
        # earlier queued copies run first, at the pre-defrag layout — only
        # the moves themselves see the new ids
        self._pending.extend(moves)
        self._free = sorted(
            (sid for sid in range(_FIRST, _FIRST + self.num_slots)
             if sid not in self._ref), reverse=True)
        return moves
