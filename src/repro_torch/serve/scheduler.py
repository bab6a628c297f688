"""(A copy of the JAX package's ``repro.serve.scheduler``.)

FIFO admission scheduler with token-budgeted chunked prefill + preemption.

Pure host-side policy, no device code: the engine asks it *what* to run each tick
(admissions, prefill chunks, the preemption victim) and executes the device
work itself.  Keeping the policy side-effect-free against engine state makes
the invariants unit-testable without building a model.

Request lifecycle::

    QUEUED --admit--> PREFILLING --prompt cached--> DECODING --eos/len--> DONE
       ^                  |                            |
       +---- preempt (pages freed, recompute) ---------+

Scheduler invariants (tested in tests/test_serve_engine.py against the JAX copy):

* **FIFO admission** — requests enter PREFILLING in submit order; a
  preempted request re-enters at the *front* of the queue, so overall
  completion order remains submit order under greedy decoding.
* **Token-budgeted prefill** — at most ``prefill_budget`` prompt tokens are
  processed per tick across all PREFILLING slots, in admission order, in
  chunks of at most ``prefill_chunk`` tokens; decode ticks for already-
  DECODING slots continue regardless (chunked prefill never starves decode).
* **Youngest-first preemption** — when the page pool cannot cover a
  mandatory allocation, the most recently admitted active request is
  preempted: its pages are freed in one step and its prompt *plus generated
  tokens* are requeued for recompute, so its visible output is unchanged
  (greedy decode is deterministic).
* **Row-budgeted verify** (speculative decoding, the JAX package's ``repro.spec``) — a
  speculative tick spends at most ``verify_budget`` verify rows (drafted
  tokens + one pending token per request) across all DECODING slots, in
  admission order; a request that gets no rows simply skips the tick.
  Per-request draft accounting (``spec_steps`` / ``draft_proposed`` /
  ``draft_accepted``) lives on :class:`Request`.
* **SLO-aware admission with bounded aging** — each request carries an SLO
  class: :data:`SLO_TTFT` (latency-sensitive; jumps the admission queue) or
  :data:`SLO_THROUGHPUT` (the default; plain FIFO).  Every time a waiting
  request is passed over by a later-submitted TTFT request its ``skips``
  counter grows; at ``starvation_limit`` it is force-admitted ahead of any
  TTFT traffic, so a throughput request waits at most ``starvation_limit``
  queue-jumps regardless of offered TTFT load (no livelock — tested in
  tests/test_server.py).  With a single class in play admission reduces to
  exact FIFO and no skips accumulate.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Tuple

# request lifecycle states
QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
DONE = "done"

# SLO classes (Request.slo)
SLO_TTFT = "ttft"              # latency-sensitive: priority admission
SLO_THROUGHPUT = "throughput"  # default: FIFO, protected by aging


@dataclasses.dataclass
class Request:
    """One generation request.  ``output`` accumulates generated tokens;
    ``done`` mirrors ``state == DONE`` for seed-engine API compatibility."""
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slo: str = SLO_THROUGHPUT     # admission class (SLO_TTFT jumps the queue)

    # -- scheduling state (engine/scheduler internal) --------------------
    state: str = QUEUED
    slot: int = -1
    skips: int = 0                # admissions that passed this request over
                                  #   while it waited (aging anti-starvation)
    prefill_pos: int = 0          # tokens of ``prefill_tokens()`` cached
    admit_seq: int = -1           # admission order; youngest = max
    preemptions: int = 0
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    # -- speculative-decoding state (unused by the port's plain engine) --
    spec_steps: int = 0           # verify steps run for this request
    draft_proposed: int = 0       # draft tokens proposed across all steps
    draft_accepted: int = 0       # ... of which the target model confirmed

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target verified (0 when the
        request never ran speculatively)."""
        return self.draft_accepted / max(self.draft_proposed, 1)

    def prefill_tokens(self) -> List[int]:
        """What must be in the KV cache before decode can proceed: the
        prompt, plus — after a preemption — every token generated so far
        (recompute-style preemption keeps outputs identical)."""
        return self.prompt + self.output

    @property
    def ttft(self) -> float:
        return (self.first_token_at - self.submitted_at
                if self.first_token_at else float("nan"))


class FifoScheduler:
    """Admission queue + per-tick prefill planning + preemption policy."""

    def __init__(self, *, prefill_chunk: int = 16,
                 prefill_budget: Optional[int] = None,
                 verify_budget: Optional[int] = None,
                 starvation_limit: int = 8):
        if prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be positive")
        if starvation_limit < 1:
            raise ValueError("starvation_limit must be >= 1")
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget or prefill_chunk
        # verify_budget caps the *verify rows* (drafted tokens + the pending
        # token, i.e. model positions) one speculative tick may spend across
        # all DECODING slots; None = every slot verifies at full spec_k.
        self.verify_budget = verify_budget
        # how many queue-jumps a waiting request tolerates before it is
        # force-admitted ahead of TTFT traffic (bounded-wait guarantee)
        self.starvation_limit = starvation_limit
        self.waiting: Deque[Request] = collections.deque()
        self._admit_seq = 0

    # -- queue ------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.state = QUEUED
        if not req.submitted_at:
            req.submitted_at = time.perf_counter()
        self.waiting.append(req)

    def requeue_preempted(self, req: Request) -> None:
        """Preempted requests go to the *front*: they were admitted before
        anything still waiting, so FIFO order is preserved."""
        req.state = QUEUED
        req.slot = -1
        req.prefill_pos = 0
        req.preemptions += 1
        self.waiting.appendleft(req)

    def _pick_next(self) -> Request:
        """Next request to admit: a starved request (skips at the limit)
        beats everything, then the oldest waiting TTFT-class request, then
        plain FIFO.  Requests the pick jumped over age one skip each —
        since only TTFT picks can jump, skips grow at most once per TTFT
        admission and the wait is bounded by ``starvation_limit``."""
        pick = None
        for r in self.waiting:
            if r.skips >= self.starvation_limit:
                pick = r
                break
        if pick is None:
            pick = next((r for r in self.waiting if r.slo == SLO_TTFT),
                        self.waiting[0])
        for r in self.waiting:
            if r is pick:
                break
            r.skips += 1
        self.waiting.remove(pick)
        return pick

    def admit(self, free_slots: List[int]) -> List[Tuple[int, Request]]:
        """Assign waiting requests to free slots, one per slot: FIFO within
        an SLO class, TTFT class first, aged-out requests before both
        (see :meth:`_pick_next`)."""
        placed = []
        for slot in free_slots:
            if not self.waiting:
                break
            req = self._pick_next()
            req.state = PREFILLING
            req.slot = slot
            req.prefill_pos = 0
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            placed.append((slot, req))
        return placed

    # -- per-tick plans ---------------------------------------------------
    def prefill_plan(self, prefilling: List[Request]) -> List[Tuple[Request, int]]:
        """(request, n_tokens) chunks for this tick, admission order, total
        capped at ``prefill_budget`` tokens."""
        plan = []
        budget = self.prefill_budget
        for req in sorted(prefilling, key=lambda r: r.admit_seq):
            if budget <= 0:
                break
            remaining = len(req.prefill_tokens()) - req.prefill_pos
            n = min(self.prefill_chunk, remaining, budget)
            if n > 0:
                plan.append((req, n))
                budget -= n
        return plan

    def verify_plan(self, decoding: List[Request],
                    spec_k: int) -> List[Tuple[Request, int]]:
        """(request, k) speculative verify chunks for this tick.

        Each DECODING request gets ``k <= spec_k`` drafted tokens to verify
        (plus its pending token — ``k + 1`` model positions).  ``k`` is
        additionally capped at ``max_new_tokens`` headroom: a verify step
        can emit at most ``k + 1`` tokens, so drafting past the remaining
        quota is wasted draft *and* wasted verify compute.  With a
        ``verify_budget``, rows are granted in admission order until the
        budget runs out; a request that cannot get even its pending row is
        deferred to the next tick (it simply does not decode this tick —
        outputs are unaffected, only latency).
        """
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        plan = []
        budget = (self.verify_budget if self.verify_budget is not None
                  else (spec_k + 1) * max(len(decoding), 1))
        for req in sorted(decoding, key=lambda r: r.admit_seq):
            if budget < 1:
                break
            remaining = req.max_new_tokens - len(req.output)
            k = max(0, min(spec_k, remaining - 1, budget - 1))
            plan.append((req, k))
            budget -= k + 1
        return plan

    def preemption_victim(self, active: List[Request],
                          exclude: Optional[Request] = None) -> Optional[Request]:
        """Youngest-admitted active request (LIFO preemption: the request
        that has consumed the least scheduler time loses its pages)."""
        pool = [r for r in active if r is not exclude]
        if not pool:
            return None
        return max(pool, key=lambda r: r.admit_seq)
