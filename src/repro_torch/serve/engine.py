"""Paged continuous-batching serving engine, in PyTorch.

Port of the JAX package's ``repro.serve.engine`` for the attention
families (dense; moe: arctic, llama4; vlm: internvl2, on text tokens), the
recurrent (rwkv6, mamba2) and the hybrid (zamba2) families:
:class:`EngineMetrics`,
:class:`PagedServeEngine` with chunked prefill, preemption, the refcounted
prefix cache, bf16 or int8 KV pools and the recurrent-state pools behind a
:class:`~.state_cache.StateCache`, and the contiguous :class:`ServeEngine`
baseline.  The hooks the speculative engine (:mod:`repro_torch.spec`)
overrides are here too, and the graph-compiled steps of ``use_graph``; the
tensor-parallel branch of the JAX engine is not ported yet.

The host side (page allocator, state-slot allocator, scheduler, block
tables) is the same Python code as in the JAX package; the device side is
the model's KV page pools and state pools, written in place by every
forward, and COW / defrag / state-slot moves are in-place slice assignments
on those pools.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..bench.autotune import warm_cache
from ..bench.config import ConfigCache, scoped_cache
from ..models.paged_state import copy_kv_page, copy_state_slot
from ..models.registry import ModelBundle, check_params
from .paged_cache import OutOfPages, PagedKVCache
from .scheduler import DECODING, DONE, PREFILLING, FifoScheduler, Request
from .state_cache import TRASH_STATE, StateCache


@dataclasses.dataclass
class EngineMetrics:
    """Aggregate serving metrics, accumulated per tick by the engine."""
    ticks: int = 0
    requests_done: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    preemptions: int = 0
    prefill_calls: int = 0        # prefill-chunk forwards (B=1, T=chunk)
    decode_calls: int = 0         # decode-tick forwards (B=slots, T=1)
    prefill_time_s: float = 0.0   # device time inside prefill-chunk calls
    decode_time_s: float = 0.0    # device time inside decode-tick calls
    started_at: float = dataclasses.field(default_factory=time.perf_counter)
    ttfts: List[float] = dataclasses.field(default_factory=list)
    util_samples: List[float] = dataclasses.field(default_factory=list)
    # speculative decoding (repro_torch.spec); all zero on the plain engine
    spec_steps: int = 0           # verify steps, counted per participating
                                  #   request (a batched tick adds one per
                                  #   DECODING slot it verified)
    draft_proposed: int = 0       # draft tokens proposed across all steps
    draft_accepted: int = 0       # ... accepted by the target AND emitted
    draft_time_s: float = 0.0     # time spent producing draft proposals
    # prefix cache (prefix_sharing=True); hit/cow stay zero without it
    prefix_hit_tokens: int = 0    # prompt tokens whose KV came from the
                                  #   prefix cache instead of prefill
    prefix_hit_requests: int = 0  # admissions that matched a cached prefix
    cow_copies: int = 0           # device page copies from COW splits
    prompt_pages_logical: int = 0  # sum over admissions of the pages each
                                   #   prompt would cost without sharing
    prompt_pages_unique: int = 0   # net new physical pages prefill actually
                                   #   consumed (fresh + COW - dedup)

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.started_at

    @property
    def decode_tps(self) -> float:
        """Decode tokens per second of *decode device time* (phase-local,
        so prefill pressure and host scheduling don't dilute it)."""
        return self.decode_tokens / max(self.decode_time_s, 1e-9)

    @property
    def prefill_tps(self) -> float:
        """Prompt tokens per second of *prefill device time*."""
        return self.prefill_tokens / max(self.prefill_time_s, 1e-9)

    @property
    def mean_ttft(self) -> float:
        return float(np.mean(self.ttfts)) if self.ttfts else float("nan")

    @property
    def p50_ttft(self) -> float:
        return float(np.median(self.ttfts)) if self.ttfts else float("nan")

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target model verified."""
        return self.draft_accepted / max(self.draft_proposed, 1)

    @property
    def tokens_per_step(self) -> float:
        """Tokens emitted per verify step (1.0 would match plain decode;
        the speculative ceiling is spec_k + 1)."""
        return self.decode_tokens / max(self.spec_steps, 1)

    @property
    def spec_decode_tps(self) -> float:
        """Decode tokens per second *including* draft time -- the
        speculative throughput to compare against a plain engine's
        ``decode_tps`` (which has no draft phase)."""
        return self.decode_tokens / max(self.decode_time_s
                                        + self.draft_time_s, 1e-9)

    @property
    def effective_kv_multiplier(self) -> float:
        """Logical prompt pages served per physical page consumed -- the
        effective-KV-capacity multiplier prefix sharing buys."""
        return self.prompt_pages_logical / max(self.prompt_pages_unique, 1)

    @property
    def peak_page_utilization(self) -> float:
        return max(self.util_samples, default=0.0)

    @property
    def mean_page_utilization(self) -> float:
        return float(np.mean(self.util_samples)) if self.util_samples else 0.0

    def summary(self) -> Dict[str, float]:
        out = {
            "ticks": self.ticks,
            "requests_done": self.requests_done,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "preemptions": self.preemptions,
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "elapsed_s": self.elapsed,
            "prefill_time_s": self.prefill_time_s,
            "decode_time_s": self.decode_time_s,
            "prefill_tps": self.prefill_tps,
            "decode_tps": self.decode_tps,
            "mean_ttft_s": self.mean_ttft if self.ttfts else None,
            "p50_ttft_s": self.p50_ttft if self.ttfts else None,
            "peak_page_utilization": self.peak_page_utilization,
            "mean_page_utilization": self.mean_page_utilization,
        }
        if self.spec_steps:  # speculative fields only when spec ran
            out.update({
                "spec_steps": self.spec_steps,
                "draft_proposed": self.draft_proposed,
                "draft_accepted": self.draft_accepted,
                "draft_time_s": self.draft_time_s,
                "acceptance_rate": self.acceptance_rate,
                "tokens_per_step": self.tokens_per_step,
                "spec_decode_tps": self.spec_decode_tps,
            })
        if self.prefix_hit_requests or self.cow_copies:
            out.update({
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_hit_requests": self.prefix_hit_requests,
                "cow_copies": self.cow_copies,
                "prompt_pages_logical": self.prompt_pages_logical,
                "prompt_pages_unique": self.prompt_pages_unique,
                "effective_kv_multiplier": self.effective_kv_multiplier,
            })
        return out


class PagedServeEngine:
    """Continuous batching over a paged KV cache with chunked prefill.

    Device state: per-layer KV page pools (``bundle.init_paged_cache``),
    updated in place by ``bundle.decode_paged``: a slot-batched decode tick
    (B=slots, T=1) and a B=1 prefill-chunk step (T=``prefill_chunk``) share
    that one cache contract.  Host state: the page allocator
    (``PagedKVCache``) and the FIFO scheduler.

    The engine runs on ``device`` (default ``"cuda"``; it raises without a
    card unless ``device="cpu"`` is passed), which must be the bundle's.
    Phase times are read after ``torch.cuda.synchronize()``, so they hold
    the device's work and not only its enqueueing.

    ``prefix_sharing=True`` turns on the refcounted prefix cache: at admit
    the longest already-cached prefix of the prompt is attached read-only
    (prefill resumes after it), pages completed by prefill are published
    for later requests, and the first divergent write COW-splits its shared
    boundary page (:meth:`_sync_page_copies` copies it on the device pools).
    Greedy outputs are token-identical to a sharing-off engine.

    ``kv_dtype="int8"`` stores the KV pages as int8 with one fp32 scale per
    (page slot, kv head), quantized on write; with int8 weights
    (``bundle.quantize_params``) this is the int8 serving path.

    Recurrent families (rwkv6, mamba2) keep each sequence's fixed-size
    state in a pool of physical state slots (``bundle.init_paged_cache``'s
    state pools, slot axis 1) allocated by a :class:`StateCache` with a
    snapshot ring (one deep; ``spec_k + 1`` deep on the speculative engine,
    whose subclass sets ``spec_k`` before calling up); the block table of
    every forward is extended (:meth:`_tables`) with one state-read
    column and T state-write columns, and only a
    chunk's last real token writes the slot's state (the rest go to
    ``TRASH_STATE``).  The page allocator still ledgers their tokens; the
    hybrid (zamba2) also keeps its shared attention's K/V in the pages of
    those columns, so preemption, defrag and truncation move both kinds of
    storage.
    ``state_dtype="int8"`` stores the large state leaves int8 with
    per-(layer, slot, head) scales: lossy across steps, so not
    token-identity gated.  ``prefix_sharing`` is rejected for these
    families: a state is a running summary of its whole history, so a
    cached prefix cannot be attached mid-sequence.

    ``use_graph=True`` routes the chunked-prefill step *and* the T=1
    decode tick through the :mod:`repro_torch.graph` compiler: the paged
    decode contract is traced at the two fixed shapes on the engine's
    device, the fusion passes run (chosen by the :mod:`repro_torch.cost`
    model; ``graph_cost_model=False`` or ``$REPRO_TORCH_COST_MODEL=off``
    reverts to the fixed pipeline, and the chosen schedule persists in this
    engine's ``tune_cache``), and both steps run through the graph
    executor (``"kernel"`` on the card, where recognized epilogue clusters
    launch the fused kernels and a folded int8 head the int8 x int8 GEMM;
    ``"plain"`` on the CPU).  The dense family is served; the hybrid is
    refused with the JAX engine's ``ValueError``, the other families with
    a ``NotImplementedError``.  :meth:`graph_schedule_report` prints the
    cost model's audit.
    """

    def __init__(self, bundle: ModelBundle, params, *, device="cuda",
                 slots: int = 4, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefill_chunk: int = 16,
                 kv_dtype: str = "bfloat16",
                 state_dtype: str = "float32",
                 prefix_sharing: bool = False,
                 use_graph: bool = False,
                 graph_cost_model: Optional[bool] = None,
                 tune_cache: Optional[str] = None,
                 autotune_at_start: bool = False):
        self.device = resolve_device(device)
        if bundle.device != self.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"bundle's {bundle.device}")
        if use_graph and bundle.cfg.family == "hybrid":
            raise ValueError(
                "use_graph=True is unsupported for the hybrid family: "
                "cluster boundaries are compilation boundaries, and the "
                "interleaved f32 SSD update + bf16 attention is sensitive "
                "to cross-op FMA contraction — a 1-ulp f32 shift at a "
                "cluster cut can cross a bf16 rounding boundary and flip "
                "a greedy token, breaking the token-identity invariant; "
                "serve hybrids on the plain paged engine")
        if not bundle.supports_paged_serving:
            raise ValueError(
                f"{bundle.cfg.family!r} family has no paged KV cache or "
                "state pool; use the contiguous ServeEngine")
        if kv_dtype not in ("bfloat16", "float32", "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        if state_dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported state_dtype {state_dtype!r}")
        if prefix_sharing and bundle.supports_paged_state:
            raise ValueError(
                "prefix_sharing=True is unsupported for recurrent-state "
                "families: a state slot is a lossy running summary of its "
                "whole history, so a cached prefix's KV pages cannot be "
                "attached mid-sequence (there is no state to resume from)")
        check_params(params, self.device.type)
        self.bundle = bundle
        self.params = params
        self.slots = slots
        self.page_size = page_size
        if num_pages is None:
            num_pages = slots * max(256 // page_size, 1)
        # bound the block-table width (and with it the logical span every
        # gather attends over) to 256 tokens per request
        self.kv = PagedKVCache(slots=slots, num_pages=num_pages,
                               page_size=page_size,
                               max_pages_per_slot=min(
                                   num_pages, max(256 // page_size, 1)),
                               enable_sharing=prefix_sharing)
        self.prefix_sharing = prefix_sharing
        self.sched = FifoScheduler(prefill_chunk=prefill_chunk)
        self.prefill_chunk = prefill_chunk
        self.kv_dtype = kv_dtype
        self.state_dtype = state_dtype
        # recurrent-state slot pool: one current state per engine slot plus
        # a snapshot ring for truncate rollback (depth spec_k + 1 on the
        # speculative engine, whose subclass sets ``spec_k`` before this)
        self.state: Optional[StateCache] = (
            StateCache(slots=slots, ring_depth=getattr(self, "spec_k", 0) + 1)
            if bundle.supports_paged_state else None)
        # tuned-kernel plumbing: an explicit ``tune_cache`` is scoped to
        # this engine (warm-up and every step()); see scoped_cache
        self.tune_cache = (ConfigCache(tune_cache)
                           if tune_cache is not None else None)
        with scoped_cache(self.tune_cache):
            self.tuned_configs = warm_cache(
                self._decode_kernel_shapes(), dtype=bundle.cfg.dtype,
                device=self.device, sweep=autotune_at_start)
        self.cache = bundle.init_paged_cache(
            self.kv.pool_pages, page_size, kv_dtype=kv_dtype,
            state_slots=(self.state.pool_slots if self.state else 0),
            state_dtype=state_dtype)
        self.active: List[Optional[Request]] = [None] * slots
        self.last_tokens = np.zeros((slots,), np.int64)
        self.metrics = EngineMetrics()
        self.use_graph = use_graph
        # the graph-compiled steps; None: ``bundle.decode_paged``, looked up
        # at every forward
        self._prefill = self._decode_step = None
        if use_graph:
            # graph-compiled chunked prefill AND decode tick, each traced
            # once at the engine's fixed shapes -- (B=1, T=chunk) and
            # (B=slots, T=1) -- on the engine's device, fused, and run
            # cluster by cluster (repro_torch.graph.compiler); under this
            # engine's tune cache, so the cost model's schedules persist
            # next to the tuned kernel tiles
            from ..graph.compiler import (compile_decode_step,
                                          compile_prefill_step)
            width = self.kv.max_pages_per_slot
            with scoped_cache(self.tune_cache):
                self._prefill = compile_prefill_step(
                    bundle, params, self.cache, chunk=prefill_chunk,
                    table_width=width, cost_model=graph_cost_model)
                self._decode_step = compile_decode_step(
                    bundle, params, self.cache, slots=slots,
                    table_width=width, cost_model=graph_cost_model)

    def graph_schedule_report(self) -> str:
        """Human-readable cost-model schedule report for the graph-compiled
        steps (``launch.serve --explain``): one
        :meth:`~repro_torch.cost.ScheduleDecision.report` block per compiled
        step.  Empty when ``use_graph=False`` or the cost model was off."""
        blocks = []
        for label, step in (("prefill", self._prefill),
                            ("decode", self._decode_step)):
            ex = getattr(step, "executor", None)
            decision = getattr(ex, "schedule", None)
            if decision is not None:
                blocks.append(f"[{label}] {decision.report()}")
        return "\n".join(blocks)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    def _forward(self, tokens, lengths, counts, tables,
                 step=None) -> torch.Tensor:
        """One forward through ``step`` (the prefill tick passes its own
        under ``use_graph``), else the graph-compiled decode tick, else the
        bundle's ``decode_paged``."""
        step = step or self._decode_step or self.bundle.decode_paged
        return step(self.params, self.cache, self._to_device(tokens),
                    self._to_device(lengths), self._to_device(counts),
                    self._to_device(tables))

    def _tables(self, rows, write_ids=None) -> np.ndarray:
        """Block-table rows for a forward over engine slots ``rows``: the KV
        page table, extended on state engines with each row's state read id
        and the caller-built ``(len(rows), T)`` write-id columns
        (``TRASH_STATE`` for padded or inactive positions)."""
        kv_rows = self.kv.block_tables[list(rows)]
        if self.state is None:
            return kv_rows
        reads = np.array([[self.state.read_id(s)] for s in rows], np.int32)
        return np.concatenate(
            [kv_rows, reads, np.asarray(write_ids, np.int32)], axis=1)

    def _decode_kernel_shapes(self):
        """Kernel shapes the paged decode path runs: paged decode attention
        over the slot batch (attention families; the ``kv_int8`` variant
        for an int8 cache) and the slot-batch GEMM, as the JAX engine
        lists them."""
        cfg = self.bundle.cfg
        shapes = []
        if not cfg.is_attention_free:
            attn_shape = {"b": self.slots, "hq": cfg.num_heads,
                          "hkv": cfg.num_kv_heads,
                          "d": cfg.resolved_head_dim,
                          "pages": self.kv.max_pages_per_slot,
                          "ps": self.page_size}
            if self.kv_dtype == "int8":
                attn_shape["kv_int8"] = 1
            shapes.append(("flash_decode_paged", attn_shape))
        shapes.append(("apr_matmul", {"m": self.slots, "k": cfg.d_model,
                                      "n": cfg.d_ff or cfg.d_inner}))
        return shapes

    def kv_pool_bytes(self) -> int:
        """Bytes held by the device cache pools: KV pages, recurrent-state
        pools and any int8 scale pools -- the footprint ``kv_dtype="int8"``
        and ``state_dtype="int8"`` shrink."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    # -- public API -------------------------------------------------------
    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt (generation needs at "
                "least one conditioning token, e.g. a BOS id)")
        need = len(req.prompt) + req.max_new_tokens
        cap = min(self.kv.max_tokens_per_slot(),
                  self.kv.num_pages * self.page_size)
        if need > cap:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {need} tokens exceeds "
                f"per-request capacity {cap} (pages are exhausted even with "
                "every other request preempted)")
        self.sched.submit(req)

    def step(self) -> int:
        """One engine tick: admit, chunked prefill (token-budgeted), one
        batched decode for all DECODING slots, under this engine's tuned
        configurations.  Returns active requests."""
        with scoped_cache(self.tune_cache):
            self._admit()
            self._prefill_tick()
            self._decode_tick()
        self.metrics.ticks += 1
        self.metrics.util_samples.append(self.kv.utilization())
        return sum(r is not None for r in self.active)

    def run_until_drained(self, max_ticks: int = 10_000) -> EngineMetrics:
        for _ in range(max_ticks):
            n = self.step()
            if n == 0 and not self.sched.waiting:
                break
        return self.metrics

    # -- tick phases ------------------------------------------------------
    def _active_requests(self) -> List[Request]:
        return [r for r in self.active if r is not None]

    def _admit(self) -> None:
        # gate on available pages (free + lazily-evictable prefix cache) so
        # a freshly-preempted request is not bounced straight back into the
        # pool that just evicted it
        if self.kv.available_pages == 0:
            return
        free = [i for i, r in enumerate(self.active) if r is None]
        for slot, req in self.sched.admit(free):
            self.active[slot] = req
            toks = req.prefill_tokens()
            self.metrics.prompt_pages_logical += self.kv.pages_for(len(toks))
            if self.prefix_sharing:
                # attach the longest cached prefix; prefill resumes after it
                matched = self.kv.match_prefix(slot, toks)
                if matched:
                    req.prefill_pos = matched
                    self.metrics.prefix_hit_tokens += matched
                    self.metrics.prefix_hit_requests += 1
            if self.state is not None:
                self.state.alloc(slot)
            self._on_admit(slot, req)

    def _on_admit(self, slot: int, req: Request) -> None:
        """Placement hook for subclasses (the speculative engine notifies
        its draft proposer here); the base engine needs nothing."""

    def _preempt(self, req: Request) -> None:
        self.kv.free_slot(req.slot)
        if self.state is not None:
            self.state.free_slot(req.slot)
        self.active[req.slot] = None
        self.sched.requeue_preempted(req)
        self.metrics.preemptions += 1

    def _ensure_pages(self, req: Request, n_tokens: int) -> bool:
        """Grow ``req``'s slot to hold ``n_tokens``, preempting the youngest
        active request (possibly ``req`` itself) until the pool covers it.
        Returns False if ``req`` was preempted or nothing could be freed."""
        while True:
            try:
                self.kv.allocate(req.slot, n_tokens)
                return True
            except OutOfPages:
                victim = self.sched.preemption_victim(self._active_requests())
                if victim is None:
                    return False
                self._preempt(victim)
                if victim is req:
                    return False

    def _sync_page_copies(self) -> None:
        """Copy queued COW page splits on the device pools.  Must run after
        any host-side ``allocate`` and before the next forward."""
        for src, dst in self.kv.pop_page_copies():
            copy_kv_page(self.cache, src, dst)
            self.metrics.cow_copies += 1

    def _sync_state_copies(self) -> None:
        """Mirror queued state-slot copies (truncate restores, snapshot
        materialisations, defrag moves) onto the device state pools, in
        queue order -- the StateCache sequences them so earlier copies see
        the layout they were queued against."""
        if self.state is None:
            return
        for src, dst in self.state.pop_state_copies():
            copy_state_slot(self.cache, src, dst)

    def _truncate_slot(self, slot: int, n_tokens: int) -> None:
        """Roll one engine slot back (or commit it forward) to ``n_tokens``
        across both residency domains: the KV page suffix is dropped and
        the recurrent state restored from its ring checkpoint before any
        later forward can read either."""
        self.kv.truncate(slot, n_tokens)
        if self.state is not None:
            self.state.truncate(slot, n_tokens)
            self._sync_state_copies()

    def defrag(self) -> int:
        """Compact the page pool -- and on state engines the state-slot
        pool -- host tables and device pools in lockstep; returns the
        number of device moves."""
        moves = self.kv.defrag()
        for src, dst in moves:
            copy_kv_page(self.cache, src, dst)
        n = len(moves)
        if self.state is not None:
            n += len(self.state.defrag())
            self._sync_state_copies()
        return n

    def _net_unique_pages(self) -> int:
        s = self.kv.stats
        return s["fresh_pages"] + s["cow_splits"] - s["dedup_reclaimed"]

    def _prefill_tick(self) -> None:
        prefilling = [r for r in self._active_requests()
                      if r.state == PREFILLING]
        unique0 = self._net_unique_pages()
        for req, n in self.sched.prefill_plan(prefilling):
            if self.active[req.slot] is not req:
                continue  # preempted earlier this tick by a sibling's alloc
            toks_all = req.prefill_tokens()
            if not self._ensure_pages(req, req.prefill_pos + n):
                continue
            self._sync_page_copies()
            chunk = toks_all[req.prefill_pos:req.prefill_pos + n]
            padded = chunk + [0] * (self.prefill_chunk - n)
            write_ids = None
            if self.state is not None:
                # only the chunk's last real token needs its state kept --
                # the forward carries state across tokens itself, so the
                # intermediate (and padded) positions write to the sink
                write_ids = np.full((1, self.prefill_chunk), TRASH_STATE,
                                    np.int32)
                write_ids[0, n - 1] = self.state.cur(req.slot)
            self._sync()
            t0 = time.perf_counter()
            logits = self._forward([padded], [req.prefill_pos], [n],
                                   self._tables([req.slot], write_ids),
                                   step=self._prefill)
            self._sync()
            self.metrics.prefill_time_s += time.perf_counter() - t0
            self.metrics.prefill_calls += 1
            req.prefill_pos += n
            self.kv.commit(req.slot, req.prefill_pos)
            if self.state is not None:
                self.state.commit(req.slot, req.prefill_pos)
            if self.prefix_sharing:
                # publish completed pages so siblings (and later waves) can
                # share them
                self.kv.register_prefix(req.slot, toks_all)
            self.metrics.prefill_tokens += n
            if req.prefill_pos == len(toks_all):
                # prompt (+ recompute suffix) fully cached: the last real
                # row of this chunk's logits is the next-token distribution
                nxt = int(torch.argmax(logits[0, n - 1]))
                if not req.first_token_at:
                    req.first_token_at = time.perf_counter()
                    self.metrics.ttfts.append(req.ttft)
                req.output.append(nxt)
                self.last_tokens[req.slot] = nxt
                req.state = DECODING
                self._maybe_finish(req, nxt)
        self.metrics.prompt_pages_unique += (self._net_unique_pages()
                                             - unique0)

    def _decode_tick(self) -> None:
        # oldest first, so page pressure evicts the youngest (LIFO) and the
        # head of the FIFO line always makes progress
        decoding = sorted(
            (r for r in self._active_requests() if r.state == DECODING),
            key=lambda r: r.admit_seq)
        for req in decoding:
            self._ensure_pages(req, self.kv.length(req.slot) + 1)
        self._sync_page_copies()
        decoding = [r for r in self._active_requests() if r.state == DECODING]
        if not decoding:
            return
        lengths = [self.kv.length(s) for s in range(self.slots)]
        counts = np.zeros((self.slots,), np.int32)
        for r in decoding:
            counts[r.slot] = 1
        write_ids = None
        if self.state is not None:
            write_ids = np.full((self.slots, 1), TRASH_STATE, np.int32)
            for r in decoding:
                write_ids[r.slot, 0] = self.state.cur(r.slot)
        self._sync()
        t0 = time.perf_counter()
        logits = self._forward(self.last_tokens[:, None], lengths, counts,
                               self._tables(range(self.slots), write_ids))
        self._sync()
        self.metrics.decode_time_s += time.perf_counter() - t0
        self.metrics.decode_calls += 1
        next_tokens = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for req in decoding:
            self.kv.commit(req.slot, self.kv.length(req.slot) + 1)
            if self.state is not None:
                self.state.commit(req.slot, self.kv.length(req.slot))
            tok = int(next_tokens[req.slot])
            req.output.append(tok)
            self.last_tokens[req.slot] = tok
            self.metrics.decode_tokens += 1
            self._maybe_finish(req, tok)

    def _maybe_finish(self, req: Request, tok: int) -> None:
        if (req.eos_id is not None and tok == req.eos_id) or \
           len(req.output) >= req.max_new_tokens:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        # the request's KV working set (and its state slot and checkpoint)
        # flushes back to the pool in one step
        self.kv.free_slot(req.slot)
        if self.state is not None:
            self.state.free_slot(req.slot)
        self.active[req.slot] = None
        req.state = DONE
        req.done = True
        req.finished_at = time.perf_counter()
        self.metrics.requests_done += 1


class ServeEngine:
    """Contiguous slot engine: one ``slots x max_seq`` bf16 KV cache (or,
    for the recurrent families, one decode carry of ``slots`` rows; for
    the hybrid, both; for the audio family, the self-attention cache and
    the cross K/V of ``encoder_frames`` frames, which stay the zeros of
    ``init_cache``: no frames reach the engine, as in the JAX package),
    prefill-on-admit *through the decode path*, token by token.

    The numerics reference the paged engine must match token for token.
    Device state: the cache (``bundle.init_cache``), updated by
    ``bundle.decode_step`` (B = slots, T = 1); host state: per-slot lengths
    and last tokens.  Runs on ``device`` (default ``"cuda"``; it raises
    without a card unless ``device="cpu"``), which must be the bundle's.
    """

    def __init__(self, bundle: ModelBundle, params, *, device="cuda",
                 slots: int = 4, max_seq: int = 256,
                 tune_cache: Optional[str] = None,
                 autotune_at_start: bool = False):
        self.device = resolve_device(device)
        if bundle.device != self.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"bundle's {bundle.device}")
        check_params(params, self.device.type)
        self.bundle = bundle
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        # tuned-kernel plumbing, as in PagedServeEngine
        self.tune_cache = (ConfigCache(tune_cache)
                           if tune_cache is not None else None)
        with scoped_cache(self.tune_cache):
            self.tuned_configs = warm_cache(
                self._decode_kernel_shapes(), dtype=bundle.cfg.dtype,
                device=self.device, sweep=autotune_at_start)
        self.cache = bundle.init_cache(slots, max_seq)
        self.lengths = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self.last_tokens = np.zeros((slots, 1), np.int32)

    def _decode_kernel_shapes(self):
        """Kernel shapes this engine's decode path runs: batched decode
        attention over the whole slot batch and the slot-batch GEMM, as the
        JAX engine lists them."""
        cfg = self.bundle.cfg
        return [
            ("flash_decode", {"b": self.slots, "hq": cfg.num_heads,
                              "hkv": cfg.num_kv_heads,
                              "d": cfg.resolved_head_dim,
                              "s": self.max_seq}),
            ("apr_matmul", {"m": self.slots, "k": cfg.d_model,
                            "n": cfg.d_ff or cfg.d_inner}),
        ]

    def _decode(self, tokens: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        return self.bundle.decode_step(
            self.params, self.cache,
            torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(lengths)).to(self.device))

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt (generation needs at "
                "least one conditioning token, e.g. a BOS id)")
        if len(req.prompt) >= self.max_seq:
            raise ValueError(f"request {req.rid}: prompt of "
                             f"{len(req.prompt)} tokens does not fit "
                             f"max_seq {self.max_seq}")
        if not req.submitted_at:
            req.submitted_at = time.perf_counter()
        self.pending.put(req)

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is not None or self.pending.empty():
                continue
            req = self.pending.get()
            # prefill by decoding the prompt token by token into this slot,
            # over the whole slot batch; the slot's length is reset first,
            # so a reused slot never attends over the previous request's KV
            # (stale entries past the new length are masked and overwritten
            # as the request grows).  The other rows rewrite their pending
            # token at their own length, which their next tick writes again.
            stateful = self.bundle.supports_paged_state
            if stateful:
                # a recurrent state is a running summary, not masked by
                # lengths: the slot starts from zeros, and the prompt loop
                # below advances every row's recurrence, so the other rows
                # are restored once at the end (rows are independent in
                # decode, so that is exact).  The loop runs on clones --
                # decode_step replaces the state tensors and writes the
                # hybrid's KV caches in place -- so ``keep`` still holds
                # every leaf as it was.
                keep = dict(self.cache)
                for k, a in keep.items():
                    self.cache[k] = a.clone()
                    self.cache[k][:, slot] = 0
            lengths = self.lengths.copy()
            lengths[slot] = 0
            for tok in req.prompt:
                toks = self.last_tokens.copy()
                toks[slot, 0] = tok
                logits = self._decode(toks, lengths)
                lengths[slot] += 1
            if stateful:
                for k, a in keep.items():
                    a[:, slot] = self.cache[k][:, slot]
                    self.cache[k] = a
            self.lengths = lengths
            nxt = int(torch.argmax(logits[slot, -1]))
            if not req.first_token_at:
                req.first_token_at = time.perf_counter()
            req.output.append(nxt)
            self.last_tokens[slot, 0] = nxt
            self.active[slot] = req

    def step(self) -> int:
        """One engine tick: admit new requests, one decode for all slots,
        under this engine's tuned configurations.  Returns the number of
        active requests."""
        with scoped_cache(self.tune_cache):
            return self._step()

    def _step(self) -> int:
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        logits = self._decode(self.last_tokens, self.lengths)
        next_tokens = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.lengths[slot] += 1
            tok = int(next_tokens[slot])
            req.output.append(tok)
            self.last_tokens[slot, 0] = tok
            if (req.eos_id is not None and tok == req.eos_id) or \
               len(req.output) >= req.max_new_tokens or \
               int(self.lengths[slot]) >= self.max_seq - 1:
                req.done = True
                req.finished_at = time.perf_counter()
                self.active[slot] = None
        return sum(r is not None for r in self.active)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            n = self.step()
            if n == 0 and self.pending.empty():
                return
