"""Async streaming front end over the serving engine (a copy of the JAX
package's ``repro.serve.server``; it is framework-free asyncio).

:class:`AsyncServeFrontend` turns the tick-driven engines
(:class:`~repro_torch.serve.engine.PagedServeEngine` or the contiguous
:class:`~repro_torch.serve.engine.ServeEngine`) into an
asyncio server: callers ``await submit(...)`` and receive a
:class:`TokenStream` that yields tokens as the engine emits them, instead
of blocking until the whole batch drains.  This replaces the batch-drain
loop the first launcher shipped with: requests now arrive *while* the
engine runs, which is what makes SLO classes and the prefix cache earn
their keep (a TTFT-class request can jump the admission queue mid-flight;
a late request can attach KV pages that an earlier wave published).

Design: everything runs on one asyncio loop, no threads.  A single driver
task alternates ``engine.step()`` (host-blocking, device-synchronous — the
same tick the batch loop ran) with an ``await`` checkpoint, so submissions
and consumers interleave between ticks, never during one.  Because
submission and stepping never overlap, the engines need no locking and
keep their deterministic tick semantics — greedy outputs are identical to
feeding the same requests through ``run_until_drained()``.  When nothing
is queued or active the driver parks on an :class:`asyncio.Event` and
costs nothing until the next ``submit`` wakes it.

Streaming: after each tick the driver diffs every live request's
``output`` against what its stream has already delivered and pushes the
new tokens into that stream's queue (then a sentinel when the request
finishes).  Consumers iterate ``async for tok in stream`` — per-token
latency is one engine tick, not one request lifetime.

SLO classes ride on the scheduler (:data:`repro_torch.serve.scheduler.SLO_TTFT`
jumps the admission queue, :data:`~repro_torch.serve.scheduler.SLO_THROUGHPUT`
is FIFO with aged anti-starvation; see ``FifoScheduler._pick_next``), and
per-request metrics — TTFT, end-to-end latency, tokens, preemptions,
queue-jump count — are collected on :meth:`TokenStream.metrics` when the
stream ends.
"""
from __future__ import annotations

import asyncio
import itertools
import time
from typing import Dict, List, Optional

from .scheduler import SLO_THROUGHPUT, Request

_DONE = object()   # stream sentinel: the request finished


class TokenStream:
    """Per-request async token stream.

    ``async for tok in stream`` yields generated token ids as the engine
    produces them; iteration ends when the request finishes.  The
    underlying :class:`~repro_torch.serve.scheduler.Request` is exposed as
    ``.request`` for callers that want scheduling state mid-flight.
    """

    def __init__(self, request: Request):
        self.request = request
        self._queue: "asyncio.Queue" = asyncio.Queue()
        self._delivered = 0    # tokens pushed into the queue so far

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        tok = await self._queue.get()
        if tok is _DONE:
            raise StopAsyncIteration
        return tok

    async def drain(self) -> List[int]:
        """Collect the remaining tokens into a list (convenience for
        callers that don't need per-token streaming)."""
        return [tok async for tok in self]

    def metrics(self) -> Dict[str, object]:
        """Per-request serving metrics (meaningful once the stream ends)."""
        r = self.request
        return {
            "rid": r.rid,
            "slo": r.slo,
            "tokens": len(r.output),
            "ttft_s": round(r.ttft, 4) if r.first_token_at else None,
            "latency_s": (round(r.finished_at - r.submitted_at, 4)
                          if r.finished_at else None),
            "preemptions": r.preemptions,
            "queue_jumped": r.skips,
            "prefill_tokens": len(r.prompt),
        }


class AsyncServeFrontend:
    """Asyncio front end driving one serving engine.

    Works with any engine exposing ``submit(Request)`` / ``step()`` and the
    ``active`` state plus ``sched`` (paged engine) or ``pending`` (slot
    engine).
    Use as an async context manager, or call :meth:`start` / :meth:`stop`::

        async with AsyncServeFrontend(engine) as front:
            stream = await front.submit([1, 2, 3], max_new_tokens=16)
            async for tok in stream:
                ...
    """

    def __init__(self, engine):
        self.engine = engine
        self._streams: List[TokenStream] = []
        self._rid = itertools.count()
        self._wake = asyncio.Event()
        self._running = False
        self._driver: Optional["asyncio.Task"] = None

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> "AsyncServeFrontend":
        if self._driver is not None:
            raise RuntimeError("frontend already started")
        self._running = True
        self._driver = asyncio.get_running_loop().create_task(self._drive())
        return self

    async def stop(self) -> None:
        """Stop the driver after the current tick.  In-flight requests stay
        un-finished; their streams end with what was already delivered."""
        self._running = False
        self._wake.set()
        if self._driver is not None:
            await self._driver
            self._driver = None
        for stream in self._streams:   # unblock any waiting consumers
            stream._queue.put_nowait(_DONE)
        self._streams.clear()

    async def __aenter__(self) -> "AsyncServeFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- request intake ---------------------------------------------------
    async def submit(self, prompt: List[int], *, max_new_tokens: int = 32,
                     eos_id: Optional[int] = None,
                     slo: str = SLO_THROUGHPUT,
                     rid: Optional[int] = None) -> TokenStream:
        """Queue a generation request; returns its :class:`TokenStream`.
        Raises whatever the engine's ``submit`` raises (empty prompt,
        prompt larger than the page pool, ...) before anything is queued.
        """
        if self._driver is None:
            raise RuntimeError("frontend not started (use `async with` or "
                               "await start())")
        req = Request(rid=rid if rid is not None else next(self._rid),
                      prompt=list(prompt), max_new_tokens=max_new_tokens,
                      eos_id=eos_id, slo=slo)
        req.submitted_at = time.perf_counter()
        # safe between ticks: the driver only mutates engine state inside
        # step(), and this coroutine never runs concurrently with it
        self.engine.submit(req)
        stream = TokenStream(req)
        self._streams.append(stream)
        self._wake.set()
        return stream

    async def generate(self, prompt: List[int], **kw) -> List[int]:
        """Submit and drain in one call (non-streaming convenience)."""
        stream = await self.submit(prompt, **kw)
        return await stream.drain()

    # -- driver -----------------------------------------------------------
    def _has_work(self) -> bool:
        eng = self.engine
        if any(r is not None for r in eng.active):
            return True
        sched = getattr(eng, "sched", None)
        if sched is not None:                 # paged engine
            return bool(sched.waiting)
        return not eng.pending.empty()        # contiguous slot engine

    def _pump(self) -> None:
        """Push tokens emitted since the last tick into their streams."""
        live = []
        for stream in self._streams:
            req = stream.request
            for tok in req.output[stream._delivered:]:
                stream._queue.put_nowait(tok)
            stream._delivered = len(req.output)
            if req.done:
                stream._queue.put_nowait(_DONE)
            else:
                live.append(stream)
        self._streams = live

    async def _drive(self) -> None:
        while self._running:
            if self._has_work():
                self.engine.step()
                self._pump()
                # yield so submissions/consumers interleave between ticks
                await asyncio.sleep(0)
            else:
                self._wake.clear()
                if self._running and not self._has_work():
                    await self._wake.wait()
