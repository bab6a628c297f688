"""Port parity, the async streaming front end (``repro_torch.serve.server``)
and SLO-aware admission: the 13 cases of the JAX package's
``tests/test_server.py`` on the port, each case that takes a paged engine
run on the port's plain ``PagedServeEngine`` and on its
``SpeculativeServeEngine`` (n-gram draft).

* ``TestSloAdmission`` -- host-side scheduler policy (the port's copy of
  the scheduler): TTFT-class priority, the aged anti-starvation bound and
  the single-class degeneration to exact FIFO.
* ``TestAsyncFrontend`` -- the asyncio server over the port's smoke
  llama3-8b on the CPU: per-token streaming, batch-loop token identity,
  deterministic SLO admission order, idle park and wake, early stop,
  per-request metrics, and the contiguous slot engine through the same
  duck-typed driver.
"""
import asyncio

import pytest

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import (SLO_THROUGHPUT, SLO_TTFT, AsyncServeFrontend,
                               FifoScheduler, PagedServeEngine, Request,
                               ServeEngine)
from repro_torch.spec import SpeculativeServeEngine

ENGINES = {"plain": PagedServeEngine, "spec": SpeculativeServeEngine}


def _req(rid, slo=SLO_THROUGHPUT):
    return Request(rid=rid, prompt=[1], max_new_tokens=4, slo=slo)


class TestSloAdmission:
    def test_ttft_jumps_the_queue(self):
        s = FifoScheduler(prefill_chunk=4)
        slow, fast = _req(0), _req(1, SLO_TTFT)
        s.submit(slow)
        s.submit(fast)
        (_, first), = s.admit([0])
        assert first is fast
        assert slow.skips == 1                  # the jump aged the waiter

    def test_throughput_wait_is_bounded(self):
        """Under saturating TTFT load a throughput request is force-admitted
        after exactly ``starvation_limit`` queue-jumps — no livelock."""
        limit = 3
        s = FifoScheduler(prefill_chunk=4, starvation_limit=limit)
        slow = _req(-1)
        s.submit(slow)
        admitted = []
        for i in range(2 * limit):              # always a TTFT rival waiting
            s.submit(_req(i, SLO_TTFT))
            (_, req), = s.admit([0])
            admitted.append(req)
        assert admitted.index(slow) == limit
        # the rivals it jumped still drain afterwards, in FIFO order
        assert [r.rid for r in admitted[limit + 1:]] == [limit, limit + 1]

    def test_single_class_is_exact_fifo(self):
        s = FifoScheduler(prefill_chunk=4)
        reqs = [_req(i) for i in range(5)]
        for r in reqs:
            s.submit(r)
        order = []
        while s.waiting:
            order.extend(r for _, r in s.admit([0]))
        assert order == reqs
        assert all(r.skips == 0 for r in reqs)  # no aging without jumps

    def test_ttft_class_is_fifo_within_itself(self):
        s = FifoScheduler(prefill_chunk=4)
        a, b = _req(0, SLO_TTFT), _req(1, SLO_TTFT)
        s.submit(a)
        s.submit(b)
        assert [r for _, r in s.admit([0, 1])] == [a, b]

    def test_starvation_limit_validated(self):
        with pytest.raises(ValueError, match="starvation_limit"):
            FifoScheduler(prefill_chunk=4, starvation_limit=0)


# --------------------------------------------------------------- async server
@pytest.fixture(scope="module")
def llama():
    bundle = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    return bundle, bundle.init_params()


@pytest.fixture(params=sorted(ENGINES))
def paged(request, llama):
    """A maker of the port's paged engine of one kind, on the CPU."""
    bundle, params = llama

    def make(**kw):
        kw.setdefault("slots", 2)
        return ENGINES[request.param](bundle, params, device="cpu",
                                      page_size=8, num_pages=16,
                                      prefill_chunk=8, **kw)
    return make


def _prompt(i, n=5):
    return [1 + i] + [2] * (n - 1)


class TestAsyncFrontend:
    def test_streams_tokens_before_request_finishes(self, paged):
        async def go():
            async with AsyncServeFrontend(paged()) as front:
                stream = await front.submit(_prompt(0), max_new_tokens=6)
                first = await stream.__anext__()
                # per-token latency is one tick, not one request lifetime
                assert not stream.request.done
                rest = await stream.drain()
                return [first] + rest
        out = asyncio.run(go())
        assert len(out) == 6

    def test_outputs_identical_to_batch_drain_loop(self, paged):
        prompts = [_prompt(i) for i in range(4)]

        eng = paged()
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        batch_out = [r.output for r in reqs]

        async def go():
            async with AsyncServeFrontend(paged()) as front:
                streams = [await front.submit(p, max_new_tokens=6)
                           for p in prompts]
                return [await s.drain() for s in streams]
        assert asyncio.run(go()) == batch_out

    def test_ttft_request_admitted_first_and_none_starve(self, paged):
        # submit() never yields to the event loop, so all four requests are
        # queued before the driver's first tick: with one slot, admission
        # order is fully determined by the SLO policy
        async def go():
            eng = paged(slots=1)
            async with AsyncServeFrontend(eng) as front:
                slow = [await front.submit(_prompt(i), max_new_tokens=4)
                        for i in range(3)]
                fast = await front.submit(_prompt(9), max_new_tokens=4,
                                          slo=SLO_TTFT)
                await asyncio.gather(fast.drain(), *(s.drain() for s in slow))
                return fast, slow
        fast, slow = asyncio.run(go())
        assert fast.request.admit_seq == 0      # jumped all three
        assert [s.request.admit_seq for s in slow] == [1, 2, 3]
        assert all(s.request.done for s in [fast] + slow)
        assert fast.metrics()["queue_jumped"] == 0
        assert all(s.metrics()["queue_jumped"] == 1 for s in slow)

    def test_driver_parks_idle_and_wakes_on_submit(self, paged):
        async def go():
            async with AsyncServeFrontend(paged()) as front:
                first = await (await front.submit(_prompt(0),
                                                  max_new_tokens=4)).drain()
                # engine fully drained: the driver is parked on its event;
                # a fresh submission must wake it
                await asyncio.sleep(0)
                second = await front.generate(_prompt(1), max_new_tokens=4)
                return first, second
        first, second = asyncio.run(go())
        assert len(first) == 4 and len(second) == 4

    def test_stop_ends_streams_with_partial_output(self, paged):
        async def go():
            front = await AsyncServeFrontend(paged()).start()
            stream = await front.submit(_prompt(0), max_new_tokens=64)
            got = [await stream.__anext__()]    # wait for the first token
            await front.stop()                  # shut down mid-request
            got += await stream.drain()         # ends on the stop sentinel
            return stream, got
        stream, got = asyncio.run(go())
        assert 1 <= len(got) < 64
        assert got == stream.request.output[:len(got)]

    def test_request_metrics_populated(self, paged):
        async def go():
            async with AsyncServeFrontend(paged()) as front:
                stream = await front.submit(_prompt(0), max_new_tokens=5)
                await stream.drain()
                return stream.metrics()
        m = asyncio.run(go())
        assert m["tokens"] == 5 and m["prefill_tokens"] == 5
        assert m["slo"] == SLO_THROUGHPUT
        assert m["ttft_s"] > 0 and m["latency_s"] >= m["ttft_s"]
        assert m["preemptions"] == 0

    def test_submit_requires_started_frontend(self, paged):
        async def go():
            front = AsyncServeFrontend(paged())
            with pytest.raises(RuntimeError, match="not started"):
                await front.submit(_prompt(0))
        asyncio.run(go())

    def test_drives_contiguous_slot_engine(self, llama):
        bundle, params = llama

        async def go():
            eng = ServeEngine(bundle, params, device="cpu", slots=2,
                              max_seq=32)
            async with AsyncServeFrontend(eng) as front:
                return await asyncio.gather(
                    front.generate(_prompt(0), max_new_tokens=4),
                    front.generate(_prompt(1), max_new_tokens=4))
        outs = asyncio.run(go())
        assert [len(o) for o in outs] == [4, 4]
