"""Fault-tolerant step-loop controller (a copy of the JAX package's
``repro.runtime.fault_tolerance``, over the port's checkpoints).

Responsibilities (all host-side policy — the pieces a real cluster agent
drives):

* **heartbeat**: a monotonically advancing (step, wall-time) record written
  after every step; an external watchdog treats a stale heartbeat as a
  hung/failed worker.
* **checkpoint/restart**: periodic async checkpoints; on a step failure the
  controller retries, and after ``max_retries`` restores the latest
  checkpoint and continues (simulated fault injection in tests).
* **straggler mitigation**: per-step wall-time EWMA + MAD outlier detection;
  a sustained straggle raises a re-plan signal (``on_straggle``).

The elastic re-mesh (``runtime/elastic.py`` in the JAX package) needs the
port's ``parallel/`` and is not here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..checkpoint import CheckpointManager
from ..data.pipeline import DataCursor


class FaultInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_steps=(), exc=RuntimeError):
        self.fail_steps = set(fail_steps)
        self.exc = exc
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_steps and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected fault at step {step}")


@dataclasses.dataclass
class StragglerDetector:
    """EWMA + MAD step-time outlier detection."""
    window: int = 32
    threshold: float = 3.0       # MADs above median = straggle
    sustained: int = 3           # consecutive outliers before re-plan

    def __post_init__(self):
        self.times = deque(maxlen=self.window)
        self.consecutive = 0

    def observe(self, dt: float) -> bool:
        """Returns True when a sustained straggle is detected."""
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            mad = sorted(abs(t - med) for t in self.times)[len(self.times) // 2]
            if dt > med + self.threshold * max(mad, 1e-6, 0.05 * med):
                self.consecutive += 1
            else:
                self.consecutive = 0
        self.times.append(dt)
        return self.consecutive >= self.sustained


class Heartbeat:
    def __init__(self, path: str):
        self.path = path

    def beat(self, step: int, **info):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(), **info}, f)
        os.rename(tmp, self.path)

    def read(self) -> Optional[Dict]:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            return json.load(f)

    def is_stale(self, timeout_s: float) -> bool:
        hb = self.read()
        return hb is None or (time.time() - hb["time"]) > timeout_s


@dataclasses.dataclass
class RunReport:
    steps_completed: int
    restarts: int
    retries: int
    straggle_events: int
    losses: list


class TrainController:
    """Wraps a step function with heartbeat / retry / restore / straggler
    policy.  ``state`` is any pytree holding (params, opt_state, ...)."""

    def __init__(
        self,
        step_fn: Callable,                # (state, batch, step) -> (state, metrics)
        ckpt: CheckpointManager,
        *,
        ckpt_every: int = 50,
        max_retries: int = 1,
        heartbeat_path: Optional[str] = None,
        injector: Optional[FaultInjector] = None,
        straggler: Optional[StragglerDetector] = None,
        on_straggle: Optional[Callable] = None,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.heartbeat = Heartbeat(heartbeat_path) if heartbeat_path else None
        self.injector = injector
        self.straggler = straggler or StragglerDetector()
        self.on_straggle = on_straggle

    def run(self, state: Any, source, cursor: DataCursor,
            num_steps: int) -> (Any, RunReport):
        restarts = retries = straggles = 0
        losses = []
        step = cursor.step
        end = step + num_steps
        while step < end:
            batch = source.batch_at(step)
            t0 = time.time()
            try:
                if self.injector:
                    self.injector.maybe_fail(step)
                state, metrics = self.step_fn(state, batch, step)
            except Exception:
                retries += 1
                if retries <= self.max_retries:
                    continue  # transient: retry same step
                # fatal: restore from latest checkpoint
                self.ckpt.wait()  # never race an in-flight async write
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                state, meta = self.ckpt.restore(latest, target=state)
                step = meta["cursor"]["step"]
                cursor.step = step
                restarts += 1
                retries = 0
                continue
            retries = 0
            dt = time.time() - t0
            losses.append(float(metrics.get("loss", 0.0)))
            if self.straggler.observe(dt):
                straggles += 1
                if self.on_straggle:
                    self.on_straggle(step, dt)
            if self.heartbeat:
                self.heartbeat.beat(step, loss=losses[-1])
            step += 1
            cursor.step = step
            if step % self.ckpt_every == 0:
                self.ckpt.save_async(step, state,
                                     metadata={"cursor": cursor.to_dict()})
        self.ckpt.wait()
        return state, RunReport(
            steps_completed=num_steps, restarts=restarts, retries=retries,
            straggle_events=straggles, losses=losses,
        )
