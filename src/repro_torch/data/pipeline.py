"""Deterministic, shard-aware synthetic token pipeline (a copy of the JAX
package's ``repro.data.pipeline``: numpy only, so its batches are the JAX
package's bit for bit; the train step moves them to the device).

Production shape: every (step, dp_shard) pair maps to a unique, reproducible
batch slice via a counter-based RNG (threefry on (seed, step, shard)) — no
filesystem dependence, no coordination; a restarted/rescaled job replays
exactly from its checkpointed cursor.  Host-side prefetch overlaps batch
synthesis with the device step.

The same interface fronts a memmapped token corpus (``TokenFileSource``) for
the examples that train on real bytes.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec


@dataclasses.dataclass
class DataCursor:
    """Checkpointable pipeline position."""
    step: int = 0
    seed: int = 0

    def to_dict(self):
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class SyntheticLMSource:
    """Counter-based random tokens with a learnable bigram structure so loss
    actually decreases in the examples (next token = f(prev) + noise)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng((self.seed, step))
        b, s = shape.global_batch, shape.seq_len
        text = s - (cfg.vision_tokens if cfg.family == "vlm" else 0)
        v = cfg.vocab_size
        # structured stream: x_{t+1} = (a*x_t + c) % v with token noise
        a = 31, 17
        start = rng.integers(0, v, size=(b, 1))
        seq = [start]
        for _ in range(text - 1):
            nxt = (seq[-1] * 31 + 17) % v
            seq.append(nxt)
        tokens = np.concatenate(seq, axis=1).astype(np.int32)
        noise = rng.random((b, text)) < 0.05
        tokens = np.where(noise, rng.integers(0, v, size=(b, text)), tokens)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        if cfg.family == "vlm":
            pad = np.zeros((b, cfg.vision_tokens), np.int32)
            labels = np.concatenate([pad, labels], axis=1)
        batch: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels.astype(np.int32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = rng.standard_normal(
                (b, cfg.vision_tokens, cfg.d_model), dtype=np.float32) * 0.02
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (b, cfg.encoder_frames, cfg.d_model), dtype=np.float32) * 0.02
        return batch


class TokenFileSource:
    """Memmapped uint16/uint32 token corpus, sharded round-robin."""

    def __init__(self, path: str, cfg: ModelConfig, shape: ShapeSpec,
                 dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.cfg, self.shape = cfg, shape

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s = self.shape.global_batch, self.shape.seq_len
        n = len(self.tokens) - (s + 1)
        idx = (np.arange(b) * 9973 + step * b) % n
        toks = np.stack([self.tokens[i:i + s + 1].astype(np.int32) for i in idx])
        toks = toks % self.cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Host-side prefetch thread: hides batch synthesis behind the step."""

    def __init__(self, source, cursor: DataCursor, depth: int = 2):
        self.source = source
        self.cursor = cursor
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._next_step = cursor.step
        self._thread.start()

    def _run(self):
        step = self._next_step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.cursor.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
