"""Sweep driver: time candidates, gate on correctness, persist the winner.

Port of the JAX package's ``repro.bench.autotune``.  For each candidate
:class:`~repro_torch.bench.config.BlockConfig` of a spec's
:class:`~repro_torch.bench.registry.TuneSpace`, :func:`autotune`

1. runs the family's wrapper once and compares it with the plain version
   (``numpy.allclose`` at the spec's tolerances, the relative one at least
   one bf16 rounding for a bf16 output): a candidate with wrong
   numbers is *rejected*, never timed, never cached.  A candidate the
   wrapper refuses (:class:`~repro_torch.bench.config.TileError`, raised
   before any launch) is rejected too; every other error -- a failed
   ``nvcc`` build, a CUDA error -- propagates;
2. times the survivor: the median and the min-max spread of ``iters``
   samples after ``warmup`` untimed calls (``$REPRO_TORCH_BENCH_ITERS`` /
   ``$REPRO_TORCH_BENCH_WARMUP`` override the defaults 3 / 1).  On the
   card a sample is CUDA events around ``CUDA_REPS`` back-to-back calls,
   with the stream held busy (longer than a warm-up call took the host)
   while the host enqueues them, after a ``torch.cuda.synchronize()``; on
   the CPU it is the host clock;
3. stores the fastest validated candidate in the :class:`ConfigCache`
   under ``kernel|shape|dtype|backend``, the backend being the device type
   of the operands.

``prune_top_k`` ranks the candidates with
:func:`repro_torch.cost.rank_candidates` on the device's hardware profile
and times only the cheapest-predicted K; the correctness gate still
applies to every timed candidate.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .config import BlockConfig, ConfigCache, TileError, active_cache
from .registry import KernelSpec, Shape

_ITERS_ENV = "REPRO_TORCH_BENCH_ITERS"
_WARMUP_ENV = "REPRO_TORCH_BENCH_WARMUP"
_DEFAULT_ITERS = 3
_DEFAULT_WARMUP = 1
#: calls per timed sample on the card.  The stream is held busy while the
#: host enqueues them -- per call, at least _FILL_CYCLES (~0.1 ms) and
#: _HOST_TO_CYCLES times the host seconds a warm-up call took (over 1.5x
#: that time at the card's ~2 GHz) -- so the events time the device's work
#: back to back and not the host's launch rate
CUDA_REPS = 10
_FILL_CYCLES = 2e5
_HOST_TO_CYCLES = 3e9


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default


def resolve_timing(iters: Optional[int] = None,
                   warmup: Optional[int] = None) -> Tuple[int, int]:
    """(iters, warmup) with explicit args > env overrides > defaults (3, 1)."""
    if iters is None:
        iters = _env_int(_ITERS_ENV, _DEFAULT_ITERS)
    if warmup is None:
        warmup = _env_int(_WARMUP_ENV, _DEFAULT_WARMUP)
    return max(1, iters), warmup


def time_stats(fn, *, iters: Optional[int] = None,
               warmup: Optional[int] = None,
               device=None) -> Tuple[float, float]:
    """(median, max-min spread) seconds per call of ``fn``.

    On a CUDA ``device`` each sample is CUDA events around ``CUDA_REPS``
    calls; otherwise the host clock around one call."""
    iters, warmup = resolve_timing(iters, warmup)
    cuda = device is not None and torch.device(device).type == "cuda"
    host = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host = max(host, time.perf_counter() - t0)
    samples = []
    if cuda:
        fill = CUDA_REPS * max(_FILL_CYCLES, _HOST_TO_CYCLES * host)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(iters):
            torch.cuda.synchronize()
            torch.cuda._sleep(int(fill))
            start.record()
            for _ in range(CUDA_REPS):
                fn()
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / CUDA_REPS)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    return float(np.median(samples)), float(max(samples) - min(samples))


def time_callable(fn, *, iters: Optional[int] = None,
                  warmup: Optional[int] = None, device=None) -> float:
    """Median seconds per call (see :func:`time_stats`)."""
    return time_stats(fn, iters=iters, warmup=warmup, device=device)[0]


@dataclasses.dataclass
class TuneResult:
    kernel: str
    shape_key: str
    dtype: str
    backend: str
    config: Optional[BlockConfig]     # None if every candidate failed the gate
    us: float                         # best median microseconds per call
    gflops: float                     # analytic FLOPs / best time
    hbm_bytes: int                    # analytic traffic at the best config
    n_candidates: int
    rejected: List[Tuple[BlockConfig, str]]  # (config, reason) for failures
    spread_us: float = 0.0            # max-min sample spread at the winner
    predicted_us: Optional[float] = None  # cost-model price of the winner
    n_timed: int = 0                  # candidates actually timed
    pruned_from: Optional[int] = None  # pre-pruning candidate count, if pruned

    @property
    def ok(self) -> bool:
        return self.config is not None


def _as_numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


#: relative tolerance floor for a bf16 output: kernel and plain version may
#: round the same fp32 value to adjacent bf16 values (2^-8 relative)
BF16_RTOL = 2.0 ** -7


def _validate(spec: KernelSpec, out, ref) -> Optional[str]:
    rtol = spec.rtol
    if torch.bfloat16 in (out.dtype, ref.dtype):
        rtol = max(rtol, BF16_RTOL)
    out = _as_numpy(out)
    ref = _as_numpy(ref)
    if out.shape != ref.shape:
        return f"shape {out.shape} != ref {ref.shape}"
    if not np.allclose(out, ref, rtol=rtol, atol=spec.atol):
        err = float(np.max(np.abs(out - ref)))
        return f"max abs err {err:.3e} exceeds rtol={rtol} atol={spec.atol}"
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def autotune(
    spec: KernelSpec,
    shape: Shape,
    *,
    dtype: str = "bfloat16",
    seed: int = 0,
    device="cuda",
    cache: Optional[ConfigCache] = None,
    max_candidates: Optional[int] = None,
    iters: Optional[int] = None,
    warmup: Optional[int] = None,
    validate: bool = True,
    prune_top_k: Optional[int] = None,
    profile=None,
) -> TuneResult:
    """Sweep ``spec``'s tune space for one (shape, dtype) on ``device``
    (default the card; raises without one unless ``device="cpu"``) and
    cache the winner under the device type as backend.

    With ``prune_top_k`` set, only the K cheapest candidates under the
    analytic cost model are timed; the correctness gate still applies to
    every timed candidate."""
    dev = resolve_device(device)
    backend = dev.type
    cache = cache if cache is not None else active_cache()
    shape_key = spec.shape_key(shape)

    args = spec.make_inputs(shape, dtype, seed, dev)
    ref = spec.ref(args) if validate else None

    candidates = spec.candidates(shape)
    if max_candidates is not None:
        candidates = candidates[:max_candidates]

    pruned_from: Optional[int] = None
    predicted: dict = {}
    if prune_top_k is not None:
        from ..cost import rank_candidates
        ranked = rank_candidates(spec, shape, candidates, profile=profile
                                 if profile is not None else
                                 _profile_for(dev), dtype=dtype)
        predicted = {cfg: est for cfg, est in ranked}
        if len(candidates) > prune_top_k:
            pruned_from = len(candidates)
            candidates = [cfg for cfg, _ in ranked[:prune_top_k]]

    best: Optional[BlockConfig] = None
    best_t = float("inf")
    best_spread = 0.0
    n_timed = 0
    rejected: List[Tuple[BlockConfig, str]] = []
    for cfg in candidates:
        try:
            out = spec.run(args, cfg)
        except TileError as exc:      # the wrapper refused the tile
            rejected.append((cfg, f"refused: {exc}"))
            continue
        _sync(dev)
        if validate:
            reason = _validate(spec, out, ref)
            if reason is not None:
                rejected.append((cfg, reason))
                continue
        t, spread = time_stats(lambda: spec.run(args, cfg), iters=iters,
                               warmup=warmup, device=dev)
        n_timed += 1
        if t < best_t:
            best, best_t, best_spread = cfg, t, spread

    gflops = 0.0
    traffic = 0
    predicted_us: Optional[float] = None
    if best is not None:
        gflops = spec.flops(shape) / best_t / 1e9
        traffic = spec.hbm_bytes(shape, best, dtype)
        est = predicted.get(best)
        if est is not None:
            predicted_us = est.predicted_us
        cache.store(spec.name, shape_key, dtype, backend, best,
                    metrics={"us": best_t * 1e6, "gflops": gflops})
    return TuneResult(
        kernel=spec.name, shape_key=shape_key, dtype=dtype, backend=backend,
        config=best, us=best_t * 1e6 if best is not None else float("inf"),
        gflops=gflops, hbm_bytes=traffic,
        n_candidates=len(candidates), rejected=rejected,
        spread_us=best_spread * 1e6 if best is not None else 0.0,
        predicted_us=predicted_us, n_timed=n_timed, pruned_from=pruned_from,
    )


def _profile_for(device: torch.device):
    from ..roofline.hw import get_profile
    return get_profile(device=device)


def warm_cache(
    kernels_and_shapes,
    *,
    dtype: str = "bfloat16",
    device="cuda",
    cache: Optional[ConfigCache] = None,
    sweep: bool = False,
    results: Optional[dict] = None,
    **tune_kwargs,
) -> dict:
    """Resolve (and optionally tune) configs for a list of (kernel, shape).

    With ``sweep=False`` (the default, used by the serve engines at
    start-up) this only *reads*: it reports which shapes already have
    tuned winners in the cache for ``device``'s backend.  With
    ``sweep=True`` it runs :func:`autotune` for every miss (on ``device``)
    and, when ``results`` is a dict, puts each :class:`TuneResult` there
    under the same key.  Returns ``{f"{kernel}|{shape_key}": BlockConfig |
    None}``."""
    from .registry import get_spec

    backend = torch.device(device).type
    cache = cache if cache is not None else active_cache()
    resolved = {}
    for kernel, shape in kernels_and_shapes:
        spec = get_spec(kernel)
        key = spec.shape_key(shape)
        cfg = cache.lookup(kernel, key, dtype, backend)
        if cfg is None and sweep:
            result = autotune(spec, shape, dtype=dtype, device=device,
                              cache=cache, **tune_kwargs)
            cfg = result.config
            if results is not None:
                results[f"{kernel}|{key}"] = result
        resolved[f"{kernel}|{key}"] = cfg
    return resolved
