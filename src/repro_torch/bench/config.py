"""Block-configuration objects and the tuned-config JSON cache.

A copy of the JAX package's ``repro.bench.config``.  A :class:`BlockConfig`
is an immutable, hashable bag of integer parameters (``block_m``,
``chunk``, ...); a :class:`ConfigCache` persists tuned winners to JSON,
keyed ``kernel|shape_key|dtype|backend``.  The on-disk format is the JAX
package's (version 1), so a cache written there loads here::

    {
      "version": 1,
      "entries": {
        "apr_matmul|k4096_m4_n4096_resapr|bfloat16|cuda": {
          "config":  {"block_k": 128, "block_m": 16, "block_n": 64},
          "metrics": {"us": 30.1, "gflops": 4.5},
          "tuned_at": "2026-10-17T00:00:00"
        }
      }
    }

Two things differ from the JAX package: the backend is the device type of
the operands (``"cuda"`` or ``"cpu"``), and the process-wide default cache
is ``$REPRO_TORCH_TUNE_CACHE`` or ``src/repro_torch/_tune/tune_cache.json``
beside the package, so the port never reads the JAX package's
``~/.cache/repro/tune_cache.json``.

Resolution (:func:`resolve_config`) consults the *active* cache: the
innermost :func:`scoped_cache` on the current thread (each serve engine
scopes its own ``tune_cache`` around warm-up and every ``step()``), else the
process-wide default.  The kernel wrappers resolve through
:func:`resolve_cached`, which memoizes per cache, so a decode tick's
hundreds of launches pay one dictionary lookup each.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import threading
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Tuple

SCHEMA_VERSION = 1
_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_PATH = (Path(__file__).resolve().parent.parent / "_tune"
                / "tune_cache.json")


class TileError(ValueError):
    """A kernel wrapper refuses a configuration its kernel was not compiled
    for, before any launch.  The autotuner rejects such a candidate; every
    other error propagates."""


@dataclasses.dataclass(frozen=True, order=True)
class BlockConfig:
    """Immutable set of sweepable kernel parameters (tile/chunk sizes)."""

    items: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        # frozen dataclass: stash the lookup dict once
        object.__setattr__(self, "_map", dict(self.items))

    @classmethod
    def make(cls, **params: int) -> "BlockConfig":
        return cls(tuple(sorted(params.items())))

    @classmethod
    def from_dict(cls, d: Mapping[str, int]) -> "BlockConfig":
        return cls.make(**dict(d))

    def to_dict(self) -> Dict[str, int]:
        return dict(self._map)

    def get(self, key: str, default: Optional[int] = None) -> Optional[int]:
        return self._map.get(key, default)

    def __getitem__(self, key: str) -> int:
        return self._map[key]

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def replace(self, **params: int) -> "BlockConfig":
        merged = dict(self.items)
        merged.update(params)
        return BlockConfig.make(**merged)

    def __repr__(self) -> str:  # compact: BlockConfig(block_k=128, block_m=64)
        inner = ", ".join(f"{k}={v}" for k, v in self.items)
        return f"BlockConfig({inner})"


def cache_key(kernel: str, shape_key: str, dtype: str, backend: str) -> str:
    """Canonical ``kernel|shape|dtype|backend`` entry key."""
    return "|".join((kernel, shape_key, dtype, backend))


def shape_key_from_dims(**dims: int) -> str:
    """``m=256, k=512`` -> ``"k512_m256"`` (sorted for stability)."""
    return "_".join(f"{k}{v}" for k, v in sorted(dims.items()))


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``, the JAX package's dtype names."""
    return str(dtype).rsplit(".", 1)[-1]


class ConfigCache:
    """JSON-backed map of tuned :class:`BlockConfig` winners.

    Thread-safe; writes are whole-file atomic (tmp + rename).  Each cache
    also holds the memo of :func:`resolve_cached`, emptied whenever an
    entry changes.
    """

    def __init__(self, path: Optional[os.PathLike] = None, *,
                 autosave: bool = True):
        if path is None:
            path = os.environ.get(_ENV_VAR) or DEFAULT_PATH
        self.path = Path(path)
        self.autosave = autosave
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._memo: Dict[tuple, BlockConfig] = {}
        if self.path.exists():
            self.load()

    # -- persistence ------------------------------------------------------
    def load(self) -> None:
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return
        if raw.get("version") != SCHEMA_VERSION:
            return
        with self._lock:
            self._entries = dict(raw.get("entries", {}))
            self._memo = {}

    def save(self) -> None:
        with self._lock:
            payload = {"version": SCHEMA_VERSION, "entries": self._entries}
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
            os.replace(tmp, self.path)

    # -- entry access -----------------------------------------------------
    def lookup(self, kernel: str, shape_key: str, dtype: str,
               backend: str) -> Optional[BlockConfig]:
        entry = self._entries.get(cache_key(kernel, shape_key, dtype, backend))
        if not entry:
            return None
        return BlockConfig.from_dict(entry["config"])

    def store(self, kernel: str, shape_key: str, dtype: str, backend: str,
              config: BlockConfig,
              metrics: Optional[Mapping[str, float]] = None) -> None:
        entry = {
            "config": config.to_dict(),
            "metrics": dict(metrics or {}),
            "tuned_at": datetime.datetime.now().isoformat(timespec="seconds"),
        }
        with self._lock:
            self._entries[cache_key(kernel, shape_key, dtype, backend)] = entry
            self._memo = {}
        if self.autosave:
            self.save()

    def __len__(self) -> int:
        return len(self._entries)


_default_cache: Optional[ConfigCache] = None
_default_lock = threading.Lock()
_scope = threading.local()  # per-thread stack of scoped caches


def default_cache() -> ConfigCache:
    """Process-wide fallback cache (``$REPRO_TORCH_TUNE_CACHE`` or the
    package's ``_tune/tune_cache.json``); resolution consults it only when
    no scope is active."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = ConfigCache()
        return _default_cache


def set_default_cache(cache: Optional[ConfigCache]) -> None:
    """Swap the process-wide *fallback* cache (tests; ``None`` restores
    the env-derived default).  Engine-owned caches are scoped with
    :func:`scoped_cache` instead, so two engines with different
    ``tune_cache`` paths coexist."""
    global _default_cache
    with _default_lock:
        _default_cache = cache


class scoped_cache:
    """Context manager: make ``cache`` the active resolution cache on this
    thread for the dynamic extent of the block.  Scopes nest (innermost
    wins) and ``scoped_cache(None)`` is a no-op, so call sites can wrap
    unconditionally."""

    def __init__(self, cache: Optional["ConfigCache"]):
        self.cache = cache

    def __enter__(self):
        if self.cache is not None:
            if not hasattr(_scope, "stack"):
                _scope.stack = []
            _scope.stack.append(self.cache)
        return self.cache

    def __exit__(self, *exc):
        if self.cache is not None:
            _scope.stack.pop()
        return False


def active_cache() -> ConfigCache:
    """The cache config resolution uses *right now*: the innermost active
    :func:`scoped_cache`, else the process-wide default."""
    stack = getattr(_scope, "stack", None)
    if stack:
        return stack[-1]
    return default_cache()


def resolve_config(
    kernel: str,
    shape_key: str,
    dtype: str,
    backend: str,
    *,
    default: BlockConfig,
    override: Optional[BlockConfig] = None,
    explicit: Optional[Mapping[str, Optional[int]]] = None,
) -> BlockConfig:
    """Resolution order used by every ``ops.py`` wrapper.

    1. per-parameter ``explicit`` kwargs the caller pinned (non-None values),
    2. an ``override`` config object passed by the caller,
    3. the tuned winner in the active :class:`ConfigCache`,
    4. the kernel's shape-derived ``default`` heuristic.
    """
    base = default
    cached = active_cache().lookup(kernel, shape_key, dtype, backend)
    if cached is not None:
        base = base.replace(**cached.to_dict())
    if override is not None:
        base = base.replace(**override.to_dict())
    if explicit:
        pinned = {k: v for k, v in explicit.items() if v is not None}
        if pinned:
            base = base.replace(**pinned)
    return base


def resolve_cached(kernel: str, dims: tuple, dtype: str, backend: str, *,
                   shape_key: Callable[..., str],
                   default: Callable[..., BlockConfig]) -> BlockConfig:
    """:func:`resolve_config` without caller overrides, memoized in the
    active cache per ``(kernel, dims, dtype, backend)``: the shape key and
    the default are built from ``dims`` on the first call only."""
    cache = active_cache()
    key = (kernel, dims, dtype, backend)
    cfg = cache._memo.get(key)
    if cfg is None:
        cfg = resolve_config(kernel, shape_key(*dims), dtype, backend,
                             default=default(*dims))
        cache._memo[key] = cfg
    return cfg


def resolve_fixed(kernel: str, dims: tuple, dtype: str, backend: str, *,
                  shape_key: Callable[..., str], compiled: BlockConfig,
                  config: Optional[BlockConfig] = None) -> BlockConfig:
    """Resolution for a kernel compiled for one configuration: whatever
    resolves (``config``, a tuned entry or the default, ``compiled``) must
    be ``compiled``, or :class:`TileError` is raised before any launch."""
    if config is None:
        cfg = resolve_cached(kernel, dims, dtype, backend,
                             shape_key=shape_key,
                             default=lambda *_: compiled)
    else:
        cfg = resolve_config(kernel, shape_key(*dims), dtype, backend,
                             default=compiled, override=config)
    if cfg != compiled:
        raise TileError(f"{kernel}: {cfg} is not compiled; the kernel has "
                        f"one configuration, {compiled}")
    return cfg
