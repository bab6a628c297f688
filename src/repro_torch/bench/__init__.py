"""``repro_torch.bench`` -- the kernel tuning layer.

Port of the JAX package's ``repro.bench``:

* :mod:`.config` -- :class:`BlockConfig` and the JSON :class:`ConfigCache`
  of tuned winners keyed ``kernel|shape|dtype|backend`` (backend ``cuda``
  or ``cpu``); every kernel wrapper resolves its tiles through it
  (:func:`resolve_cached`), so a tuned cache retunes every call site.
* :mod:`.registry` -- :class:`KernelSpec` / :class:`TuneSpace`: each family
  registers its runner, its plain version and the configurations its CUDA
  kernel is compiled for (:mod:`.specs` holds the built-in families).
* :mod:`.autotune` -- the sweep driver: times every candidate on the card
  with CUDA events, rejects candidates whose output differs from the plain
  version, persists the winner; :func:`warm_cache` is what the serve
  engines call at start-up.

Usage::

    from repro_torch.bench import ConfigCache, autotune, get_spec
    res = autotune(get_spec("apr_matmul"), {"m": 4, "k": 4096, "n": 4096},
                   cache=ConfigCache("/tmp/tune.json"))   # on the card
    print(res.config, res.us)

On the CPU pass ``device="cpu"``: the wrappers then run their plain
versions, so the sweep exercises the plumbing and not a kernel.
"""
from .config import (  # noqa: F401
    BlockConfig,
    ConfigCache,
    TileError,
    active_cache,
    cache_key,
    default_cache,
    resolve_cached,
    resolve_config,
    resolve_among,
    scoped_cache,
    set_default_cache,
    shape_key_from_dims,
)
from .registry import (KernelSpec, TuneSpace, all_specs, get_spec,  # noqa: F401
                       register)
from .autotune import (TuneResult, autotune, time_callable,  # noqa: F401
                       time_stats, warm_cache)
