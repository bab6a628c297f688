"""Kernel registry: each kernel family declares *what can be swept*.

A copy of the JAX package's ``repro.bench.registry``.  A
:class:`KernelSpec` packages what the autotuner needs to treat a family
generically:

* ``make_inputs(shape, dtype, seed, device)`` -- random operands for a
  shape, from a ``torch.Generator`` seeded with ``seed`` on ``device``;
* ``run(args, config)`` -- the family's wrapper at a
  :class:`~repro_torch.bench.config.BlockConfig`; the device of ``args``
  decides between the kernel (CUDA) and the plain version (CPU), so there
  is no ``interpret`` argument;
* ``ref(args)`` -- the plain PyTorch version from the family's ``ref.py``
  (the correctness gate compares against it);
* ``tune_space(shape)`` -- the configurations the family's CUDA kernel is
  compiled for (one point where it has one);
* ``default_config(shape)`` -- what resolves when nothing is tuned;
* ``flops(shape)`` / ``hbm_bytes(shape, config, dtype)`` -- analytic work
  and memory traffic, the operands' item size taken from ``dtype``;
* ``vmem_bytes(shape, config, dtype)`` (optional) -- the kernel's shared-
  memory footprint at ``config``; the cost model penalises candidates over
  the hardware profile's ceiling.

The built-in families live in :mod:`repro_torch.bench.specs`, loaded on
first lookup.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

from .config import BlockConfig

Shape = Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class TuneSpace:
    """Declarative sweep space: parameter name -> candidate values.

    ``constraint(config, shape)`` prunes combinations the kernel does not
    take."""

    params: Tuple[Tuple[str, Tuple[int, ...]], ...]
    constraint: Callable[[BlockConfig, Shape], bool] = lambda cfg, shape: True

    @classmethod
    def make(cls, constraint=None, **params: Iterable[int]) -> "TuneSpace":
        items = tuple(sorted((k, tuple(v)) for k, v in params.items()))
        return cls(items, constraint or (lambda cfg, shape: True))

    def candidates(self, shape: Shape) -> List[BlockConfig]:
        configs = [BlockConfig()]
        for name, values in self.params:
            configs = [c.replace(**{name: v}) for c in configs for v in values]
        return [c for c in configs if self.constraint(c, shape)]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    make_inputs: Callable[[Shape, str, int, Any], Tuple[Any, ...]]
    run: Callable[[Tuple[Any, ...], BlockConfig], Any]
    ref: Callable[[Tuple[Any, ...]], Any]
    tune_space: Callable[[Shape], TuneSpace]
    default_config: Callable[[Shape], BlockConfig]
    shape_key: Callable[[Shape], str]
    flops: Callable[[Shape], int]
    hbm_bytes: Callable[..., int]
    vmem_bytes: Optional[Callable[..., int]] = None
    rtol: float = 2e-3
    atol: float = 2e-3

    def candidates(self, shape: Shape) -> List[BlockConfig]:
        return self.tune_space(shape).candidates(shape)


_REGISTRY: Dict[str, KernelSpec] = {}
_defaults_loaded = False


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel spec {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_defaults() -> None:
    # lazy: specs.py imports the kernel wrappers, which import bench.config
    global _defaults_loaded
    if not _defaults_loaded:
        _defaults_loaded = True
        from . import specs  # noqa: F401


def get_spec(name: str) -> KernelSpec:
    _ensure_defaults()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no kernel spec {name!r}; known: {sorted(_REGISTRY)}") from None


def all_specs() -> Dict[str, KernelSpec]:
    _ensure_defaults()
    return dict(_REGISTRY)
