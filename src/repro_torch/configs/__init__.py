"""Model configs: copies of the JAX package's ``repro.configs.base``,
``repro.configs.registry`` and ``repro.configs.shapes`` (``input_specs``
on the ``meta`` device)."""
from .base import ModelConfig, scale_down
from .registry import (ARCHS, DRAFT_FOR, DRAFTS, EXTRAS, SMOKE, get_config,
                       get_draft_config)
from .shapes import SHAPES, ShapeSpec, applicable, input_specs, skip_reason

__all__ = ["ModelConfig", "scale_down", "ARCHS", "DRAFT_FOR", "DRAFTS",
           "EXTRAS", "SMOKE", "get_config", "get_draft_config", "SHAPES",
           "ShapeSpec", "applicable", "input_specs", "skip_reason"]
