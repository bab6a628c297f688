"""Model configs: copies of the JAX package's ``repro.configs.base`` and
``repro.configs.registry`` (its ``__init__`` pulls in ``shapes.py``, which
imports jax, so the port keeps its own)."""
from .base import ModelConfig, scale_down
from .registry import (ARCHS, DRAFT_FOR, DRAFTS, EXTRAS, SMOKE, get_config,
                       get_draft_config)

__all__ = ["ModelConfig", "scale_down", "ARCHS", "DRAFT_FOR", "DRAFTS",
           "EXTRAS", "SMOKE", "get_config", "get_draft_config"]
