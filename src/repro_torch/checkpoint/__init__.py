"""Checkpoints of the training state (the JAX package's
``repro.checkpoint``), in its on-disk layout."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
