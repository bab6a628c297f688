"""Speculative decoding on the port's paged serving engine (draft and
verify), as the JAX package's ``repro.spec`` does it."""
from .draft import DraftProposer, ModelDraft, NgramDraft
from .engine import SpeculativeServeEngine

__all__ = ["DraftProposer", "ModelDraft", "NgramDraft",
           "SpeculativeServeEngine"]
