"""Token pipelines of the training path (the JAX package's ``repro.data``)."""
from .pipeline import DataCursor, Prefetcher, SyntheticLMSource, TokenFileSource

__all__ = ["DataCursor", "Prefetcher", "SyntheticLMSource", "TokenFileSource"]
