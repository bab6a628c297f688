from .registry import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
