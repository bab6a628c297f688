from .ops import mamba2_ssd
from .ref import mamba2_ref

__all__ = ["mamba2_ssd", "mamba2_ref"]
