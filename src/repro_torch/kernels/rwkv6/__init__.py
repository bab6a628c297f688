from .ops import rwkv6_wkv
from .ref import rwkv6_ref

__all__ = ["rwkv6_wkv", "rwkv6_ref"]
