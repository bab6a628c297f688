from .ops import (Rwkv6Function, rwkv6_wkv, rwkv6_wkv_backward,
                  rwkv6_wkv_grad)
from .ref import rwkv6_ref, rwkv6_ref_bwd

__all__ = ["Rwkv6Function", "rwkv6_wkv", "rwkv6_wkv_backward",
           "rwkv6_wkv_grad", "rwkv6_ref", "rwkv6_ref_bwd"]
