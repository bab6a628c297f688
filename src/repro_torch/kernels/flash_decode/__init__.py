from .ops import flash_decode, flash_decode_paged
from .ref import (decode_attention_ref, decode_attention_split_ref,
                  gather_pages, paged_decode_attention_q_ref,
                  paged_decode_attention_ref,
                  paged_decode_attention_split_ref)

__all__ = ["flash_decode", "flash_decode_paged", "decode_attention_ref",
           "decode_attention_split_ref", "gather_pages",
           "paged_decode_attention_q_ref", "paged_decode_attention_ref",
           "paged_decode_attention_split_ref"]
