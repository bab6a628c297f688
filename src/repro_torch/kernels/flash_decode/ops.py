"""``flash_decode_paged`` wrapper: the hand-written CUDA kernel for CUDA
tensors, the plain PyTorch version
(:func:`.ref.paged_decode_attention_ref`) for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import paged_decode_attention_ref

LIBRARY = "flash_decode_paged"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"flash_decode_paged_bf16": (
    ctypes.c_int, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])}
MAX_GROUP, MAX_HEAD_DIM = 8, 128   # the kernel's register budget


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, lengths: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a paged KV cache.

    q: (B, Hq, D); k/v_pages: (P_pool, page_size, Hkv, D); lengths: (B,);
    block_tables: (B, P_max).  Logical token ``t`` of row ``b`` lives at
    ``pages[block_tables[b, t // page_size], t % page_size]``; positions at
    or past ``lengths[b]`` are masked, and rows with ``lengths == 0`` return
    zeros.  CUDA tensors launch the kernel (bf16 q and pools, int32 lengths
    and tables) or raise; CPU tensors take the plain version.  Each kernel
    launch adds one to ``flash_decode_paged.launches``."""
    tensors = (q, k_pages, v_pages, lengths, block_tables)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          block_tables)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_decode_paged: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError("flash_decode_paged kernel takes bf16 q and pools, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if lengths.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("flash_decode_paged kernel takes int32 lengths and "
                        "block tables")
    b, hq, d = q.shape
    p_pool, ps, hkv, d2 = k_pages.shape
    if (v_pages.shape != k_pages.shape or d2 != d or hq % hkv
            or hq // hkv > MAX_GROUP or d > MAX_HEAD_DIM
            or lengths.shape != (b,) or block_tables.dim() != 2
            or block_tables.shape[0] != b):
        raise ValueError(
            f"flash_decode_paged: q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, lengths "
            f"{tuple(lengths.shape)}, tables {tuple(block_tables.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_paged kernel takes contiguous tensors")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_decode_paged_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, ps, p_pool, block_tables.shape[1], stream)
    _build.check(lib, err, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
