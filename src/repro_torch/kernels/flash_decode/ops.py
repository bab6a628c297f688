"""Decode-attention wrappers: the hand-written CUDA kernels of
``csrc/flash_decode.cu`` for CUDA tensors, the plain PyTorch versions
(:mod:`.ref`) for CPU tensors.

* :func:`flash_decode_paged`: one-token attention over a paged KV pool,
  bf16 pools, or int8 pools with their fp32 scale pools;
* :func:`flash_decode`: the same over a contiguous (B, S, Hkv, D) cache.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import (decode_attention_ref, paged_decode_attention_q_ref,
                  paged_decode_attention_ref)

LIBRARY = "flash_decode"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "flash_decode_paged_bf16": (
        ctypes.c_int, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_decode_paged_int8": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_decode_bf16": (
        ctypes.c_int, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}
MAX_GROUP, MAX_HEAD_DIM = 8, 128   # the kernel's register budget


def _check_cuda(name, tensors, q, k, kv_dtype):
    """Device, dtype, GQA-geometry and layout checks shared by the CUDA
    paths; raises on anything the kernel does not take."""
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype:
        raise TypeError(f"{name} kernel takes a bf16 q and {kv_dtype} K/V, "
                        f"got {q.dtype} and {k.dtype}")
    b, hq, d = q.shape
    hkv = k.shape[-2]
    if (k.shape[-1] != d or hq % hkv or hq // hkv > MAX_GROUP
            or d > MAX_HEAD_DIM):
        raise ValueError(f"{name}: q {tuple(q.shape)} against K/V "
                         f"{tuple(k.shape)} (G <= {MAX_GROUP}, D <= "
                         f"{MAX_HEAD_DIM})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors")


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, lengths: torch.Tensor,
                       block_tables: torch.Tensor, *,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Single-token attention over a paged KV cache.

    q: (B, Hq, D); k/v_pages: (P_pool, page_size, Hkv, D); lengths: (B,);
    block_tables: (B, P_max).  Logical token ``t`` of row ``b`` lives at
    ``pages[block_tables[b, t // page_size], t % page_size]``; positions at
    or past ``lengths[b]`` are masked, and rows with ``lengths == 0`` return
    zeros.  With ``k_scales``/``v_scales`` (P_pool, page_size, Hkv) fp32 the
    pools are int8 and token ``t`` of head ``h`` is ``code * scale``.

    CUDA tensors launch the kernel (bf16 q, bf16 or int8 pools, int32
    lengths and tables) or raise; CPU tensors take the plain version.  Each
    launch adds one to ``flash_decode_paged.launches`` (bf16 pools) or
    ``flash_decode_paged.int8_launches`` (int8 pools)."""
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("flash_decode_paged: pass both scale pools or none")
    tensors = (q, k_pages, v_pages, lengths, block_tables) + (
        (k_scales, v_scales) if quantized else ())
    if all(t.device.type == "cpu" for t in tensors):
        if quantized:
            return paged_decode_attention_q_ref(q, k_pages, v_pages, k_scales,
                                                v_scales, lengths,
                                                block_tables)
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          block_tables)
    _check_cuda("flash_decode_paged", tensors, q, k_pages,
                torch.int8 if quantized else torch.bfloat16)
    if lengths.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("flash_decode_paged kernel takes int32 lengths and "
                        "block tables")
    b = q.shape[0]
    p_pool, ps, hkv, _ = k_pages.shape
    if (v_pages.shape != k_pages.shape or lengths.shape != (b,)
            or block_tables.dim() != 2 or block_tables.shape[0] != b):
        raise ValueError(
            f"flash_decode_paged: q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, lengths "
            f"{tuple(lengths.shape)}, tables {tuple(block_tables.shape)}")
    if quantized and not all(s.shape == k_pages.shape[:-1]
                             and s.dtype == torch.float32
                             for s in (k_scales, v_scales)):
        raise ValueError(f"flash_decode_paged: scale pools must be fp32 "
                         f"{tuple(k_pages.shape[:-1])}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dims = (b, q.shape[1], hkv, q.shape[2], ps, p_pool, block_tables.shape[1],
            stream)
    if quantized:
        err = lib.flash_decode_paged_int8(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), lengths.data_ptr(),
            block_tables.data_ptr(), out.data_ptr(), *dims)
    else:
        err = lib.flash_decode_paged_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            *dims)
    _build.check(lib, err, "flash_decode_paged")
    if quantized:
        flash_decode_paged.int8_launches += 1
    else:
        flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
flash_decode_paged.int8_launches = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a contiguous KV cache.

    q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,).  Positions at or
    past ``lengths[b]`` are masked; a row with ``lengths == 0`` returns the
    mean of its S values of V, as the JAX package's kernel and oracle do.
    CUDA tensors launch the kernel (bf16 q and cache, int32 lengths) or
    raise; CPU tensors take :func:`decode_attention_ref`.  Each launch adds
    one to ``flash_decode.launches``."""
    tensors = (q, k, v, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_ref(q, k, v, lengths)
    _check_cuda("flash_decode", tensors, q, k, torch.bfloat16)
    if lengths.dtype != torch.int32:
        raise TypeError("flash_decode kernel takes int32 lengths")
    b = q.shape[0]
    if k.dim() != 4 or k.shape[0] != b or v.shape != k.shape \
            or lengths.shape != (b,):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}/{tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_decode_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                lengths.data_ptr(), out.data_ptr(), b,
                                q.shape[1], k.shape[2], q.shape[2],
                                k.shape[1], stream)
    _build.check(lib, err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
