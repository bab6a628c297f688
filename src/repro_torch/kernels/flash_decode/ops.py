"""Decode-attention wrappers: the hand-written CUDA kernels of
``csrc/flash_decode.cu`` for CUDA tensors, the plain PyTorch versions
(:mod:`.ref`) for CPU tensors.

* :func:`flash_decode_paged`: one-token attention over a paged KV pool,
  bf16 or fp32 pools, or int8 pools with their fp32 scale pools;
* :func:`flash_decode`: the same over a contiguous (B, S, Hkv, D) cache.

Both kernels split each row's walk over the blocks of a thread-block
cluster (``splits``, tunable).  They take a GQA group ``G = Hq / Hkv`` of
up to :data:`MAX_GROUP` query heads at a head dim of up to
:data:`MAX_HEAD_DIM`: a block holds at most :data:`BLOCK_GROUP` of a
group's rows, so a wider group (starcoder2's 12, chatglm3's 16) runs in
:func:`group_parts` parts on the grid.

The CUDA kernels take the (q, K/V) dtype pairs of :data:`KERNEL_DTYPES`;
the output has the dtype of q, as in the JAX kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...bench.config import (BlockConfig, TileError, dtype_name,
                             pin_config, resolve_cached, resolve_config,
                             shape_key_from_dims)
from ...roofline.hw import get_profile
from .. import _build
from .._leaf import graph_leaf
from .ref import (decode_attention_ref, paged_decode_attention_q_ref,
                  paged_decode_attention_ref)

LIBRARY = "flash_decode"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "flash_decode_paged_bf16": (ctypes.c_int, [_P] * 6 + [_I] * 9 + [_P]),
    "flash_decode_paged_int8": (ctypes.c_int, [_P] * 8 + [_I] * 9 + [_P]),
    "flash_decode_paged_f32": (ctypes.c_int, [_P] * 6 + [_I] * 9 + [_P]),
    "flash_decode_bf16": (ctypes.c_int, [_P] * 5 + [_I] * 7 + [_P]),
    "flash_decode_f32": (ctypes.c_int, [_P] * 5 + [_I] * 7 + [_P]),
}
#: the query rows a block holds (the kernel's register and shared-memory
#: budget), the widest group the kernels take (in parts of BLOCK_GROUP) and
#: the widest head
BLOCK_GROUP, MAX_GROUP, MAX_HEAD_DIM = 8, 16, 128
KERNEL_NAME = "flash_decode"
PAGED_KERNEL_NAME = "flash_decode_paged"
#: (q dtype, K/V dtype) pairs each kernel family is compiled for: a bf16
#: or an fp32 q over every cache type
KERNEL_DTYPES = {
    PAGED_KERNEL_NAME: frozenset({
        (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
        (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
        (torch.float32, torch.int8), (torch.float32, torch.float32)}),
    KERNEL_NAME: frozenset({
        (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
        (torch.float32, torch.bfloat16), (torch.float32, torch.float32)}),
}
#: the kernels walk 32-token steps (``STEP`` in the source): their one chunk
COMPILED = BlockConfig.make(chunk=32)
#: the split counts both kernels take (one cluster of at most 8 blocks per
#: (row, kv head))
SPLITS = (1, 2, 4, 8)
#: the SM count :func:`default_splits` assumes, on every card (the
#: ``h100_sxm`` profile's), so the tune spec and the wrapper agree
SMS = get_profile("h100_sxm").sms
#: the blocks :func:`default_splits` aims to run at once, by bytes of a
#: cached K/V value: two a SM for bf16 and int8 caches (4 warps a block;
#: a block's walk is latency-bound, so a second one streams alongside it),
#: but one to every two SMs for fp32 caches, whose 8-warp blocks of ~230
#: registers fill an SM's register file and measured slower as soon as
#: their clusters outnumbered half the SMs on an H100 (PERF.md §7)
BLOCK_BUDGET = {1: 2 * SMS, 2: 2 * SMS, 4: SMS // 2}
#: the batch :func:`default_splits` is evaluated at, whatever the launch's
#: B: the serving default of 4 slots
REFERENCE_BATCH = 4


def shape_key(b, hq, hkv, d, s) -> str:
    return shape_key_from_dims(b=b, hq=hq, hkv=hkv, d=d, s=s)


def paged_shape_key(b, hq, hkv, d, pages, ps, kv_int8: bool = False) -> str:
    # int8 pools tune under their own key, as in the JAX package
    return (shape_key_from_dims(b=b, hq=hq, hkv=hkv, d=d, pages=pages, ps=ps)
            + ("_kvint8" if kv_int8 else ""))


def group_parts(hq, hkv) -> int:
    """The blocks a (row, kv head) takes at one split: one for a group of
    up to :data:`BLOCK_GROUP` query heads, ``ceil(G / BLOCK_GROUP)`` for a
    wider one."""
    return -(-(hq // hkv) // BLOCK_GROUP)


def default_splits(hkv, s, kv_bytes: int = 2) -> int:
    """The split count of either kernel, from the geometry and the cache's
    bytes a value alone, never from the batch (``s`` is S or the table
    width ``P_max * ps``; the lengths live on the device): the largest of
    :data:`SPLITS` for which :data:`REFERENCE_BATCH` x ``hkv`` x splits
    blocks stay within :data:`BLOCK_BUDGET`, and no more splits than the
    row has 32-token steps.  ``hkv`` counts a row's blocks at one split:
    Hkv x :func:`group_parts`, which is Hkv for a group of up to 8.  A
    row's sums then run in one order at every B: a decode tick, a paged
    prefill chunk of B = 1, a speculative verify step of B x T rows and
    the slot engine's step agree where S equals the table width."""
    cap = min(max(1, BLOCK_BUDGET[kv_bytes] // (REFERENCE_BATCH * hkv)),
              -(-s // COMPILED["chunk"]))
    return max(n for n in SPLITS if n <= cap)


def default_config(b, hq, hkv, d, s, kv_bytes: int = 2) -> BlockConfig:
    return COMPILED.replace(splits=default_splits(
        hkv * group_parts(hq, hkv), s, kv_bytes))


def compiled_configs() -> tuple:
    """Every configuration either kernel takes."""
    return tuple(COMPILED.replace(splits=n) for n in SPLITS)


def paged_default_config(b, hq, hkv, d, pages, ps, kv_int8: bool = False,
                         kv_bytes: int = 2) -> BlockConfig:
    return COMPILED.replace(splits=default_splits(
        hkv * group_parts(hq, hkv), pages * ps, 1 if kv_int8 else kv_bytes))


def check_dtypes(name: str, q_dtype: torch.dtype,
                 kv_dtype: torch.dtype) -> None:
    """Raise ``TypeError`` unless kernel family ``name``
    (``flash_decode`` or ``flash_decode_paged``) is compiled for a q of
    ``q_dtype`` over K/V of ``kv_dtype`` (:data:`KERNEL_DTYPES`)."""
    pairs = KERNEL_DTYPES[name]
    if (q_dtype, kv_dtype) not in pairs:
        raise TypeError(
            f"{name} kernel takes (q, K/V) dtypes "
            f"{sorted((str(a)[6:], str(b)[6:]) for a, b in pairs)}, got "
            f"{q_dtype} and {kv_dtype}")


def check_geometry(name: str, q_shape, kv_shape) -> None:
    """Raise ``ValueError`` unless the kernels take q of ``q_shape`` (B,
    Hq, D) over K/V of ``kv_shape`` (..., Hkv, D): Hq a multiple of Hkv,
    G = Hq / Hkv <= :data:`MAX_GROUP` and D <= :data:`MAX_HEAD_DIM`."""
    hq, d = q_shape[-2:]
    hkv = kv_shape[-2]
    if (kv_shape[-1] != d or hq % hkv or hq // hkv > MAX_GROUP
            or d > MAX_HEAD_DIM):
        raise ValueError(f"{name}: q {tuple(q_shape)} against K/V "
                         f"{tuple(kv_shape)}: the kernel takes Hq a multiple "
                         f"of Hkv with G = Hq / Hkv <= {MAX_GROUP} (a group "
                         f"wider than {BLOCK_GROUP} runs in parts of "
                         f"{BLOCK_GROUP} query heads) and D <= "
                         f"{MAX_HEAD_DIM}")


def _check_cuda(name, tensors, q, k, v):
    """Device, dtype, GQA-geometry and layout checks shared by the CUDA
    paths; raises on anything the kernel does not take."""
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    check_dtypes(name, q.dtype, k.dtype)
    if v.dtype != k.dtype:
        raise TypeError(f"{name}: K {k.dtype} and V {v.dtype}")
    check_geometry(name, q.shape, k.shape)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors")


def _resolve_splits(kernel: str, dims: tuple, shape_key_of, default_of,
                    dtype: str, backend: str,
                    config: Optional[BlockConfig]) -> int:
    """The split count a launch of ``kernel`` uses: ``config`` > the tuned
    entry of the active cache > the default, under the JAX package's key.
    Raises :class:`~repro_torch.bench.TileError` for a configuration the
    kernel does not take."""
    if config is None:
        cfg = resolve_cached(kernel, dims, dtype, backend,
                             shape_key=shape_key_of, default=default_of)
    else:
        cfg = resolve_config(kernel, shape_key_of(*dims), dtype, backend,
                             default=default_of(*dims), override=config)
    if cfg not in compiled_configs():
        raise TileError(f"{kernel}: {cfg} is not compiled; the kernel "
                        f"takes {list(compiled_configs())}")
    return cfg["splits"]


def resolve_paged_splits(b, hq, hkv, d, pages, ps, kv_int8: bool,
                         dtype: str, backend: str,
                         config: Optional[BlockConfig] = None,
                         kv_bytes: int = 2) -> int:
    """The split count a launch of the paged kernel uses (the shape key of
    :func:`paged_shape_key`, ``_kvint8`` for int8 pools; the default of
    :func:`paged_default_config` for pools of ``kv_bytes`` a value)."""
    return _resolve_splits(
        PAGED_KERNEL_NAME, (b, hq, hkv, d, pages, ps, kv_int8, kv_bytes),
        lambda *dims: paged_shape_key(*dims[:7]), paged_default_config,
        dtype, backend, config)


@graph_leaf
def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, lengths: torch.Tensor,
                       block_tables: torch.Tensor, *,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None,
                       chunk: Optional[int] = None,
                       config: Optional[BlockConfig] = None) -> torch.Tensor:
    """Single-token attention over a paged KV cache.

    q: (B, Hq, D); k/v_pages: (P_pool, page_size, Hkv, D); lengths: (B,);
    block_tables: (B, P_max).  Logical token ``t`` of row ``b`` lives at
    ``pages[block_tables[b, t // page_size], t % page_size]``; positions at
    or past ``lengths[b]`` are masked, and rows with ``lengths == 0`` return
    zeros.  With ``k_scales``/``v_scales`` (P_pool, page_size, Hkv) fp32 the
    pools are int8 and token ``t`` of head ``h`` is ``code * scale``.  The
    kernel splits each row's walk over ``splits`` blocks of one cluster
    (:func:`resolve_paged_splits`: ``chunk`` > ``config`` > the tuned entry
    under the JAX package's key, ``_kvint8`` for int8 pools > the
    geometry's default); a chunk other than 32 or a split count outside
    :data:`SPLITS` raises :class:`~repro_torch.bench.TileError`.  A
    block-table entry outside the pool is a dead position (weight 0).

    CUDA tensors launch the kernel (a bf16 or fp32 q over bf16, int8 or
    fp32 pools; int32 lengths and tables) or raise; CPU tensors take the
    plain version.  The output has the dtype of q.  Each launch adds one to
    ``flash_decode_paged.launches`` (bf16 q, bf16 pools),
    ``flash_decode_paged.int8_launches`` (bf16 q, int8 pools),
    ``flash_decode_paged.f32_launches`` (fp32 pools, either q),
    ``flash_decode_paged.f32q_launches`` (fp32 q, bf16 pools) or
    ``flash_decode_paged.int8_f32q_launches`` (fp32 q, int8 pools)."""
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("flash_decode_paged: pass both scale pools or none")
    tensors = (q, k_pages, v_pages, lengths, block_tables) + (
        (k_scales, v_scales) if quantized else ())
    config = pin_config(config, chunk=chunk)
    if all(t.device.type == "cpu" for t in tensors):
        if quantized:
            return paged_decode_attention_q_ref(q, k_pages, v_pages, k_scales,
                                                v_scales, lengths,
                                                block_tables)
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          block_tables)
    _check_cuda(PAGED_KERNEL_NAME, tensors, q, k_pages, v_pages)
    if quantized != (k_pages.dtype == torch.int8):
        raise TypeError("flash_decode_paged: int8 pools go with their "
                        "scale pools, float pools without")
    if lengths.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("flash_decode_paged kernel takes int32 lengths and "
                        "block tables")
    b, hq, d = q.shape
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
    splits = resolve_paged_splits(b, hq, hkv, d, block_tables.shape[1], ps,
                                  quantized, dtype_name(q.dtype), "cuda",
                                  config, k_pages.element_size())
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q_f32 = q.dtype == torch.float32
    dims = (b, hq, hkv, d, ps, p_pool, block_tables.shape[1], int(q_f32),
            splits)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    tail = (lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr())
    if quantized:
        err = lib.flash_decode_paged_int8(
            *ptrs, k_scales.data_ptr(), v_scales.data_ptr(), *tail, *dims,
            stream)
    elif k_pages.dtype == torch.float32:
        err = lib.flash_decode_paged_f32(*ptrs, *tail, *dims, stream)
    else:
        err = lib.flash_decode_paged_bf16(*ptrs, *tail, *dims, stream)
    _build.check(lib, err, "flash_decode_paged")
    if k_pages.dtype == torch.float32:
        flash_decode_paged.f32_launches += 1
    elif quantized and q_f32:
        flash_decode_paged.int8_f32q_launches += 1
    elif quantized:
        flash_decode_paged.int8_launches += 1
    elif q_f32:
        flash_decode_paged.f32q_launches += 1
    else:
        flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
flash_decode_paged.int8_launches = 0
flash_decode_paged.f32_launches = 0
flash_decode_paged.f32q_launches = 0
flash_decode_paged.int8_f32q_launches = 0


def resolve_splits(b, hq, hkv, d, s, dtype: str, backend: str,
                   config: Optional[BlockConfig] = None,
                   kv_bytes: int = 2) -> int:
    """The split count a launch of the contiguous kernel uses (the shape
    key of :func:`shape_key`, the default of :func:`default_config` for a
    cache of ``kv_bytes`` a value)."""
    return _resolve_splits(KERNEL_NAME, (b, hq, hkv, d, s, kv_bytes),
                           lambda *dims: shape_key(*dims[:5]),
                           default_config, dtype, backend, config)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, chunk: Optional[int] = None,
                 config: Optional[BlockConfig] = None) -> torch.Tensor:
    """Single-token attention over a contiguous KV cache.

    q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,).  Positions at or
    past ``lengths[b]`` are masked; a row with ``lengths == 0`` returns the
    mean of its S values of V, as the JAX package's kernel and oracle do.
    CUDA tensors launch the kernel (a bf16 or fp32 q over a bf16 or fp32
    cache; int32 lengths) or raise; CPU tensors take
    :func:`decode_attention_ref`.  The output has the dtype of q.  The
    kernel splits each row's sequence over ``splits`` blocks of one cluster
    (:func:`resolve_splits`: by default from the geometry and the H100's
    SM count; a ``config`` or a tuned entry may pick any of :data:`SPLITS`;
    ``chunk`` pins the chunk, which must be 32).  Each launch adds one to
    ``flash_decode.launches`` (``flash_decode.f32q_launches`` for an fp32 q
    over a bf16 cache)."""
    tensors = (q, k, v, lengths)
    config = pin_config(config, chunk=chunk)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_ref(q, k, v, lengths)
    _check_cuda(KERNEL_NAME, tensors, q, k, v)
    if lengths.dtype != torch.int32:
        raise TypeError("flash_decode kernel takes int32 lengths")
    b = q.shape[0]
    if k.dim() != 4 or k.shape[0] != b or v.shape != k.shape \
            or lengths.shape != (b,):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}/{tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    splits = resolve_splits(b, q.shape[1], k.shape[2], q.shape[2],
                            k.shape[1], dtype_name(q.dtype), "cuda", config,
                            k.element_size())
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q_f32 = q.dtype == torch.float32
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, q.shape[1], k.shape[2], q.shape[2], k.shape[1],
            splits, int(q_f32), stream)
    if k.dtype == torch.float32:
        err = lib.flash_decode_f32(*args)
    else:
        err = lib.flash_decode_bf16(*args)
    _build.check(lib, err, "flash_decode")
    if q_f32 and k.dtype == torch.bfloat16:
        flash_decode.f32q_launches += 1
    else:
        flash_decode.launches += 1
    return out


flash_decode.launches = 0
flash_decode.f32q_launches = 0
