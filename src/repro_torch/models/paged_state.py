"""Device-side paged recurrent-state pools, in PyTorch.

Port of the JAX package's ``repro.models.paged_state``, shared by the rwkv6
and mamba2 paged decode paths: every state leaf in a paged cache is a pool
with the *physical state slot* as axis 1 (``(layers, pool_slots, ...)``),
indexed by the read/write columns the engine appends to the block table
(``repro_torch.serve.state_cache``).  The helpers gather a batch's state out
of the pools, scatter post-token state back in, and split the combined
block table the engine builds:

    [ KV page table (width P) | state read col (1) | write cols (T) ]

The model derives the split purely from shapes (``P = width - 1 - T``).

int8 state storage (``state_dtype="int8"``): the large running-reduction
leaves (``wkv``, ``ssm``) are stored int8 with a per-(layer, slot, head)
symmetric scale, quantized on scatter and dequantized on gather.  The small
leaves (conv window, token-shift rows) stay in their native dtype.  int8
state is lossy across steps (re-quantized every token), so it trades
accuracy for a ~4x pool-byte cut and is not token-identity gated.

Unlike the JAX functions, which return a new cache, :func:`scatter_state`,
:func:`copy_state_slot` and :func:`copy_kv_page` write the pools in place
(``index_copy_`` and slice assignment), as the port's KV pools are written.
"""
from __future__ import annotations

from typing import Dict

import torch

#: cache keys that are state pools (slot axis 1); everything else in a
#: paged cache is a KV page pool (page axis 2) -- the engine's copy
#: choreography dispatches on this split
STATE_POOL_KEYS = frozenset({
    "tmix_x", "cmix_x", "wkv", "wkv_scale", "conv", "ssm", "ssm_scale",
})

#: state leaves eligible for int8 storage (scale key = f"{key}_scale")
INT8_STATE_KEYS = ("wkv", "ssm")

Cache = Dict[str, torch.Tensor]


def split_state_tables(block_tables: torch.Tensor, t: int):
    """``(kv_tables, read_ids, write_ids)`` from a combined table whose
    last ``1 + t`` columns are the state read column and ``t`` per-token
    write columns.  ``kv_tables`` is empty-width for pure recurrent
    families (the engine still ledgers their tokens through the KV block
    table, but the model never looks at pages)."""
    kv_w = block_tables.shape[1] - 1 - t
    return (block_tables[:, :kv_w], block_tables[:, kv_w],
            block_tables[:, kv_w + 1:])


def _quantize(v: torch.Tensor):
    """Symmetric int8 over the trailing two axes; the scale has their shape
    dropped (per layer/row/head).  Divides by the scale and rounds half to
    even, as the JAX function does."""
    amax = v.abs().amax(dim=(-2, -1))
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(v / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def gather_state(cache: Cache, ids: torch.Tensor) -> Cache:
    """Gather per-sequence state ``{key: (layers, B, ...)}`` from the pools
    at physical slot ``ids (B,)``, dequantizing int8 leaves."""
    ids = ids.long()
    state = {}
    for k, pool in cache.items():
        if k not in STATE_POOL_KEYS or k.endswith("_scale"):
            continue
        if k in INT8_STATE_KEYS and f"{k}_scale" in cache:
            scale = cache[f"{k}_scale"].index_select(1, ids)
            state[k] = (pool.index_select(1, ids).float()
                        * scale[..., None, None])
        else:
            state[k] = pool.index_select(1, ids)
    return state


def scatter_state(cache: Cache, state: Cache, ids: torch.Tensor) -> Cache:
    """Scatter post-token state back into the pools at slot ``ids (B,)``,
    in place (quantizing int8 leaves); returns ``cache``.  Padded rows
    target ``TRASH_STATE``; duplicate trash writes race benignly (the sink
    is never read)."""
    ids = ids.long()
    for k, v in state.items():
        if k in INT8_STATE_KEYS and f"{k}_scale" in cache:
            q, scale = _quantize(v)
            cache[k].index_copy_(1, ids, q)
            cache[f"{k}_scale"].index_copy_(1, ids, scale)
        else:
            cache[k].index_copy_(1, ids, v.to(cache[k].dtype))
    return cache


def copy_state_slot(cache: Cache, src: int, dst: int) -> Cache:
    """Copy one physical state slot across every state leaf, in place (KV
    page pools untouched) -- the engine's mirror for ``pop_state_copies``."""
    for k, a in cache.items():
        if k in STATE_POOL_KEYS:
            a[:, dst] = a[:, src]
    return cache


def copy_kv_page(cache: Cache, src: int, dst: int) -> Cache:
    """Copy one physical KV page across every page-pool leaf, in place
    (state pools untouched; the page axis is 2 on every KV leaf)."""
    for k, a in cache.items():
        if k not in STATE_POOL_KEYS:
            a[:, :, dst] = a[:, :, src]
    return cache
