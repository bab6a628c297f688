"""Transformer building blocks of the dense paged-decode path, in PyTorch.

Port of the subset of the JAX package's ``repro.models.layers`` that
``lm_decode_paged`` runs.  Functions take and return tensors; parameters
are plain dicts keyed by the JAX names.  Every 2-D weight product goes
through the ``apr_matmul`` wrapper and the one-token decode attention
through ``flash_decode_paged``: on CUDA tensors those launch the
hand-written kernels, on CPU tensors they compute the plain versions, which
repeat the JAX layers' arithmetic (fp32 accumulation, one rounding) so the
CPU path is the middle link of the parity chain kernel == plain == JAX.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..kernels.apr_matmul import apr_matmul, matmul_ref
from ..kernels.flash_decode import flash_decode_paged

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def mask_vocab_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Neutralise padded vocab slots (see ModelConfig.padded_vocab)."""
    if logits.shape[-1] == vocab_size:
        return logits
    live = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    return torch.where(live, logits,
                       torch.tensor(NEG_INF, dtype=logits.dtype,
                                    device=logits.device))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm that rounds to the storage dtype *before* the weight
    multiply, as the JAX layer does."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding over the first ``fraction`` of the head dim.
    x: (..., T, H, Dh); positions: (..., T).  Angles in fp32, then cast."""
    dh = x.shape[-1]
    rot = int(dh * fraction) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    xr = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([xr.to(x.dtype), xp], dim=-1)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` in ``x.dtype`` with an fp32 accumulator
    (the JAX layers' ``einsum("btd,dk->btk")``), through ``apr_matmul``."""
    y = apr_matmul(x.reshape(-1, x.shape[-1]), w, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[1])


#: canonical split-K granularity of :func:`tp_einsum` on the plain path
TP_CHUNKS = 4


def _tp_chunks(k: int) -> int:
    """Canonical chunk count for a contraction length ``k``."""
    for c in (TP_CHUNKS, 2):
        if k % c == 0:
            return c
    return 1


def _tree_sum(parts):
    """Balanced-binary-tree sum: the one canonical association order."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def tp_einsum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The JAX ``tp_einsum("btk,kd->btd", x, w)`` of ``wo`` and ``w_down``
    on one device.

    Plain path (CPU tensors): canonical split-K, as the JAX layer computes
    it even on one device -- K cut into :data:`TP_CHUNKS` slices, one fp32
    partial per slice, a balanced tree sum, one rounding to ``x.dtype``.
    CUDA tensors: one ``apr_matmul`` launch whose fp32 accumulator spans
    the whole K (the same sum in another fp32 order)."""
    if x.is_cuda:
        return linear(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    k = x2.shape[1]
    step = k // _tp_chunks(k)
    parts = [matmul_ref(x2[:, i:i + step], w[i:i + step], torch.float32)
             for i in range(0, k, step)]
    y = _tree_sum(parts).to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[1])


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` with every step rounded to ``x.dtype``:
    the op sequence of ``jax.nn.silu``, which in bf16 differs from
    ``torch.nn.functional.silu``'s single rounding in about a third of the
    values."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = linear(x, w_gate)
    u = linear(x, w_up)
    return tp_einsum(silu(g) * u, w_down)


def project_qkv(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    b, t, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(x, p[f"{prefix}.wq"]).reshape(b, t, h, dh)
    k = linear(x, p[f"{prefix}.wk"]).reshape(b, t, hkv, dh)
    v = linear(x, p[f"{prefix}.wv"]).reshape(b, t, hkv, dh)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def gqa_scores_attend(q, k, v, mask) -> torch.Tensor:
    """q: (B,T,H,Dh); k/v: (B,S,Hkv,Dh); mask broadcastable to
    (B,Hkv,G,T,S).  Scores in the storage dtype, softmax in fp32, as the
    JAX layer computes them (mixed operand dtypes promote, as in jnp)."""
    b, t, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    ct = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, t, hkv, g, dh).to(ct)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.to(ct)).float()
    scores = scores * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ct = torch.promote_types(q.dtype, v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(ct), v.to(ct))
    return out.reshape(b, t, h * dh)


def attention_decode_paged(
    p: Params,
    prefix: str,
    cfg: ModelConfig,
    x: torch.Tensor,             # (B, T, d): T new tokens per slot
    k_pages: torch.Tensor,       # (P_pool, page_size, Hkv, Dh) shared pool
    v_pages: torch.Tensor,
    lengths: torch.Tensor,       # (B,) int32 tokens already in the cache
    new_counts: torch.Tensor,    # (B,) int32 real new tokens (<= T)
    block_tables: torch.Tensor,  # (B, P_max) int32 physical page per page
) -> torch.Tensor:
    """Multi-token attention against, and update of, a paged KV cache.

    ``T == 1`` is the decode step, ``T == chunk`` one chunked-prefill step.
    Token ``i`` of slot ``b`` sits at logical position ``lengths[b] + i``
    and is written **in place** (``index_put_``) into ``k_pages`` /
    ``v_pages`` at page ``block_tables[b, pos // page_size]``, offset
    ``pos % page_size``.  Positions ``i >= new_counts[b]`` are padding:
    their writes go to the reserved null page 0 and their query rows are
    garbage the caller ignores.  Token ``i`` attends to positions
    ``<= lengths + i``.

    On CUDA the decode step (T == 1) calls the ``flash_decode_paged``
    kernel with lengths ``lengths + new_counts``, after the new K/V are in
    the pool; rows with ``new_counts == 0`` then hold zeros or garbage.
    Chunked prefill, and every call on the CPU, gathers the pages and
    attends as the JAX layer does.  Returns the attention output after the
    ``wo`` projection, (B, T, d).
    """
    b, t, _ = x.shape
    ps = k_pages.shape[1]
    lengths = lengths.long()
    steps = torch.arange(t, device=x.device)
    positions = lengths[:, None] + steps[None]                  # (B, T)
    q, k_new, v_new = project_qkv(p, prefix, cfg, x, positions)
    write = steps[None] < new_counts.long()[:, None]            # (B, T)
    page_idx = torch.clamp(positions // ps, max=block_tables.shape[1] - 1)
    bidx = torch.arange(b, device=x.device)[:, None]
    pids = torch.where(write, block_tables.long()[bidx, page_idx], 0)
    offs = torch.where(write, positions % ps, 0)
    k_pages.index_put_((pids, offs), k_new.to(k_pages.dtype))
    v_pages.index_put_((pids, offs), v_new.to(v_pages.dtype))
    if x.is_cuda and t == 1:
        out = flash_decode_paged(
            q[:, 0].contiguous(), k_pages, v_pages,
            (lengths + new_counts.long()).to(torch.int32),
            block_tables).reshape(b, 1, -1)
    else:
        k_all = k_pages[block_tables.long()].reshape(b, -1, *k_pages.shape[2:])
        v_all = v_pages[block_tables.long()].reshape(b, -1, *v_pages.shape[2:])
        s = k_all.shape[1]
        mask = (torch.arange(s, device=x.device)[None, None]
                <= positions[:, :, None])[:, None, None]
        out = gqa_scores_attend(q, k_all, v_all, mask)
    return tp_einsum(out, p[f"{prefix}.wo"])
