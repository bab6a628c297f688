"""Building blocks of the port's model paths, in PyTorch.

Port of the subset of the JAX package's ``repro.models.layers`` that the
ported model paths run (``attention`` for the whole-sequence entry points,
``attention_decode_paged`` and ``attention_decode`` for serving), plus the
parameter initialiser and the elementwise ops the recurrent families share.
Functions take and return
tensors; parameters are plain dicts keyed by the JAX names, and every
weight may be an int8 :class:`~repro_torch.quant.QuantizedTensor`.  Every
2-D weight product goes through the ``apr_matmul`` wrapper and the
one-token decode attention through ``flash_decode_paged`` (paged cache) or
``flash_decode`` (contiguous cache): on CUDA tensors those launch the
hand-written kernels, on CPU tensors they compute the plain versions, which
repeat the JAX layers' arithmetic (fp32 accumulation, one rounding) so the
CPU path is the middle link of the parity chain kernel == plain == JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.apr_matmul import ProductTape, apr_matmul, apr_matmul_grad, \
    matmul_ref, needs_grad, not_residual
from ..kernels.flash_decode import flash_decode, flash_decode_paged
from ..quant import QuantizedTensor, quantize_channelwise

Weight = Union[torch.Tensor, QuantizedTensor]
Params = Dict[str, Weight]
#: name -> (shape, init scale); scale 0 means zeros (the norms' offsets)
ParamSpecs = Dict[str, Tuple[Tuple[int, ...], float]]

NEG_INF = -1e30


def fan_in_scale(shape: Tuple[int, ...]) -> float:
    """The JAX ``ParamBuilder``'s default init scale, ``fan_in ** -0.5``
    with ``fan_in = shape[-2]`` (``shape[-1]`` for a vector)."""
    return (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5


def init_from_specs(specs: ParamSpecs, generator: torch.Generator,
                    device) -> Params:
    """Random bf16 parameters, ``normal * scale`` drawn in fp32 and rounded
    to bf16 (as the JAX builder does), in sorted-name order from
    ``generator`` (which must live on ``device``).  Every tensor is drawn in
    blocks of at most 2^24 values (one layer slice at a time for the
    stacked weights), so no fp32 copy of a whole tensor (7.5 GB for the
    stacked ``w_gate`` of llama3-8b) is ever held."""
    out: Params = {}
    for name, (shape, scale) in sorted(specs.items()):
        t = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        if scale:
            rows = t.reshape(-1, shape[-1])
            step = max(1, (1 << 24) // shape[-1])
            for r in range(0, rows.shape[0], step):
                blk = rows[r:r + step]
                blk.copy_(torch.randn(blk.shape, generator=generator,
                                      dtype=torch.float32, device=device)
                          * scale)
        out[name] = t
    return out


def requires_grad(params: Params) -> bool:
    """Whether a gradient flows to ``params``: grad mode on and some
    parameter tensor that requires grad (serving holds none)."""
    return torch.is_grad_enabled() and any(
        isinstance(w, torch.Tensor) and w.requires_grad
        for w in params.values())


def grad_wanted(*tensors: torch.Tensor) -> bool:
    """Whether a gradient flows through ``tensors``: grad mode on and one
    of them requires grad (``apr_matmul``'s ``needs_grad`` rule).  A
    recurrence takes its autograd Function only then, so serving calls
    its kernel as before."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def remat_wanted(cfg: ModelConfig, params: Params) -> bool:
    """Whether a model's blocks run under ``torch.utils.checkpoint``: under
    ``cfg.remat`` with a gradient to compute (:func:`requires_grad`).  What
    a block keeps is the caller's: only the dense, moe and vlm super-blocks
    read ``cfg.remat_policy`` (``lm.remat_policy``), as in JAX, where every
    other family checkpoints with ``nothing_saveable`` whatever it says."""
    return cfg.remat and requires_grad(params)


def rematerialised(remat: bool, fn, *args, dots: bool = False):
    """``fn(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) when ``remat``: all of them
    (``jax.checkpoint``'s ``nothing_saveable``), or with ``dots`` all but
    the outputs of its products, which a :class:`ProductTape` keeps
    (``dots_with_no_batch_dims_saveable``)."""
    if not remat:
        return fn(*args)
    if dots:
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=ProductTape().contexts)
    return checkpoint(fn, *args, use_reentrant=False)


def use_scan_kernel(x: torch.Tensor) -> bool:
    """Whether a recurrence on ``x`` launches its kernel (``rwkv6_wkv``,
    ``mamba2_ssd``) rather than its plain formula: on CUDA tensors.  The
    one seam a caller substitutes to run the plain formulas on the card, or
    the kernel branches on the CPU."""
    return x.is_cuda


def mask_vocab_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Neutralise padded vocab slots (see ModelConfig.padded_vocab)."""
    if logits.shape[-1] == vocab_size:
        return logits
    live = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    return torch.where(live, logits,
                       torch.tensor(NEG_INF, dtype=logits.dtype,
                                    device=logits.device))


#: groups of the batch-invariant mean of :func:`mean_square` on the card
NORM_GROUPS = 16


def mean_square(xf: torch.Tensor) -> torch.Tensor:
    """The fp32 mean of squares over the last axis of ``xf`` (keepdim), the
    variance of :func:`rms_norm`.

    On CUDA tensors it is taken per group of ``d / NORM_GROUPS`` values,
    then over the groups.  PyTorch's CUDA reduction picks its thread-block
    shape from the number of rows it reduces, so one mean over d sums a row
    in another order at B = 1 (a paged prefill step) than inside B = 4 (a
    slot-engine step), and the two engines' greedy tokens then part
    (``chip_smoke.py --ablate``); with at least 16 rows of groups the block
    shape, and so every row's sum order, no longer depends on the batch.
    ``chip_smoke.py`` phase 2 holds both row for row: the one mean differs
    in some rows between B = 1 and B = 4 on an H100, the grouped mean in
    none.  The CPU path keeps the one mean, which equals the JAX layer's."""
    sq = xf * xf
    d = xf.shape[-1]
    if xf.is_cuda and d % NORM_GROUPS == 0:
        return sq.reshape(*xf.shape[:-1], NORM_GROUPS, d // NORM_GROUPS
                          ).mean(dim=-1).mean(dim=-1, keepdim=True)
    return sq.mean(dim=-1, keepdim=True)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm that rounds to the storage dtype *before* the weight
    multiply, as the JAX layer does; the variance is :func:`mean_square`."""
    xf = x.float()
    return (xf * torch.rsqrt(mean_square(xf) + eps)).to(x.dtype) * w


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


def materialize_weight(w: Weight, dtype: torch.dtype) -> torch.Tensor:
    """A plain weight as it is, an int8 :class:`QuantizedTensor`
    dequantized to ``dtype`` (the JAX layers' use-site dequantize).  Only
    the plain paths call it: on the card ``apr_matmul`` dequantizes in its
    load stage instead of materialising a copy."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize(dtype)
    return w


def linear(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` in ``x.dtype`` with an fp32 accumulator
    (the JAX layers' ``einsum("btd,dk->btk", x, materialize_weight(w))``),
    through ``apr_matmul``, which takes bf16 and int8 weights alike.  Under
    a gradient (``needs_grad``: grad mode on, an operand that requires
    grad) the product goes through ``AprMatmulFunction``, whose backward
    runs both products on ``apr_matmul`` too; serving, where no operand
    requires grad, makes the plain call."""
    x2 = x.reshape(-1, x.shape[-1])
    if needs_grad(x2, w):
        y = apr_matmul_grad(x2, w, x.dtype)
    else:
        y = apr_matmul(x2, w, out_dtype=x.dtype)
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


def tp_einsum(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """The JAX ``tp_einsum("btk,kd->btd", x, w)`` of ``wo`` and ``w_down``
    on one device.

    Plain path (CPU tensors): canonical split-K, as the JAX layer computes
    it even on one device -- K cut into :data:`TP_CHUNKS` slices, one fp32
    partial per slice, a balanced tree sum, one rounding to ``x.dtype``.
    CUDA tensors: one ``apr_matmul`` launch whose fp32 accumulator spans
    the whole K (the same sum in another fp32 order).  Under a gradient
    the plain path's slices go through ``AprMatmulFunction`` (on the CPU
    its products are ``matmul_ref``'s), so the backward is the card's."""
    if x.is_cuda:
        return linear(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if needs_grad(x2, w):   # each slice's product differentiable
        mm = apr_matmul_grad
    else:
        w = materialize_weight(w, x.dtype)
        mm = matmul_ref
    k = x2.shape[1]
    step = k // _tp_chunks(k)
    parts = [mm(x2[:, i:i + step], w[i:i + step], torch.float32)
             for i in range(0, k, step)]
    y = _tree_sum(parts).to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[1])


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` with every step rounded to ``x.dtype``:
    the op sequence of ``jax.nn.silu``, which in bf16 differs from
    ``torch.nn.functional.silu``'s single rounding in about a third of the
    values."""
    return x * (1 / (1 + torch.exp(-x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` with every step rounded to ``x.dtype``, the op
    sequence of ``jax.nn.sigmoid`` on the CPU (``torch.sigmoid`` rounds once
    and differs in bf16)."""
    return 1 / (1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``, in that order of operations."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``): ``x * 0.5 * (1 + tanh(
    sqrt(2 / pi) * (x + 0.044715 * x^3)))`` with JAX's constants in
    ``x.dtype`` and every step rounded to it, its op sequence, which in
    bf16 equals JAX's bit for bit (PyTorch's ``gelu(approximate="tanh")``
    and a scalar constant work in fp32 and round once)."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def swiglu(x: torch.Tensor, w_gate: Weight, w_up: Weight,
           w_down: Weight, *, closing: bool = False) -> torch.Tensor:
    """``tp_einsum(silu(x @ w_gate) * (x @ w_up), w_down)``.  ``closing``
    marks a block's last FFN, whose output is only added into the block's
    output: under the ``"dots"`` policy its ``w_down`` product is then
    neither kept nor recomputed (:func:`not_residual`)."""
    g = linear(x, w_gate)
    u = linear(x, w_up)
    with not_residual(closing):
        return tp_einsum(silu(g) * u, w_down)


def attn_params(prefix: str, cfg: ModelConfig,
                layers: Optional[int]) -> ParamSpecs:
    """Shapes and init scales of one (or ``layers`` stacked) attention
    blocks, name for name as the JAX ``attn_params``."""
    d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    lead = () if layers is None else (layers,)
    shapes = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
              "wo": (h * dh, d)}
    return {f"{prefix}.{name}": (lead + shape, fan_in_scale(shape))
            for name, shape in shapes.items()}


def project_qkv(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
                positions: Optional[torch.Tensor], apply_rope: bool = True):
    """q (B, T, H, Dh), k and v (B, T, Hkv, Dh) of ``x`` (B, T, d), rotary
    at ``positions`` (B, T) unless ``apply_rope`` is off or there are no
    positions, as the JAX layer does."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(x, p[f"{prefix}.wq"]).reshape(b, t, h, dh)
    k = linear(x, p[f"{prefix}.wk"]).reshape(b, t, hkv, dh)
    v = linear(x, p[f"{prefix}.wv"]).reshape(b, t, hkv, dh)
    if apply_rope and positions is not None:
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


def causal_mask(t: int, device) -> torch.Tensor:
    """The (1, 1, 1, T, T) lower-triangular mask of whole-sequence
    self-attention, broadcast over (B, Hkv, G)."""
    return torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=device))[None, None, None]


def attention(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None, *,
              causal: bool = True, apply_rope: bool = True) -> torch.Tensor:
    """Self-attention over a whole sequence ``x`` (B, T, d), for the
    forward and prefill paths: ``project_qkv`` (rotary at ``positions``
    (B, T) when given and ``apply_rope``), then ``gqa_scores_attend`` under
    the causal mask (none when ``causal`` is off: whisper's encoder), then
    ``wo`` through :func:`tp_einsum`, as the JAX layer computes it.  The
    projections go through ``apr_matmul``; the score and probability
    products are plain PyTorch, as the JAX layer computes them outside any
    kernel (not ``scaled_dot_product_attention``, whose sums run in another
    order).  Returns (B, T, d)."""
    q, k, v = project_qkv(p, prefix, cfg, x, positions, apply_rope)
    mask = causal_mask(x.shape[1], x.device) if causal else None
    return tp_einsum(gqa_scores_attend(q, k, v, mask), p[f"{prefix}.wo"])


def paged_attention_folded(q, k_pages, v_pages, lengths, block_tables,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """q (B, T, Hq, D) of T new tokens a row, whose K/V are already in the
    pools, attended by one ``flash_decode_paged`` call over B·T rows: row
    ``b·T + i`` is ``q[b, i]`` over table ``block_tables[b]`` at length
    ``lengths[b] + i + 1``, so every position attends to the logical
    positions at or before its own, as :func:`paged_attention_gather` and
    the JAX layer attend them.  A real position gets the length the
    decode tick of its token would give it.  A padded one reads what the
    gather reads: the pages its table names (null page 0, where padded
    positions write, included; an entry outside the pool is a dead
    position to both), up to the table's width, so its output equals the
    plain version's too (an MoE layer routes every row, padded ones
    included).  At T == 1 that is ``lengths + 1`` over the tables as
    given.  Returns (B, T, Hq·D) in q's dtype; CPU tensors take the
    kernel's plain version."""
    b, t = q.shape[:2]
    lengths = lengths.long()
    if t == 1:   # the decode tick: no copy of the tables on its host path
        lens, tables = lengths + 1, block_tables
    else:
        steps = torch.arange(1, t + 1, device=q.device)
        lens = (lengths[:, None] + steps[None]).reshape(-1)
        tables = block_tables.repeat_interleave(t, dim=0)
    scales = ({} if k_scales is None
              else dict(k_scales=k_scales, v_scales=v_scales))
    out = flash_decode_paged(q.reshape(b * t, *q.shape[2:]).contiguous(),
                             k_pages, v_pages, lens.to(torch.int32), tables,
                             **scales)
    return out.reshape(b, t, -1)


def paged_attention_gather(q, k_pages, v_pages, positions, block_tables,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """The JAX layer's paged attention: q (B, T, Hq, D) at ``positions``
    (B, T) over the pages of ``block_tables`` gathered into one (B, S)
    view (int8 pages dequantized to q's dtype), each token attending to
    the positions at or before its own.  Returns (B, T, Hq·D) in q's
    dtype."""
    b = q.shape[0]
    tables = block_tables.long()
    k_all = k_pages[tables].reshape(b, -1, *k_pages.shape[2:])
    v_all = v_pages[tables].reshape(b, -1, *v_pages.shape[2:])
    if k_scales is not None:   # dequantize the gathered view before softmax
        ks_all = k_scales[tables].reshape(b, -1, k_scales.shape[2])
        vs_all = v_scales[tables].reshape(b, -1, v_scales.shape[2])
        k_all = (k_all.float() * ks_all[..., None]).to(q.dtype)
        v_all = (v_all.float() * vs_all[..., None]).to(q.dtype)
    s = k_all.shape[1]
    mask = (torch.arange(s, device=q.device)[None, None]
            <= positions[:, :, None])[:, None, None]
    # q's dtype on every device, as the decode kernel (and the JAX kernels)
    # return it: fp32 pools under a bf16 model keep the bf16 activations the
    # card's apr_matmul takes (the JAX layer promotes them to fp32 here)
    return gqa_scores_attend(q, k_all, v_all, mask).to(q.dtype)


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
    k_scales: Optional[torch.Tensor] = None,  # (P_pool, page_size, Hkv) fp32
    v_scales: Optional[torch.Tensor] = None,  # when the pools are int8
) -> torch.Tensor:
    """Multi-token attention against, and update of, a paged KV cache.

    ``T == 1`` is the decode step, ``T == chunk`` one chunked-prefill step.
    Token ``i`` of slot ``b`` sits at logical position ``lengths[b] + i``
    and is written **in place** (``index_put_``) into ``k_pages`` /
    ``v_pages`` at page ``block_tables[b, pos // page_size]``, offset
    ``pos % page_size``.  Positions ``i >= new_counts[b]`` are padding:
    their writes go to the reserved null page 0, and the caller ignores
    their logits (an MoE layer still routes them).  Token ``i``, real or
    padded, attends to positions ``<= lengths + i``.

    With ``k_scales``/``v_scales`` the pools are **int8**: each new (token,
    head) vector is quantized over the head dim on write
    (``quantize_channelwise(axis=-1)``) and its fp32 scale written to the
    same slot of the scale pool.

    On CUDA every T (the decode step, a prefill chunk, a speculative
    verify step) calls the ``flash_decode_paged`` kernel (bf16, fp32 or
    int8 pools) once, after the new K/V are in the pool, with T folded into
    the batch (:func:`paged_attention_folded`), so a token's attention sums
    in the order of the decode tick that would have produced it; padded
    positions attend up to their own index, as on the CPU.  There is no
    other path on CUDA: a geometry the kernel refuses raises.  On the CPU
    the pages are gathered (int8 ones dequantized to ``x.dtype``) and
    attended as the JAX layer does (:func:`paged_attention_gather`).  The
    attention output has q's dtype on both paths; the JAX layer differs
    only for fp32 pools under a bf16 model, where it keeps fp32.  Returns
    the attention output after the ``wo`` projection, (B, T, d).
    """
    b, t, _ = x.shape
    ps = k_pages.shape[1]
    lengths = lengths.long()
    steps = torch.arange(t, device=x.device)
    positions = lengths[:, None] + steps[None]                  # (B, T)
    q, k_new, v_new = project_qkv(p, prefix, cfg, x, positions)
    write = steps[None] < new_counts.long()[:, None]            # (B, T)
    # every padded position writes slot 0 of null page 0, and the card
    # orders such writes in no way: give them all the last one's K/V (what
    # the CPU's in-order writes leave there), so that the page holds the
    # same bits on both and the padded positions that read it agree
    rows = torch.arange(b * t, device=x.device).reshape(b, t)
    src = torch.where(write, rows,
                      torch.where(write, -1, rows).amax()).reshape(-1)
    k_new, v_new = (n.reshape(b * t, *n.shape[2:])[src].reshape(n.shape)
                    for n in (k_new, v_new))
    page_idx = torch.clamp(positions // ps, max=block_tables.shape[1] - 1)
    bidx = torch.arange(b, device=x.device)[:, None]
    pids = torch.where(write, block_tables.long()[bidx, page_idx], 0)
    offs = torch.where(write, positions % ps, 0)
    quantized = k_scales is not None
    if quantized:
        for pool, spool, new in ((k_pages, k_scales, k_new),
                                 (v_pages, v_scales, v_new)):
            qt = quantize_channelwise(new, axis=-1)   # per (token, head)
            pool.index_put_((pids, offs), qt.q)
            spool.index_put_((pids, offs), qt.scale[..., 0])
    else:
        k_pages.index_put_((pids, offs), k_new.to(k_pages.dtype))
        v_pages.index_put_((pids, offs), v_new.to(v_pages.dtype))
    scales = dict(k_scales=k_scales, v_scales=v_scales) if quantized else {}
    if x.is_cuda:
        out = paged_attention_folded(q, k_pages, v_pages, lengths,
                                     block_tables, **scales)
    else:
        out = paged_attention_gather(q, k_pages, v_pages, positions,
                                     block_tables, **scales)
    return tp_einsum(out, p[f"{prefix}.wo"])


def attention_decode(
    p: Params,
    prefix: str,
    cfg: ModelConfig,
    x: torch.Tensor,             # (B, 1, d)
    k_cache: torch.Tensor,       # (B, S, Hkv, Dh) contiguous slot cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,       # (B,) int32 tokens already in the cache
    *,
    apply_rope: bool = True,
) -> torch.Tensor:
    """One-token attention against, and update of, a contiguous KV cache.

    The new token of row ``b`` sits at position ``lengths[b]`` (rotary
    there unless ``apply_rope`` is off) and is written there **in place**;
    it attends to positions ``<= lengths``.  On CUDA the ``flash_decode``
    kernel runs with lengths ``lengths + 1``, after the write; on the CPU
    the whole cache is masked and attended as the JAX layer does.  Returns
    the attention output after the ``wo`` projection, (B, 1, d).
    """
    b = x.shape[0]
    s = k_cache.shape[1]
    pos = lengths.long()
    q, k_new, v_new = project_qkv(p, prefix, cfg, x, pos[:, None],
                                  apply_rope)
    bidx = torch.arange(b, device=x.device)
    k_cache.index_put_((bidx, pos), k_new[:, 0].to(k_cache.dtype))
    v_cache.index_put_((bidx, pos), v_new[:, 0].to(v_cache.dtype))
    if x.is_cuda:
        out = flash_decode(q[:, 0].contiguous(), k_cache, v_cache,
                           (pos + 1).to(torch.int32)).reshape(b, 1, -1)
    else:
        mask = (torch.arange(s, device=x.device)[None]
                <= pos[:, None])[:, None, None, None, :]
        out = gqa_scores_attend(q, k_cache, v_cache, mask)
    return tp_einsum(out, p[f"{prefix}.wo"])
