"""Decoder-only dense LM, in PyTorch.

Port of the dense-family subset of the JAX package's ``repro.models.lm``:
the parameter layout of ``build_params``, the whole-sequence entry points
``lm_forward`` and ``lm_prefill``, ``init_paged_cache`` /
``lm_decode_paged`` (paged KV, bf16 or int8) and ``init_cache`` /
``lm_decode_step`` (the slot engine's contiguous cache).
Parameters keep the JAX names and the stacked layout -- ``blk.0.attn.wq``
is (n_layers, d, h·dh), and layer ``i`` uses the (K, N) slice ``[i]`` as it
lies in memory; any matmul weight may be an int8 ``QuantizedTensor``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig
from .layers import ParamSpecs, Params, attention, attention_decode, \
    attention_decode_paged, attn_params, causal_mask, gqa_scores_attend, \
    linear, mask_vocab_logits, project_qkv, rms_norm, swiglu, tp_einsum

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "int8": torch.int8}


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.num_experts:
        raise NotImplementedError(
            f"the port serves the dense family only so far, not "
            f"{cfg.family!r} ({cfg.name})")


def _check_prefix(prefix_embeds) -> None:
    if prefix_embeds is not None:
        raise NotImplementedError(
            "prefix_embeds (the vlm and audio families) is not ported yet")


def build_params(cfg: ModelConfig) -> ParamSpecs:
    """Shapes and init scales of the dense LM, name for name as the JAX
    ``build_params`` lays them out (``moe_every`` is 1, so every layer is
    ``blk.0.*`` stacked over ``num_layers``)."""
    _check_dense(cfg)
    d, n, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
    specs: ParamSpecs = {"embed": ((cfg.padded_vocab, d), 0.02)}
    specs.update(attn_params("blk.0.attn", cfg, n))
    for name, shape in (("mlp.w_gate", (n, d, ff)),
                        ("mlp.w_up", (n, d, ff)),
                        ("mlp.w_down", (n, ff, d))):
        specs[f"blk.0.{name}"] = (shape, shape[-2] ** -0.5)  # 1/sqrt(fan_in)
    specs["blk.0.ln1"] = ((n, d), 0.0)
    specs["blk.0.ln2"] = ((n, d), 0.0)
    specs["final_norm"] = ((d,), 0.0)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, cfg.padded_vocab), d ** -0.5)
    return specs


def init_paged_cache(cfg: ModelConfig, pool_pages: int, page_size: int,
                     kv_dtype: str = "bfloat16", device="cpu"
                     ) -> Dict[str, torch.Tensor]:
    """Per-layer KV page pools ``(n_layers, 1, pool_pages, page_size, Hkv,
    Dh)`` -- the JAX shape, whose second axis is ``moe_every`` (1 here).
    ``pool_pages`` includes the reserved null page 0.  ``kv_dtype="int8"``
    adds the fp32 scale pools ``k_scale`` / ``v_scale`` of shape
    ``(n_layers, 1, pool_pages, page_size, Hkv)``: one scale per (page
    slot, kv head), as in the JAX package."""
    _check_dense(cfg)
    if kv_dtype not in _KV_DTYPES:
        raise NotImplementedError(f"kv_dtype {kv_dtype!r} is not ported "
                                  f"(use one of {sorted(_KV_DTYPES)})")
    shape = (cfg.num_layers, 1, pool_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = _KV_DTYPES[kv_dtype]
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if kv_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cpu"
               ) -> Dict[str, torch.Tensor]:
    """The slot engine's contiguous KV cache: ``k`` / ``v`` of shape
    ``(n_layers, 1, batch, max_seq, Hkv, Dh)`` in bf16, the JAX shape and
    dtype (bf16 whatever the params' dtype)."""
    _check_dense(cfg)
    shape = (cfg.num_layers, 1, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final projection; a tied head is the (full-precision) embedding, an
    untied ``lm_head`` may be int8."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return mask_vocab_logits(linear(x, head), cfg.vocab_size)


def _decoder(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             attend: Callable[[int, Params, torch.Tensor], torch.Tensor],
             last_only: bool = False) -> torch.Tensor:
    """Embed, run every layer (``attend(i, layer_params, h)`` is layer
    ``i``'s attention on the normed input), final norm and head (on the
    last position alone with ``last_only``)."""
    _check_dense(cfg)
    x = params["embed"][tokens.long()]
    for i in range(cfg.num_layers):
        lp = {name[len("blk.0."):]: w[i] for name, w in params.items()
              if name.startswith("blk.0.")}
        h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
        x = x + attend(i, lp, h)
        h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
        x = x + swiglu(h, lp["mlp.w_gate"], lp["mlp.w_up"], lp["mlp.w_down"])
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    return _lm_head(params, cfg, x)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def lm_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
               prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, T, V) of the whole sequence ``tokens`` (B, T), every
    layer's attention causal over it (the JAX ``lm_forward`` with its
    layers unrolled).  ``prefix_embeds`` (vlm, audio) is not ported and
    raises."""
    _check_prefix(prefix_embeds)
    positions = _positions(tokens)
    return _decoder(params, cfg, tokens, lambda i, lp, h: attention(
        lp, "attn", cfg, h, positions))


def lm_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               max_seq: Optional[int] = None, *,
               prefix_embeds: Optional[torch.Tensor] = None):
    """The whole prompt (B, T) at once: the last-position logits (B, 1, V)
    and the slot engine's cache after it, ``k`` / ``v`` of shape
    ``(n_layers, 1, B, max_seq, Hkv, Dh)`` in bf16 with the prompt's K/V at
    positions ``< T`` and zeros past them (``max_seq`` defaults to T), as
    the JAX ``lm_prefill`` pads and stacks them and ``lm_decode_step``
    reads them.  ``prefix_embeds`` is not ported and raises."""
    _check_prefix(prefix_embeds)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, tokens.device)
    positions = _positions(tokens)
    mask = causal_mask(s, tokens.device)

    def attend(i, lp, h):
        q, k, v = project_qkv(lp, "attn", cfg, h, positions)
        cache["k"][i, 0, :, :s] = k
        cache["v"][i, 0, :, :s] = v
        return tp_einsum(gqa_scores_attend(q, k, v, mask), lp["attn.wo"])

    logits = _decoder(params, cfg, tokens, attend, last_only=True)
    return logits, cache


def lm_decode_paged(
    params: Params,
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,        # (B, T) new tokens; T=1 decode, T=chunk prefill
    lengths: torch.Tensor,       # (B,) int32 tokens already cached per slot
    new_counts: torch.Tensor,    # (B,) int32 real new tokens this call (<= T)
    block_tables: torch.Tensor,  # (B, P_max) int32
) -> torch.Tensor:
    """Multi-token decode/prefill step over the paged cache.

    Returns logits ``(B, T, V)``; the caller reads row ``new_counts[b]-1``
    of slot ``b`` and ignores padded rows.  The new K/V (and, for an int8
    cache, their scales) are written into the cache's pools in place (the
    JAX function returns a new cache instead)."""
    quantized = "k_scale" in cache

    def attend(i, lp, h):
        scales = (dict(k_scales=cache["k_scale"][i, 0],
                       v_scales=cache["v_scale"][i, 0]) if quantized else {})
        return attention_decode_paged(lp, "attn", cfg, h, cache["k"][i, 0],
                                      cache["v"][i, 0], lengths, new_counts,
                                      block_tables, **scales)

    return _decoder(params, cfg, tokens, attend)


def lm_decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,        # (B, 1)
    lengths: torch.Tensor,       # (B,) int32 tokens already cached per slot
) -> torch.Tensor:
    """One decode token for every slot over the contiguous cache.

    Returns logits ``(B, 1, V)``; token ``b`` is written at position
    ``lengths[b]`` of ``cache["k"]`` / ``cache["v"]`` in place (the JAX
    function returns a new cache instead)."""
    return _decoder(params, cfg, tokens, lambda i, lp, h: attention_decode(
        lp, "attn", cfg, h, cache["k"][i, 0], cache["v"][i, 0], lengths))
