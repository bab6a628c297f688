"""Decoder-only LM (the dense, moe and vlm families), in PyTorch.

Port of the JAX package's ``repro.models.lm``: the parameter layout of
``build_params`` (super-blocks of ``moe_every`` layers, the last of each an
MoE layer in the moe family), the whole-sequence entry points
``lm_forward`` and ``lm_prefill`` (with the vlm's ``prefix_embeds``),
``init_paged_cache`` / ``lm_decode_paged`` (paged KV, bf16, fp32 or int8)
and ``init_cache`` / ``lm_decode_step`` (the slot engine's contiguous
cache).  Parameters keep the JAX names and the stacked layout --
``blk.{j}.attn.wq`` is (n_sb, d, h·dh) for layer ``j`` of each super-block,
and super-block ``sb`` uses the (K, N) slice ``[sb]`` as it lies in memory;
any matmul weight may be an int8 ``QuantizedTensor`` (the MoE router stays
full precision).  The layers run unrolled, super-block by super-block, in
the JAX ``_super_block``'s order; ``lm_forward`` is differentiable (the
training path), with each super-block rematerialised under ``cfg.remat``
as ``cfg.remat_policy`` says (:func:`remat_policy`).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import ParamSpecs, Params, attention, attention_decode, \
    attention_decode_paged, attn_params, causal_mask, fan_in_scale, \
    gqa_scores_attend, linear, mask_vocab_logits, project_qkv, \
    rematerialised, remat_wanted, rms_norm, swiglu, tp_einsum
from .moe import moe_block, moe_params

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "int8": torch.int8}
#: the families this module serves, as the JAX package routes them here
FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"models/lm.py serves the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r} ({cfg.name})")


def super_block(cfg: ModelConfig) -> Tuple[int, int]:
    """``(n_sb, me)``: super-blocks and layers per super-block, the JAX
    layout (``me = moe_every`` for an MoE model, else 1)."""
    me = max(cfg.moe_every, 1) if cfg.num_experts else 1
    return cfg.num_layers // me, me


def _is_moe(cfg: ModelConfig, j: int) -> bool:
    """Whether layer ``j`` of a super-block is an MoE layer (the last)."""
    return bool(cfg.num_experts) and j == super_block(cfg)[1] - 1


def build_params(cfg: ModelConfig) -> ParamSpecs:
    """Shapes and init scales, name for name as the JAX ``build_params``
    lays them out: for each layer ``j`` of a super-block, ``blk.{j}.attn.*``,
    ``blk.{j}.ln1`` / ``ln2`` and ``blk.{j}.mlp.*`` (``blk.{j}.moe.*`` on
    the MoE layer), each stacked over the ``n_sb`` super-blocks."""
    _check_family(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    n_sb, me = super_block(cfg)
    specs: ParamSpecs = {"embed": ((cfg.padded_vocab, d), 0.02)}
    for j in range(me):
        specs.update(attn_params(f"blk.{j}.attn", cfg, n_sb))
        specs[f"blk.{j}.ln1"] = ((n_sb, d), 0.0)
        specs[f"blk.{j}.ln2"] = ((n_sb, d), 0.0)
        if _is_moe(cfg, j):
            specs.update(moe_params(f"blk.{j}.moe", cfg, n_sb))
        else:
            for name, shape in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                                ("w_down", (ff, d))):
                specs[f"blk.{j}.mlp.{name}"] = ((n_sb,) + shape,
                                                fan_in_scale(shape))
    specs["final_norm"] = ((d,), 0.0)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, cfg.padded_vocab), d ** -0.5)
    return specs


def _kv_shape(cfg: ModelConfig, rows: int, seq: int) -> Tuple[int, ...]:
    return super_block(cfg) + (rows, seq, cfg.num_kv_heads,
                               cfg.resolved_head_dim)


def init_paged_cache(cfg: ModelConfig, pool_pages: int, page_size: int,
                     kv_dtype: str = "bfloat16", device="cpu"
                     ) -> Dict[str, torch.Tensor]:
    """Per-layer KV page pools ``(n_sb, me, pool_pages, page_size, Hkv,
    Dh)``, the JAX shape.  ``pool_pages`` includes the reserved null page
    0.  ``kv_dtype="int8"`` adds the fp32 scale pools ``k_scale`` /
    ``v_scale`` of shape ``(n_sb, me, pool_pages, page_size, Hkv)``: one
    scale per (page slot, kv head), as in the JAX package."""
    _check_family(cfg)
    if kv_dtype not in _KV_DTYPES:
        raise NotImplementedError(f"kv_dtype {kv_dtype!r} is not ported "
                                  f"(use one of {sorted(_KV_DTYPES)})")
    shape = _kv_shape(cfg, pool_pages, page_size)
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
    ``(n_sb, me, batch, max_seq, Hkv, Dh)`` in bf16, the JAX shape and
    dtype (bf16 whatever the params' dtype)."""
    _check_family(cfg)
    shape = _kv_shape(cfg, batch, max_seq)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final projection; a tied head is the (full-precision) embedding, an
    untied ``lm_head`` may be int8."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return mask_vocab_logits(linear(x, head), cfg.vocab_size)


def _super_blocks(params: Params, cfg: ModelConfig
                  ) -> Iterator[Tuple[int, Tuple[Params, ...]]]:
    """``(sb, layer params)`` for every super-block in order: for each
    layer ``j``, super-block ``sb``'s slice of ``blk.{j}.*``, named as the
    JAX ``_super_block`` names them (``attn.wq``, ``ln1``, ``mlp.w_gate``
    / ``moe.router``).  With one super-block a tensor's slice is
    ``squeeze(0)``, a view whose backward is a view of the slice's
    gradient: ``w[0]``'s would copy it into fresh zeros of the whole leaf
    (a second full-size tensor of an MoE expert leaf)."""
    n_sb, me = super_block(cfg)
    for sb in range(n_sb):
        layers = []
        for j in range(me):
            pre = f"blk.{j}."
            layers.append({name[len(pre):]: (
                w.squeeze(0) if n_sb == 1 and isinstance(w, torch.Tensor)
                else w[sb])
                for name, w in params.items() if name.startswith(pre)})
        yield sb, tuple(layers)


def remat_policy(cfg: ModelConfig, pctx=None) -> str:
    """What a checkpointed super-block keeps on this device, as the JAX
    ``_remat_policy`` maps ``cfg.remat_policy``: ``"dots"`` keeps the
    outputs of its products without batch dimensions
    (``dots_with_no_batch_dims_saveable``); ``"save_coll"`` keeps the
    values named ``moe_a2a``, the expert-parallel all-to-alls, which only
    a mesh has, so on one device it keeps nothing, as ``"nothing"`` does
    and as every other name does.  ``"save_coll"`` over a parallel context
    with a mesh is refused by name."""
    if cfg.remat_policy == "dots":
        return "dots"
    if cfg.remat_policy == "save_coll" and \
            getattr(pctx, "mesh", None) is not None:
        raise NotImplementedError(
            "remat_policy 'save_coll' over a mesh keeps the expert-parallel "
            "all-to-alls (moe_a2a), which need expert parallelism over "
            "several cards (ROADMAP A.12); not ported")
    return "nothing"


def _super_block(cfg: ModelConfig, attend, sb: int,
                 layers: Tuple[Params, ...], x: torch.Tensor) -> torch.Tensor:
    """Super-block ``sb``'s ``moe_every`` layers on ``x``, the JAX
    ``_super_block``: ``attend((sb, j), layer_params, h)`` is layer ``(sb,
    j)``'s attention on the normed input; the MoE layer's FFN is
    ``moe_block``.  The last layer's FFN is the block's closing one
    (``swiglu``'s ``closing``)."""
    for j, lp in enumerate(layers):
        closing = j == len(layers) - 1
        h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
        x = x + attend((sb, j), lp, h)
        h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
        if _is_moe(cfg, j):
            x = x + moe_block(lp, "moe", cfg, h, closing=closing)
        else:
            x = x + swiglu(h, lp["mlp.w_gate"], lp["mlp.w_up"],
                           lp["mlp.w_down"], closing=closing)
    return x


def _decoder(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             attend: Callable[[Tuple[int, int], Params, torch.Tensor],
                              torch.Tensor],
             last_only: bool = False,
             prefix_embeds: Optional[torch.Tensor] = None,
             remat: bool = False, pctx=None) -> torch.Tensor:
    """Embed (after ``prefix_embeds``, when given), run every super-block
    (:func:`_super_block`), final norm and head (on the last position
    alone with ``last_only``).  With ``remat`` and a gradient to compute
    (:func:`.layers.remat_wanted`) each super-block runs under
    ``torch.utils.checkpoint`` (non-reentrant), the port of
    ``jax.checkpoint`` under :func:`remat_policy`: its activations are
    recomputed in the backward, all of them or, under ``"dots"``, all but
    its products' outputs."""
    _check_family(cfg)
    remat = remat and remat_wanted(cfg, params)
    dots = remat and remat_policy(cfg, pctx) == "dots"
    x = params["embed"][tokens.long()]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    for sb, layers in _super_blocks(params, cfg):
        x = rematerialised(remat, _super_block, cfg, attend, sb, layers,
                           x, dots=dots)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    return _lm_head(params, cfg, x)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _length(tokens: torch.Tensor, prefix_embeds) -> int:
    return tokens.shape[1] + (0 if prefix_embeds is None
                              else prefix_embeds.shape[1])


def lm_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
               prefix_embeds: Optional[torch.Tensor] = None,
               pctx=None) -> torch.Tensor:
    """Logits (B, S, V) of the whole sequence: ``prefix_embeds`` (B, Nv, d)
    (the vlm's vision embeddings, any LM family's stub prefix) then the
    embedded ``tokens`` (B, T), S = Nv + T, positions over the whole
    sequence, every layer's attention causal over it (the JAX
    ``lm_forward`` with its layers unrolled; under a gradient, each
    super-block recomputed in the backward when ``cfg.remat``, as the JAX
    forward wraps it in ``jax.checkpoint`` under ``cfg.remat_policy``).
    ``pctx`` is the JAX function's parallel context; over one with a mesh
    ``"save_coll"`` is refused (:func:`remat_policy`)."""
    positions = _positions(tokens.shape[0], _length(tokens, prefix_embeds),
                           tokens.device)
    return _decoder(params, cfg, tokens, lambda sj, lp, h: attention(
        lp, "attn", cfg, h, positions), prefix_embeds=prefix_embeds,
        remat=cfg.remat, pctx=pctx)


def lm_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               max_seq: Optional[int] = None, *,
               prefix_embeds: Optional[torch.Tensor] = None):
    """The whole prompt at once (``prefix_embeds`` then ``tokens``, S
    positions): the last-position logits (B, 1, V) and the slot engine's
    cache after it, ``k`` / ``v`` of shape ``(n_sb, me, B, max_seq, Hkv,
    Dh)`` in bf16 with the K/V of all S positions (the prefix's included)
    at positions ``< S`` and zeros past them (``max_seq`` defaults to S),
    as the JAX ``lm_prefill`` pads and stacks them and ``lm_decode_step``
    reads them."""
    b = tokens.shape[0]
    s = _length(tokens, prefix_embeds)
    cache = init_cache(cfg, b, max_seq or s, tokens.device)
    positions = _positions(b, s, tokens.device)
    mask = causal_mask(s, tokens.device)

    def attend(sj, lp, h):
        q, k, v = project_qkv(lp, "attn", cfg, h, positions)
        cache["k"][sj][:, :s] = k
        cache["v"][sj][:, :s] = v
        return tp_einsum(gqa_scores_attend(q, k, v, mask), lp["attn.wo"])

    logits = _decoder(params, cfg, tokens, attend, last_only=True,
                      prefix_embeds=prefix_embeds)
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

    def attend(sj, lp, h):
        scales = (dict(k_scales=cache["k_scale"][sj],
                       v_scales=cache["v_scale"][sj]) if quantized else {})
        return attention_decode_paged(lp, "attn", cfg, h, cache["k"][sj],
                                      cache["v"][sj], lengths, new_counts,
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
    return _decoder(params, cfg, tokens, lambda sj, lp, h: attention_decode(
        lp, "attn", cfg, h, cache["k"][sj], cache["v"][sj], lengths))
