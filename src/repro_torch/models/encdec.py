"""Whisper-style encoder-decoder (the audio family), in PyTorch.

Port of the JAX package's ``repro.models.encdec``.  The conv/mel frontend
is a stub there too: ``frames`` are precomputed frame embeddings (B, F, d)
and the encoder transformer runs on them directly.  The decoder runs causal
self-attention and cross-attention into the encoder output; positions are
learned embeddings (``pos_enc``, ``pos_dec``), with no rotary anywhere.

Parameters keep the JAX names and the stacked layout (``enc.attn.wq`` is
(L_enc, d, h·dh), ``dec.cross.wk`` (L, d, hkv·dh), ...), and the layers run
unrolled in the JAX order.  Products follow the JAX model's split: the
attention blocks' ``wo`` inside ``layers.attention`` / ``attention_decode``
go through ``tp_einsum``; every other weight product (q/k/v, the cross K/V
of the encoder output, ``cross.wo``, the prefill's ``self.wo``, the GELU
MLP and the head), a plain ``einsum`` in JAX, goes through ``linear``
(``apr_matmul`` on the card).  The score and probability products are
plain PyTorch (``gqa_scores_attend``), as the JAX model computes them
outside any kernel, except the decode step's self-attention, which is
``flash_decode`` on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from .layers import (ParamSpecs, Params, attention, attention_decode,
                     attn_params, causal_mask, fan_in_scale, gelu,
                     gqa_scores_attend, linear, mask_vocab_logits,
                     project_qkv, rematerialised, remat_wanted, rms_norm)

#: rows of the decoder's learned position table, as the JAX model builds it
DEC_POSITIONS = 32768


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name} is not an audio (whisper) config")


def gelu_mlp_params(prefix: str, cfg: ModelConfig, layers: int) -> ParamSpecs:
    """``{prefix}.w1`` (L, d, ff) and ``{prefix}.w2`` (L, ff, d)."""
    d, ff = cfg.d_model, cfg.d_ff
    return {f"{prefix}.w1": ((layers, d, ff), fan_in_scale((d, ff))),
            f"{prefix}.w2": ((layers, ff, d), fan_in_scale((ff, d)))}


def gelu_mlp(lp: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return linear(gelu(linear(x, lp[f"{prefix}.w1"])), lp[f"{prefix}.w2"])


def build_params(cfg: ModelConfig) -> ParamSpecs:
    """Shapes and init scales, name for name as the JAX ``build_params``."""
    _check_family(cfg)
    d = cfg.d_model
    le, ld = cfg.encoder_layers, cfg.num_layers
    specs: ParamSpecs = {
        "embed": ((cfg.padded_vocab, d), 0.02),
        "pos_dec": ((DEC_POSITIONS, d), 0.02),
        "pos_enc": ((cfg.encoder_frames, d), 0.02)}
    specs.update(attn_params("enc.attn", cfg, le))
    specs.update(gelu_mlp_params("enc.mlp", cfg, le))
    specs.update({"enc.ln1": ((le, d), 0.0), "enc.ln2": ((le, d), 0.0),
                  "enc_final": ((d,), 0.0)})
    specs.update(attn_params("dec.self", cfg, ld))
    specs.update(attn_params("dec.cross", cfg, ld))
    specs.update(gelu_mlp_params("dec.mlp", cfg, ld))
    specs.update({f"dec.ln{i}": ((ld, d), 0.0) for i in (1, 2, 3)})
    specs["final_norm"] = ((d,), 0.0)
    head = (d, cfg.padded_vocab)
    specs["lm_head"] = (head, fan_in_scale(head))
    return specs


def _layers(params: Params, prefix: str, n: int):
    """Layer ``i``'s slice of every ``{prefix}*`` parameter, named without
    the prefix, for ``i`` in order."""
    group = {k[len(prefix):]: w for k, w in params.items()
             if k.startswith(prefix)}
    for i in range(n):
        yield i, {k: w[i] for k, w in group.items()}


def _enc_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params
               ) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
    x = x + attention(lp, "attn", cfg, h, causal=False, apply_rope=False)
    h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
    return x + gelu_mlp(lp, "mlp", h)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder output (B, F, d):
    non-causal self-attention without rotary, then the GELU MLP, each
    after an RMS norm, and a final norm.  Under a gradient each layer is
    recomputed in the backward when ``cfg.remat``
    (:func:`.layers.remat_wanted`; all of it, whatever
    ``cfg.remat_policy`` says), as in JAX."""
    remat = remat_wanted(cfg, params)
    f = frames.shape[1]
    x = frames.to(torch.bfloat16) + params["pos_enc"][:f][None]
    for _, lp in _layers(params, "enc.", cfg.encoder_layers):
        x = rematerialised(remat, _enc_layer, cfg, x, lp)
    return rms_norm(x, params["enc_final"] + 1.0, cfg.norm_eps)


def _cross_kv(lp: Params, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention K and V (B, F, Hkv, Dh) of the encoder output."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    b, f = enc_out.shape[:2]
    return tuple(linear(enc_out, lp[f"cross.{n}"]).reshape(b, f, hkv, dh)
                 for n in ("wk", "wv"))


def _cross(lp: Params, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor,
           kc: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """``x`` plus the cross-attention of ``h`` over K/V ``kc``, ``vc``, then
    plus the GELU MLP, each after its norm (``ln3`` before the MLP).  Only
    the query is projected from ``h`` (the JAX model's ``project_qkv``
    there also projects a key and a value, which it drops)."""
    b, t, _ = h.shape
    qc = linear(h, lp["cross.wq"]).reshape(b, t, cfg.num_heads,
                                            cfg.resolved_head_dim)
    x = x + linear(gqa_scores_attend(qc, kc, vc, None), lp["cross.wo"])
    h = rms_norm(x, lp["ln3"] + 1.0, cfg.norm_eps)
    return x + gelu_mlp(lp, "mlp", h)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    return mask_vocab_logits(linear(x, params["lm_head"]), cfg.vocab_size)


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    s = tokens.shape[1]
    return params["embed"][tokens.long()] + params["pos_dec"][:s][None]


def encdec_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor) -> torch.Tensor:
    """Teacher-forced forward: logits (B, T, V) over the decoder positions
    of ``tokens`` (B, T), attending to the encoded ``frames``.  Under a
    gradient each decoder layer (its cross K/V of the encoder output
    included) is recomputed in the backward when ``cfg.remat`` (all of
    it, whatever ``cfg.remat_policy`` says), as in JAX."""
    enc_out = encode(params, cfg, frames)
    remat = remat_wanted(cfg, params)
    x = _embed(params, tokens)
    for _, lp in _layers(params, "dec.", cfg.num_layers):
        x = rematerialised(remat, _dec_layer, cfg, x, lp, enc_out)
    return _head(params, cfg, x)


def _dec_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
               enc_out: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
    x = x + attention(lp, "self", cfg, h, causal=True, apply_rope=False)
    h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
    return _cross(lp, cfg, x, h, *_cross_kv(lp, cfg, enc_out))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cpu"
               ) -> Dict[str, torch.Tensor]:
    """The slot engine's cache, in bf16 as in the JAX model: ``self_k`` /
    ``self_v`` (L, B, max_seq, Hkv, Dh) and ``cross_k`` / ``cross_v`` (L,
    B, F, Hkv, Dh), all zeros."""
    _check_family(cfg)
    lead = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    shapes = {"self_k": lead + (max_seq,) + tail,
              "self_v": lead + (max_seq,) + tail,
              "cross_k": lead + (cfg.encoder_frames,) + tail,
              "cross_v": lead + (cfg.encoder_frames,) + tail}
    return {name: torch.zeros(shape, dtype=torch.bfloat16, device=device)
            for name, shape in shapes.items()}


def encdec_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor, max_seq: Optional[int] = None):
    """Encode the audio and run the decoder prompt ``tokens`` (B, T): the
    last position's logits (B, 1, V) and the cache after it, the prompt's
    self K/V at positions ``< T`` (zeros up to ``max_seq``, T by default)
    and the cross K/V of the encoder output, computed once here and kept."""
    enc_out = encode(params, cfg, frames)
    b, s = tokens.shape
    frames_cfg = dataclasses.replace(cfg, encoder_frames=frames.shape[1])
    cache = init_cache(frames_cfg, b, max_seq or s, tokens.device)
    x = _embed(params, tokens)
    mask = causal_mask(s, tokens.device)
    for i, lp in _layers(params, "dec.", cfg.num_layers):
        h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
        q, k, v = project_qkv(lp, "self", cfg, h, None, apply_rope=False)
        x = x + linear(gqa_scores_attend(q, k, v, mask), lp["self.wo"])
        h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
        kc, vc = _cross_kv(lp, cfg, enc_out)
        x = _cross(lp, cfg, x, h, kc, vc)
        cache["self_k"][i, :, :s] = k
        cache["self_v"][i, :, :s] = v
        cache["cross_k"][i] = kc
        cache["cross_v"][i] = vc
    return _head(params, cfg, x[:, -1:]), cache


def encdec_decode_step(params: Params, cfg: ModelConfig,
                       cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """One decode token a row (``tokens`` (B, 1) at positions ``lengths``):
    self-attention over the cache (``attention_decode``: ``flash_decode``
    on the card; the new K/V written into ``self_k`` / ``self_v`` in
    place), then cross-attention over ``cross_k`` / ``cross_v`` as plain
    products, as the JAX model computes it.  Returns the logits (B, 1, V);
    the cross K/V are read, never written."""
    pos = params["pos_dec"][lengths.long()]
    x = params["embed"][tokens.long()] + pos[:, None]
    for i, lp in _layers(params, "dec.", cfg.num_layers):
        h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
        x = x + attention_decode(lp, "self", cfg, h, cache["self_k"][i],
                                 cache["self_v"][i], lengths,
                                 apply_rope=False)
        h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
        x = _cross(lp, cfg, x, h, cache["cross_k"][i], cache["cross_v"][i])
    return _head(params, cfg, x)
