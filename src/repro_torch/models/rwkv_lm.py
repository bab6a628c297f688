"""RWKV-6 language model (the attention-free ``ssm`` family), in PyTorch.

Port of the JAX package's ``repro.models.rwkv_lm``: parameters
(:func:`build_params`, the JAX names with the layer axis stacked), the
whole-sequence :func:`rwkv_forward` and :func:`rwkv_prefill` (the WKV
recurrence over the whole prompt, one ``rwkv6_wkv`` launch per layer on the
card), the O(1) :func:`rwkv_decode_step` on a carried state, and the paged
serving contract (:func:`init_paged_state`, :func:`rwkv_decode_paged`).
The serving state of a sequence is, per layer, the two token-shift rows
(bf16) and the (H, D, D) fp32 WKV matrix.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import ParamSpecs, Params, fan_in_scale, linear, \
    mask_vocab_logits, rematerialised, remat_wanted, rms_norm
from .paged_state import gather_state, scatter_state, split_state_tables
from .rwkv import rwkv6_channel_mix, rwkv6_time_mix, rwkv_params

State = Dict[str, torch.Tensor]


def build_params(cfg: ModelConfig) -> ParamSpecs:
    """Shapes and init scales, name for name as the JAX ``build_params``."""
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name} is not an rwkv6 (ssm) config")
    d, n, v = cfg.d_model, cfg.num_layers, cfg.padded_vocab
    specs: ParamSpecs = {"embed": ((v, d), 0.02)}
    specs.update(rwkv_params("blk", cfg, n))
    specs["blk.ln1"] = ((n, d), 0.0)
    specs["blk.ln2"] = ((n, d), 0.0)
    specs["final_norm"] = ((d,), 0.0)
    specs["lm_head"] = ((d, v), fan_in_scale((d, v)))
    return specs


def _layers(params: Params, cfg: ModelConfig):
    """Per-layer parameter dicts: layer ``i`` gets slice ``[i]`` of every
    stacked ``blk.*`` tensor, under its name without the prefix."""
    blk = {k[len("blk."):]: w for k, w in params.items()
           if k.startswith("blk.")}
    return [{k: w[i] for k, w in blk.items()} for i in range(cfg.num_layers)]


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    return mask_vocab_logits(linear(x, params["lm_head"]), cfg.vocab_size)


def _layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
           chunk: int) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
    x = x + rwkv6_time_mix(lp, "", cfg, h, chunk=chunk)
    h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
    return x + rwkv6_channel_mix(lp, "", cfg, h)


def rwkv_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                 chunk: int = 64) -> torch.Tensor:
    """Logits (B, T, V) of the whole sequence ``tokens`` (B, T); under a
    gradient each layer recomputed in the backward when ``cfg.remat``
    (:func:`.layers.remat_wanted`), all of it whatever
    ``cfg.remat_policy`` says, as the JAX forward wraps it in
    ``jax.checkpoint`` with ``nothing_saveable``."""
    remat = remat_wanted(cfg, params)
    x = params["embed"][tokens.long()]
    for lp in _layers(params, cfg):
        x = rematerialised(remat, _layer, cfg, x, lp, chunk)
    return _head(params, cfg, x)


def init_state(cfg: ModelConfig, batch: int, device="cpu") -> State:
    """The decode carry of ``batch`` sequences, zeros (the JAX dtypes:
    bf16 token-shift rows, fp32 WKV state, whatever the params' dtype)."""
    d, dh, n = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers
    return {
        "tmix_x": torch.zeros((n, batch, d), dtype=torch.bfloat16,
                              device=device),
        "cmix_x": torch.zeros((n, batch, d), dtype=torch.bfloat16,
                              device=device),
        "wkv": torch.zeros((n, batch, d // dh, dh, dh), dtype=torch.float32,
                           device=device),
    }


def rwkv_decode_step(params: Params, cfg: ModelConfig, state: State,
                     tokens: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """One token per row, tokens (B, 1): logits (B, 1, V) and the new
    carry (the old one is not written).  Cost independent of context."""
    x = params["embed"][tokens.long()]
    tmix, cmix, wkv = [], [], []
    for i, lp in enumerate(_layers(params, cfg)):
        h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
        out, new_tmx, new_wkv = rwkv6_time_mix(
            lp, "", cfg, h, chunk=1, last_x=state["tmix_x"][i],
            s_init=state["wkv"][i], return_state=True)
        x = x + out
        h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
        out, new_cmx = rwkv6_channel_mix(lp, "", cfg, h,
                                         last_x=state["cmix_x"][i],
                                         return_last=True)
        x = x + out
        tmix.append(new_tmx.to(torch.bfloat16))
        cmix.append(new_cmx.to(torch.bfloat16))
        wkv.append(new_wkv)
    return _head(params, cfg, x), {"tmix_x": torch.stack(tmix),
                                   "cmix_x": torch.stack(cmix),
                                   "wkv": torch.stack(wkv)}


def rwkv_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                 chunk: int = 64) -> Tuple[torch.Tensor, State]:
    """The whole prompt (B, T) at once: last-position logits (B, 1, V) and
    the decode carry after it."""
    x = params["embed"][tokens.long()]
    tmix, cmix, wkv = [], [], []
    for lp in _layers(params, cfg):
        h = rms_norm(x, lp["ln1"] + 1.0, cfg.norm_eps)
        out, tmx, s = rwkv6_time_mix(lp, "", cfg, h, chunk=chunk,
                                     return_state=True)
        x = x + out
        h = rms_norm(x, lp["ln2"] + 1.0, cfg.norm_eps)
        out, cmx = rwkv6_channel_mix(lp, "", cfg, h, return_last=True)
        x = x + out
        tmix.append(tmx.to(torch.bfloat16))
        cmix.append(cmx.to(torch.bfloat16))
        wkv.append(s)
    return _head(params, cfg, x[:, -1:]), {"tmix_x": torch.stack(tmix),
                                           "cmix_x": torch.stack(cmix),
                                           "wkv": torch.stack(wkv)}


# ---------------------------------------------------------------------------
# Paged serving: state pools behind the StateCache contract.
# ---------------------------------------------------------------------------


def init_paged_state(cfg: ModelConfig, state_slots: int,
                     state_dtype: str = "float32", device="cpu") -> State:
    """State pools with the physical state slot as axis 1 (the engine's copy
    convention; ``repro_torch.serve.state_cache``).  ``state_dtype="int8"``
    stores the WKV matrices int8 with per-(layer, slot, head) scales."""
    d, dh, n, s = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers, state_slots
    pools = {
        "tmix_x": torch.zeros((n, s, d), dtype=torch.bfloat16, device=device),
        "cmix_x": torch.zeros((n, s, d), dtype=torch.bfloat16, device=device),
    }
    shape = (n, s, d // dh, dh, dh)
    if state_dtype == "int8":
        pools["wkv"] = torch.zeros(shape, dtype=torch.int8, device=device)
        pools["wkv_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                         device=device)
    elif state_dtype == "float32":
        pools["wkv"] = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unsupported state_dtype {state_dtype!r}")
    return pools


def rwkv_decode_paged(params: Params, cfg: ModelConfig, cache: State,
                      tokens: torch.Tensor, lengths: torch.Tensor,
                      new_counts: torch.Tensor,
                      block_tables: torch.Tensor) -> torch.Tensor:
    """Paged decode/prefill chunk, tokens (B, T): gather the state at the
    read column, run the *same* per-token recurrence as the slot engine (so
    greedy outputs are identical), scatter the post-token state to each
    write column, in place.  Padded positions write to the trash slot and
    their logits rows are ignored by the caller."""
    _, read, writes = split_state_tables(block_tables, tokens.shape[1])
    state = gather_state(cache, read)
    outs = []
    for t in range(tokens.shape[1]):
        logits, state = rwkv_decode_step(params, cfg, state,
                                         tokens[:, t:t + 1])
        scatter_state(cache, state, writes[:, t])
        outs.append(logits)
    return torch.cat(outs, dim=1)
