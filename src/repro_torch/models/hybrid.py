"""Zamba2-style hybrid, in PyTorch: a Mamba-2 backbone plus one *shared*
attention block applied every ``cfg.attn_every`` layers (weight reuse is
the Zamba trick -- attention quality at almost no parameter cost).

Port of the JAX package's ``repro.models.hybrid``.  Layer layout for
num_layers=38, attn_every=6: 6 super-blocks of (6 mamba layers + the shared
attention) + 2 tail mamba layers.  Parameters keep the JAX names and
stacking: ``sb.{j}.*`` is stacked over the super-blocks (super-block ``i``
uses slice ``[i]``), ``tail.{j}.*`` and ``shared.*`` are single.

Every projection goes through ``apr_matmul``, the SSD recurrence through
``mamba2_ssd`` (``models/ssm.py``: over all T in the forward, at T = 1 in
decode) and the shared attention's decode through ``flash_decode`` (slot
cache) or ``flash_decode_paged`` (page pools); on CPU tensors each takes
its plain version.  As in the rest of the port, KV caches and page pools
are written in place, and ``scatter_state`` writes the state pools in
place.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import ParamSpecs, Params, attention, attention_decode, \
    attention_decode_paged, attn_params, fan_in_scale, linear, \
    mask_vocab_logits, rematerialised, remat_wanted, rms_norm
from .paged_state import gather_state, scatter_state, split_state_tables
from .ssm import CONV_K, init_paged_state, mamba2_decode, mamba_layer, \
    ssm_params

State = Dict[str, torch.Tensor]


def _layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(super-blocks, mamba layers a super-block, tail mamba layers)."""
    ae = cfg.attn_every
    n_sb = cfg.num_layers // ae
    tail = cfg.num_layers - n_sb * ae
    return n_sb, ae, tail


def build_params(cfg: ModelConfig) -> ParamSpecs:
    """Shapes and init scales, name for name as the JAX ``build_params``."""
    if cfg.family != "hybrid":
        raise ValueError(f"{cfg.name} is not a hybrid (zamba2) config")
    d = cfg.d_model
    n_sb, ae, tail = _layout(cfg)
    specs: ParamSpecs = {"embed": ((cfg.padded_vocab, d), 0.02)}
    for j in range(ae):
        specs.update(ssm_params(f"sb.{j}.ssm", cfg, n_sb))
        specs[f"sb.{j}.ln"] = ((n_sb, d), 0.0)
    for j in range(tail):
        specs.update(ssm_params(f"tail.{j}.ssm", cfg, None))
        specs[f"tail.{j}.ln"] = ((d,), 0.0)
    # ONE shared attention block (not stacked)
    specs.update(attn_params("shared.attn", cfg, None))
    specs["shared.ln"] = ((d,), 0.0)
    specs["final_norm"] = ((d,), 0.0)
    head = (d, cfg.padded_vocab)
    specs["lm_head"] = (head, fan_in_scale(head))
    return specs


def _sub(params: Params, prefix: str, i=None) -> Params:
    """The parameters under ``prefix`` (named without it), slice ``[i]``
    of each where ``i`` is given."""
    return {k[len(prefix):]: (w if i is None else w[i])
            for k, w in params.items() if k.startswith(prefix)}


def _mamba_layers(params: Params, cfg: ModelConfig) -> List[List[Params]]:
    """Each super-block's mamba layers' parameters, then the tail's as one
    more list, in layer order (the order of the state's layer axis)."""
    n_sb, ae, tail = _layout(cfg)
    blocks = [[_sub(params, f"sb.{j}.", i) for j in range(ae)]
              for i in range(n_sb)]
    return blocks + [[_sub(params, f"tail.{j}.") for j in range(tail)]]


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    return mask_vocab_logits(linear(x, params["lm_head"]), cfg.vocab_size)


def adaptive_chunk(t: int) -> int:
    """SSD chunk size of the CPU formula, as the JAX package picks it: at
    most 32 chunks, and chunks of at least 256."""
    return max(256, -(-t // 32))


def hybrid_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   *, chunk: int = 0) -> torch.Tensor:
    """Logits (B, T, V) of the whole sequence ``tokens`` (B, T): every
    super-block's mamba layers, then the shared attention (causal over the
    sequence), then the tail (the JAX ``hybrid_forward`` unrolled).  Under
    a gradient each super-block is recomputed in the backward when
    ``cfg.remat`` (:func:`.layers.remat_wanted`; all of it, whatever
    ``cfg.remat_policy`` says), the tail not, as in JAX."""
    remat = remat_wanted(cfg, params)
    x = params["embed"][tokens.long()]
    b, s = tokens.shape
    chunk = chunk or adaptive_chunk(s)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    shared = _sub(params, "shared.")
    *blocks, tail = _mamba_layers(params, cfg)

    def super_block(x, block, shared):
        for lp in block:
            x = mamba_layer(cfg, x, lp, chunk)
        h = rms_norm(x, shared["ln"] + 1.0, cfg.norm_eps)
        return x + attention(shared, "attn", cfg, h, positions)

    for block in blocks:
        x = rematerialised(remat, super_block, x, block, shared)
    for lp in tail:
        x = mamba_layer(cfg, x, lp, chunk)
    return _head(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving state: per-mamba-layer (conv, ssm) + shared-attn KV caches.
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, batch: int, max_seq: int,
               device="cpu") -> State:
    """The slot engine's carry of ``batch`` rows, zeros, batch at axis 1:
    the conv window and SSD state of every mamba layer in fp32 (the JAX
    package keeps the raw conv window fp32 so that decode does not
    re-round it every step), and one contiguous bf16 KV cache per shared
    attention application, ``(n_sb, batch, max_seq, Hkv, Dh)``."""
    n_sb, _, _ = _layout(cfg)
    ch = cfg.d_inner + 2 * cfg.ssm_state
    n, h, p, s = (cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim,
                  cfg.ssm_state)
    kv = (n_sb, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "conv": torch.zeros((n, batch, CONV_K - 1, ch), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((n, batch, h, p, s), dtype=torch.float32,
                           device=device),
        "attn_k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
        "attn_v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
    }


def _token_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                conv: torch.Tensor, ssm: torch.Tensor,
                attend: Callable[[int, Params, torch.Tensor], torch.Tensor]):
    """One token per row, tokens (B, 1), through the whole stack from the
    carried ``conv`` / ``ssm`` stacks (layers at axis 0); ``attend(i,
    shared, h)`` is the ``i``-th shared-attention application on the
    normed input, which updates its own KV store.  Returns the logits
    (B, 1, V) and the new conv and SSD stacks (the old ones are not
    written)."""
    x = params["embed"][tokens.long()]
    shared = _sub(params, "shared.")
    *blocks, tail = _mamba_layers(params, cfg)
    conv_l, ssm_l = [], []

    def mamba(x, lp):
        h = rms_norm(x, lp["ln"] + 1.0, cfg.norm_eps)
        li = len(conv_l)
        out, cs, ss = mamba2_decode(lp, "ssm", cfg, h, conv[li], ssm[li])
        conv_l.append(cs)
        ssm_l.append(ss)
        return x + out

    for i, block in enumerate(blocks):
        for lp in block:
            x = mamba(x, lp)
        h = rms_norm(x, shared["ln"] + 1.0, cfg.norm_eps)
        x = x + attend(i, shared, h)
    for lp in tail:
        x = mamba(x, lp)
    return _head(params, cfg, x), torch.stack(conv_l), torch.stack(ssm_l)


def hybrid_decode_step(params: Params, cfg: ModelConfig, state: State,
                       tokens: torch.Tensor, lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, State]:
    """One token per row, tokens (B, 1), at positions ``lengths`` (B,):
    logits (B, 1, V) and the new carry.  The new conv and SSD stacks are
    new tensors; the new K/V are written into ``state["attn_k"]`` /
    ``["attn_v"]`` in place (the returned carry holds those same tensors),
    where the JAX function returns new caches."""
    def attend(i, shared, h):
        return attention_decode(shared, "attn", cfg, h, state["attn_k"][i],
                                state["attn_v"][i], lengths)

    logits, conv, ssm = _token_step(params, cfg, tokens, state["conv"],
                                    state["ssm"], attend)
    return logits, {"conv": conv, "ssm": ssm, "attn_k": state["attn_k"],
                    "attn_v": state["attn_v"]}


# ---------------------------------------------------------------------------
# Paged serving: KV page pools for the shared-attention applications +
# state-slot pools for the mamba layers, driven through one block table.
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, pool_pages: int, page_size: int,
                     kv_dtype: str = "bfloat16", state_slots: int = 0,
                     state_dtype: str = "float32", device="cpu") -> State:
    """KV page pools per super-block, ``(n_sb, 1, pool_pages, page_size,
    Hkv, Dh)`` (the dummy axis 1 keeps the physical page at axis 2, the
    engine's page-copy convention), plus the mamba state pools of
    ``ssm.init_paged_state`` (physical state slot at axis 1).  As in the
    JAX package, the KV pools are int8 with fp32 scale pools for
    ``kv_dtype="int8"`` and bf16 for every other ``kv_dtype``."""
    n_sb, _, _ = _layout(cfg)
    shape = (n_sb, 1, pool_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    pools = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if kv_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            pools[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    pools.update(init_paged_state(cfg, state_slots, state_dtype, device))
    return pools


def hybrid_decode_paged(params: Params, cfg: ModelConfig, cache: State,
                        tokens: torch.Tensor, lengths: torch.Tensor,
                        new_counts: torch.Tensor,
                        block_tables: torch.Tensor) -> torch.Tensor:
    """Paged decode/prefill chunk over the hybrid stack, tokens (B, T), one
    token at a time: the same per-token recurrence as
    :func:`hybrid_decode_step` (so greedy outputs equal the slot engine's),
    the shared attention reading and writing the KV page pools through the
    KV columns of the combined table, the mamba state gathered from its
    read column and scattered after token ``t`` to write column ``t`` (the
    engine sends every column but a chunk's last real token to the trash
    slot).  Token ``t`` of row ``b`` is real while ``t < new_counts[b]``;
    a padded one writes its K/V to the null page 0.  Returns the logits
    (B, T, V); the pools are updated in place."""
    t_total = tokens.shape[1]
    kv_bt, read, writes = split_state_tables(block_tables, t_total)
    kv_bt = kv_bt.contiguous()
    state = gather_state(cache, read)
    conv, ssm = state["conv"], state["ssm"]
    quantized = "k_scale" in cache
    lengths, new_counts = lengths.long(), new_counts.long()
    outs = []
    for t in range(t_total):
        count_t = (new_counts > t).to(torch.int32)           # (B,) 0/1
        len_t = lengths + torch.clamp(new_counts, max=t)

        def attend(i, shared, h):
            kw = (dict(k_scales=cache["k_scale"][i, 0],
                       v_scales=cache["v_scale"][i, 0]) if quantized
                  else {})
            return attention_decode_paged(
                shared, "attn", cfg, h, cache["k"][i, 0], cache["v"][i, 0],
                len_t, count_t, kv_bt, **kw)

        logits, conv, ssm = _token_step(params, cfg, tokens[:, t:t + 1],
                                        conv, ssm, attend)
        outs.append(logits)
        scatter_state(cache, {"conv": conv, "ssm": ssm}, writes[:, t])
    return torch.cat(outs, dim=1)
