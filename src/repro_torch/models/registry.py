"""Model bundle: config -> params (bf16 or int8), the paged and contiguous
caches and their decode steps, and the whole-sequence entry points.

Port of the JAX package's ``repro.models.registry.ModelBundle`` for the
families ported so far: ``dense``, ``moe`` (arctic, llama4; the MoE layer
in ``models/moe.py``) and ``vlm`` (internvl2), all three on
``models/lm.py``; ``ssm`` (rwkv6, ``models/rwkv_lm.py``), ``mamba``
(mamba2, ``models/ssm.py``), ``hybrid`` (zamba2, ``models/hybrid.py``) and
``audio`` (whisper, ``models/encdec.py``; the slot engine only, as in the
JAX package: it pages no cross-attention cache).  A bundle
is bound to one device at construction; it defaults to ``"cuda"`` and
raises when there is no card, unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..quant import quantize_params
from . import encdec, hybrid, lm, rwkv_lm, ssm
from .layers import ParamSpecs, Params, init_from_specs

#: the families with a paged KV cache of attention layers alone, served by
#: ``models/lm.py``, as the JAX package counts them
_LM_FAMILIES = lm.FAMILIES


@dataclasses.dataclass(frozen=True)
class Family:
    """One family's module functions.  ``kv``: the decode state holds
    attention KV, so the cache functions take the KV arguments (``lm``'s:
    ``max_seq``, the page pools' ``pool_pages, page_size, kv_dtype``) and
    the decode step the positions ``lengths``.  ``state``: the decode state
    holds a fixed-size recurrent register file, served through the paged
    *state* cache (``serve/state_cache.py``), so the paged pools take
    ``state_slots, state_dtype`` and the decode step returns the new state
    (``rwkv_lm``, ``ssm``).  The hybrid is both."""
    build_params: Callable
    init_cache: Callable
    decode_step: Callable
    init_paged_cache: Callable
    decode_paged: Callable
    forward: Callable
    prefill: Callable
    kv: bool = True
    state: bool = False


def _hybrid_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    max_seq: Optional[int] = None):
    """The hybrid's prefill, as the JAX registry defines it: the forward's
    last row and no cache (serving builds the decode state by running the
    decode path over the prompt)."""
    return hybrid.hybrid_forward(params, cfg, tokens)[:, -1:], None


def _no_paged_cache(*args, **kwargs):
    """The audio family's paged functions: the JAX package pages no
    encoder-decoder cache (its ``_LM_FAMILIES``), so neither does the
    port."""
    raise ValueError("the 'audio' family has no paged KV cache or state "
                     "pool; serve it on the contiguous ServeEngine")


def _audio_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   max_seq: Optional[int] = None, *, frames: torch.Tensor):
    """The audio family's prefill with the bundle's arguments: the cache
    ``max_seq`` long (the prompt's length by default)."""
    return encdec.encdec_prefill(params, cfg, tokens, frames, max_seq)


_LM = Family(lm.build_params, lm.init_cache, lm.lm_decode_step,
             lm.init_paged_cache, lm.lm_decode_paged, lm.lm_forward,
             lm.lm_prefill)

FAMILIES: Dict[str, Family] = {
    "dense": _LM,
    "moe": _LM,
    "vlm": _LM,
    "ssm": Family(rwkv_lm.build_params, rwkv_lm.init_state,
                  rwkv_lm.rwkv_decode_step, rwkv_lm.init_paged_state,
                  rwkv_lm.rwkv_decode_paged, rwkv_lm.rwkv_forward,
                  rwkv_lm.rwkv_prefill, kv=False, state=True),
    "mamba": Family(ssm.build_lm_params, ssm.init_lm_state,
                    ssm.mamba_decode_step, ssm.init_paged_state,
                    ssm.mamba_decode_paged, ssm.mamba_forward,
                    ssm.mamba_prefill, kv=False, state=True),
    "hybrid": Family(hybrid.build_params, hybrid.init_state,
                     hybrid.hybrid_decode_step, hybrid.init_paged_cache,
                     hybrid.hybrid_decode_paged, hybrid.hybrid_forward,
                     _hybrid_prefill, state=True),
    "audio": Family(encdec.build_params, encdec.init_cache,
                    encdec.encdec_decode_step, _no_paged_cache,
                    _no_paged_cache, encdec.encdec_forward, _audio_prefill),
}


def family(cfg: ModelConfig) -> Family:
    """The family's functions; raises, by name, for a family the port does
    not have yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port has no {cfg.family!r} family ({cfg.name}); "
            f"ported: {', '.join(FAMILIES)}")
    return FAMILIES[cfg.family]


def check_param_dtype(dtype, device_type: str) -> None:
    """Refuse, with a ``ValueError``, float parameters of ``dtype`` (a
    torch dtype or its name) on a ``device_type`` whose kernels cannot take
    them: on ``"cuda"`` the hand-written ``apr_matmul`` kernels take bf16
    and fp32 activations, so a model with fp16 parameters would fail at its
    first projection.  Such a model runs on ``device="cpu"``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if device_type == "cuda" and dtype not in (torch.bfloat16,
                                               torch.float32):
        raise ValueError(
            f"{dtype} parameters cannot run on the card: no apr_matmul "
            "kernel takes them (bf16 and fp32 activations only; other "
            "dtypes run on device='cpu')")


def check_params(params, device_type: str) -> None:
    """:func:`check_param_dtype` for every float tensor of ``params`` (an
    int8 weight's fp32 scales are not parameters of their own); ``None``
    passes."""
    for dtype in {t.dtype for t in (params or {}).values()
                  if isinstance(t, torch.Tensor) and t.is_floating_point()}:
        check_param_dtype(dtype, device_type)


def param_specs(cfg: ModelConfig) -> ParamSpecs:
    """The family's parameter shapes and init scales."""
    return family(cfg).build_params(cfg)


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    device: Union[str, torch.device] = "cuda"   # a torch.device once built

    def __post_init__(self):
        param_specs(self.cfg)     # raises for unported families and options
        self.family = FAMILIES[self.cfg.family]
        self.device = resolve_device(self.device)
        check_param_dtype(self.cfg.dtype, self.device.type)

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Params:
        """Random bf16 parameters on the bundle's device, drawn from
        ``generator`` (seed 0 on the bundle's device when omitted)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return init_from_specs(param_specs(self.cfg), generator, self.device)

    # ---- whole-sequence entry points ------------------------------------
    def _inputs(self, prefix_embeds, frames) -> dict:
        """The inputs beside the tokens, as the JAX bundle's ``batch``
        holds them: ``prefix_embeds`` for the LM families (its
        ``"vision_embeds"``), ``frames`` for the audio family, which needs
        them; every other family takes neither."""
        if prefix_embeds is not None and self.family is not _LM:
            raise ValueError(f"the {self.cfg.family!r} family takes no "
                             "prefix_embeds")
        audio = self.cfg.family == "audio"
        if (frames is not None) != audio:
            raise ValueError(
                "the 'audio' family needs frames" if audio else
                f"the {self.cfg.family!r} family takes no frames")
        return ({"frames": frames} if audio else
                {} if prefix_embeds is None else
                {"prefix_embeds": prefix_embeds})

    def forward(self, params: Params, tokens: torch.Tensor, *,
                prefix_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, S, V) of the whole sequence ``tokens`` (B, T), after
        ``prefix_embeds`` (B, Nv, d) when given (S = Nv + T); the audio
        family's decoder logits (S = T) over its encoded ``frames`` (B, F,
        d)."""
        return self.family.forward(params, self.cfg, tokens,
                                   **self._inputs(prefix_embeds, frames))

    def prefill(self, params: Params, tokens: torch.Tensor,
                max_seq: Optional[int] = None, *,
                prefix_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None):
        """The whole prompt (B, T) at once, after ``prefix_embeds`` when
        given (over the encoded ``frames`` for the audio family):
        last-position logits (B, 1, V) and the decode carry after it, in
        the slot engine's cache layout (a KV family's cache ``max_seq``
        long, the sequence's length by default, the audio family's with
        the frames' cross K/V; the hybrid, as in the JAX package, returns
        none)."""
        args = (max_seq,) if self.family.kv else ()
        return self.family.prefill(params, self.cfg, tokens, *args,
                                   **self._inputs(prefix_embeds, frames))

    # ---- multi-precision --------------------------------------------------
    @property
    def supports_int8_weights(self) -> bool:
        # the JAX package's set; the recurrent families keep their own
        # mixer products there too
        return self.cfg.family in _LM_FAMILIES + ("audio",)

    def quantize_params(self, params: Params) -> Params:
        """Int8-weight variant of ``params`` (symmetric per-output-channel;
        embeddings, norms and the MoE router stay as they are), on the
        params' device.  A
        drop-in replacement for every entry point below."""
        if not self.supports_int8_weights:
            raise ValueError(f"{self.cfg.family!r} family has no int8-weight "
                             "path")
        return quantize_params(params)

    # ---- contiguous (slot engine) cache -----------------------------------
    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """The slot engine's cache: the contiguous bf16 KV cache (batch x
        max_seq) of a KV family, a state family's decode carry of ``batch``
        rows, or both for the hybrid (every leaf of a state family's carry
        has the batch at axis 1)."""
        args = (max_seq,) if self.family.kv else ()
        return self.family.init_cache(self.cfg, batch, *args, self.device)

    def decode_step(self, params: Params, cache: Dict[str, torch.Tensor],
                    tokens, lengths) -> torch.Tensor:
        """One decode token per slot; returns the logits (B, 1, V).  The
        new K/V are written into ``cache`` in place; a state family's new
        state tensors replace ``cache``'s (the old tensors are not
        written)."""
        args = (lengths,) if self.family.kv else ()
        out = self.family.decode_step(params, self.cfg, cache, tokens, *args)
        if not self.family.state:
            return out
        logits, new = out
        cache.update(new)
        return logits

    # ---- paged serving contract -------------------------------------------
    @property
    def supports_paged_kv(self) -> bool:
        return self.cfg.family in _LM_FAMILIES

    @property
    def supports_paged_state(self) -> bool:
        return self.family.state

    @property
    def supports_paged_serving(self) -> bool:
        return self.supports_paged_kv or self.supports_paged_state

    def init_paged_cache(self, pool_pages: int, page_size: int,
                         kv_dtype: str = "bfloat16", *, state_slots: int = 0,
                         state_dtype: str = "float32"
                         ) -> Dict[str, torch.Tensor]:
        """Paged pools.  A KV family: KV page pools (``kv_dtype="int8"``
        adds the fp32 scale pools).  A state family: state pools with the
        physical state slot at axis 1, ``state_slots`` =
        ``StateCache.pool_slots`` (reserved ids included), and
        ``state_dtype="int8"`` storing the large state leaves int8.  The
        hybrid holds both kinds."""
        kv = (pool_pages, page_size, kv_dtype) if self.family.kv else ()
        state = (state_slots, state_dtype) if self.family.state else ()
        return self.family.init_paged_cache(self.cfg, *kv, *state,
                                            self.device)

    def decode_paged(self, params: Params, cache: Dict[str, torch.Tensor],
                     tokens, lengths, new_counts, block_tables) -> torch.Tensor:
        """Multi-token paged decode/prefill step (T=1 decode tick, T=chunk
        prefill); updates ``cache`` in place and returns the logits.  For a
        state family ``block_tables`` is the engine's combined table: KV
        page columns, one state read column, T state write columns
        (``paged_state.split_state_tables``)."""
        return self.family.decode_paged(params, self.cfg, cache, tokens,
                                        lengths, new_counts, block_tables)


def build_model(cfg: ModelConfig, device="cuda") -> ModelBundle:
    return ModelBundle(cfg=cfg, device=device)




def check_draft_pair(target: ModelConfig, draft: ModelConfig) -> None:
    """Validate a (target, draft) speculative-decoding pairing, as the JAX
    package does.

    Greedy verification compares the draft's proposed token *ids* against
    the target's argmax, so the two models must share one tokenizer -- the
    config-level proxy is an identical ``vocab_size``.  Both sides must
    also speak the paged decode contract: the target verifies through
    ``decode_paged`` and a model-backed draft keeps its own paged cache in
    lockstep (rollback via ``PagedKVCache.truncate``).
    """
    if draft.vocab_size != target.vocab_size:
        raise ValueError(
            f"draft {draft.name!r} (vocab {draft.vocab_size}) does not share "
            f"target {target.name!r}'s tokenizer (vocab {target.vocab_size}); "
            "speculative verification compares token ids, so the pair must "
            "use one vocabulary")
    for role, cfg in (("target", target), ("draft", draft)):
        if cfg.family not in _LM_FAMILIES:
            raise ValueError(
                f"{role} {cfg.name!r} ({cfg.family!r} family) has no paged "
                "KV cache; speculative decoding runs on the paged engine")


def build_draft_model(target: ModelConfig, draft: ModelConfig,
                      device="cuda") -> ModelBundle:
    """The draft-side :class:`ModelBundle` for speculative decoding, on
    ``device``, after :func:`check_draft_pair` validates the pairing."""
    check_draft_pair(target, draft)
    return build_model(draft, device=device)
