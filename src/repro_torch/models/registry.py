"""Model bundle: config -> params (bf16 or int8), the paged and contiguous
caches and their decode steps, and the whole-sequence entry points.

Port of the JAX package's ``repro.models.registry.ModelBundle`` for the
families ported so far: ``dense`` (``models/lm.py``), ``ssm`` (rwkv6,
``models/rwkv_lm.py``) and ``mamba`` (mamba2, ``models/ssm.py``).  A bundle
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
from . import lm, rwkv_lm, ssm
from .layers import ParamSpecs, Params, init_from_specs


@dataclasses.dataclass(frozen=True)
class Family:
    """One family's module functions.  A KV family's take the module
    signatures of ``lm``; a state family's (``state=True``) those of
    ``rwkv_lm``/``ssm``, whose decode state is a fixed-size recurrent
    register file served through the paged *state* cache
    (``serve/state_cache.py``).  ``forward``/``prefill`` are ``None`` where
    the port has no whole-sequence entry point for the family yet."""
    build_params: Callable
    init_cache: Callable
    decode_step: Callable
    init_paged_cache: Callable
    decode_paged: Callable
    forward: Optional[Callable] = None
    prefill: Optional[Callable] = None
    state: bool = False


FAMILIES: Dict[str, Family] = {
    "dense": Family(lm.build_params, lm.init_cache, lm.lm_decode_step,
                    lm.init_paged_cache, lm.lm_decode_paged),
    "ssm": Family(rwkv_lm.build_params, rwkv_lm.init_state,
                  rwkv_lm.rwkv_decode_step, rwkv_lm.init_paged_state,
                  rwkv_lm.rwkv_decode_paged, rwkv_lm.rwkv_forward,
                  rwkv_lm.rwkv_prefill, state=True),
    "mamba": Family(ssm.build_lm_params, ssm.init_lm_state,
                    ssm.mamba_decode_step, ssm.init_paged_state,
                    ssm.mamba_decode_paged, ssm.mamba_forward,
                    ssm.mamba_prefill, state=True),
}


def family(cfg: ModelConfig) -> Family:
    """The family's functions; raises, by name, for a family the port does
    not have yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port has no {cfg.family!r} family yet ({cfg.name}); "
            f"ported: dense, ssm (rwkv6), mamba (mamba2)")
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
    def _whole(self, fn: Optional[Callable], what: str) -> Callable:
        if fn is None:
            raise NotImplementedError(
                f"{self.cfg.family!r} family: the port has no {what} yet")
        return fn

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, T, V) of the whole sequence ``tokens`` (B, T)."""
        return self._whole(self.family.forward, "forward")(
            params, self.cfg, tokens)

    def prefill(self, params: Params, tokens: torch.Tensor):
        """The whole prompt (B, T) at once: last-position logits (B, 1, V)
        and the decode carry (the slot engine's cache layout) after it."""
        return self._whole(self.family.prefill, "prefill")(
            params, self.cfg, tokens)

    # ---- multi-precision --------------------------------------------------
    @property
    def supports_int8_weights(self) -> bool:
        # the recurrent families keep their own mixer products in the JAX
        # package too (src/repro/models/registry.py: dense/moe/vlm/audio)
        return self.cfg.family == "dense"

    def quantize_params(self, params: Params) -> Params:
        """Int8-weight variant of ``params`` (symmetric per-output-channel;
        embeddings and norms stay as they are), on the params' device.  A
        drop-in replacement for every entry point below."""
        if not self.supports_int8_weights:
            raise ValueError(f"{self.cfg.family!r} family has no int8-weight "
                             "path")
        return quantize_params(params)

    # ---- contiguous (slot engine) cache -----------------------------------
    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """The slot engine's cache: the contiguous bf16 KV cache (batch x
        max_seq) of a KV family, or a state family's decode carry of
        ``batch`` rows (every leaf has the batch at axis 1)."""
        if self.family.state:
            return self.family.init_cache(self.cfg, batch, self.device)
        return self.family.init_cache(self.cfg, batch, max_seq, self.device)

    def decode_step(self, params: Params, cache: Dict[str, torch.Tensor],
                    tokens, lengths) -> torch.Tensor:
        """One decode token per slot; returns the logits (B, 1, V).  A KV
        family writes the new K/V into ``cache`` in place; a state family
        replaces ``cache``'s state tensors with the new ones (the old
        tensors are not written)."""
        if self.family.state:
            logits, new = self.family.decode_step(params, self.cfg, cache,
                                                  tokens)
            cache.update(new)
            return logits
        return self.family.decode_step(params, self.cfg, cache, tokens,
                                       lengths)

    # ---- paged serving contract -------------------------------------------
    @property
    def supports_paged_kv(self) -> bool:
        return not self.family.state

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
        ``state_dtype="int8"`` storing the large state leaves int8."""
        if self.family.state:
            return self.family.init_paged_cache(self.cfg, state_slots,
                                                state_dtype, self.device)
        return self.family.init_paged_cache(self.cfg, pool_pages, page_size,
                                            kv_dtype, self.device)

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
