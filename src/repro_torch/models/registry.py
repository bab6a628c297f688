"""Model bundle: config -> params (bf16 or int8), the paged and contiguous
caches and their decode steps.

Port of the JAX package's ``repro.models.registry.ModelBundle`` for the
dense family.  A bundle is bound to one device at construction; it defaults
to ``"cuda"`` and raises when there is no card, unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..quant import quantize_params
from . import lm
from .layers import Params


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    device: Union[str, torch.device] = "cuda"   # a torch.device once built

    def __post_init__(self):
        lm.build_params(self.cfg)            # raises for unported families
        self.device = resolve_device(self.device)

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Params:
        """Random bf16 parameters on the bundle's device, drawn from
        ``generator`` (seed 0 on the bundle's device when omitted)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return lm.init_params(self.cfg, generator, self.device)

    @property
    def supports_int8_weights(self) -> bool:
        return self.cfg.family == "dense"   # the one family ported so far

    def quantize_params(self, params: Params) -> Params:
        """Int8-weight variant of ``params`` (symmetric per-output-channel;
        embeddings and norms stay as they are), on the params' device.  A
        drop-in replacement for every entry point below."""
        if not self.supports_int8_weights:
            raise ValueError(f"{self.cfg.family!r} family has no int8-weight "
                             "path")
        return quantize_params(params)

    def init_paged_cache(self, pool_pages: int, page_size: int,
                         kv_dtype: str = "bfloat16") -> Dict[str, torch.Tensor]:
        """Paged KV pools; ``kv_dtype="int8"`` adds the fp32 scale pools."""
        return lm.init_paged_cache(self.cfg, pool_pages, page_size, kv_dtype,
                                   self.device)

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """The slot engine's contiguous bf16 cache (batch x max_seq)."""
        return lm.init_cache(self.cfg, batch, max_seq, self.device)

    def decode_paged(self, params: Params, cache: Dict[str, torch.Tensor],
                     tokens, lengths, new_counts, block_tables) -> torch.Tensor:
        """Multi-token paged decode/prefill step (T=1 decode tick, T=chunk
        prefill); updates ``cache`` in place and returns the logits."""
        return lm.lm_decode_paged(params, self.cfg, cache, tokens, lengths,
                                  new_counts, block_tables)

    def decode_step(self, params: Params, cache: Dict[str, torch.Tensor],
                    tokens, lengths) -> torch.Tensor:
        """One decode token per slot over the contiguous cache; updates
        ``cache`` in place and returns the logits (B, 1, V)."""
        return lm.lm_decode_step(params, self.cfg, cache, tokens, lengths)


def build_model(cfg: ModelConfig, device="cuda") -> ModelBundle:
    return ModelBundle(cfg=cfg, device=device)
