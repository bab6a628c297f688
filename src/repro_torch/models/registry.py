"""Model bundle: config -> params, paged cache and the paged decode step.

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

    def init_paged_cache(self, pool_pages: int, page_size: int,
                         kv_dtype: str = "bfloat16") -> Dict[str, torch.Tensor]:
        return lm.init_paged_cache(self.cfg, pool_pages, page_size, kv_dtype,
                                   self.device)

    def decode_paged(self, params: Params, cache: Dict[str, torch.Tensor],
                     tokens, lengths, new_counts, block_tables) -> torch.Tensor:
        """Multi-token paged decode/prefill step (T=1 decode tick, T=chunk
        prefill); updates ``cache`` in place and returns the logits."""
        return lm.lm_decode_paged(params, self.cfg, cache, tokens, lengths,
                                  new_counts, block_tables)


def build_model(cfg: ModelConfig, device="cuda") -> ModelBundle:
    return ModelBundle(cfg=cfg, device=device)
