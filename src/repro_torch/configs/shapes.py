"""The assigned input-shape set and ``input_specs()`` stand-ins (a copy of
the JAX package's ``repro.configs.shapes``; its ShapeDtypeStructs are
tensors on the ``meta`` device here).

Four shapes per LM-family arch (40 cells total):
  train_4k     seq 4,096  x batch 256   (training)
  prefill_32k  seq 32,768 x batch 32    (inference prefill)
  decode_32k   seq 32,768 x batch 128   (one new token, 32k KV/state)
  long_500k    seq 524,288 x batch 1    (long-context decode; sub-quadratic
                                         archs only — ssm/hybrid)

``decode_*``/``long_*`` run the serving step (token + cache), never the
train step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic decode (ssm/hybrid); every assigned
    arch has a decoder, so decode shapes otherwise always apply."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str:
    if not applicable(cfg, shape):
        return "skipped_full_attention (0.5M-token full attention out of scope; see DESIGN.md)"
    return ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Stand-ins for every model input of this cell: tensors on the
    ``meta`` device (a shape and a dtype, no storage), as the JAX
    function's ShapeDtypeStructs, branch for branch.  Caches and states are
    the port's own ``init_cache`` / ``init_state`` made on ``meta``, so they
    match the serving path's exactly; the ``mamba`` family's decode, as in
    JAX, gets none."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model

    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {}
        text = s
        if cfg.family == "vlm":
            text = s - cfg.vision_tokens
            specs["vision_embeds"] = _meta((b, cfg.vision_tokens, d),
                                           torch.bfloat16)
        if cfg.family == "audio":
            specs["frames"] = _meta((b, cfg.encoder_frames, d),
                                    torch.bfloat16)
        specs["tokens"] = _meta((b, text), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int32)
        return specs

    # decode: one new token against a seq_len-deep cache/state
    specs = {
        "tokens": _meta((b, 1), torch.int32),
        "lengths": _meta((b,), torch.int32),
    }
    if cfg.family in ("dense", "moe", "vlm"):
        from ..models.lm import init_cache
        specs["cache"] = init_cache(cfg, b, s, device="meta")
    elif cfg.family == "audio":
        from ..models.encdec import init_cache
        specs["cache"] = init_cache(cfg, b, s, device="meta")
    elif cfg.family == "ssm":
        from ..models.rwkv_lm import init_state
        specs["cache"] = init_state(cfg, b, device="meta")
    elif cfg.family == "hybrid":
        from ..models.hybrid import init_state
        specs["cache"] = init_state(cfg, b, s, device="meta")
    return specs
