"""The assigned input-shape set (a copy of the JAX package's
``repro.configs.shapes`` without ``input_specs``, whose ShapeDtypeStruct
stand-ins serve the multi-pod dry-run, which the port does not have yet).

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
from typing import Dict

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
