"""Symmetric per-channel int8 quantization, in PyTorch.

Port of the JAX package's ``repro.quant.quantize``.  For a weight ``w``
whose last two dims are ``(in, out)`` (stacked ``(layers, in, out)`` too)::

    scale[..., 1, o] = max(|w[..., :, o]|) / 127          (fp32; 1/127 if 0)
    q[..., i, o]     = clip(round(w / scale), -127, 127)  (int8)

``round`` is round-half-to-even and the division is a true fp32 division
(not a multiply by ``1 / scale``), so the codes equal the JAX package's bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

INT8_MAX = 127.0


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload + fp32 per-output-channel scales (broadcastable)."""

    q: torch.Tensor        # int8, the original weight shape
    scale: torch.Tensor    # fp32, q's shape with the contraction axis = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return self.q.numel() * 1 + self.scale.numel() * 4

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)

    def __getitem__(self, idx) -> "QuantizedTensor":
        """Index the leading (stacking) axes, e.g. layer ``i`` of a stacked
        ``(layers, in, out)`` weight; payload and scales are indexed alike."""
        return QuantizedTensor(q=self.q[idx], scale=self.scale[idx])

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(q=self.q.to(device), scale=self.scale.to(device))


def quantize_channelwise(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Symmetric int8 quantization reducing ``axis`` (the contraction dim).

    ``axis=-2`` matches every stored ``(in, out)`` matmul weight; per-token
    KV quantization uses ``axis=-1`` (the head dim)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / INT8_MAX
    q = torch.clamp(torch.round(wf / scale), -INT8_MAX, INT8_MAX)
    return QuantizedTensor(q=q.to(torch.int8), scale=scale)


def dequantize(qt: QuantizedTensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return qt.dequantize(dtype)


#: name fragments that keep full precision regardless of shape (gathered
#: tables, norm gains, the MoE router), as in the JAX package
DEFAULT_SKIP = ("embed", "pos_", ".ln", "norm", ".router")


def default_predicate(name: str, w: Any) -> bool:
    """Should ``name`` be int8-quantized?  Floating matmul weights only."""
    if not isinstance(w, torch.Tensor) or w.dim() < 2:
        return False
    if not w.is_floating_point():
        return False
    return not any(frag in name for frag in DEFAULT_SKIP)


def _quantize_weight(w: torch.Tensor) -> QuantizedTensor:
    """:func:`quantize_channelwise` over axis -2, one leading-axis slice at
    a time for stacked weights: the reduction never crosses a slice, so the
    result is the same, and the fp32 temporaries stay one layer's size
    (a whole stacked ``w_gate`` of llama3-8b would need 7.5 GB each)."""
    if w.dim() < 3:
        return quantize_channelwise(w)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        qt = _quantize_weight(w[i])
        q[i], scale[i] = qt.q, qt.scale
    return QuantizedTensor(q=q, scale=scale)


def quantize_params(params: Dict[str, Any], *,
                    predicate: Optional[Callable[[str, Any], bool]] = None
                    ) -> Dict[str, Any]:
    """A copy of a flat params dict with the matmul weights quantized.

    Entries selected by ``predicate`` (default: :func:`default_predicate`)
    become :class:`QuantizedTensor` on the weight's device; everything else
    is passed through (the same tensor objects)."""
    predicate = predicate or default_predicate
    return {name: _quantize_weight(w) if predicate(name, w) else w
            for name, w in params.items()}


def weight_bytes(params: Dict[str, Any]) -> Dict[str, int]:
    """Streamed-weight bytes at fp32, at bf16 and as stored (int8 + scales
    for :class:`QuantizedTensor` entries, native width otherwise), over the
    params that are or would be quantized; the JAX package's accounting."""
    fp32 = bf16 = actual = 0
    quantized = skipped = 0
    for name, w in params.items():
        if isinstance(w, QuantizedTensor):
            n = w.q.numel()
            fp32 += 4 * n
            bf16 += 2 * n
            actual += w.nbytes
            quantized += 1
        elif default_predicate(name, w):
            n = w.numel()
            fp32 += 4 * n
            bf16 += 2 * n
            actual += n * w.element_size()
            skipped += 1
        else:
            skipped += 1
    return {"bytes_fp32": fp32, "bytes_bf16": bf16, "bytes_actual": actual,
            "n_quantized": quantized, "n_passthrough": skipped}
