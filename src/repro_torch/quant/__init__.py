"""Symmetric per-channel int8 quantization (int8 weights, int8 paged KV).

Port of the JAX package's ``repro.quant`` scheme: :class:`QuantizedTensor`
(int8 payload + fp32 per-output-channel scales), :func:`quantize_channelwise`
(also used per (token, head) by the int8 paged-KV cache) and
:func:`quantize_params`.  The model layers take a :class:`QuantizedTensor`
wherever they take a weight; on the card ``apr_matmul`` dequantizes it in
its load stage, so the weight crosses device memory at 1 byte per element.
"""
from .quantize import (DEFAULT_SKIP, INT8_MAX, QuantizedTensor,
                       default_predicate, dequantize, quantize_channelwise,
                       quantize_params, weight_bytes)

__all__ = ["DEFAULT_SKIP", "INT8_MAX", "QuantizedTensor", "default_predicate",
           "dequantize", "quantize_channelwise", "quantize_params",
           "weight_bytes"]
