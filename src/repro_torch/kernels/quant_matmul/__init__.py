from .ops import (default_config, quant_matmul, quant_matmul_fused,
                  quantize_activations, quantize_weights, shape_key)
from .ref import quant_matmul_fused_ref, quant_matmul_ref

__all__ = ["default_config", "quant_matmul", "quant_matmul_fused",
           "quant_matmul_fused_ref", "quant_matmul_ref",
           "quantize_activations", "quantize_weights", "shape_key"]
