from .ops import (default_config, default_splits, quant_matmul,
                  quant_matmul_fused, quantize_activations, quantize_weights,
                  shape_key)
from .ref import (K_RANGE, quant_matmul_fused_ref, quant_matmul_ref,
                  quant_matmul_split_ref)

__all__ = ["K_RANGE", "default_config", "default_splits", "quant_matmul",
           "quant_matmul_fused", "quant_matmul_fused_ref", "quant_matmul_ref",
           "quant_matmul_split_ref", "quantize_activations",
           "quantize_weights", "shape_key"]
