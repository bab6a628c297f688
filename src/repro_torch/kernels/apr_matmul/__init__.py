from .ops import accumulator_traffic_bytes, apr_matmul, apr_matmul_fused
from .ref import activation_ref, matmul_fused_ref, matmul_ref

__all__ = ["accumulator_traffic_bytes", "activation_ref", "apr_matmul",
           "apr_matmul_fused", "matmul_fused_ref", "matmul_ref"]
