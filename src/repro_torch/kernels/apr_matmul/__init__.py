from .ops import (AprMatmulFunction, accumulator_traffic_bytes, apr_matmul,
                  apr_matmul_fused, apr_matmul_grad, needs_grad)
from .ref import (K_RANGE, activation_ref, matmul_fused_ref,
                  matmul_fused_split_ref, matmul_ref, matmul_split_ref,
                  split_range)

__all__ = ["AprMatmulFunction", "K_RANGE", "accumulator_traffic_bytes",
           "activation_ref", "apr_matmul", "apr_matmul_fused",
           "apr_matmul_grad", "needs_grad", "matmul_fused_ref",
           "matmul_fused_split_ref", "matmul_ref", "matmul_split_ref",
           "split_range"]
