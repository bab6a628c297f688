from .ops import (AprMatmulFunction, ProductTape, accumulator_traffic_bytes,
                  apr_matmul, apr_matmul_fused, apr_matmul_grad, needs_grad,
                  not_residual)
from .ref import (K_RANGE, activation_ref, matmul_fused_ref,
                  matmul_fused_split_ref, matmul_ref, matmul_split_ref,
                  split_range)

__all__ = ["AprMatmulFunction", "K_RANGE", "ProductTape",
           "accumulator_traffic_bytes", "activation_ref", "apr_matmul",
           "apr_matmul_fused", "apr_matmul_grad", "needs_grad",
           "not_residual", "matmul_fused_ref",
           "matmul_fused_split_ref", "matmul_ref", "matmul_split_ref",
           "split_range"]
