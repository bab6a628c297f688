from .ops import apr_matmul
from .ref import activation_ref, matmul_fused_ref, matmul_ref

__all__ = ["activation_ref", "apr_matmul", "matmul_fused_ref", "matmul_ref"]
