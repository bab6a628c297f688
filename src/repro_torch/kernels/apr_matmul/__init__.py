from .ops import apr_matmul
from .ref import matmul_ref

__all__ = ["apr_matmul", "matmul_ref"]
