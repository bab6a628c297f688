from .ops import apr_conv2d, apr_conv2d_fused
from .ref import conv2d_fused_ref, conv2d_ref, im2col

__all__ = ["apr_conv2d", "apr_conv2d_fused", "conv2d_fused_ref",
           "conv2d_ref", "im2col"]
