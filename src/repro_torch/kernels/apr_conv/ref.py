"""Plain PyTorch versions of ``apr_conv`` (mirror of the JAX ``ref.py``):
NHWC activations, HWIO filters, fp32 output."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..apr_matmul.ref import activation_ref


def conv2d_ref(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """``x (B, H, W, C) ⊛ f (Hf, Wf, C, M) -> (B, Ho, Wo, M)`` in fp32: the
    counterpart of ``lax.conv_general_dilated`` with ``("NHWC", "HWIO",
    "NHWC")``.  ``F.conv2d`` runs on the NCHW / OIHW views of the same
    memory, so an NHWC input is a channels-last tensor to it and the output
    comes back NHWC without a copy.  On a GPU the caller keeps
    ``torch.backends.cudnn.allow_tf32`` False, or cuDNN rounds the inputs
    to TF32."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   f.float().permute(3, 2, 0, 1),
                   stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def conv2d_fused_ref(x: torch.Tensor, f: torch.Tensor, bias=None,
                     activation: str = "relu", *, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """``activation(conv2d(x, f) + bias)``; ``bias`` is ``None``, ``(M,)``
    or ``(1, M)``."""
    out = conv2d_ref(x, f, stride=stride, padding=padding)
    if bias is not None:
        out = out + bias.reshape(1, 1, 1, -1).float()
    return activation_ref(out, activation)


def im2col(x: torch.Tensor, hf: int, wf: int, stride: int,
           padding: int) -> Tuple[torch.Tensor, int, int]:
    """``(B, H, W, C) -> ((B·Ho·Wo, Hf·Wf·C), Ho, Wo)`` patch matrix.

    Column ``k = (di·Wf + dj)·C + c`` holds input channel ``c`` at filter
    offset ``(di, dj)``: the row order of ``f.reshape(Hf·Wf·C, M)`` and the
    order in which the ``apr_conv`` kernel walks its reduction.  The kernel
    never builds this matrix; it exists to pin that order."""
    b, h, w, c = x.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
        h, w = h + 2 * padding, w + 2 * padding
    ho = (h - hf) // stride + 1
    wo = (w - wf) // stride + 1
    cols = [x[:, di:di + (ho - 1) * stride + 1:stride,
              dj:dj + (wo - 1) * stride + 1:stride, :].reshape(b * ho * wo, c)
            for di in range(hf) for dj in range(wf)]
    return torch.cat(cols, dim=-1), ho, wo
