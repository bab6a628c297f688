"""``apr_matmul`` wrapper: the hand-written CUDA kernel for CUDA tensors,
the plain PyTorch version (:func:`.ref.matmul_ref`) for CPU tensors.

There is no padding here: the kernel masks the ragged M/N/K edges itself,
so the (K, N) weight slice goes to it as it lies in memory.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import matmul_ref

LIBRARY = "apr_matmul"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"apr_matmul_bf16": (ctypes.c_int,
                                  [_P, _P, _P, _I, _I, _I, _I, _P])}


def apr_matmul(x: torch.Tensor, y: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x (M, K) @ y (K, N)`` with an fp32 accumulator resident across
    the whole K loop, rounded once to ``out_dtype``.

    CUDA tensors launch the kernel (bf16 operands, ``out_dtype`` bf16 or
    fp32) or raise; CPU tensors take :func:`matmul_ref`.  Each kernel
    launch adds one to ``apr_matmul.launches``."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return matmul_ref(x, y, out_dtype)
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ValueError(f"apr_matmul: operands on {x.device} and {y.device}")
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise TypeError(f"apr_matmul kernel takes bf16 operands, got "
                        f"{x.dtype} and {y.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"apr_matmul kernel writes bf16 or fp32, not {out_dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"apr_matmul: shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("apr_matmul kernel takes contiguous row-major operands")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.apr_matmul_bf16(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                              m, n, k, int(out_dtype == torch.float32), stream)
    _build.check(lib, err, "apr_matmul")
    apr_matmul.launches += 1
    return out


apr_matmul.launches = 0
