"""``apr_matmul`` wrapper: the hand-written CUDA kernel for CUDA tensors,
the plain PyTorch version (:func:`.ref.matmul_ref`) for CPU tensors.

There is no padding here: the kernel masks the ragged M/N/K edges itself,
so the (K, N) weight slice goes to it as it lies in memory.  The weight may
be an int8 :class:`~repro_torch.quant.QuantizedTensor`: the CUDA kernel
then dequantizes it in its load stage, and the plain version dequantizes it
first (to ``x.dtype``, as the JAX layers' ``materialize_weight`` does).
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from ...quant import QuantizedTensor
from .. import _build
from .ref import matmul_ref

LIBRARY = "apr_matmul"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "apr_matmul_bf16": (ctypes.c_int, [_P, _P, _P, _I, _I, _I, _I, _P]),
    "apr_matmul_int8w": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
}


def apr_matmul(x: torch.Tensor, y: Union[torch.Tensor, QuantizedTensor], *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x (M, K) @ y (K, N)`` with an fp32 accumulator resident across
    the whole K loop, rounded once to ``out_dtype``.

    ``y`` is a bf16 tensor or an int8 :class:`QuantizedTensor` with (1, N)
    fp32 scales.  CUDA tensors launch the kernel (bf16 ``x``, ``out_dtype``
    bf16 or fp32) or raise; CPU tensors take :func:`matmul_ref`.  Each
    launch adds one to ``apr_matmul.launches`` (bf16 weight) or
    ``apr_matmul.int8_launches`` (int8 weight)."""
    quantized = isinstance(y, QuantizedTensor)
    w = y.q if quantized else y
    if x.device.type == "cpu" and w.device.type == "cpu":
        if quantized:
            w = y.dequantize(x.dtype)
        return matmul_ref(x, w, out_dtype)
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"apr_matmul: operands on {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != (torch.int8 if quantized
                                                else torch.bfloat16):
        raise TypeError(f"apr_matmul kernel takes a bf16 x and a bf16 or int8 "
                        f"(QuantizedTensor) weight, got {x.dtype} and "
                        f"{w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"apr_matmul kernel writes bf16 or fp32, not {out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"apr_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("apr_matmul kernel takes contiguous row-major operands")
    m, k = x.shape
    n = w.shape[1]
    if quantized and (y.scale.shape != (1, n) or y.scale.dtype != torch.float32
                      or y.scale.device != w.device
                      or not y.scale.is_contiguous()):
        raise ValueError(f"apr_matmul: int8 weight {tuple(w.shape)} needs "
                         f"contiguous fp32 (1, {n}) scales on {w.device}, got "
                         f"{y.scale.dtype} {tuple(y.scale.shape)}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out_f32 = int(out_dtype == torch.float32)
    if quantized:
        err = lib.apr_matmul_int8w(x.data_ptr(), w.data_ptr(),
                                   y.scale.data_ptr(), out.data_ptr(), m, n,
                                   k, out_f32, stream)
    else:
        err = lib.apr_matmul_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  m, n, k, out_f32, stream)
    _build.check(lib, err, "apr_matmul")
    if quantized:
        apr_matmul.int8_launches += 1
    else:
        apr_matmul.launches += 1
    return out


apr_matmul.launches = 0
apr_matmul.int8_launches = 0
