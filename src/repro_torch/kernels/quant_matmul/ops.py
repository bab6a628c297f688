"""``quant_matmul`` and ``quant_matmul_fused`` wrappers: the hand-written
CUDA kernel of ``csrc/quant_matmul.cu`` for CUDA tensors, the plain PyTorch
versions (:mod:`.ref`) for CPU tensors.

W8A8-dynamic contract, as in the JAX package's ``quant_matmul/ops.py``:
weights are quantized offline (symmetric per output channel,
:func:`quantize_weights`), activations per call (symmetric per row over the
whole K axis, :func:`quantize_activations`, plain PyTorch ops on either
device), so one scale covers every K block of a row and the int32
accumulation is exact.  The kernel masks ragged edges itself; there is no
padding.

Tiles resolve as in the JAX package: an explicit ``config`` > the tuned
entry of the active cache for this (shape, dtype, backend) >
:func:`default_config`, under the JAX shape keys.  On the
card the tile must be one of :data:`TILES`, or the wrapper raises
:class:`~repro_torch.bench.TileError` before any launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...bench.config import (BlockConfig, TileError, dtype_name,
                             resolve_cached, resolve_config,
                             shape_key_from_dims)
from ...quant import QuantizedTensor, quantize_channelwise
from .. import _build
from ..apr_matmul.ref import ACTIVATIONS
from .ref import quant_matmul_fused_ref, quant_matmul_ref, quantize_activations

LIBRARY = "quant_matmul"
KERNEL_NAME = "quant_matmul"
FUSED_KERNEL_NAME = "quant_matmul_fused"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "quant_matmul_i8": (ctypes.c_int, [_P] * 6 + [_I] * 8 + [_P]),
}
#: the (block_m, block_n, block_k) tiles ``quant_matmul.cu`` compiles
#: (``QMM_TILES``)
TILES = ((16, 64, 64), (16, 64, 128), (16, 64, 256),
         (32, 64, 64), (32, 64, 128), (32, 64, 256))
DEFAULT_TILE = (16, 64, 64)
_STAGES = 4


def shape_key(m: int, k: int, n: int) -> str:
    return shape_key_from_dims(m=m, k=k, n=n)


def default_config(m: int, k: int, n: int) -> BlockConfig:
    """Untuned tile: 16 x 64 x 64, B1's tile (the JAX package's 128-cube is
    a TPU matrix-unit shape)."""
    bm, bn, bk = DEFAULT_TILE
    return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk)


def smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Shared memory a tile takes (``QTile<...>::SMEM``): the 4-stage ring
    of padded Xq and raw Yq tiles plus the transposed Yq tile, or the int32
    C tile of the flush if larger."""
    ring = _STAGES * (block_m * (block_k + 16) + block_k * (block_n + 16))
    return max(ring + block_n * (block_k + 16), block_m * block_n * 4)


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline weight prep: (K, N) float -> int8 payload + (1, N) scales."""
    qt = quantize_channelwise(w, axis=-2)
    return qt.q, qt.scale


def _default(m: int, k: int, n: int) -> BlockConfig:
    return default_config(m, k, n)


def resolve_tile(kernel: str, m: int, k: int, n: int, dtype: str,
                 backend: str, config: Optional[BlockConfig] = None) -> tuple:
    """The ``(block_m, block_n, block_k)`` a launch of ``kernel``
    (``quant_matmul`` or ``quant_matmul_fused``) uses, checked against
    :data:`TILES`; memoized in the active cache without a caller's
    ``config``."""
    if config is None:
        cfg = resolve_cached(kernel, (m, k, n), dtype, backend,
                             shape_key=shape_key, default=_default)
    else:
        cfg = resolve_config(kernel, shape_key(m, k, n), dtype, backend,
                             default=default_config(m, k, n),
                             override=config)
    tile = (cfg["block_m"], cfg["block_n"], cfg["block_k"])
    if tile not in TILES:
        raise TileError(f"{kernel}: tile {tile} is not compiled; compiled "
                        f"tiles {TILES}")
    return tile


def _launch(kernel: str, x: torch.Tensor, y_q: torch.Tensor,
            y_scale: torch.Tensor, bias: Optional[torch.Tensor],
            activation: str, out_dtype: torch.dtype,
            config: Optional[BlockConfig]) -> torch.Tensor:
    tensors = [x, y_q, y_scale] + ([] if bias is None else [bias])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{kernel}: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            y_q.dtype != torch.int8:
        raise TypeError(f"{kernel} kernel takes an fp32 or bf16 x and an int8 "
                        f"weight, got {x.dtype} and {y_q.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel} kernel writes bf16 or fp32, not "
                        f"{out_dtype}")
    if x.dim() != 2 or y_q.dim() != 2 or x.shape[1] != y_q.shape[0]:
        raise ValueError(f"{kernel}: shapes {tuple(x.shape)} @ "
                         f"{tuple(y_q.shape)}")
    if not y_q.is_contiguous():
        raise ValueError(f"{kernel} kernel takes a contiguous row-major "
                         f"weight")
    m, k = x.shape
    n = y_q.shape[1]
    if y_scale.numel() != n:
        raise ValueError(f"{kernel}: weight scales {tuple(y_scale.shape)} "
                         f"for {n} columns")
    bm, bn, bk = resolve_tile(kernel, m, k, n, dtype_name(x.dtype), "cuda",
                              config)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    x_q, x_scale = quantize_activations(x)
    ys = y_scale.reshape(n).float().contiguous()
    if bias is not None:
        bias = bias.reshape(n).float().contiguous()
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul_i8(
        x_q.data_ptr(), y_q.data_ptr(), x_scale.data_ptr(), ys.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        bm, bn, bk, int(out_dtype == torch.float32), ACTIVATIONS[activation],
        stream)
    _build.check(lib, err, kernel)
    return out


def quant_matmul(x: torch.Tensor, y_q, y_scale: Optional[torch.Tensor] = None,
                 *, out_dtype: torch.dtype = torch.float32,
                 config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``x @ dequant(y)`` with int8 operands and an int32 accumulator.

    ``x`` (M, K) fp32 or bf16 is quantized per row; ``y_q`` / ``y_scale``
    are the offline-quantized weight (a :class:`QuantizedTensor` as ``y_q``
    needs no ``y_scale``).  CUDA tensors launch the kernel or raise; CPU
    tensors take :func:`quant_matmul_ref`.  Each launch adds one to
    ``quant_matmul.launches``."""
    if isinstance(y_q, QuantizedTensor):
        y_q, y_scale = y_q.q, y_q.scale
    if y_scale is None:
        raise ValueError("quant_matmul: y_scale is required with a raw int8 "
                         "payload")
    if all(t.device.type == "cpu" for t in (x, y_q, y_scale)):
        return quant_matmul_ref(x, y_q, y_scale, out_dtype)
    out = _launch(KERNEL_NAME, x, y_q, y_scale, None, "none", out_dtype,
                  config)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_matmul_fused(x: torch.Tensor, y_q,
                       y_scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None, *,
                       activation: str = "relu",
                       out_dtype: torch.dtype = torch.float32,
                       config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``activation(x @ dequant(y) + bias)`` in one kernel: the scales, the
    bias (``None``, ``(N,)`` or ``(1, N)``, used in fp32) and the
    activation all ride the int32 accumulator's one flush.  Tuned under its
    own family name.  CUDA tensors launch the kernel or raise; CPU tensors
    take :func:`quant_matmul_fused_ref`.  Each launch adds one to
    ``quant_matmul_fused.launches``."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"expected one of {tuple(ACTIVATIONS)}")
    if isinstance(y_q, QuantizedTensor):
        y_q, y_scale = y_q.q, y_q.scale
    if y_scale is None:
        raise ValueError("quant_matmul_fused: y_scale is required with a raw "
                         "int8 payload")
    n = y_q.shape[-1]
    if bias is not None and bias.numel() != n:
        raise ValueError(f"quant_matmul_fused: bias {tuple(bias.shape)} for "
                         f"{n} output columns")
    tensors = (x, y_q, y_scale) + (() if bias is None else (bias,))
    if all(t.device.type == "cpu" for t in tensors):
        return quant_matmul_fused_ref(x, y_q, y_scale, bias, activation,
                                      out_dtype)
    out = _launch(FUSED_KERNEL_NAME, x, y_q, y_scale, bias, activation,
                  out_dtype, config)
    quant_matmul_fused.launches += 1
    return out


quant_matmul_fused.launches = 0
