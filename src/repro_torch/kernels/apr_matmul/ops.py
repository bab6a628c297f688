"""``apr_matmul`` and ``apr_matmul_fused`` wrappers: the hand-written CUDA
kernels of ``csrc/apr_matmul.cu`` for CUDA tensors, the plain PyTorch
versions (:mod:`.ref`) for CPU tensors.

There is no padding here: the kernels mask the ragged M/N/K edges
themselves, so the (K, N) weight slice goes to them as it lies in memory.
The weight of :func:`apr_matmul` may be an int8
:class:`~repro_torch.quant.QuantizedTensor`: the CUDA kernel then
dequantizes it in its load stage, and the plain version dequantizes it
first (to ``x.dtype``, as the JAX layers' ``materialize_weight`` does).

Tiles resolve as in the JAX package's ``ops.py``: an explicit ``config`` >
the tuned entry of the active :class:`~repro_torch.bench.ConfigCache` for
this (shape, dtype, backend) > :func:`default_config`, under the JAX
package's shape keys.  On the card
the tile must be one the kernel is compiled for (:data:`TILES`), or the
wrapper raises :class:`~repro_torch.bench.TileError` before any launch.
The int8-weight operand has one compiled tile (:data:`INT8W_TILE`) and no
family in the tuning layer: the JAX package has no such kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ...bench.config import (BlockConfig, TileError, dtype_name,
                             resolve_cached, resolve_config,
                             shape_key_from_dims)
from ...core.apr import reduction_hbm_traffic
from ...quant import QuantizedTensor
from .. import _build
from .ref import ACTIVATIONS, matmul_fused_ref, matmul_ref

LIBRARY = "apr_matmul"
KERNEL_NAME = "apr_matmul"
FUSED_KERNEL_NAME = "apr_matmul_fused"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "apr_matmul_bf16": (ctypes.c_int, [_P] * 5 + [_I] * 10 + [_P]),
    "apr_matmul_int8w": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
}
#: the (block_m, block_n, block_k) tiles ``apr_matmul.cu`` compiles
#: (``APR_MATMUL_TILES``) for the bf16 APR, memory-resident and fused kernels
TILES = ((16, 64, 32), (16, 64, 64), (16, 64, 128),
         (32, 64, 32), (32, 64, 64), (32, 64, 128))
#: the untuned tile, and the one tile of the int8-weight kernel
DEFAULT_TILE = INT8W_TILE = (16, 64, 64)
RESIDENCIES = ("apr", "hbm")
_STAGES = 4                                   # the bf16 cp.async ring


def shape_key(m: int, k: int, n: int, residency: str = "apr") -> str:
    # residency is part of the key: tiles tuned for the APR kernel never
    # apply to the memory-resident baseline
    return shape_key_from_dims(m=m, k=k, n=n) + f"_res{residency}"


def default_config(m: int, k: int, n: int) -> BlockConfig:
    """Untuned tile: 16 x 64 x 64, one 16x16 WMMA fragment per warp, the
    tile the serving path has run since the port's first slice."""
    bm, bn, bk = DEFAULT_TILE
    return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk)


def smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Shared memory a bf16 tile takes (``Tile<false, ...>::SMEM``): the
    4-stage ring of padded A and B tiles, or the fp32 C tile of the flush
    if larger."""
    ring = _STAGES * (block_m * (block_k + 8) + block_k * (block_n + 8)) * 2
    return max(ring, block_m * block_n * 4)


def accumulator_traffic_bytes(m: int, n: int, k: int, block_k: int,
                              residency: str, out_bytes: int = 2) -> int:
    """Analytic memory traffic attributable to the accumulator (Table-III
    'memory access' analogue), as the JAX package computes it."""
    n_steps = max(1, (k + block_k - 1) // block_k)
    return reduction_hbm_traffic(m * n, n_steps, out_bytes, residency)


def _tile(cfg: BlockConfig) -> tuple:
    tile = (cfg["block_m"], cfg["block_n"], cfg["block_k"])
    if tile not in TILES:
        raise TileError(f"apr_matmul: tile {tile} is not compiled; "
                        f"compiled tiles {TILES}")
    return tile


_SHAPE_KEYS = {
    KERNEL_NAME: lambda m, k, n, residency: shape_key(m, k, n, residency),
    FUSED_KERNEL_NAME: lambda m, k, n, residency: shape_key_from_dims(
        m=m, k=k, n=n),
}


def _default(m: int, k: int, n: int, residency: str) -> BlockConfig:
    return default_config(m, k, n)


def resolve_tile(kernel: str, m: int, k: int, n: int, dtype: str,
                 backend: str, residency: str = "apr",
                 config: Optional[BlockConfig] = None) -> tuple:
    """The ``(block_m, block_n, block_k)`` a launch of ``kernel``
    (``apr_matmul`` or ``apr_matmul_fused``) uses, checked against
    :data:`TILES`.  Without a caller's ``config`` the resolution is
    memoized in the active cache."""
    shape_key_of = _SHAPE_KEYS[kernel]
    if config is None:
        cfg = resolve_cached(kernel, (m, k, n, residency), dtype, backend,
                             shape_key=shape_key_of, default=_default)
    else:
        cfg = resolve_config(kernel, shape_key_of(m, k, n, residency), dtype,
                             backend, default=default_config(m, k, n),
                             override=config)
    return _tile(cfg)


def _check(x: torch.Tensor, w: torch.Tensor, wdtype: torch.dtype,
           out_dtype: torch.dtype, what: str) -> None:
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"{what}: operands on {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != wdtype:
        raise TypeError(f"{what} kernel takes a bf16 x and a {wdtype} weight, "
                        f"got {x.dtype} and {w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel writes bf16 or fp32, not {out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous row-major operands")


def apr_matmul(x: torch.Tensor, y: Union[torch.Tensor, QuantizedTensor], *,
               out_dtype: torch.dtype = torch.float32,
               residency: str = "apr",
               config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``x (M, K) @ y (K, N)`` with an fp32 accumulator, rounded once to
    ``out_dtype``.

    ``residency="apr"`` keeps the accumulator in registers across the whole
    K loop (one launch); ``"hbm"`` is the paper's baseline, whose fp32
    partial goes through global memory on every K step (one launch per
    step; bf16 weights only), equal to the APR kernel at the same tile bit
    for bit.  ``y`` is a bf16 tensor or an int8 :class:`QuantizedTensor`
    with (1, N) fp32 scales.  CUDA tensors launch the kernel (bf16 ``x``,
    ``out_dtype`` bf16 or fp32) or raise; CPU tensors take
    :func:`matmul_ref`.  Each launch adds one to ``apr_matmul.launches``
    (and to ``apr_matmul.tile_launches[tile]``), ``apr_matmul.hbm_launches``
    (one per K step of the baseline) or ``apr_matmul.int8_launches`` (int8
    weight)."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency {residency!r}")
    quantized = isinstance(y, QuantizedTensor)
    w = y.q if quantized else y
    if x.device.type == "cpu" and w.device.type == "cpu":
        if quantized:
            w = y.dequantize(x.dtype)
        return matmul_ref(x, w, out_dtype)
    if quantized and residency != "apr":
        raise ValueError("apr_matmul: the memory-resident baseline takes a "
                         "bf16 weight")
    _check(x, w, torch.int8 if quantized else torch.bfloat16, out_dtype,
           "apr_matmul")
    m, k = x.shape
    n = w.shape[1]
    if quantized:
        if config is not None and _tile(
                default_config(m, k, n).replace(**config.to_dict())) \
                != INT8W_TILE:
            raise TileError(f"apr_matmul: the int8-weight kernel has one "
                            f"tile, {INT8W_TILE}")
        if (y.scale.shape != (1, n) or y.scale.dtype != torch.float32
                or y.scale.device != w.device or not y.scale.is_contiguous()):
            raise ValueError(f"apr_matmul: int8 weight {tuple(w.shape)} needs "
                             f"contiguous fp32 (1, {n}) scales on {w.device}, "
                             f"got {y.scale.dtype} {tuple(y.scale.shape)}")
    else:
        bm, bn, bk = resolve_tile(KERNEL_NAME, m, k, n, dtype_name(x.dtype),
                                  "cuda", residency, config)
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
        _build.check(lib, err, "apr_matmul")
        apr_matmul.int8_launches += 1
        return out
    ktiles = -(-k // bk)
    if residency == "apr":
        err = lib.apr_matmul_bf16(x.data_ptr(), w.data_ptr(), None, None,
                                  out.data_ptr(), m, n, k, bm, bn, bk, 0,
                                  ktiles, out_f32, ACTIVATIONS["none"],
                                  stream)
        _build.check(lib, err, "apr_matmul")
        apr_matmul.launches += 1
        tiles = apr_matmul.tile_launches
        tiles[(bm, bn, bk)] = tiles.get((bm, bn, bk), 0) + 1
        return out
    # the baseline: the fp32 partial (the output itself when it is fp32)
    # is read and written by every K step; the last step rounds
    partial = out if out_f32 else torch.empty((m, n), dtype=torch.float32,
                                              device=x.device)
    steps = max(1, ktiles)
    for s in range(steps):
        last = s == steps - 1
        err = lib.apr_matmul_bf16(
            x.data_ptr(), w.data_ptr(), None,
            partial.data_ptr() if s else None,
            (out if last else partial).data_ptr(), m, n, k, bm, bn, bk, s,
            min(s + 1, ktiles), out_f32 if last else 1, ACTIVATIONS["none"],
            stream)
        _build.check(lib, err, "apr_matmul (residency='hbm')")
        apr_matmul.hbm_launches += 1
    return out


apr_matmul.launches = 0
apr_matmul.hbm_launches = 0
apr_matmul.int8_launches = 0
apr_matmul.tile_launches = {}


def apr_matmul_fused(x: torch.Tensor, y: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     activation: str = "relu",
                     out_dtype: torch.dtype = torch.float32,
                     config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``activation(x @ y + bias)`` in one kernel: bias (``None``, ``(N,)``
    or ``(1, N)``, used in fp32) and the activation are applied to the fp32
    accumulator at its one flush, before the single write.  Tuned under its
    own family name.  CUDA tensors launch the kernel (bf16 ``x`` and ``y``)
    or raise; CPU tensors take :func:`matmul_fused_ref`.  Each launch adds
    one to ``apr_matmul_fused.launches``."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"expected one of {tuple(ACTIVATIONS)}")
    n = y.shape[-1]
    if bias is not None and bias.numel() != n:
        raise ValueError(f"apr_matmul_fused: bias {tuple(bias.shape)} for "
                         f"{n} output columns")
    tensors = (x, y) if bias is None else (x, y, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return matmul_fused_ref(x, y, bias, activation, out_dtype)
    _check(x, y, torch.bfloat16, out_dtype, "apr_matmul_fused")
    if bias is not None:
        if bias.device != x.device:
            raise ValueError(f"apr_matmul_fused: bias on {bias.device}, "
                             f"operands on {x.device}")
        bias = bias.reshape(n).float().contiguous()
    m, k = x.shape
    bm, bn, bk = resolve_tile(FUSED_KERNEL_NAME, m, k, n, dtype_name(x.dtype),
                              "cuda", "apr", config)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.apr_matmul_bf16(x.data_ptr(), y.data_ptr(),
                              None if bias is None else bias.data_ptr(), None,
                              out.data_ptr(), m, n, k, bm, bn, bk, 0,
                              -(-k // bk), int(out_dtype == torch.float32),
                              ACTIVATIONS[activation], stream)
    _build.check(lib, err, "apr_matmul_fused")
    apr_matmul_fused.launches += 1
    return out


apr_matmul_fused.launches = 0
