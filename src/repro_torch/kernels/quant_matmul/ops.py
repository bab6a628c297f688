"""``quant_matmul`` and ``quant_matmul_fused`` wrappers: the hand-written
CUDA kernel of ``csrc/quant_matmul.cu`` for CUDA tensors, the plain PyTorch
versions (:mod:`.ref`) for CPU tensors.

W8A8-dynamic contract, as in the JAX package's ``quant_matmul/ops.py``:
weights are quantized offline (symmetric per output channel,
:func:`quantize_weights`), activations per call (symmetric per row over the
whole K axis, :func:`quantize_activations`), so one scale covers every K
block of a row and the int32 accumulation is exact.  On the card the
kernel takes ``x`` as it is (bf16 or fp32) and quantizes it inside its one
launch; the plain version runs :func:`quantize_activations` first.  The
kernel masks ragged edges itself; there is no padding.

Configurations resolve as in the JAX package: the ``block_m``,
``block_n``, ``block_k`` and ``splits`` kwargs laid over an explicit
``config`` > the tuned entry of the active cache for this (shape, dtype,
backend) > :func:`default_config`, under the JAX shape keys.  A
configuration is a tile and a split count: the K range of each column tile
cut into ``splits`` ranges of :data:`~.ref.K_RANGE`-row multiples combined
over a thread-block cluster (the default from the geometry,
:func:`default_splits`).  Every tile and split count gives the same bits
(the integer sums are exact).  On the card the configuration must be one
of :data:`TILES` at one of :data:`SPLITS`, or the wrapper raises
:class:`~repro_torch.bench.TileError` before any launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...bench.config import (BlockConfig, TileError, dtype_name, pin_config,
                             resolve_cached, resolve_config,
                             shape_key_from_dims)
from ...quant import QuantizedTensor, quantize_channelwise
from ...roofline.hw import get_profile
from .. import _build
from ..apr_matmul.ref import ACTIVATIONS, split_range
from .ref import (K_RANGE, quant_matmul_fused_ref, quant_matmul_ref,
                  quantize_activations)

LIBRARY = "quant_matmul"
KERNEL_NAME = "quant_matmul"
FUSED_KERNEL_NAME = "quant_matmul_fused"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "quant_matmul_i8": (ctypes.c_int, [_P] * 5 + [_I] * 11 + [_P]),
}
#: the (block_m, block_n, block_k) tiles ``quant_matmul.cu`` compiles
#: (``QMM_TILES``), each for a bf16 and an fp32 ``x``
TILES = ((16, 64, 64), (16, 64, 128), (16, 64, 256),
         (32, 64, 64), (32, 64, 128), (32, 64, 256))
#: the untuned tile: the deepest K step, the fastest tile at every
#: llama3-8b projection shape on an H100 (PERF.md, PR 20)
DEFAULT_TILE = (16, 64, 256)
#: the split counts the kernel takes (one cluster of at most 8 blocks per
#: column tile)
SPLITS = (1, 2, 4, 8)
#: the blocks :func:`default_splits` aims to run at once: about one on
#: each SM of the ``h100_sxm`` profile (on every card, so that the tune
#: spec and the wrapper agree), twice that where a block's range would
#: otherwise exceed :data:`LONG_RANGE` rows
SPLIT_BLOCK_BUDGET = get_profile("h100_sxm").sms
LONG_RANGE = 4096
_WEIGHT_RING = 48 * 1024                      # WEIGHT_RING in the source


def shape_key(m: int, k: int, n: int) -> str:
    return shape_key_from_dims(m=m, k=k, n=n)


def default_splits(m: int, k: int, n: int, block_m: int, block_n: int
                   ) -> int:
    """The largest of :data:`SPLITS` for which column tiles x row tiles x
    splits stay within :data:`SPLIT_BLOCK_BUDGET` blocks, doubled (within
    twice the budget) while a split's range exceeds :data:`LONG_RANGE`
    rows; never more splits than K has :data:`~.ref.K_RANGE`-row ranges
    (one at least).  At llama3-8b's decode shapes (M = 4 or 16, 64-column
    tiles): 8 at N = 1024, 2 at wq/wo's N = 4096, 1 at N = 14336, 4 at
    w_down's K = 14336 -- the fastest counts there on an H100."""
    tiles = -(-n // block_n) * -(-m // block_m)
    ranges = max(1, -(-k // K_RANGE))
    splits = max(s for s in SPLITS if s <= min(
        ranges, max(1, SPLIT_BLOCK_BUDGET // max(1, tiles))))
    while (splits < SPLITS[-1] and 2 * splits <= ranges
           and tiles * 2 * splits <= 2 * SPLIT_BLOCK_BUDGET
           and split_range(k, splits, K_RANGE) > LONG_RANGE):
        splits *= 2
    return splits


def default_config(m: int, k: int, n: int) -> BlockConfig:
    """Untuned configuration: :data:`DEFAULT_TILE` (the JAX package's
    128-cube is a TPU matrix-unit shape) at :func:`default_splits`."""
    bm, bn, bk = DEFAULT_TILE
    return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk,
                            splits=default_splits(m, k, n, bm, bn))


def smem_bytes(block_m: int, block_n: int, block_k: int,
               x_bytes: int = 2) -> int:
    """Shared memory a tile takes (``QTile<...>::SMEM``) over an ``x`` of
    ``x_bytes`` an element: a ring of (padded x tile, unpadded int8 weight
    tile) stages holding about 48 KB of weight (3 to 8 stages), or the
    warps' int32 partials of the flush if larger, plus the rows' maxima and
    scales."""
    warps_k = min(4, block_k // 32)
    stage = block_m * (block_k + 16 // x_bytes) * x_bytes \
        + block_k * block_n
    ring = min(8, max(3, _WEIGHT_RING // (block_k * block_n))) * stage
    return max(ring, warps_k * block_m * block_n * 4) + 8 * block_m


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline weight prep: (K, N) float -> int8 payload + (1, N) scales."""
    qt = quantize_channelwise(w, axis=-2)
    return qt.q, qt.scale


def _default(m: int, k: int, n: int) -> BlockConfig:
    return default_config(m, k, n)


def resolve_launch(kernel: str, m: int, k: int, n: int, dtype: str,
                   backend: str, config: Optional[BlockConfig] = None
                   ) -> tuple:
    """``((block_m, block_n, block_k), splits)`` of a launch of ``kernel``
    (``quant_matmul`` or ``quant_matmul_fused``), checked against
    :data:`TILES` and :data:`SPLITS`; memoized in the active cache without a
    caller's ``config``.  A configuration without a split count (a cache
    entry of the JAX package's) takes the default one."""
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
    splits = cfg.get("splits", 1)
    if splits not in SPLITS:
        raise TileError(f"{kernel}: {splits} splits; the kernel takes "
                        f"{SPLITS}")
    return tile, splits


def resolve_tile(kernel: str, m: int, k: int, n: int, dtype: str,
                 backend: str, config: Optional[BlockConfig] = None) -> tuple:
    """The ``(block_m, block_n, block_k)`` of :func:`resolve_launch`."""
    return resolve_launch(kernel, m, k, n, dtype, backend, config)[0]


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
    if not (x.is_contiguous() and y_q.is_contiguous()):
        raise ValueError(f"{kernel} kernel takes a contiguous row-major x "
                         f"and weight")
    m, k = x.shape
    n = y_q.shape[1]
    if y_scale.numel() != n:
        raise ValueError(f"{kernel}: weight scales {tuple(y_scale.shape)} "
                         f"for {n} columns")
    (bm, bn, bk), splits = resolve_launch(kernel, m, k, n,
                                          dtype_name(x.dtype), "cuda", config)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    # views, no copies, for the (1, N) fp32 scales and (N,) fp32 bias the
    # callers pass
    ys = y_scale.reshape(n).float().contiguous()
    if bias is not None:
        bias = bias.reshape(n).float().contiguous()
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul_i8(
        x.data_ptr(), y_q.data_ptr(), ys.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        int(x.dtype == torch.bfloat16), bm, bn, bk, splits,
        split_range(k, splits, K_RANGE), int(out_dtype == torch.float32),
        ACTIVATIONS[activation], stream)
    _build.check(lib, err, kernel)
    return out


def quant_matmul(x: torch.Tensor, y_q, y_scale: Optional[torch.Tensor] = None,
                 *, block_m: Optional[int] = None,
                 block_n: Optional[int] = None,
                 block_k: Optional[int] = None, splits: Optional[int] = None,
                 out_dtype: torch.dtype = torch.float32,
                 config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``x @ dequant(y)`` with int8 operands and an int32 accumulator.

    ``x`` (M, K) fp32 or bf16 is quantized per row (inside the kernel's
    launch on the card); ``y_q`` / ``y_scale`` are the offline-quantized
    weight (a :class:`QuantizedTensor` as ``y_q`` needs no ``y_scale``).
    ``block_m``, ``block_n``, ``block_k`` and ``splits`` pin the
    configuration over ``config``, as the JAX wrapper's kwargs do.  CUDA
    tensors launch the kernel (one launch a call) or raise; CPU tensors
    take :func:`quant_matmul_ref`.  Each launch adds one to
    ``quant_matmul.launches``."""
    if isinstance(y_q, QuantizedTensor):
        y_q, y_scale = y_q.q, y_q.scale
    if y_scale is None:
        raise ValueError("quant_matmul: y_scale is required with a raw int8 "
                         "payload")
    if all(t.device.type == "cpu" for t in (x, y_q, y_scale)):
        return quant_matmul_ref(x, y_q, y_scale, out_dtype)
    config = pin_config(config, block_m=block_m, block_n=block_n,
                        block_k=block_k, splits=splits)
    out = _launch(KERNEL_NAME, x, y_q, y_scale, None, "none", out_dtype,
                  config)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_matmul_fused(x: torch.Tensor, y_q,
                       y_scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None, *,
                       activation: str = "relu",
                       block_m: Optional[int] = None,
                       block_n: Optional[int] = None,
                       block_k: Optional[int] = None,
                       splits: Optional[int] = None,
                       out_dtype: torch.dtype = torch.float32,
                       config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``activation(x @ dequant(y) + bias)`` in one kernel: the scales, the
    bias (``None``, ``(N,)`` or ``(1, N)``, used in fp32) and the
    activation all ride the int32 accumulator's one flush.  Tuned under its
    own family name; ``block_*`` and ``splits`` pin the configuration as in
    :func:`quant_matmul`.  CUDA tensors launch the kernel or raise; CPU
    tensors take :func:`quant_matmul_fused_ref`.  Each launch adds one to
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
    config = pin_config(config, block_m=block_m, block_n=block_n,
                        block_k=block_k, splits=splits)
    out = _launch(FUSED_KERNEL_NAME, x, y_q, y_scale, bias, activation,
                  out_dtype, config)
    quant_matmul_fused.launches += 1
    return out


quant_matmul_fused.launches = 0
