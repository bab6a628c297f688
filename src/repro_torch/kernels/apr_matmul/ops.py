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
The int8-weight operand has a kernel and tiles of its own
(:data:`INT8W_TILES`); it tunes within the ``apr_matmul`` family under the
shape key's ``_wint8`` suffix (the JAX package has no such kernel, so no
JAX key carries it).  fp32 operands (an fp32 ``x`` with an fp32 weight)
have a kernel of their own compiled for one tile (:data:`F32_CONFIG`),
resolved under the JAX package's keys at dtype ``float32``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ...bench.config import (BlockConfig, TileError, dtype_name,
                             pin_config, resolve_cached, resolve_config,
                             resolve_fixed, shape_key_from_dims)
from ...core.apr import reduction_hbm_traffic
from ...quant import QuantizedTensor
from ...roofline.hw import get_profile
from .. import _build
from .ref import ACTIVATIONS, matmul_fused_ref, matmul_ref

LIBRARY = "apr_matmul"
KERNEL_NAME = "apr_matmul"
FUSED_KERNEL_NAME = "apr_matmul_fused"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "apr_matmul_bf16": (ctypes.c_int, [_P] * 5 + [_I] * 10 + [_P]),
    "apr_matmul_int8w": (ctypes.c_int, [_P] * 4 + [_I] * 6 + [_P]),
    "apr_matmul_f32": (ctypes.c_int, [_P] * 4 + [_I] * 5 + [_P]),
}
#: (x dtype, weight dtype) pairs each kernel family is compiled for; int8
#: is a :class:`QuantizedTensor`'s codes (with its fp32 scales)
KERNEL_DTYPES = {
    KERNEL_NAME: frozenset({(torch.bfloat16, torch.bfloat16),
                            (torch.bfloat16, torch.int8),
                            (torch.float32, torch.float32)}),
    FUSED_KERNEL_NAME: frozenset({(torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.float32)}),
}
#: the (block_m, block_n, block_k) tiles ``apr_matmul.cu`` compiles
#: (``APR_MATMUL_TILES``) for the bf16 APR, memory-resident and fused kernels
TILES = ((16, 64, 32), (16, 64, 64), (16, 64, 128),
         (32, 64, 32), (32, 64, 64), (32, 64, 128))
#: the untuned tile
DEFAULT_TILE = (16, 64, 64)
#: the (block_m, block_n, block_k) tiles of the int8-weight kernel
#: (``INT8W_TILES`` in ``apr_matmul.cu``); every one gives the same bits
INT8W_TILES = ((16, 16, 128), (16, 32, 64), (16, 64, 64), (16, 32, 128),
               (16, 64, 128))
#: the one tile of the fp32 kernel (``F32_BM``, ``F32_BN``, ``F32_KU`` in
#: ``apr_matmul.cu``: 16 rows x 32 columns a block, 8 K rows a load step)
F32_CONFIG = BlockConfig.make(block_m=16, block_n=32, block_k=8)
RESIDENCIES = ("apr", "hbm")
_STAGES = 4                                   # the bf16 cp.async ring


def shape_key(m: int, k: int, n: int, residency: str = "apr",
              w_int8: bool = False) -> str:
    # residency is part of the key: tiles tuned for the APR kernel never
    # apply to the memory-resident baseline, nor to the int8-weight kernel
    return (shape_key_from_dims(m=m, k=k, n=n) + f"_res{residency}"
            + ("_wint8" if w_int8 else ""))


def default_config(m: int, k: int, n: int) -> BlockConfig:
    """Untuned tile: 16 x 64 x 64, one 16x16 WMMA fragment per warp, the
    tile the serving path has run since the port's first slice."""
    bm, bn, bk = DEFAULT_TILE
    return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk)


def int8w_default_config(m: int, k: int, n: int) -> BlockConfig:
    """Untuned int8-weight tile, 128 rows of K a stage (half the barriers
    of 64): 64 columns where N / 64 blocks cover every one of the
    ``h100_sxm`` profile's SMs, 32 where N / 32 cover half of them, else
    16.  At llama3-8b's widths that is 64 at N = 14336, 32 at 4096 and 16
    at 1024, the exhaustive winners there on an H100."""
    sms = get_profile("h100_sxm").sms
    if -(-n // 64) >= sms:
        bn = 64
    elif -(-n // 32) >= sms // 2:
        bn = 32
    else:
        bn = 16
    return BlockConfig.make(block_m=16, block_n=bn, block_k=128)


def int8w_smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Shared memory an int8-weight tile takes (``QTile::SMEM``): a ring of
    (A, int8 B) stage pairs as deep as 48 KB allows, at most 8."""
    stage = block_m * (block_k + 8) * 2 + block_k * max(block_n + 16, 48)
    return min(8, 48 * 1024 // stage) * stage


def smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Shared memory a bf16 tile takes (``Tile<...>::SMEM``): the
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


def _tile(cfg: BlockConfig, w_int8: bool = False) -> tuple:
    tile = (cfg["block_m"], cfg["block_n"], cfg["block_k"])
    tiles = INT8W_TILES if w_int8 else TILES
    if tile not in tiles:
        raise TileError(f"apr_matmul: {'int8-weight ' if w_int8 else ''}"
                        f"tile {tile} is not compiled; compiled tiles "
                        f"{tiles}")
    return tile


_SHAPE_KEYS = {
    KERNEL_NAME: lambda m, k, n, residency, w_int8=False: shape_key(
        m, k, n, residency, w_int8),
    FUSED_KERNEL_NAME: lambda m, k, n, residency, w_int8=False:
        shape_key_from_dims(m=m, k=k, n=n),
}


def _default(m: int, k: int, n: int, residency: str,
             w_int8: bool = False) -> BlockConfig:
    if w_int8:
        return int8w_default_config(m, k, n)
    return default_config(m, k, n)


def resolve_tile(kernel: str, m: int, k: int, n: int, dtype: str,
                 backend: str, residency: str = "apr",
                 config: Optional[BlockConfig] = None,
                 w_int8: bool = False) -> tuple:
    """The ``(block_m, block_n, block_k)`` a launch of ``kernel``
    (``apr_matmul`` or ``apr_matmul_fused``) uses, checked against
    :data:`TILES` (:data:`INT8W_TILES` for the int8-weight kernel,
    ``w_int8``).  Without a caller's ``config`` the resolution is memoized
    in the active cache."""
    shape_key_of = _SHAPE_KEYS[kernel]
    dims = (m, k, n, residency, w_int8)
    if config is None:
        cfg = resolve_cached(kernel, dims, dtype, backend,
                             shape_key=shape_key_of, default=_default)
    else:
        cfg = resolve_config(kernel, shape_key_of(*dims), dtype, backend,
                             default=_default(*dims), override=config)
    return _tile(cfg, w_int8)


def resolve_f32(kernel: str, m: int, k: int, n: int,
                config: Optional[BlockConfig] = None) -> BlockConfig:
    """The fp32 kernel's configuration for a launch of ``kernel``: whatever
    resolves under the family's key at dtype ``float32`` must be
    :data:`F32_CONFIG`, or :class:`~repro_torch.bench.TileError` is
    raised."""
    return resolve_fixed(kernel, (m, k, n, "apr"), "float32", "cuda",
                         shape_key=_SHAPE_KEYS[kernel], compiled=F32_CONFIG,
                         config=config)


def _launch_f32(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor], activation: str,
                out_dtype: torch.dtype, kernel: str,
                config: Optional[BlockConfig], wrapper) -> torch.Tensor:
    """``activation(x @ w + bias)`` on fp32 operands by ``apr_matmul_f32``
    for family ``kernel``, whose configuration must resolve to
    :data:`F32_CONFIG`; ``bias`` fp32 (N,) or None.  A launch adds one to
    ``wrapper.f32_launches``."""
    (m, k), n = x.shape, w.shape[1]
    resolve_f32(kernel, m, k, n, config)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    err = lib.apr_matmul_f32(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, int(out_dtype == torch.float32),
        ACTIVATIONS[activation],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, kernel)
    wrapper.f32_launches += 1
    return out


def check_dtypes(name: str, x_dtype: torch.dtype,
                 w_dtype: torch.dtype) -> None:
    """Raise ``TypeError`` unless kernel family ``name`` (``apr_matmul``
    or ``apr_matmul_fused``) is compiled for an ``x`` of ``x_dtype`` and a
    weight of ``w_dtype`` (:data:`KERNEL_DTYPES`)."""
    pairs = KERNEL_DTYPES[name]
    if (x_dtype, w_dtype) not in pairs:
        raise TypeError(
            f"{name} kernel takes (x, weight) dtypes "
            f"{sorted((str(a)[6:], str(b)[6:]) for a, b in pairs)}, got "
            f"{x_dtype} and {w_dtype}")


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
           what: str) -> None:
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"{what}: operands on {x.device} and {w.device}")
    check_dtypes(what, x.dtype, w.dtype)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel writes bf16 or fp32, not {out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous row-major operands")


def apr_matmul(x: torch.Tensor, y: Union[torch.Tensor, QuantizedTensor], *,
               block_m: Optional[int] = None, block_n: Optional[int] = None,
               block_k: Optional[int] = None,
               out_dtype: torch.dtype = torch.float32,
               residency: str = "apr",
               config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``x (M, K) @ y (K, N)`` with an fp32 accumulator, rounded once to
    ``out_dtype``.

    ``residency="apr"`` keeps the accumulator in registers across the whole
    K loop (one launch); ``"hbm"`` is the paper's baseline, whose fp32
    partial goes through global memory on every K step (one launch per
    step; bf16 operands only), equal to the APR kernel at the same tile bit
    for bit.  ``y`` is a bf16 tensor or an int8 :class:`QuantizedTensor`
    with (1, N) fp32 scales under a bf16 ``x``, or an fp32 tensor under an
    fp32 ``x`` (:data:`KERNEL_DTYPES`); the int8-weight kernel equals the
    bf16 one on the dequantized weight bit for bit.  ``block_m``,
    ``block_n`` and ``block_k`` pin the tile over ``config``, as the JAX
    wrapper's kwargs do.  CUDA tensors launch the kernel (``out_dtype``
    bf16 or fp32) or raise; CPU tensors take :func:`matmul_ref`.  Each
    launch adds one to ``apr_matmul.launches`` (and to
    ``apr_matmul.tile_launches[tile]``), ``apr_matmul.hbm_launches`` (one
    per K step of the baseline), ``apr_matmul.int8_launches`` (int8 weight;
    and ``apr_matmul.int8_tile_launches[tile]``) or
    ``apr_matmul.f32_launches`` (fp32 operands)."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency {residency!r}")
    config = pin_config(config, block_m=block_m, block_n=block_n,
                        block_k=block_k)
    quantized = isinstance(y, QuantizedTensor)
    w = y.q if quantized else y
    if x.device.type == "cpu" and w.device.type == "cpu":
        if quantized:
            w = y.dequantize(x.dtype)
        return matmul_ref(x, w, out_dtype)
    _check(x, w, out_dtype, KERNEL_NAME)
    if residency != "apr" and (quantized or x.dtype != torch.bfloat16):
        raise ValueError("apr_matmul: the memory-resident baseline takes "
                         "bf16 operands")
    if x.dtype == torch.float32:
        return _launch_f32(x, w, None, "none", out_dtype, KERNEL_NAME,
                           config, apr_matmul)
    m, k = x.shape
    n = w.shape[1]
    if quantized and (y.scale.shape != (1, n)
                      or y.scale.dtype != torch.float32
                      or y.scale.device != w.device
                      or not y.scale.is_contiguous()):
        raise ValueError(f"apr_matmul: int8 weight {tuple(w.shape)} needs "
                         f"contiguous fp32 (1, {n}) scales on {w.device}, "
                         f"got {y.scale.dtype} {tuple(y.scale.shape)}")
    bm, bn, bk = resolve_tile(KERNEL_NAME, m, k, n, dtype_name(x.dtype),
                              "cuda", residency, config, quantized)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out_f32 = int(out_dtype == torch.float32)
    if quantized:
        err = lib.apr_matmul_int8w(x.data_ptr(), w.data_ptr(),
                                   y.scale.data_ptr(), out.data_ptr(), m, n,
                                   k, bn, bk, out_f32, stream)
        _build.check(lib, err, "apr_matmul")
        apr_matmul.int8_launches += 1
        tiles = apr_matmul.int8_tile_launches
        tiles[(bm, bn, bk)] = tiles.get((bm, bn, bk), 0) + 1
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
apr_matmul.f32_launches = 0
apr_matmul.tile_launches = {}
apr_matmul.int8_tile_launches = {}


def apr_matmul_fused(x: torch.Tensor, y: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     block_m: Optional[int] = None,
                     block_n: Optional[int] = None,
                     block_k: Optional[int] = None,
                     activation: str = "relu",
                     out_dtype: torch.dtype = torch.float32,
                     config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``activation(x @ y + bias)`` in one kernel: bias (``None``, ``(N,)``
    or ``(1, N)``, used in fp32) and the activation are applied to the fp32
    accumulator at its one flush, before the single write.  Tuned under its
    own family name; ``block_m``/``block_n``/``block_k`` pin the tile.
    CUDA tensors launch the kernel (bf16 ``x`` and ``y``, or fp32 both) or
    raise; CPU tensors take :func:`matmul_fused_ref`.  Each launch adds one
    to ``apr_matmul_fused.launches`` (``.f32_launches`` for fp32)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"expected one of {tuple(ACTIVATIONS)}")
    n = y.shape[-1]
    if bias is not None and bias.numel() != n:
        raise ValueError(f"apr_matmul_fused: bias {tuple(bias.shape)} for "
                         f"{n} output columns")
    tensors = (x, y) if bias is None else (x, y, bias)
    config = pin_config(config, block_m=block_m, block_n=block_n,
                        block_k=block_k)
    if all(t.device.type == "cpu" for t in tensors):
        return matmul_fused_ref(x, y, bias, activation, out_dtype)
    _check(x, y, out_dtype, FUSED_KERNEL_NAME)
    if bias is not None:
        if bias.device != x.device:
            raise ValueError(f"apr_matmul_fused: bias on {bias.device}, "
                             f"operands on {x.device}")
        bias = bias.reshape(n).float().contiguous()
    if x.dtype == torch.float32:
        return _launch_f32(x, y, bias, activation, out_dtype,
                           FUSED_KERNEL_NAME, config, apr_matmul_fused)
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
apr_matmul_fused.f32_launches = 0
