"""``apr_matmul`` and ``apr_matmul_fused`` wrappers: the hand-written CUDA
kernels of ``csrc/apr_matmul.cu`` for CUDA tensors, the plain PyTorch
versions (:mod:`.ref`) for CPU tensors.

There is no padding here: the kernels mask the ragged M/N/K edges
themselves, so the (K, N) weight slice goes to them as it lies in memory.
The weight of :func:`apr_matmul` may be an int8
:class:`~repro_torch.quant.QuantizedTensor`: the CUDA kernel then
dequantizes it in its load stage, and the plain version dequantizes it
first (to ``x.dtype``, as the JAX layers' ``materialize_weight`` does).

Configurations resolve as in the JAX package's ``ops.py``: an explicit
``config`` (and the ``block_m/n/k``, ``splits`` kwargs laid over it) > the
tuned entry of the active :class:`~repro_torch.bench.ConfigCache` for this
(shape, dtype, backend) > the default, under the JAX package's shape keys.
A configuration is a tile and, for the bf16 and fp32 bodies, a split
count: the K range of each column tile cut into ``splits`` ranges
(:func:`~.ref.split_range`) combined over a thread-block cluster
(:data:`SPLITS`; the default from the geometry, :func:`default_splits`).
On the card the configuration must be one the kernel is compiled for, or
the wrapper raises :class:`~repro_torch.bench.TileError` before any
launch: :data:`TILES` for bf16 operands, :data:`F32_TILES` for an fp32
``x`` (with an fp32 or an int8 weight), :data:`INT8W_TILES` (one split)
for an int8 weight under a bf16 ``x``.  The int8-weight operands tune
within the ``apr_matmul`` family under the shape key's ``_wint8`` suffix
(the JAX package has no such kernel, so no JAX key carries it); fp32
operands resolve under the JAX package's keys at dtype ``float32``.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, Optional, Union

import torch

from ...bench.config import (BlockConfig, TileError, dtype_name,
                             pin_config, resolve_cached, resolve_config,
                             shape_key_from_dims)
from ...core.apr import reduction_hbm_traffic
from ...quant import QuantizedTensor
from ...roofline.hw import get_profile
from .. import _build
from .._leaf import graph_leaf
from .ref import (ACTIVATIONS, K_RANGE, matmul_fused_ref, matmul_ref,
                  split_range)

LIBRARY = "apr_matmul"
KERNEL_NAME = "apr_matmul"
FUSED_KERNEL_NAME = "apr_matmul_fused"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "apr_matmul_bf16": (ctypes.c_int, [_P] * 4 + [_I] * 10 + [_P]),
    "apr_matmul_hbm_bf16": (ctypes.c_int, [_P] * 4 + [_I] * 7 + [_P]),
    "apr_matmul_hbm_f32": (ctypes.c_int, [_P] * 4 + [_I] * 6 + [_P]),
    "apr_matmul_int8w": (ctypes.c_int, [_P] * 4 + [_I] * 6 + [_P]),
    "apr_matmul_f32": (ctypes.c_int, [_P] * 4 + [_I] * 9 + [_P]),
    "apr_matmul_f32_int8w": (ctypes.c_int, [_P] * 4 + [_I] * 8 + [_P]),
}
#: (x dtype, weight dtype) pairs each kernel family is compiled for; int8
#: is a :class:`QuantizedTensor`'s codes (with its fp32 scales)
KERNEL_DTYPES = {
    KERNEL_NAME: frozenset({(torch.bfloat16, torch.bfloat16),
                            (torch.bfloat16, torch.int8),
                            (torch.float32, torch.float32),
                            (torch.float32, torch.int8)}),
    FUSED_KERNEL_NAME: frozenset({(torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.float32)}),
}
#: the (block_m, block_n, block_k) tiles ``apr_matmul.cu`` compiles
#: (``APR_MATMUL_TILES``) for the bf16 APR, memory-resident and fused
#: kernels: 4 warps of 16 x 16 WMMA fragments over a ``cp.async`` ring, the
#: decode family (M = a tick's slots or a prefill chunk's 16 rows); the
#: wide family (:data:`WIDE_TILES`) serves larger M
TILES = ((16, 64, 32), (16, 64, 64), (16, 64, 128),
         (32, 64, 32), (32, 64, 64), (32, 64, 128))
#: the untuned tile below :data:`WIDE_MIN_M` rows
DEFAULT_TILE = (16, 64, 64)
#: the wide tiles (``APR_MATMUL_WIDE_TILES``) of the bf16 APR and fused
#: kernels for prefill M: a TMA ring of 128-byte-swizzled (BM x 64) A and
#: (64 x BN) B tiles feeding tensor-core MMAs of 64 rows a warpgroup.  Every
#: one gives the bits of :data:`TILES` at each split count.  TMA needs both
#: operands 16-byte aligned and K and N multiples of 8; the
#: memory-resident baseline and the int8-weight kernel have no wide tiles
WIDE_TILES = ((128, 128, 64), (128, 256, 64))
#: the fewest rows at which :func:`default_config` takes a wide tile
WIDE_MIN_M = 128
#: the (block_m, block_n, block_k) tiles of the int8-weight kernel
#: (``INT8W_TILES`` in ``apr_matmul.cu``); every one gives the same bits
INT8W_TILES = ((16, 16, 128), (16, 32, 64), (16, 64, 64), (16, 32, 128),
               (16, 64, 128))
#: the tiles of the fp32 body (``F32_TILES`` in ``apr_matmul.cu``: up to 16
#: rows x 64 columns a block, 32 or 64 K rows a stage), for fp32 and int8
#: weights under an fp32 ``x``; every one gives the same bits at one split
#: count
F32_TILES = ((16, 64, 32), (16, 64, 64))
#: the fp32 body's untuned tile
F32_DEFAULT_TILE = (16, 64, 64)
#: the split counts of the bf16 and fp32 bodies (one cluster of at most 8
#: blocks per column tile); the memory-resident baseline (on either body)
#: and the int8-weight kernel under a bf16 ``x`` run one split
SPLITS = (1, 2, 4, 8)
#: the SM count :func:`default_splits` assumes, on every card (the
#: ``h100_sxm`` profile's), so the tune spec and the wrapper agree
SMS = get_profile("h100_sxm").sms
#: the blocks :func:`default_splits` aims to run at once, by bytes of a
#: weight element: about one on each SM for bf16 and fp32 weights (more
#: splits measured slower at N = 4096 on an H100: each block's range gets
#: too short for its fixed start and combine), about four for int8 codes,
#: whose ranges stream a quarter of the fp32 bytes (PERF.md §6)
SPLIT_BLOCK_BUDGET = {1: 4 * SMS, 2: SMS, 4: SMS}
RESIDENCIES = ("apr", "hbm")
_STAGES = 4                                   # the bf16 cp.async ring


def shape_key(m: int, k: int, n: int, residency: str = "apr",
              w_int8: bool = False) -> str:
    # residency is part of the key: tiles tuned for the APR kernel never
    # apply to the memory-resident baseline, nor to the int8-weight kernel
    return (shape_key_from_dims(m=m, k=k, n=n) + f"_res{residency}"
            + ("_wint8" if w_int8 else ""))


def default_splits(k: int, n: int, block_n: int, w_bytes: int = 2) -> int:
    """The split count from (K, N) and the weight's bytes an element alone,
    never from M: the largest of :data:`SPLITS` for which the column tiles
    of one row tile x splits stay within :data:`SPLIT_BLOCK_BUDGET` blocks,
    and no more splits than K has 128-row ranges (at least one).  B1's bits
    depend on the split count, so a row gets the same bits at every M: a
    decode tick (M = slots), a prefill chunk and a speculative verify step
    (M = slots x (spec_k + 1)) agree.  At llama3-8b's projections (64-column
    tiles), bf16 or fp32 weights: 8 at N = 1024, 2 at N = 4096, 1 at
    N = 14336 and at the lm_head; int8 codes under an fp32 ``x``: 8 at
    N = 1024 and 4096, 2 at N = 14336."""
    col_tiles = max(1, -(-n // block_n))
    cap = min(max(1, SPLIT_BLOCK_BUDGET[w_bytes] // col_tiles),
              max(1, -(-k // K_RANGE)))
    return max(s for s in SPLITS if s <= cap)


def wide_takes(m: int, k: int, n: int) -> bool:
    """Whether the untuned bf16 configuration at (M, K, N) is wide: at
    least :data:`WIDE_MIN_M` rows, K and N multiples of 8 (TMA's 16-byte
    row strides)."""
    return m >= WIDE_MIN_M and k % 8 == 0 and n % 8 == 0


def default_config(m: int, k: int, n: int,
                   residency: str = "apr") -> BlockConfig:
    """Untuned bf16 configuration: below :data:`WIDE_MIN_M` rows (or at K
    or N not a multiple of 8) the 16 x 64 x 64 tile, one 16x16 WMMA
    fragment per warp (the tile the serving path has run since the port's
    first slice); at prefill M (:func:`wide_takes`) a wide tile
    (:data:`WIDE_TILES`): 128 x 256 x 64 from 256 rows where N is a
    multiple of 256, else 128 x 128 x 64 (the M sweep of ``chip_smoke.py``
    phase 3 on an H100).  All at :func:`default_splits` of the 64-column
    tiles, so M does not enter the split count and a row gets the same
    bits at every M.  The memory-resident baseline (``residency="hbm"``)
    runs the 16 x 64 x 64 tile at one split."""
    if residency == "hbm":
        bm, bn, bk = DEFAULT_TILE
        return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk, splits=1)
    if not wide_takes(m, k, n):
        bm, bn, bk = DEFAULT_TILE
    elif m >= 2 * WIDE_MIN_M and n % 256 == 0:
        bm, bn, bk = 128, 256, 64
    else:
        bm, bn, bk = 128, 128, 64
    return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk,
                            splits=default_splits(k, n, DEFAULT_TILE[1]))


def f32_default_config(m: int, k: int, n: int,
                       w_int8: bool = False) -> BlockConfig:
    """Untuned fp32-body configuration: :data:`F32_DEFAULT_TILE` at
    :func:`default_splits` for fp32 weights, or int8 codes (``w_int8``);
    M does not enter."""
    bm, bn, bk = F32_DEFAULT_TILE
    return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk,
                            splits=default_splits(k, n, bn,
                                                  1 if w_int8 else 4))


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


def wide_smem_bytes(block_m: int, block_n: int, block_k: int = 64) -> int:
    """Shared memory a wide tile takes (``WideTile<...>::SMEM``): 1 KB of
    alignment slack, the 4-stage ring of (block_m x 64) A and (64 x
    block_n) B bf16 tiles, or the fp32 C tile of the flush and the split
    partial (rows padded by 8 floats) if larger, and a full and an empty
    barrier a stage."""
    ring = _STAGES * (block_m + block_n) * block_k * 2
    flush = block_m * (block_n + 8) * 4
    return 1024 + max(ring, flush) + 2 * _STAGES * 8


def f32_smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Shared memory an fp32-body tile takes (``FTile::SMEM`` at 16 rows):
    a ring of [A (16 x block_k) | weight (block_k x block_n)] fp32 stages of
    about 64 KB (3 to 8 stages), or the 8 chains' and the block's partials
    after the K loop if larger."""
    stage = (16 * block_k + block_k * block_n) * 4
    stages = min(8, max(3, 64 * 1024 // stage))
    return max(stages * stage, 9 * 16 * block_n * 4)


def accumulator_traffic_bytes(m: int, n: int, k: int, block_k: int,
                              residency: str, out_bytes: int = 2) -> int:
    """Analytic memory traffic attributable to the accumulator (Table-III
    'memory access' analogue), as the JAX package computes it."""
    n_steps = max(1, (k + block_k - 1) // block_k)
    return reduction_hbm_traffic(m * n, n_steps, out_bytes, residency)


def _tile(cfg: BlockConfig, w_int8: bool = False) -> tuple:
    tile = (cfg["block_m"], cfg["block_n"], cfg["block_k"])
    tiles = INT8W_TILES if w_int8 else TILES + WIDE_TILES
    if tile not in tiles:
        raise TileError(f"apr_matmul: {'int8-weight ' if w_int8 else ''}"
                        f"tile {tile} is not compiled; compiled tiles "
                        f"{tiles}")
    return tile


def _splits(cfg: BlockConfig, allowed=SPLITS) -> int:
    splits = cfg.get("splits", 1)
    if splits not in allowed:
        raise TileError(f"apr_matmul: {splits} splits; this kernel takes "
                        f"{allowed}")
    return splits


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
    return default_config(m, k, n, residency)


def resolve_launch(kernel: str, m: int, k: int, n: int, dtype: str,
                   backend: str, residency: str = "apr",
                   config: Optional[BlockConfig] = None,
                   w_int8: bool = False, aligned: bool = True) -> tuple:
    """``((block_m, block_n, block_k), splits)`` of a launch of ``kernel``
    (``apr_matmul`` or ``apr_matmul_fused``) on bf16 ``x``: the tile
    checked against :data:`TILES` and :data:`WIDE_TILES`
    (:data:`INT8W_TILES` for the int8-weight kernel, ``w_int8``, which
    runs one split), the split count against :data:`SPLITS`.  Without a
    caller's ``config`` the resolution is memoized in the active cache.
    A wide tile on operands TMA cannot take (``aligned`` False: a base not
    16-byte aligned; or K or N not a multiple of 8) gives way to the 16 x
    64 x 64 tile, the same bits, where it came from the default or the
    cache, and raises :class:`~repro_torch.bench.TileError` where the
    caller pinned it; under ``residency="hbm"`` it raises."""
    shape_key_of = _SHAPE_KEYS[kernel]
    dims = (m, k, n, residency, w_int8)
    if config is None:
        cfg = resolve_cached(kernel, dims, dtype, backend,
                             shape_key=shape_key_of, default=_default)
    else:
        cfg = resolve_config(kernel, shape_key_of(*dims), dtype, backend,
                             default=_default(*dims), override=config)
    tile = _tile(cfg, w_int8)
    splits = _splits(cfg, (1,) if w_int8 else SPLITS)
    if tile in WIDE_TILES:
        if residency == "hbm":
            raise TileError(f"{kernel}: the memory-resident baseline runs "
                            f"the tiles {TILES}, not the wide {tile}")
        if not (aligned and k % 8 == 0 and n % 8 == 0):
            if config is not None:
                raise TileError(
                    f"{kernel}: wide tile {tile} pinned on operands TMA "
                    f"cannot take (K={k}, N={n}, 16-byte aligned: "
                    f"{aligned}); it needs K and N multiples of 8 and "
                    f"aligned bases")
            tile = DEFAULT_TILE
    return tile, splits


def resolve_tile(kernel: str, m: int, k: int, n: int, dtype: str,
                 backend: str, residency: str = "apr",
                 config: Optional[BlockConfig] = None,
                 w_int8: bool = False) -> tuple:
    """The ``(block_m, block_n, block_k)`` of :func:`resolve_launch`."""
    return resolve_launch(kernel, m, k, n, dtype, backend, residency, config,
                          w_int8)[0]


def resolve_f32(kernel: str, m: int, k: int, n: int,
                config: Optional[BlockConfig] = None,
                w_int8: bool = False, residency: str = "apr") -> BlockConfig:
    """The fp32 body's configuration for a launch of ``kernel`` (an fp32
    ``x`` over an fp32 weight, or an int8 one with ``w_int8``; the
    memory-resident baseline with ``residency="hbm"``): whatever resolves
    under the family's key at dtype ``float32`` (``_wint8`` for the int8
    weight, ``_reshbm`` for the baseline; default
    :func:`f32_default_config`, one split for the baseline) must be one of
    :data:`F32_TILES` at one of :data:`SPLITS`, or
    :class:`~repro_torch.bench.TileError` is raised."""
    shape_key_of = _SHAPE_KEYS[kernel]
    dims = (m, k, n, residency, w_int8)

    def default(m, k, n, res, q):
        cfg = f32_default_config(m, k, n, q)
        return cfg.replace(splits=1) if res == "hbm" else cfg
    if config is None:
        cfg = resolve_cached(kernel, dims, "float32", "cuda",
                             shape_key=shape_key_of, default=default)
    else:
        cfg = resolve_config(kernel, shape_key_of(*dims), "float32", "cuda",
                             default=default(*dims), override=config)
    tile = (cfg["block_m"], cfg["block_n"], cfg["block_k"])
    if tile not in F32_TILES:
        raise TileError(f"{kernel}: fp32 tile {tile} is not compiled; "
                        f"compiled tiles {F32_TILES}")
    _splits(cfg)
    return cfg


def _launch_f32(x: torch.Tensor, w: torch.Tensor,
                scale: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], activation: str,
                out_dtype: torch.dtype, kernel: str,
                config: Optional[BlockConfig],
                residency: str = "apr",
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``activation(x @ w + bias)`` on an fp32 ``x`` by the fp32 body for
    family ``kernel``: ``apr_matmul_f32`` over an fp32 weight,
    ``apr_matmul_f32_int8w`` over int8 codes with their fp32 (1, N)
    ``scale`` (no bias, no activation), or with ``residency="hbm"``
    ``apr_matmul_hbm_f32`` (fp32 weight, no bias, no activation); the
    configuration from :func:`resolve_f32`; ``bias`` fp32 (N,) or None;
    written into ``out`` when given (checked by :func:`_out`)."""
    (m, k), n = x.shape, w.shape[1]
    cfg = resolve_f32(kernel, m, k, n, config, scale is not None, residency)
    splits = cfg["splits"]
    if residency == "hbm" and splits != 1:
        raise ValueError(f"apr_matmul: the memory-resident baseline runs one "
                         f"split, not {splits}")
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if residency == "hbm":
        err = lib.apr_matmul_hbm_f32(
            x.data_ptr(), w.data_ptr(), _partial(out).data_ptr(),
            out.data_ptr(), m, n, k, cfg["block_n"], cfg["block_k"],
            int(out_dtype == torch.float32), stream)
        _build.check(lib, err, "apr_matmul (residency='hbm')")
        return out
    geometry = (m, n, k, cfg["block_n"], cfg["block_k"], splits,
                split_range(k, splits), int(out_dtype == torch.float32))
    if scale is None:
        err = lib.apr_matmul_f32(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            *geometry, ACTIVATIONS[activation], stream)
    else:
        err = lib.apr_matmul_f32_int8w(x.data_ptr(), w.data_ptr(),
                                       scale.data_ptr(), out.data_ptr(),
                                       *geometry, stream)
    _build.check(lib, err, kernel)
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


def _out(out: Optional[torch.Tensor], x: torch.Tensor, n: int,
         out_dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless ``out`` (when given) is a contiguous
    ``(M, N)`` tensor of ``out_dtype`` on ``x``'s device."""
    if out is not None and not (
            out.shape == (x.shape[0], n) and out.dtype == out_dtype
            and out.device == x.device and out.is_contiguous()):
        raise ValueError(
            f"apr_matmul: out {out.dtype} {tuple(out.shape)} on {out.device}"
            f" for a contiguous {out_dtype} ({x.shape[0]}, {n}) on "
            f"{x.device}")


def _aligned(x: torch.Tensor, w: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> bool:
    """Both bases 16-byte aligned, as TMA needs them (a wide tile), and a
    caller's ``out`` too (the wide flush stores 4 outputs at once)."""
    return all(t.data_ptr() % 16 == 0 for t in (x, w, out) if t is not None)


def _count(counts: dict, key) -> None:
    counts[key] = counts.get(key, 0) + 1


def _partial(out: torch.Tensor) -> torch.Tensor:
    """The memory-resident baseline's fp32 partial: ``out`` itself when it
    is fp32, else scratch of its shape."""
    if out.dtype == torch.float32:
        return out
    return torch.empty(out.shape, dtype=torch.float32, device=out.device)


@graph_leaf
def apr_matmul(x: torch.Tensor, y: Union[torch.Tensor, QuantizedTensor], *,
               block_m: Optional[int] = None, block_n: Optional[int] = None,
               block_k: Optional[int] = None, splits: Optional[int] = None,
               out_dtype: torch.dtype = torch.float32,
               residency: str = "apr",
               config: Optional[BlockConfig] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (M, K) @ y (K, N)`` with an fp32 accumulator, rounded once to
    ``out_dtype``, into ``out`` when given (a contiguous ``(M, N)`` tensor
    of ``out_dtype``, a slice of a larger one, say; bf16 or fp32 weights
    on the APR bodies only) and else into a new tensor.

    ``residency="apr"`` keeps the accumulators in registers across each
    split's K range and combines the splits on chip (one launch); ``"hbm"``
    is the paper's baseline, whose fp32 partial goes through global memory
    on every K tile (one launch, one split; bf16 operands, equal to the APR
    kernel at one split and the same tile bit for bit, or fp32 operands on
    the fp32 body; an int8 weight is refused, as the JAX kernel takes
    none).  ``y`` is a bf16 tensor or an int8 :class:`QuantizedTensor`
    with (1, N) fp32 scales under a bf16 ``x`` (the int8-weight kernel, one
    split, equal to the bf16 kernel at one split on the dequantized weight
    bit for bit), or an fp32 tensor or an int8 :class:`QuantizedTensor`
    under an fp32 ``x`` (the fp32 body; over the int8 weight it equals the
    fp32 body on ``y.dequantize(torch.float32)`` bit for bit)
    (:data:`KERNEL_DTYPES`).
    ``block_m``, ``block_n``, ``block_k`` and ``splits`` pin the
    configuration over ``config``, as the JAX wrapper's kwargs do; a pinned
    split count above one with ``residency="hbm"`` raises.  CUDA tensors
    launch the kernel (``out_dtype`` bf16 or fp32) or raise; CPU tensors
    take :func:`matmul_ref`.  Each launch adds one to
    ``apr_matmul.launches`` (and to ``apr_matmul.tile_launches[tile]``,
    ``apr_matmul.split_launches[splits]`` and, on a wide tile,
    ``apr_matmul.wide_launches``), ``apr_matmul.hbm_launches``
    (the baseline on bf16 operands; ``apr_matmul.hbm_f32_launches`` on
    fp32 ones), ``apr_matmul.int8_launches`` (int8 weight, bf16 ``x``; and
    ``apr_matmul.int8_tile_launches[tile]``), ``apr_matmul.f32_launches``
    (fp32 operands) or ``apr_matmul.f32_int8_launches`` (fp32 ``x``, int8
    weight): one per call."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency {residency!r}")
    if residency == "hbm" and splits not in (None, 1):
        raise ValueError("apr_matmul: the memory-resident baseline runs one "
                         f"split, not {splits}")
    config = pin_config(config, block_m=block_m, block_n=block_n,
                        block_k=block_k, splits=splits)
    quantized = isinstance(y, QuantizedTensor)
    w = y.q if quantized else y
    _out(out, x, w.shape[-1], out_dtype)
    if out is not None and (quantized or residency == "hbm"):
        raise ValueError("apr_matmul: out= is taken by the APR bodies on "
                         "bf16 or fp32 weights only")
    if x.device.type == "cpu" and w.device.type == "cpu":
        if quantized:
            w = y.dequantize(x.dtype)
        if out is not None:
            return out.copy_(matmul_ref(x, w, out_dtype))
        return matmul_ref(x, w, out_dtype)
    _check(x, w, out_dtype, KERNEL_NAME)
    if residency == "hbm" and quantized:
        raise ValueError("apr_matmul: the memory-resident baseline takes "
                         "bf16 or fp32 operands, not an int8 weight")
    m, k = x.shape
    n = w.shape[1]
    if quantized and (y.scale.shape != (1, n)
                      or y.scale.dtype != torch.float32
                      or y.scale.device != w.device
                      or not y.scale.is_contiguous()):
        raise ValueError(f"apr_matmul: int8 weight {tuple(w.shape)} needs "
                         f"contiguous fp32 (1, {n}) scales on {w.device}, "
                         f"got {y.scale.dtype} {tuple(y.scale.shape)}")
    if x.dtype == torch.float32:
        out = _launch_f32(x, w, y.scale if quantized else None, None, "none",
                          out_dtype, KERNEL_NAME, config, residency, out)
        if residency == "hbm":
            apr_matmul.hbm_f32_launches += 1
        elif quantized:
            apr_matmul.f32_int8_launches += 1
        else:
            apr_matmul.f32_launches += 1
        return out
    tile, n_splits = resolve_launch(KERNEL_NAME, m, k, n,
                                    dtype_name(x.dtype), "cuda", residency,
                                    config, quantized, _aligned(x, w, out))
    if residency == "hbm" and n_splits != 1:
        raise ValueError(f"apr_matmul: the memory-resident baseline runs one "
                         f"split, not {n_splits}")
    bm, bn, bk = tile
    if out is None:
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
        _count(apr_matmul.int8_tile_launches, tile)
        return out
    if residency == "hbm":
        err = lib.apr_matmul_hbm_bf16(x.data_ptr(), w.data_ptr(),
                                      _partial(out).data_ptr(),
                                      out.data_ptr(), m, n, k, bm, bn, bk,
                                      out_f32, stream)
        _build.check(lib, err, "apr_matmul (residency='hbm')")
        apr_matmul.hbm_launches += 1
        return out
    err = lib.apr_matmul_bf16(x.data_ptr(), w.data_ptr(), None,
                              out.data_ptr(), m, n, k, bm, bn, bk, n_splits,
                              split_range(k, n_splits), out_f32,
                              ACTIVATIONS["none"], stream)
    _build.check(lib, err, "apr_matmul")
    apr_matmul.launches += 1
    apr_matmul.wide_launches += tile in WIDE_TILES
    _count(apr_matmul.tile_launches, tile)
    _count(apr_matmul.split_launches, n_splits)
    return out


apr_matmul.launches = 0
apr_matmul.wide_launches = 0
apr_matmul.hbm_launches = 0
apr_matmul.hbm_f32_launches = 0
apr_matmul.int8_launches = 0
apr_matmul.f32_launches = 0
apr_matmul.f32_int8_launches = 0
apr_matmul.tile_launches = {}
apr_matmul.split_launches = {}
apr_matmul.int8_tile_launches = {}


class ProductTape:
    """The outputs of one checkpointed block's training products (each
    :class:`AprMatmulFunction`), for the ``"dots"`` remat policy, the port
    of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: every
    product without a batch dimension is kept, the rest of the block is
    recomputed in the backward.

    :meth:`contexts` is ``torch.utils.checkpoint``'s ``context_fn``.  The
    block's forward runs under the first context: each product launches and
    its output is kept (``None`` for a product under :func:`not_residual`).
    The backward's recompute runs under the second: each product returns
    its kept output, in call order, and launches nothing.  The kernel's
    bits depend on the shape alone, so a kept output equals its recompute.
    The MoE experts' products run inside ``ExpertMatmulFunction`` (grad
    mode off, no ``AprMatmulFunction``) and never reach the tape: they are
    recomputed, as JAX recomputes its batched ``"ecd,edf->ecf"``."""

    def __init__(self):
        self.outputs: List[Optional[torch.Tensor]] = []
        self._replay: Optional[int] = None   # next output, while replaying
        self._residual = True

    def contexts(self):
        return _Taping(self, False), _Taping(self, True)

    def product(self, x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
        if self._replay is None:
            y = apr_matmul(x, w, out_dtype=out_dtype)
            self.outputs.append(y.detach() if self._residual else None)
            return y
        y = self.outputs[self._replay]
        self._replay += 1
        if y is None:   # the backward never reads it
            return torch.empty((x.shape[0], w.shape[1]), dtype=out_dtype,
                               device=x.device)
        return y.detach()


#: the tape of the block being run under the "dots" policy, if any
_TAPE: Optional[ProductTape] = None


class _Taping:
    """``tape`` made the active one, recording or replaying from its first
    output: a context that can be entered again (a second backward through
    a retained graph recomputes again)."""

    def __init__(self, tape: ProductTape, replay: bool):
        self.tape, self.replay = tape, replay

    def __enter__(self):
        global _TAPE
        self._outer, _TAPE = _TAPE, self.tape
        self.tape._replay = 0 if self.replay else None

    def __exit__(self, *exc):
        global _TAPE
        _TAPE, self.tape._replay = self._outer, None


@contextlib.contextmanager
def not_residual(on: bool = True):
    """With ``on``, the products run inside are no residuals of the block
    being taped: the backward never reads their outputs (a block's closing
    projection, only added into the block's output), so the tape neither
    keeps them nor recomputes them, as JAX's remat drops them.  Without a
    tape it does nothing."""
    tape = _TAPE
    if not on or tape is None:
        yield
        return
    outer, tape._residual = tape._residual, False
    try:
        yield
    finally:
        tape._residual = outer


class AprMatmulFunction(torch.autograd.Function):
    """:func:`apr_matmul` under autograd, for training: the forward is
    ``apr_matmul(x, w, out_dtype=out_dtype)``, and both products of the
    backward go through :func:`apr_matmul` too, each only when
    ``needs_input_grad`` asks for it::

        dX = apr_matmul(dY, Wᵀ, out_dtype=x.dtype)
        dW = apr_matmul(Xᵀ, dY, out_dtype=w.dtype)

    The kernels take contiguous row-major operands, so ``Wᵀ`` and ``Xᵀ``
    are explicit copies.  CUDA tensors launch the kernels (bf16 or fp32
    bodies, as the forward's dtypes pick them) or raise; CPU tensors run
    the same three products through :func:`matmul_ref`.  Only plain
    tensors: an int8 weight has no gradient (:func:`apr_matmul_grad`
    refuses one).  Inside a block taped for the ``"dots"`` remat policy
    the forward goes through :meth:`ProductTape.product`."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        if _TAPE is None:
            return apr_matmul(x, w, out_dtype=out_dtype)
        return _TAPE.product(x, w, out_dtype)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = apr_matmul(dy, w.t().contiguous(), out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dw = apr_matmul(x.t().contiguous(), dy, out_dtype=w.dtype)
        return dx, dw, None


def needs_grad(x: torch.Tensor, y: Union[torch.Tensor, QuantizedTensor]
               ) -> bool:
    """Whether ``x @ y`` must be differentiable: grad mode on and an
    operand that requires grad (an int8 weight's scales count)."""
    w = y.scale if isinstance(y, QuantizedTensor) else y
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


def apr_matmul_grad(x: torch.Tensor, y: Union[torch.Tensor, QuantizedTensor],
                    out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ y`` rounded to ``out_dtype`` through
    :class:`AprMatmulFunction`, for a product :func:`needs_grad` marks.
    Raises ``TypeError`` for an int8 :class:`QuantizedTensor` weight: the
    port trains bf16 and fp32 parameters only, as the JAX package does."""
    if isinstance(y, QuantizedTensor):
        raise TypeError("apr_matmul: an int8 QuantizedTensor weight has no "
                        "gradient; train bf16 or fp32 parameters")
    return AprMatmulFunction.apply(x, y, out_dtype)


def apr_matmul_fused(x: torch.Tensor, y: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     block_m: Optional[int] = None,
                     block_n: Optional[int] = None,
                     block_k: Optional[int] = None,
                     splits: Optional[int] = None,
                     activation: str = "relu",
                     out_dtype: torch.dtype = torch.float32,
                     config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``activation(x @ y + bias)`` in one kernel: bias (``None``, ``(N,)``
    or ``(1, N)``, used in fp32) and the activation are applied to the fp32
    accumulator at its one flush, after the split partials are combined,
    before the single write.  Tuned under its own family name;
    ``block_m``/``block_n``/``block_k``/``splits`` pin the configuration.
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
                        block_k=block_k, splits=splits)
    if all(t.device.type == "cpu" for t in tensors):
        return matmul_fused_ref(x, y, bias, activation, out_dtype)
    _check(x, y, out_dtype, FUSED_KERNEL_NAME)
    if bias is not None:
        if bias.device != x.device:
            raise ValueError(f"apr_matmul_fused: bias on {bias.device}, "
                             f"operands on {x.device}")
        bias = bias.reshape(n).float().contiguous()
    if x.dtype == torch.float32:
        out = _launch_f32(x, y, None, bias, activation, out_dtype,
                          FUSED_KERNEL_NAME, config)
        apr_matmul_fused.f32_launches += 1
        return out
    m, k = x.shape
    (bm, bn, bk), n_splits = resolve_launch(
        FUSED_KERNEL_NAME, m, k, n, dtype_name(x.dtype), "cuda", "apr",
        config, aligned=_aligned(x, y))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.apr_matmul_bf16(x.data_ptr(), y.data_ptr(),
                              None if bias is None else bias.data_ptr(),
                              out.data_ptr(), m, n, k, bm, bn, bk, n_splits,
                              split_range(k, n_splits),
                              int(out_dtype == torch.float32),
                              ACTIVATIONS[activation], stream)
    _build.check(lib, err, "apr_matmul_fused")
    apr_matmul_fused.launches += 1
    return out


apr_matmul_fused.launches = 0
apr_matmul_fused.f32_launches = 0
