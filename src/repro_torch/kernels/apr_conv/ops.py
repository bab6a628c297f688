"""``apr_conv2d`` and ``apr_conv2d_fused`` wrappers: the hand-written CUDA
kernels of ``csrc/apr_conv.cu`` for CUDA tensors, the plain PyTorch versions
(:mod:`.ref`) for CPU tensors.

The signatures are the JAX package's (``repro.kernels.apr_conv.ops``),
``block_m``, ``block_n``, ``block_k`` and ``config`` included.  Whatever
resolves under the JAX package's shape keys (the pinned ``block_*`` kwargs
laid over ``config``, as the JAX wrappers lay them) must be a tile the
kernel is compiled for (:func:`compiled_configs`), or
:class:`~repro_torch.bench.TileError` is raised before any launch: one of
the APR kernel's :data:`TILES` (every one gives the same bits) for
``residency="apr"`` and the fused kernel, the first design's tile for
``residency="hbm"``.  Inputs are fp32 or bf16 (``x`` and ``f`` of one
type); the output is fp32 either way, as the JAX kernel writes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...bench.config import (BlockConfig, dtype_name, pin_config,
                             resolve_among, shape_key_from_dims)
from .. import _build
from .._leaf import graph_leaf
from ..apr_matmul.ref import ACTIVATIONS
from .ref import conv2d_fused_ref, conv2d_ref

LIBRARY = "apr_conv"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "apr_conv": (ctypes.c_int, [_P, _P, _P, _P] + [_I] * 11 + [_P]),
    "apr_conv_tile": (ctypes.c_int, [_P, _P, _P, _P] + [_I] * 12 + [_P]),
    "apr_conv_hbm": (ctypes.c_int, [_P, _P, _P] + [_I] * 10 + [_P]),
    "apr_conv_blocks_per_sm": (ctypes.c_int, [_P, _P] + [_I] * 11 + [_P]),
}
#: the K step of the memory-resident baseline (``BK`` in the source): its
#: partial goes through global memory once per step
K_STEP = 32
RESIDENCIES = ("apr", "hbm")
KERNEL_NAME = "apr_conv"
FUSED_KERNEL_NAME = "apr_conv_fused"
_THREADS = 256                     # the baseline's threads, 4 x 4 outputs each

#: the APR kernel's compiled tiles, ``APR_CONV_TILES`` of the source in its
#: order: (channels BN, channels a thread TN, pixels a thread TP, threads,
#: the largest M the tile is the default for)
TILES = ((16, 8, 4, 128, 16), (32, 8, 4, 128, 32), (64, 8, 4, 128, 1 << 30))
#: channels of one tap a step of the APR kernel walks at most
#: (``STEP_CHANNELS``): a step's filter slice is this many rows of K
STEP_CHANNELS = 64
#: the filter slots of the APR kernel's ring (``RING``): a step's and the
#: next two steps'
RING = 3
#: a filter slice of at most this many bytes is staged whole, once, for
#: every step (``WHOLE_BYTES``)
WHOLE_BYTES = 16384
#: shared memory a block can have (``SMEM_MAX``)
SMEM_MAX = 232448


def tile_pixels(tile) -> int:
    """Output pixels a block of ``tile`` owns at most (``ConvTile::BP``)."""
    bn, tn, tp, threads, _ = tile
    return threads // (bn // tn) * tp


def tile_config(tile) -> BlockConfig:
    """``tile`` as the implicit GEMM's (block_m, block_n, block_k): pixels,
    channels and the K rows a step stages."""
    return BlockConfig.make(block_m=tile_pixels(tile), block_n=tile[0],
                            block_k=STEP_CHANNELS)


#: the APR kernel's tiles as configurations, in :data:`TILES` order
APR_CONFIGS = tuple(tile_config(t) for t in TILES)


def hbm_config(m: int) -> BlockConfig:
    """The baseline's tile for ``m`` output channels: BN = 16, 32 or 64
    channels from ``m``, 4096 / BN pixels, K steps of 32."""
    bn = 16 if m <= 16 else 32 if m <= 32 else 64
    return BlockConfig.make(block_m=_THREADS * 16 // bn, block_n=bn,
                            block_k=K_STEP)


def compiled_configs(m: int, residency: str = "apr") -> frozenset:
    """The tiles the kernel of ``residency`` runs for ``m`` output channels:
    every APR tile (any tile takes any geometry), or the baseline's one."""
    if residency == "hbm":
        return frozenset({hbm_config(m)})
    return frozenset(APR_CONFIGS)


def default_tile(m: int) -> int:
    """The index of the APR kernel's default tile for ``m`` output channels:
    the first whose M bound covers ``m`` (``default_tile`` in the source,
    which ``apr_conv`` without a tile runs)."""
    return next(i for i, t in enumerate(TILES) if m <= t[4])


def default_config(b, h, w, c, hf, wf, m, stride, padding,
                   residency: str = "apr") -> BlockConfig:
    if residency == "hbm":
        return hbm_config(m)
    return APR_CONFIGS[default_tile(m)]


def odd_groups(c: int) -> int:
    """An odd number of 4-element groups covering ``c`` elements."""
    n = (c + 3) // 4
    return 4 * (n if n % 2 else n + 1)


def plan(b, h, w, c, hf, wf, m, stride, padding, tile, itemsize: int = 4,
         aligned: bool = True) -> dict:
    """What a launch of the APR kernel on ``tile`` stages (``make_plan`` in
    the source): a block's output tile of ``ti`` images x ``th`` rows x
    ``tw`` columns (``tiles`` blocks a channel slice), ``ring`` filter
    slots (:data:`RING`, or every step's where the whole filter slice is at
    most :data:`WHOLE_BYTES`), ``resident`` (the tile's halo of ``hrows`` x
    ``hcols`` pixels an image with every channel, staged once; else, where
    it does not fit or the stride passes the filter, the tile's pixels
    shifted by each step's tap are restaged), the staged pixel stride
    ``cs``, the channels walked ``c4`` in steps of ``fc`` (``nch`` a tap),
    the 4-element copies of x and f, and ``smem`` bytes.  ``aligned``: x
    and f start on 4-element boundaries."""
    bn, bp = tile[0], tile_pixels(tile)
    ho = (h + 2 * padding - hf) // stride + 1
    wo = (w + 2 * padding - wf) // stride + 1
    tw = min(wo, bp)
    th = min(ho, bp // tw)
    ti = min(b, bp // (tw * th))
    c4 = -(-c // 4) * 4
    fc = min(c4, STEP_CHANNELS)
    steps = hf * wf * -(-c4 // fc)
    p = dict(ti=ti, th=th, tw=tw, ho=ho, wo=wo, slices=-(-m // bn),
             tiles=-(-wo // tw) * -(-ho // th) * -(-b // ti), c4=c4,
             vec_x=c % 4 == 0 and aligned, vec_f=m % 4 == 0 and aligned,
             resident=True, hrows=(th - 1) * stride + hf,
             hcols=(tw - 1) * stride + wf, cs=odd_groups(c4),
             ring=steps if steps * fc * bn * itemsize <= WHOLE_BYTES
             else RING)
    smem = (p["ring"] * fc * bn + ti * p["hrows"] * p["hcols"] * p["cs"]) \
        * itemsize
    if smem > SMEM_MAX or stride > hf or stride > wf:
        p["resident"], p["ring"] = False, RING
        while True:
            p["cs"] = odd_groups(fc)
            smem = (RING * fc * bn + ti * th * tw * p["cs"]) * itemsize
            if smem <= SMEM_MAX or fc == 4:
                break
            fc -= 4
    p.update(fc=fc, nch=-(-c4 // fc), smem=smem)
    return p


def shape_key(b, h, w, c, hf, wf, m, stride, padding,
              residency: str = "apr") -> str:
    # residency is part of the key, as in the JAX package
    return shape_key_from_dims(b=b, h=h, w=w, c=c, hf=hf, wf=wf, m=m,
                               s=stride, p=padding) + f"_res{residency}"


def fused_shape_key(b, h, w, c, hf, wf, m, stride, padding) -> str:
    return shape_key_from_dims(b=b, h=h, w=w, c=c, hf=hf, wf=wf, m=m,
                               s=stride, p=padding)


def resolve_launch(kernel: str, x: torch.Tensor, f: torch.Tensor,
                   stride: int, padding: int, residency: Optional[str],
                   config: Optional[BlockConfig]) -> BlockConfig:
    """The configuration of a launch of ``kernel`` (``apr_conv``, or
    ``apr_conv_fused`` with ``residency`` None: its key has none, and it
    runs the APR kernel), resolved under the JAX key; anything but a tile
    the kernel is compiled for raises :class:`~repro_torch.bench.TileError`."""
    dims = (*x.shape, *f.shape[:2], f.shape[3], stride, padding)
    key = fused_shape_key
    if residency is not None:
        dims, key = dims + (residency,), shape_key
    return resolve_among(kernel, dims, dtype_name(x.dtype), "cuda",
                         shape_key=key, default=default_config,
                         compiled=compiled_configs(f.shape[3],
                                                   residency or "apr"),
                         config=config)


def _check(x: torch.Tensor, f: torch.Tensor, what: str) -> None:
    if not (x.is_cuda and f.is_cuda and x.device == f.device):
        raise ValueError(f"{what}: operands on {x.device} and {f.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or f.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes fp32 or bf16 operands of one "
                        f"type, got {x.dtype} and {f.dtype}")
    if x.dim() != 4 or f.dim() != 4 or x.shape[3] != f.shape[2]:
        raise ValueError(f"{what}: x {tuple(x.shape)} (B, H, W, C) and "
                         f"f {tuple(f.shape)} (Hf, Wf, C, M) do not match")
    if not (x.is_contiguous() and f.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous NHWC / HWIO "
                         f"operands")


def _geometry(x: torch.Tensor, f: torch.Tensor, stride: int,
              padding: int) -> tuple:
    """``(ints for the C call, output shape)``."""
    b, h, w, c = x.shape
    hf, wf, _, m = f.shape
    ho = (h + 2 * padding - hf) // stride + 1
    wo = (w + 2 * padding - wf) // stride + 1
    if stride < 1 or padding < 0 or ho < 1 or wo < 1:
        raise ValueError(f"apr_conv2d: no output for x {tuple(x.shape)}, "
                         f"f {tuple(f.shape)}, stride {stride}, padding "
                         f"{padding}")
    args = (b, h, w, c, hf, wf, m, stride, padding,
            int(x.dtype == torch.bfloat16))
    return args, (b, ho, wo, m)


@graph_leaf
def apr_conv2d(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
               padding: int = 0, block_m: Optional[int] = None,
               block_n: Optional[int] = None, block_k: Optional[int] = None,
               residency: str = "apr",
               config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``x (B, H, W, C) ⊛ f (Hf, Wf, C, M) -> (B, Ho, Wo, M)`` fp32.

    ``residency="apr"`` keeps the accumulator in registers across the whole
    reduction (one launch of the APR kernel, ``apr_conv_tile`` on the
    resolved tile); ``"hbm"`` is the paper's
    baseline, whose fp32 partial goes through global memory on every K step
    of :data:`K_STEP` rows (one launch of ``apr_conv_hbm``, its blocks
    walking the steps).  CUDA tensors launch the kernel or raise; CPU
    tensors take :func:`conv2d_ref`.  Each launch adds one to
    ``apr_conv2d.launches`` (the APR kernel) or ``apr_conv2d.hbm_launches``
    (``apr_conv_hbm``): one per call either way.  ``block_m``,
    ``block_n`` and ``block_k`` pin the configuration over ``config``."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency {residency!r}")
    if x.device.type == "cpu" and f.device.type == "cpu":
        return conv2d_ref(x, f, stride=stride, padding=padding)
    _check(x, f, "apr_conv2d")
    args, shape = _geometry(x, f, stride, padding)
    cfg = resolve_launch(KERNEL_NAME, x, f, stride, padding, residency,
                         pin_config(config, block_m=block_m, block_n=block_n,
                                    block_k=block_k))
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if residency == "apr":
        err = lib.apr_conv_tile(x.data_ptr(), f.data_ptr(), None,
                                out.data_ptr(), *args, ACTIVATIONS["none"],
                                APR_CONFIGS.index(cfg), stream)
        _build.check(lib, err, "apr_conv")
        apr_conv2d.launches += 1
        return out
    err = lib.apr_conv_hbm(x.data_ptr(), f.data_ptr(), out.data_ptr(), *args,
                           stream)
    _build.check(lib, err, "apr_conv_hbm")
    apr_conv2d.hbm_launches += 1
    return out


def apr_conv2d_fused(x: torch.Tensor, f: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     activation: str = "relu", stride: int = 1,
                     padding: int = 0, block_m: Optional[int] = None,
                     block_n: Optional[int] = None,
                     block_k: Optional[int] = None,
                     config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``activation(conv2d(x, f) + bias)`` with the epilogue applied at the
    accumulator's one flush; ``bias`` is ``None``, ``(M,)`` or ``(1, M)``
    and is used in fp32.  CUDA tensors launch the APR kernel
    (``apr_conv_tile``) or raise; CPU tensors take
    :func:`conv2d_fused_ref`.  ``block_*`` pin the configuration as in
    :func:`apr_conv2d`.  Each launch adds one to
    ``apr_conv2d_fused.launches``."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    m = f.shape[-1]
    if bias is not None and bias.numel() != m:
        raise ValueError(f"apr_conv2d_fused: bias {tuple(bias.shape)} for "
                         f"{m} output channels")
    tensors = (x, f) if bias is None else (x, f, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return conv2d_fused_ref(x, f, bias, activation, stride=stride,
                                padding=padding)
    _check(x, f, "apr_conv2d_fused")
    if bias is not None:
        if bias.device != x.device:
            raise ValueError(f"apr_conv2d_fused: bias on {bias.device}, "
                             f"operands on {x.device}")
        bias = bias.reshape(m).float().contiguous()
    args, shape = _geometry(x, f, stride, padding)
    cfg = resolve_launch(FUSED_KERNEL_NAME, x, f, stride, padding, None,
                         pin_config(config, block_m=block_m, block_n=block_n,
                                    block_k=block_k))
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.apr_conv_tile(x.data_ptr(), f.data_ptr(),
                            None if bias is None else bias.data_ptr(),
                            out.data_ptr(), *args, ACTIVATIONS[activation],
                            APR_CONFIGS.index(cfg), stream)
    _build.check(lib, err, "apr_conv")
    apr_conv2d_fused.launches += 1
    return out


def blocks_per_sm(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
                  padding: int = 0,
                  config: Optional[BlockConfig] = None) -> int:
    """How many blocks of the APR kernel's tile for this call (``config``,
    else the default) an SM of the card holds at once; launches nothing."""
    _check(x, f, "blocks_per_sm")
    args, _ = _geometry(x, f, stride, padding)
    cfg = resolve_launch(KERNEL_NAME, x, f, stride, padding, "apr", config)
    lib = _build.load(LIBRARY, SIGNATURES)
    n = ctypes.c_int(0)
    err = lib.apr_conv_blocks_per_sm(x.data_ptr(), f.data_ptr(), *args,
                                     APR_CONFIGS.index(cfg), ctypes.byref(n))
    _build.check(lib, err, "apr_conv_blocks_per_sm")
    return n.value


apr_conv2d.launches = 0
apr_conv2d.hbm_launches = 0
apr_conv2d_fused.launches = 0
