"""``apr_conv2d`` and ``apr_conv2d_fused`` wrappers: the hand-written CUDA
kernels of ``csrc/apr_conv.cu`` for CUDA tensors, the plain PyTorch versions
(:mod:`.ref`) for CPU tensors.

The signatures are the JAX package's (``repro.kernels.apr_conv.ops``),
``block_m``, ``block_n``, ``block_k`` and ``config`` included: the kernel
has one tile per output-channel count (:func:`compiled_config`), so each
family's tune space has one point, and whatever resolves under the JAX
package's shape keys (the pinned ``block_*`` kwargs laid over ``config``,
as the JAX wrappers lay them) must be that tile, or
:class:`~repro_torch.bench.TileError` is raised before any launch.  Inputs
are fp32 or bf16 (``x`` and ``f`` of one type); the output is fp32 either
way, as the JAX kernel writes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...bench.config import (BlockConfig, dtype_name, pin_config,
                             resolve_among, shape_key_from_dims)
from .. import _build
from ..apr_matmul.ref import ACTIVATIONS
from .ref import conv2d_fused_ref, conv2d_ref

LIBRARY = "apr_conv"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "apr_conv": (ctypes.c_int, [_P, _P, _P, _P] + [_I] * 11 + [_P]),
    "apr_conv_hbm": (ctypes.c_int, [_P, _P, _P] + [_I] * 10 + [_P]),
}
#: the K step of both kernels (``BK`` in the source): the memory-resident
#: baseline's partial goes through global memory once per step
K_STEP = 32
RESIDENCIES = ("apr", "hbm")
KERNEL_NAME = "apr_conv"
FUSED_KERNEL_NAME = "apr_conv_fused"
_THREADS = 256                     # threads per block, 4 x 4 outputs each


def compiled_config(m: int) -> BlockConfig:
    """The tile the kernel runs for ``m`` output channels, as the implicit
    GEMM's (block_m, block_n, block_k): BN = 16, 32 or 64 channels from
    ``m``, 4096 / BN pixels, K steps of 32."""
    bn = 16 if m <= 16 else 32 if m <= 32 else 64
    return BlockConfig.make(block_m=_THREADS * 16 // bn, block_n=bn,
                            block_k=K_STEP)


def shape_key(b, h, w, c, hf, wf, m, stride, padding,
              residency: str = "apr") -> str:
    # residency is part of the key, as in the JAX package
    return shape_key_from_dims(b=b, h=h, w=w, c=c, hf=hf, wf=wf, m=m,
                               s=stride, p=padding) + f"_res{residency}"


def fused_shape_key(b, h, w, c, hf, wf, m, stride, padding) -> str:
    return shape_key_from_dims(b=b, h=h, w=w, c=c, hf=hf, wf=wf, m=m,
                               s=stride, p=padding)


def default_config(b, h, w, c, hf, wf, m, stride, padding) -> BlockConfig:
    return compiled_config(m)


def resolve_launch(kernel: str, x: torch.Tensor, f: torch.Tensor,
                   stride: int, padding: int, residency: Optional[str],
                   config: Optional[BlockConfig]) -> BlockConfig:
    """The configuration of a launch of ``kernel`` (``apr_conv``, or
    ``apr_conv_fused`` with ``residency`` None: its key has none), resolved
    under the JAX key; anything but the compiled tile raises
    :class:`~repro_torch.bench.TileError`."""
    dims = (*x.shape, *f.shape[:2], f.shape[3], stride, padding)
    key = fused_shape_key
    if residency is not None:
        dims, key = dims + (residency,), shape_key
    cfg = compiled_config(f.shape[3])
    return resolve_among(kernel, dims, dtype_name(x.dtype), "cuda",
                         shape_key=key, default=lambda *_: cfg,
                         compiled={cfg}, config=config)


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


def apr_conv2d(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
               padding: int = 0, block_m: Optional[int] = None,
               block_n: Optional[int] = None, block_k: Optional[int] = None,
               residency: str = "apr",
               config: Optional[BlockConfig] = None) -> torch.Tensor:
    """``x (B, H, W, C) ⊛ f (Hf, Wf, C, M) -> (B, Ho, Wo, M)`` fp32.

    ``residency="apr"`` keeps the accumulator in registers across the whole
    reduction (one launch of ``apr_conv``); ``"hbm"`` is the paper's
    baseline, whose fp32 partial goes through global memory on every K step
    of :data:`K_STEP` rows (one launch of ``apr_conv_hbm``, its blocks
    walking the steps).  CUDA tensors launch the kernel or raise; CPU
    tensors take :func:`conv2d_ref`.  Each launch adds one to
    ``apr_conv2d.launches`` (``apr_conv``) or ``apr_conv2d.hbm_launches``
    (``apr_conv_hbm``): one per call either way.  ``block_m``,
    ``block_n`` and ``block_k`` pin the configuration over ``config``."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency {residency!r}")
    if x.device.type == "cpu" and f.device.type == "cpu":
        return conv2d_ref(x, f, stride=stride, padding=padding)
    _check(x, f, "apr_conv2d")
    args, shape = _geometry(x, f, stride, padding)
    resolve_launch(KERNEL_NAME, x, f, stride, padding, residency,
                   pin_config(config, block_m=block_m, block_n=block_n,
                              block_k=block_k))
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if residency == "apr":
        err = lib.apr_conv(x.data_ptr(), f.data_ptr(), None, out.data_ptr(),
                           *args, ACTIVATIONS["none"], stream)
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
    and is used in fp32.  CUDA tensors launch ``apr_conv`` or raise; CPU
    tensors take :func:`conv2d_fused_ref`.  ``block_*`` pin the
    configuration as in :func:`apr_conv2d`.  Each launch adds one to
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
    resolve_launch(FUSED_KERNEL_NAME, x, f, stride, padding, None,
                   pin_config(config, block_m=block_m, block_n=block_n,
                              block_k=block_k))
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.apr_conv(x.data_ptr(), f.data_ptr(),
                       None if bias is None else bias.data_ptr(),
                       out.data_ptr(), *args, ACTIVATIONS[activation], stream)
    _build.check(lib, err, "apr_conv")
    apr_conv2d_fused.launches += 1
    return out


apr_conv2d.launches = 0
apr_conv2d.hbm_launches = 0
apr_conv2d_fused.launches = 0
