"""``mamba2_ssd`` wrapper: the hand-written CUDA kernel of
``csrc/mamba2.cu`` for CUDA tensors, the plain PyTorch version
(:func:`.ref.mamba2_ref`) for CPU tensors."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...bench.config import (BlockConfig, dtype_name, resolve_fixed,
                             shape_key_from_dims)
from .. import _build
from .ref import mamba2_ref

LIBRARY = "mamba2"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P] * 9 + [_I] * 5 + [_L] * 7 + [_P]
SIGNATURES = {"mamba2_ssd_bf16": (ctypes.c_int, _ARGS),
              "mamba2_ssd_f32": (ctypes.c_int, _ARGS)}
#: the kernel's limits: 32 state columns a thread, 256 threads a block
MAX_HEAD_DIM, MAX_STATE = 64, 128
KERNEL_NAME = "mamba2"
#: the one configuration the kernel is compiled for: inputs are staged 16
#: time steps per round (``CH`` in the source) while the state stays in
#: registers for all T, so the family's tune space has one point
COMPILED = BlockConfig.make(chunk=16)


def shape_key(b, t, h, p, n) -> str:
    return shape_key_from_dims(b=b, t=t, h=h, p=p, n=n)


def default_config(b, t, h, p, n) -> BlockConfig:
    return COMPILED


def check_kernel_args(x, b, c, dt, a, d, h_init=None):
    """Raise on anything the CUDA kernel does not take (dtypes, shapes, the
    P/N limits, layout); returns (B, T, H, P, N)."""
    tensors = (x, b, c, dt, a, d) + (() if h_init is None else (h_init,))
    if x.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != x.dtype for t in (b, c)):
        got = [str(t.dtype) for t in (x, b, c)]
        raise TypeError(f"mamba2_ssd kernel takes x, b, c of one dtype, "
                        f"bf16 or fp32, got {got}")
    if any(t.dtype != torch.float32 for t in tensors[3:]):
        raise TypeError("mamba2_ssd kernel takes fp32 dt, a, d and state")
    bsz, t, h, p = x.shape if x.dim() == 4 else (0,) * 4
    n = b.shape[-1]
    if (x.dim() != 4 or b.shape != (bsz, t, n) or c.shape != (bsz, t, n)
            or dt.shape != (bsz, t, h) or a.shape != (h,) or d.shape != (h,)
            or (h_init is not None and h_init.shape != (bsz, h, p, n))):
        raise ValueError(
            f"mamba2_ssd: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, d "
            f"{tuple(d.shape)}, h_init "
            f"{None if h_init is None else tuple(h_init.shape)}")
    if p % 16 or n % 16 or not (16 <= p <= MAX_HEAD_DIM
                                and 16 <= n <= MAX_STATE):
        raise ValueError(f"mamba2_ssd kernel takes P and N multiples of 16, "
                         f"P <= {MAX_HEAD_DIM} and N <= {MAX_STATE}, got "
                         f"P={p} N={n}")
    if (x.stride(3) != 1 or b.stride(2) != 1 or c.stride(2) != 1
            or not all(u.is_contiguous() for u in tensors[3:])):
        raise ValueError("mamba2_ssd kernel takes x, b, c with a contiguous "
                         "last axis and contiguous dt, a, d, state")
    return bsz, t, h, p, n


def mamba2_ssd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor, *,
               h_init: Optional[torch.Tensor] = None,
               return_state: bool = False,
               config: Optional[BlockConfig] = None):
    """The Mamba-2 SSD recurrence over all T steps in one launch.

    x: (B, T, H, P); b/c: (B, T, N), indexed per batch row and shared by
    every head (never broadcast in memory); x, b and c in one dtype, bf16
    or fp32, each with a contiguous last axis (other strides are read as
    they are, so column slices of a fused projection need no copy); dt:
    (B, T, H) fp32; a (negative) and d: (H,) fp32; h_init: (B, H, P, N)
    fp32, or None to start from zeros.  Returns y (B, T, H, P) in x's
    dtype and, with ``return_state``, the final state (B, H, P, N) fp32 --
    with neither option it is exactly the TPU kernel.

    CUDA tensors launch the kernel (P and N multiples of 16, P <= 64,
    N <= 128) or raise; CPU tensors take :func:`mamba2_ref`.  The
    configuration (``config`` or the tune cache's, under the JAX key) must
    be :data:`COMPILED`.  Each launch adds one to ``mamba2_ssd.launches``."""
    tensors = (x, b, c, dt, a, d) + (() if h_init is None else (h_init,))
    if all(t.device.type == "cpu" for t in tensors):
        return mamba2_ref(x, b, c, dt, a, d, h_init=h_init,
                          return_state=return_state)
    bsz, t, h, p, n = check_kernel_args(x, b, c, dt, a, d, h_init)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"mamba2_ssd: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    y = torch.empty((bsz, t, h, p), dtype=x.dtype, device=x.device)
    h_out = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if return_state else None)
    resolve_fixed(KERNEL_NAME, (bsz, t, h, p, n), dtype_name(x.dtype),
                  "cuda", shape_key=shape_key, compiled=COMPILED,
                  config=config)
    lib = _build.load(LIBRARY, SIGNATURES)
    fn = lib.mamba2_ssd_bf16 if x.dtype == torch.bfloat16 else \
        lib.mamba2_ssd_f32
    err = fn(x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
             a.data_ptr(), d.data_ptr(),
             None if h_init is None else h_init.data_ptr(),
             None if h_out is None else h_out.data_ptr(), y.data_ptr(),
             bsz, t, h, p, n, x.stride(0), x.stride(1), x.stride(2),
             b.stride(0), b.stride(1), c.stride(0), c.stride(1),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "mamba2_ssd")
    mamba2_ssd.launches += 1
    return (y, h_out) if return_state else y


mamba2_ssd.launches = 0
