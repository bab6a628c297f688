"""``rwkv6_wkv`` wrapper: the hand-written CUDA kernel of
``csrc/rwkv6.cu`` for CUDA tensors, the plain PyTorch version
(:func:`.ref.rwkv6_ref`) for CPU tensors."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...bench.config import (BlockConfig, dtype_name, resolve_fixed,
                             shape_key_from_dims)
from .. import _build
from .ref import rwkv6_ref

LIBRARY = "rwkv6"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 4 + [_P]
SIGNATURES = {"rwkv6_wkv_bf16": (ctypes.c_int, _ARGS),
              "rwkv6_wkv_f32": (ctypes.c_int, _ARGS)}
MAX_HEAD_DIM = 128   # the kernel's register budget: 32 state rows a thread
KERNEL_NAME = "rwkv6"
#: the one configuration the kernel is compiled for: inputs are staged 16
#: time steps per round (``CH`` in the source) while the state stays in
#: registers for all T, so the family's tune space has one point
COMPILED = BlockConfig.make(chunk=16)


def shape_key(b, t, h, d) -> str:
    return shape_key_from_dims(b=b, t=t, h=h, d=d)


def default_config(b, t, h, d) -> BlockConfig:
    return COMPILED


def check_kernel_args(r, k, v, w, u, s_init=None):
    """Raise on anything the CUDA kernel does not take (dtypes, shapes, the
    head-dim limit, layout); returns (B, T, H, D)."""
    tensors = (r, k, v, w, u) + (() if s_init is None else (s_init,))
    if r.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != r.dtype for t in (k, v, u)):
        got = [str(t.dtype) for t in (r, k, v, u)]
        raise TypeError(f"rwkv6_wkv kernel takes r, k, v, u of one dtype, "
                        f"bf16 or fp32, got {got}")
    if w.dtype != torch.float32 or (s_init is not None
                                    and s_init.dtype != torch.float32):
        raise TypeError("rwkv6_wkv kernel takes an fp32 decay and state")
    b, t, h, d = r.shape if r.dim() == 4 else (0,) * 4
    if (r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w))
            or u.shape != (h, d)
            or (s_init is not None and s_init.shape != (b, h, d, d))):
        raise ValueError(f"rwkv6_wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s_init "
                         f"{None if s_init is None else tuple(s_init.shape)}")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_wkv kernel takes a head dim that is a "
                         f"multiple of 16 up to {MAX_HEAD_DIM}, got {d}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("rwkv6_wkv kernel takes contiguous tensors")
    return b, t, h, d


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *,
              s_init: Optional[torch.Tensor] = None,
              return_state: bool = False,
              config: Optional[BlockConfig] = None):
    """The RWKV-6 WKV recurrence over all T steps in one launch.

    r/k/v: (B, T, H, D) bf16 or fp32; w: the decay in (0, 1), same shape,
    fp32 (it reaches ~1e-24, far below bf16's resolution near 1); u:
    (H, D) in r's dtype; s_init: (B, H, D, D) fp32, or None to start from
    zeros.  Returns y (B, T, H, D) in r's dtype and, with
    ``return_state``, the final state (B, H, D, D) fp32 -- with neither
    option it is exactly the TPU kernel.

    CUDA tensors launch the kernel (contiguous, D a multiple of 16 up to
    128) or raise; CPU tensors take :func:`rwkv6_ref`.  The configuration
    (``config`` or the tune cache's, under the JAX key) must be
    :data:`COMPILED`.  Each launch adds one to ``rwkv6_wkv.launches``."""
    tensors = (r, k, v, w, u) + (() if s_init is None else (s_init,))
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv6_ref(r, k, v, w, u, s_init=s_init,
                         return_state=return_state)
    b, t, h, d = check_kernel_args(r, k, v, w, u, s_init)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError(f"rwkv6_wkv: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    y = torch.empty_like(r)
    s_out = (torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
             if return_state else None)
    resolve_fixed(KERNEL_NAME, (b, t, h, d), dtype_name(r.dtype), "cuda",
                  shape_key=shape_key, compiled=COMPILED, config=config)
    lib = _build.load(LIBRARY, SIGNATURES)
    fn = lib.rwkv6_wkv_bf16 if r.dtype == torch.bfloat16 else \
        lib.rwkv6_wkv_f32
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), None if s_init is None else s_init.data_ptr(),
             None if s_out is None else s_out.data_ptr(), y.data_ptr(),
             b, t, h, d, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "rwkv6_wkv")
    rwkv6_wkv.launches += 1
    return (y, s_out) if return_state else y


rwkv6_wkv.launches = 0
