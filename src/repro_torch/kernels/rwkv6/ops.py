"""``rwkv6_wkv`` wrapper: the hand-written CUDA kernel of
``csrc/rwkv6.cu`` for CUDA tensors, the plain PyTorch version
(:func:`.ref.rwkv6_ref`) for CPU tensors; its gradient
(:class:`Rwkv6Function`) is the kernel of ``csrc/rwkv6_bwd.cu``
(:func:`rwkv6_wkv_backward`), or :func:`.ref.rwkv6_ref_bwd` for CPU
tensors.

A launch's configuration has three keys: ``chunk``, the time steps staged
a round (the JAX wrapper's ``chunk``, which ``rwkv6_wkv(chunk=)`` pins as
the JAX wrapper's ``explicit={"chunk": chunk}`` does); ``cols``, the most
state columns of one (b, h) a block owns (a head's columns are cut into
ceil(D / cols) runs of nearly equal length); ``lanes``, the lanes side by
side along a state row, 4 columns each.  Every combination of :data:`CHUNKS`,
:data:`COLS` and :data:`LANES` with ``cols >= 4 * lanes`` is compiled
(:func:`compiled_configs`), and all of them give the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional

import torch

from ...bench.config import (BlockConfig, dtype_name, pin_config,
                             resolve_among, shape_key_from_dims)
from ...roofline.hw import get_profile
from .. import _build
from ..mamba2.ops import blocks_per_sm, stash_chunk
from .ref import rwkv6_ref, rwkv6_ref_bwd

LIBRARY = "rwkv6"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 7 + [_P]
SIGNATURES = {"rwkv6_wkv_bf16": (ctypes.c_int, _ARGS),
              "rwkv6_wkv_f32": (ctypes.c_int, _ARGS)}
MAX_HEAD_DIM = 128   # the kernel's register budget: 16 state rows a lane
KERNEL_NAME = "rwkv6"
#: time steps staged a round (``chunk``); 64 is the JAX wrapper's default
CHUNKS = (8, 16, 32, 64)
#: the most state columns a block owns (``cols``): a head's columns are
#: cut into ceil(D / cols) runs of nearly equal length, whole warps each
COLS = (8, 16, 24, 32, 64)
#: lanes side by side along a state row (``lanes``), 32 / lanes along i
LANES = (1, 2, 4)
#: an H100 block's dynamic shared memory, which the staging must fit
MAX_SMEM = 232448
#: the most warps a block runs (``MAX_WARPS`` in the source)
MAX_WARPS = 8
#: the SM count :func:`default_config` spreads a call over (the
#: ``h100_sxm`` profile's, on every card)
SMS = get_profile("h100_sxm").sms


def shape_key(b, t, h, d) -> str:
    return shape_key_from_dims(b=b, t=t, h=h, d=d)


@functools.lru_cache(maxsize=None)
def compiled_configs() -> frozenset:
    """Every configuration the kernel takes."""
    return frozenset(BlockConfig.make(chunk=c, cols=w, lanes=l)
                     for c, w, l in itertools.product(CHUNKS, COLS, LANES)
                     if w >= 4 * l)


def default_config(b, t, h, d) -> BlockConfig:
    """About one block an SM: each head's columns in as many runs as
    B·H·runs stays within :data:`SMS` blocks, the fewest columns a run
    that allows, one lane along a row (32 along i), over a prompt; runs of
    16 columns and four lanes along a row at a decode step (T = 1), whose
    time is latency; 64 steps a round."""
    runs = max(1, SMS // max(1, b * h))
    cols = min((c for c in COLS if -(-d // c) <= runs), default=max(COLS))
    if t == 1:              # a decode step: short runs, many blocks
        return BlockConfig.make(chunk=64, cols=16, lanes=4)
    return BlockConfig.make(chunk=64, cols=cols, lanes=1)


def head_rows(d: int) -> int:
    """D rounded up to a power of two, at least 16: the rows the kernel's
    lanes cover (those past D are zeros)."""
    ip = 16
    while ip < d:
        ip *= 2
    return ip


def smem_bytes(chunk, d, cols, itemsize) -> int:
    """Dynamic shared memory of a launch over T > 1 (``Layout`` in the
    source): u and the per-step bonus, fp32 copies of r, k (rows of
    :func:`head_rows` values) and the block's v for bf16 streams, and two
    raw buffers of r, k, v and w."""
    ip = head_rows(d)
    wide = 0 if itemsize == 4 else chunk * (2 * ip + cols) * 4
    raw = chunk * ((2 * ip + cols) * itemsize + ip * 4)
    return d * 4 + chunk * 4 + wide + 2 * raw


@functools.lru_cache(maxsize=256)
def geometry(b, t, h, d, cfg: BlockConfig, itemsize: int = 2) -> dict:
    """The launch ``cfg`` makes: lanes along a row (at least 32 / the
    padded head size), the rows a lane owns, the runs a head's columns are
    cut into (ceil(D / cols), at most one a warp of columns and at least
    enough that no run passes :data:`MAX_WARPS` warps), staging depth,
    blocks, threads a block (the longest run's warps) and shared bytes."""
    ip = head_rows(d)
    lanes = max(cfg["lanes"], 32 // ip)
    head_warps = d // (4 * lanes)
    parts = min(head_warps, max(-(-d // cfg["cols"]),
                                -(-head_warps // MAX_WARPS)))
    warps = -(-head_warps // parts)
    return dict(lanes=lanes, rows_per_lane=ip * lanes // 32, parts=parts,
                chunk=cfg["chunk"], blocks=b * h * parts, threads=warps * 32,
                smem=smem_bytes(cfg["chunk"], d, warps * 4 * lanes,
                                itemsize) if t > 1 else 0)


def resolve_launch(b, t, h, d, dtype: str, backend: str = "cuda",
                   config: Optional[BlockConfig] = None) -> BlockConfig:
    """The configuration of a launch at (B, T, H, D): ``config`` (with the
    caller's ``chunk`` laid over it) > the tuned entry under the JAX key >
    :func:`default_config`; one that is not compiled raises
    :class:`~repro_torch.bench.TileError` before any launch."""
    return resolve_among(KERNEL_NAME, (b, t, h, d), dtype, backend,
                         shape_key=shape_key, default=default_config,
                         compiled=compiled_configs(), config=config)


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
              return_state: bool = False, chunk: Optional[int] = None,
              config: Optional[BlockConfig] = None):
    """The RWKV-6 WKV recurrence over all T steps in one launch.

    r/k/v: (B, T, H, D) bf16 or fp32; w: the decay in (0, 1), same shape,
    fp32 (it reaches ~1e-24, far below bf16's resolution near 1); u:
    (H, D) in r's dtype; s_init: (B, H, D, D) fp32, or None to start from
    zeros.  Returns y (B, T, H, D) in r's dtype and, with
    ``return_state``, the final state (B, H, D, D) fp32 -- with neither
    option it is exactly the TPU kernel.

    CUDA tensors launch the kernel (contiguous and 16-byte aligned, D a
    multiple of 16 up to 128) or raise; CPU tensors take
    :func:`rwkv6_ref`, whatever the configuration.  The configuration
    (:func:`resolve_launch`: ``chunk`` laid over ``config``, else the tune
    cache's under the JAX key, else :func:`default_config`) must be one of
    :func:`compiled_configs`, or :class:`~repro_torch.bench.TileError` is
    raised.  Each launch adds one to ``rwkv6_wkv.launches``."""
    tensors = (r, k, v, w, u) + (() if s_init is None else (s_init,))
    config = pin_config(config, chunk=chunk)
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv6_ref(r, k, v, w, u, s_init=s_init,
                         return_state=return_state)
    b, t, h, d = check_kernel_args(r, k, v, w, u, s_init)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError(f"rwkv6_wkv: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("rwkv6_wkv kernel takes 16-byte aligned tensors")
    cfg = resolve_launch(b, t, h, d, dtype_name(r.dtype), "cuda", config)
    geom = geometry(b, t, h, d, cfg, r.element_size())
    y = torch.empty_like(r)
    s_out = (torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
             if return_state else None)
    lib = _build.load(LIBRARY, SIGNATURES)
    fn = lib.rwkv6_wkv_bf16 if r.dtype == torch.bfloat16 else \
        lib.rwkv6_wkv_f32
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), None if s_init is None else s_init.data_ptr(),
             None if s_out is None else s_out.data_ptr(), y.data_ptr(),
             b, t, h, d, geom["parts"], geom["lanes"], geom["chunk"],
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "rwkv6_wkv")
    rwkv6_wkv.launches += 1
    return (y, s_out) if return_state else y


rwkv6_wkv.launches = 0


# ------------------------------------------------------------- the gradient
BWD_LIBRARY = "rwkv6_bwd"
_BWD_ARGS = [_P] * 15 + [_I] * 5 + [_P]
BWD_SIGNATURES = {"rwkv6_wkv_bwd_bf16": (ctypes.c_int, _BWD_ARGS),
                  "rwkv6_wkv_bwd_f32": (ctypes.c_int, _BWD_ARGS)}
#: the state rows a backward block owns (``ROWS`` in the source)
BWD_ROWS = 16


def bwd_smem_bytes(ch, d, dp, warps, itemsize) -> int:
    """Dynamic shared memory of a backward launch (``smem_floats`` in the
    source): the stash of a chunk's states, the warps' dv partials, the
    tile's row sums, fp32 rows, two raw buffers, the per-step scalars and
    the tile's u."""
    es = itemsize
    return 4 * (ch * 16 * dp + ch * warps * dp + 3 * ch * 16
                + ch * (2 * dp + 3 * 16)
                + 2 * ((ch * (2 * d * es + 2 * 16 * es + 16 * 4) + 15)
                       // 16 * 4)
                + ch + ch * warps + 16)


@functools.lru_cache(maxsize=256)
def bwd_geometry(b, t, h, d, itemsize: int = 2) -> dict:
    """The backward launch at (B, T, H, D), from the shape alone: each
    (b, h) state cut into ``tiles`` = D / 16 row tiles, a block a tile
    holding all :func:`head_rows` columns, ``lanes`` = that / 4 lanes a
    row and ``rows_per_lane`` rows a thread (4, or 2 at 16 columns, a
    whole warp); ``chunk``, the steps a chunk's states stash, as B10's
    (``mamba2.ops.stash_chunk``)."""
    dp = head_rows(d)
    lanes, tiles = dp // 4, d // BWD_ROWS
    blocks = b * h * tiles
    rt = 4 if dp >= 32 else 2
    threads = BWD_ROWS // rt * lanes
    warps = threads // 32

    def smem(ch):
        return bwd_smem_bytes(ch, d, dp, warps, itemsize)

    chunk = stash_chunk(t, blocks, threads, smem)
    per_sm = blocks_per_sm(smem(chunk), threads)
    return dict(lanes=lanes, rows_per_lane=rt, cols=dp, tiles=tiles,
                threads=threads, warps=warps, blocks=blocks, chunk=chunk,
                chunks=-(-t // chunk), smem=smem(chunk),
                blocks_per_sm=per_sm, waves=-(-blocks // (per_sm * SMS)))


def bwd_buffers(b, t, h, d, geom: dict) -> dict:
    """The backward call's fp32 scratch, by name and shape, in the order
    the source takes it: the checkpoints (a chunk's start state of each
    tile), dv's per-tile partials, the bonus's per-tile partials and du's
    per-batch-row partials."""
    tiles = geom["tiles"]
    return {"ckpt": (geom["blocks"], geom["chunks"],
                     BWD_ROWS * geom["cols"]),
            "dv_part": (tiles, b, t, h, d), "beta_part": (tiles, b, t, h),
            "du_part": (b, h, d)}


def rwkv6_wkv_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """The gradient of :func:`rwkv6_wkv` (no state in or out) given ``dy``
    in r's dtype and shape: (dr, dk, dv, dw, du) in fp32, from one call of
    ``csrc/rwkv6_bwd.cu`` (the checkpointing and reverse sweeps over the
    row tiles of :func:`bwd_geometry`, then dv's fixed-order sum over
    tiles and du's over batch rows).  CUDA tensors only: the plain
    version is :func:`.ref.rwkv6_ref_bwd`.  Each call adds one to
    ``rwkv6_wkv_backward.launches``, whatever number of kernels it
    runs."""
    b, t, h, d = check_kernel_args(r, k, v, w, u)
    tensors = (r, k, v, w, u, dy)
    if dy.dtype != r.dtype or dy.shape != r.shape or not dy.is_contiguous():
        raise ValueError(f"rwkv6_wkv_backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} must be contiguous, r's dtype "
                         f"and shape")
    if not all(x.is_cuda and x.device == r.device for x in tensors):
        raise ValueError(f"rwkv6_wkv_backward: tensors on "
                         f"{[str(x.device) for x in tensors]}")
    if t == 0:
        raise ValueError("rwkv6_wkv_backward: T = 0")
    geom = bwd_geometry(b, t, h, d, r.element_size())
    f32 = dict(dtype=torch.float32, device=r.device)
    scratch = [torch.empty(shape, **f32)
               for shape in bwd_buffers(b, t, h, d, geom).values()]
    dr, dk, dv, dw = (torch.empty((b, t, h, d), **f32) for _ in range(4))
    du = torch.empty((h, d), **f32)
    lib = _build.load(BWD_LIBRARY, BWD_SIGNATURES)
    fn = lib.rwkv6_wkv_bwd_bf16 if r.dtype == torch.bfloat16 else \
        lib.rwkv6_wkv_bwd_f32
    err = fn(*(x.data_ptr() for x in (r, k, v, w, u, dy, *scratch, dr, dk,
                                      dv, dw, du)),
             b, t, h, d, geom["chunk"],
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "rwkv6_wkv_backward")
    rwkv6_wkv_backward.launches += 1
    return dr, dk, dv, dw, du


rwkv6_wkv_backward.launches = 0


class Rwkv6Function(torch.autograd.Function):
    """B9 under autograd: the forward is :func:`rwkv6_wkv` (from zeros, no
    state out), the backward :func:`rwkv6_wkv_backward` on CUDA tensors and
    :func:`.ref.rwkv6_ref_bwd` on CPU tensors, each gradient cast to its
    input's dtype and given only where ``needs_input_grad`` asks."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return rwkv6_wkv(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy):
        want = ctx.needs_input_grad
        if not any(want):
            return (None,) * 5
        inputs = ctx.saved_tensors
        dy = dy.to(inputs[0].dtype).contiguous()
        if all(x.device.type == "cpu" for x in inputs):
            grads = rwkv6_ref_bwd(*inputs, dy)
        else:
            grads = rwkv6_wkv_backward(*inputs, dy)
        return tuple(g.to(x.dtype) if need else None
                     for g, x, need in zip(grads, inputs, want))


def rwkv6_wkv_grad(r, k, v, w, u, *, s_init=None, return_state=False):
    """:func:`rwkv6_wkv` through :class:`Rwkv6Function`, for a call under a
    gradient.  A state in (``s_init``) or out (``return_state``) is refused
    by name: training runs every sequence from zeros, as the JAX training
    forward does, and the backward kernel takes no state."""
    if s_init is not None or return_state:
        raise NotImplementedError(
            "rwkv6_wkv under a gradient takes no s_init and returns no "
            "state (return_state): the backward kernel runs from zeros")
    return Rwkv6Function.apply(r, k, v, w, u)
