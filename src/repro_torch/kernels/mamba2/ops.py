"""``mamba2_ssd`` wrapper: the hand-written CUDA kernel of
``csrc/mamba2.cu`` for CUDA tensors, the plain PyTorch version
(:func:`.ref.mamba2_ref`) for CPU tensors; its gradient
(:class:`Mamba2Function`) is the kernel of ``csrc/mamba2_bwd.cu``
(:func:`mamba2_ssd_backward`), or :func:`.ref.mamba2_ref_bwd` for CPU
tensors.

A launch's configuration has three keys: ``chunk``, the time steps staged
a round (the JAX wrapper's ``chunk``, which ``mamba2_ssd(chunk=)`` pins as
the JAX wrapper's ``explicit={"chunk": chunk}`` does); ``rows``, the state
rows of a batch row a block owns (a tile may span heads); ``lanes``, the
lanes that share a row.
Every combination of :data:`CHUNKS`, :data:`ROWS` and :data:`LANES` is
compiled (:func:`compiled_configs`), and all of them give the same bits.
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
from .ref import mamba2_ref, mamba2_ref_bwd

LIBRARY = "mamba2"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P] * 9 + [_I] * 8 + [_L] * 7 + [_P]
SIGNATURES = {"mamba2_ssd_bf16": (ctypes.c_int, _ARGS),
              "mamba2_ssd_f32": (ctypes.c_int, _ARGS)}
#: the kernel's limits: a lane keeps its state vectors of rows up to
#: N = 128 values in registers
MAX_HEAD_DIM, MAX_STATE = 64, 128
KERNEL_NAME = "mamba2"
#: time steps staged a round (``chunk``); 64 is the JAX wrapper's default
CHUNKS = (8, 16, 32, 64)
#: state rows a block owns (``rows``), 4 or 8 a warp, cut from the H·P rows
#: of a batch row (flattened as h·P + p, so a tile may span heads); where the
#: configured count does not divide H·P the largest multiple of 8 below it
#: that does is run
ROWS = (8, 16, 24, 32, 40, 48, 56, 64)
#: lanes that share a row (``lanes``); see :func:`rows_per_lane`
LANES = (4, 8, 16)
#: heads a tile of rows may touch (``MAX_HEADS`` in the source)
MAX_HEADS = max(ROWS) // 16 + 1
#: an H100 block's dynamic shared memory, which the staging must fit
MAX_SMEM = 232448
#: the SM count :func:`default_config` spreads a call over (the
#: ``h100_sxm`` profile's, on every card, so the tune spec and the wrapper
#: agree)
SMS = get_profile("h100_sxm").sms


def shape_key(b, t, h, p, n) -> str:
    return shape_key_from_dims(b=b, t=t, h=h, p=p, n=n)


@functools.lru_cache(maxsize=None)
def compiled_configs() -> frozenset:
    """Every configuration the kernel takes."""
    return frozenset(BlockConfig.make(chunk=c, rows=r, lanes=l)
                     for c, r, l in itertools.product(CHUNKS, ROWS, LANES))


def rows_per_lane(lanes: int) -> int:
    """Rows a lane owns at ``lanes`` lanes a row (``rows_per_lane`` in the
    source): 32 state values a thread at 4 lanes, 16 at 8 and 16."""
    return lanes // 8 if lanes >= 16 else 1


def rows_per_warp(lanes: int) -> int:
    return 32 // lanes * rows_per_lane(lanes)


def tile_rows(h, p, rows) -> int:
    """The rows a block runs: the largest multiple of 8 up to ``rows``
    that divides H·P."""
    return max(r for r in range(8, rows + 1, 8) if h * p % r == 0)


def default_config(b, t, h, p, n) -> BlockConfig:
    """Over a prompt, about one block an SM: the fewest rows a block (at
    most 64) that keep B·H·P / rows within :data:`SMS` blocks, 16 lanes a
    row, 64 steps a round.  At a decode step (T = 1), whose time is the
    state's round trip, small blocks of 8 rows at 8 lanes a row, the
    fastest on an H100 (``PERF.md``)."""
    if t == 1:
        return BlockConfig.make(chunk=64, rows=8, lanes=8)
    want = min(max(ROWS), -(-b * h * p // SMS) + 7 & ~7)
    rows = min((r for r in ROWS if r >= want and h * p % r == 0),
               default=max(ROWS))
    return BlockConfig.make(chunk=64, rows=rows, lanes=16)


def smem_bytes(chunk, rows, itemsize) -> int:
    """Dynamic shared memory of a launch over T > 1 (``Layout`` in the
    source): fp32 copies of b, c (rows of :data:`MAX_STATE` values) and
    the block's x for bf16 streams, the decay of each step and head, and
    two raw buffers of b, c, x and dt."""
    wide = 0 if itemsize == 4 else chunk * (2 * MAX_STATE + rows) * 4
    raw = (chunk * (2 * MAX_STATE + rows) * itemsize
           + chunk * MAX_HEADS * 4)
    return wide + chunk * MAX_HEADS * 4 + 2 * raw


@functools.lru_cache(maxsize=256)
def geometry(b, t, h, p, n, cfg: BlockConfig, itemsize: int = 2) -> dict:
    """The launch ``cfg`` makes: the rows a block owns
    (:func:`tile_rows`), lanes a row, staging depth, blocks, threads a
    block and shared bytes."""
    rows = tile_rows(h, p, cfg["rows"])
    return dict(rows=rows, lanes=cfg["lanes"], chunk=cfg["chunk"],
                blocks=b * (h * p // rows),
                threads=rows // rows_per_warp(cfg["lanes"]) * 32,
                smem=smem_bytes(cfg["chunk"], rows, itemsize) if t > 1
                else 0)


def resolve_launch(bsz, t, h, p, n, dtype: str, backend: str = "cuda",
                   config: Optional[BlockConfig] = None) -> BlockConfig:
    """The configuration of a launch at (B, T, H, P, N): ``config`` (with
    the caller's ``chunk`` laid over it) > the tuned entry under the JAX
    key > :func:`default_config`; one that is not compiled raises
    :class:`~repro_torch.bench.TileError` before any launch."""
    return resolve_among(KERNEL_NAME, (bsz, t, h, p, n), dtype, backend,
                         shape_key=shape_key, default=default_config,
                         compiled=compiled_configs(), config=config)


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
               return_state: bool = False, chunk: Optional[int] = None,
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
    N <= 128) or raise; CPU tensors take :func:`mamba2_ref`, whatever the
    configuration.  The configuration (:func:`resolve_launch`: ``chunk``
    laid over ``config``, else the tune cache's under the JAX key, else
    :func:`default_config`) must be one of :func:`compiled_configs`, or
    :class:`~repro_torch.bench.TileError` is raised.  Each launch adds one
    to ``mamba2_ssd.launches``."""
    tensors = (x, b, c, dt, a, d) + (() if h_init is None else (h_init,))
    config = pin_config(config, chunk=chunk)
    if all(t.device.type == "cpu" for t in tensors):
        return mamba2_ref(x, b, c, dt, a, d, h_init=h_init,
                          return_state=return_state)
    bsz, t, h, p, n = check_kernel_args(x, b, c, dt, a, d, h_init)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"mamba2_ssd: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    if h_init is not None and h_init.data_ptr() % 16:
        raise ValueError("mamba2_ssd kernel takes a 16-byte aligned state")
    cfg = resolve_launch(bsz, t, h, p, n, dtype_name(x.dtype), "cuda",
                         config)
    geom = geometry(bsz, t, h, p, n, cfg, x.element_size())
    y = torch.empty((bsz, t, h, p), dtype=x.dtype, device=x.device)
    h_out = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if return_state else None)
    lib = _build.load(LIBRARY, SIGNATURES)
    fn = lib.mamba2_ssd_bf16 if x.dtype == torch.bfloat16 else \
        lib.mamba2_ssd_f32
    err = fn(x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
             a.data_ptr(), d.data_ptr(),
             None if h_init is None else h_init.data_ptr(),
             None if h_out is None else h_out.data_ptr(), y.data_ptr(),
             bsz, t, h, p, n, geom["rows"], geom["lanes"], geom["chunk"],
             x.stride(0), x.stride(1), x.stride(2), b.stride(0), b.stride(1),
             c.stride(0), c.stride(1),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "mamba2_ssd")
    mamba2_ssd.launches += 1
    return (y, h_out) if return_state else y


mamba2_ssd.launches = 0


# ------------------------------------------------------------- the gradient
BWD_LIBRARY = "mamba2_bwd"
_BWD_ARGS = [_P] * 21 + [_I] * 9 + [_P]
BWD_SIGNATURES = {"mamba2_ssd_bwd_bf16": (ctypes.c_int, _BWD_ARGS),
                  "mamba2_ssd_bwd_f32": (ctypes.c_int, _BWD_ARGS)}
#: the most steps a backward chunk stashes
BWD_MAX_CHUNK = 32
#: an H100 SM's shared memory, and the part the system keeps a block
SM_SMEM, BLOCK_RESERVED = 233472, 1024
#: the blocks an SM a wave needs from which the backward runs its
#: register-capped body (``WAVE`` in the source)
BWD_WAVE_BLOCKS = 3


def bwd_smem_bytes(ch, p, nc, warps, itemsize) -> int:
    """Dynamic shared memory of a backward launch (``smem_floats`` in the
    source): the stash of a chunk's states, the warps' column partials,
    the tile's row sums, fp32 copies of bf16 rows, two raw buffers and
    the per-step scalars."""
    es = itemsize
    return 4 * (ch * p * nc + ch * warps * nc + ch * p
                + (4 - es) // 2 * 2 * ch * (p + nc)
                + 2 * ((ch * (2 * p + 2 * nc) * es + 4 * ch + 15) // 16 * 4)
                + ch + 4 * ch * warps)


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks an SM holds by shared memory and threads (2048 an SM)."""
    return min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // threads)


def stash_chunk(t: int, blocks: int, threads: int, smem_of) -> int:
    """The steps a backward chunk stashes (``smem_of(ch)`` bytes a block):
    the most, up to :data:`BWD_MAX_CHUNK` and T, at which the blocks an SM
    that one wave of ``blocks`` needs (at least 2) fit; where none does,
    the most at which 2 fit."""
    steps = range(1, max(1, min(t, BWD_MAX_CHUNK)) + 1)
    for want in (max(2, -(-blocks // SMS)), 2):
        fits = [c for c in steps if blocks_per_sm(smem_of(c), threads)
                >= want]
        if fits:
            return fits[-1]
    return 1


@functools.lru_cache(maxsize=256)
def bwd_geometry(b, t, h, p, n, itemsize: int = 2) -> dict:
    """The backward launch at (B, T, H, P, N), from the shape alone: each
    (b, h) state cut into ``tiles`` column tiles of ``cols`` = 4 ·
    ``lanes`` columns (32, or 16 where 32 does not divide N), a block a
    tile holding all P rows, ``rows_per_lane`` rows a thread (4, or 2
    where 4 leaves a partial warp); ``chunk``, the steps a chunk's states
    stash (:func:`stash_chunk`); ``wave``: one wave needs
    :data:`BWD_WAVE_BLOCKS` or more blocks an SM (at 4 rows a thread),
    and the call runs the register-capped body."""
    lanes = 8 if n % 32 == 0 else 4
    cols = 4 * lanes
    tiles = n // cols
    blocks = b * h * tiles
    rt = 4 if p // 4 * lanes >= 32 else 2
    threads = p // rt * lanes
    warps = threads // 32
    want = max(2, -(-blocks // SMS))

    def smem(ch):
        return bwd_smem_bytes(ch, p, cols, warps, itemsize)

    chunk = stash_chunk(t, blocks, threads, smem)
    per_sm = blocks_per_sm(smem(chunk), threads)
    return dict(lanes=lanes, rows_per_lane=rt, cols=cols, tiles=tiles,
                threads=threads, warps=warps, blocks=blocks, chunk=chunk,
                chunks=-(-t // chunk), smem=smem(chunk),
                wave=want >= BWD_WAVE_BLOCKS and rt == 4,
                blocks_per_sm=per_sm,
                waves=-(-blocks // (per_sm * SMS)))


def bwd_buffers(b, t, h, p, n, geom: dict) -> dict:
    """The backward call's fp32 scratch, by name and shape, in the order
    the source takes it: the checkpoints (a chunk's start state of each
    tile), dx's per-tile partials, db's and dc's per-head partials, the
    per-tile q and s partials, and x·dy and dt·q of each (b, t, h)."""
    tiles = geom["tiles"]
    return {"ckpt": (geom["blocks"], geom["chunks"], p * geom["cols"]),
            "dx_part": (tiles, b, t, h, p), "db_part": (b, t, h, n),
            "dc_part": (b, t, h, n), "q_part": (tiles, b, t, h),
            "s_part": (tiles, b, t, h), "xdy": (b, t, h),
            "dterm": (b, t, h)}


def mamba2_ssd_backward(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                        dy: torch.Tensor):
    """The gradient of :func:`mamba2_ssd` (no state in or out) given ``dy``
    in x's dtype and shape: (dx, db, dc, ddt, da, dd) in fp32, from one
    call of ``csrc/mamba2_bwd.cu`` (the checkpointing and reverse sweeps
    over the column tiles of :func:`bwd_geometry`, then the fixed-order
    sums over tiles, heads, batch rows and steps).  CUDA tensors only, x,
    b, c and dy contiguous: the plain version is
    :func:`.ref.mamba2_ref_bwd`.  Each call adds one to
    ``mamba2_ssd_backward.launches``, whatever number of kernels it
    runs."""
    bsz, t, h, p, n = check_kernel_args(x, b, c, dt, a, d)
    tensors = (x, b, c, dt, a, d, dy)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"mamba2_ssd_backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} must be x's dtype and shape")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("mamba2_ssd_backward takes contiguous tensors")
    if not all(v.is_cuda and v.device == x.device for v in tensors):
        raise ValueError(f"mamba2_ssd_backward: tensors on "
                         f"{[str(v.device) for v in tensors]}")
    if t == 0:
        raise ValueError("mamba2_ssd_backward: T = 0")
    geom = bwd_geometry(bsz, t, h, p, n, x.element_size())
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = [torch.empty(shape, **f32) for shape in
               bwd_buffers(bsz, t, h, p, n, geom).values()]
    dx = torch.empty((bsz, t, h, p), **f32)
    db, dc = (torch.empty((bsz, t, n), **f32) for _ in range(2))
    ddt = torch.empty((bsz, t, h), **f32)
    da, dd = (torch.empty((h,), **f32) for _ in range(2))
    lib = _build.load(BWD_LIBRARY, BWD_SIGNATURES)
    fn = lib.mamba2_ssd_bwd_bf16 if x.dtype == torch.bfloat16 else \
        lib.mamba2_ssd_bwd_f32
    err = fn(*(v.data_ptr() for v in (x, b, c, dt, a, d, dy, *scratch, dx,
                                      db, dc, ddt, da, dd)),
             bsz, t, h, p, n, geom["lanes"], geom["rows_per_lane"],
             int(geom["wave"]), geom["chunk"],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "mamba2_ssd_backward")
    mamba2_ssd_backward.launches += 1
    return dx, db, dc, ddt, da, dd


mamba2_ssd_backward.launches = 0


class Mamba2Function(torch.autograd.Function):
    """B10 under autograd: the forward is :func:`mamba2_ssd` (from zeros,
    no state out; strided x, b, c as it takes them), the backward
    :func:`mamba2_ssd_backward` on contiguous copies on CUDA tensors and
    :func:`.ref.mamba2_ref_bwd` on CPU tensors, each gradient cast to its
    input's dtype and given only where ``needs_input_grad`` asks."""

    @staticmethod
    def forward(ctx, x, b, c, dt, a, d):
        ctx.save_for_backward(x, b, c, dt, a, d)
        return mamba2_ssd(x, b, c, dt, a, d)

    @staticmethod
    def backward(ctx, dy):
        want = ctx.needs_input_grad
        if not any(want):
            return (None,) * 6
        inputs = ctx.saved_tensors
        dy = dy.to(inputs[0].dtype).contiguous()
        if all(v.device.type == "cpu" for v in inputs):
            grads = mamba2_ref_bwd(*inputs, dy)
        else:
            grads = mamba2_ssd_backward(*(v.contiguous() for v in inputs),
                                        dy)
        return tuple(g.to(v.dtype) if need else None
                     for g, v, need in zip(grads, inputs, want))


def mamba2_ssd_grad(x, b, c, dt, a, d, *, h_init=None, return_state=False):
    """:func:`mamba2_ssd` through :class:`Mamba2Function`, for a call under
    a gradient.  A state in (``h_init``) or out (``return_state``) is
    refused by name: training runs every sequence from zeros, as the JAX
    training forward does, and the backward kernel takes no state."""
    if h_init is not None or return_state:
        raise NotImplementedError(
            "mamba2_ssd under a gradient takes no h_init and returns no "
            "state (return_state): the backward kernel runs from zeros")
    return Mamba2Function.apply(x, b, c, dt, a, d)
