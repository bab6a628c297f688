#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a GPU host
    python3 chip_smoke.py --ablate   # only rms_norm's batch invariance and
                                     # the paged/slot token ablation

Phases (any failure exits non-zero before the final line):
  1. build the CUDA kernels of ``src/repro_torch/csrc`` with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it and at ragged ones: ``apr_matmul``
     with bf16 and int8 weights (the int8 one also bit for bit against the
     bf16 kernel on the dequantized weight), ``flash_decode_paged`` over
     bf16 and int8 pools, ``flash_decode`` over a contiguous cache
     (``lengths == 0`` rows included), the conv kernels, and the recurrence
     kernels ``rwkv6_wkv`` (B9) and ``mamba2_ssd`` (B10) with their state in
     and out, at the decode tick, at 1024- and 1000-token prefills and at the
     smoke shapes; and ``rms_norm``'s variance, row for row, at B = 1 and
     inside batches of 4 and 16; and the matmul families at every tile
     their kernels compile, at the llama3-8b projection shapes and ragged
     ones: ``apr_matmul`` (B1), its memory-resident baseline (B4m, equal
     to B1 at the same tile bit for bit), ``apr_matmul_fused`` (B7m),
     ``quant_matmul`` (B6) and ``quant_matmul_fused`` (B8) with every
     activation, bias and none, bf16 and fp32 out;
  3. time each kernel, its plain version and a PyTorch library call at the
     serving path's shapes with CUDA events, beside the card's bound (B4m,
     B6, B7m and B8 at the llama3-8b projection shapes, B4m beside B1);
  4. serve full-width llama3-8b (32 layers, random bf16 weights from a seed)
     on the port's PagedServeEngine: 6 ragged requests on 4 slots, and check
     every kernel of the path was launched as often as the path demands;
  4c. serve full-width llama3-8b bf16 on the slot ServeEngine (4 requests,
     max_seq 256; ``flash_decode`` under every layer), and the same requests
     on the PagedServeEngine for token agreement;
  4b. quantize the weights on the card, free the bf16 ones, and serve the 6
     requests of phase 4 with int8 weights and int8 KV pages (int8-weight
     ``apr_matmul``, int8 ``flash_decode_paged``); it runs after 4c so that
     its peak memory is the int8 deployment's;
  5. run the smoke llama3-8b config on the card (kernels) and on the CPU
     (plain versions) with the same weights, and compare the logits and
     greedy tokens: ``decode_paged`` in bf16, ``decode_paged`` with int8
     weights and int8 KV, ``decode_step`` on the slot cache; the same for
     the rwkv6 and mamba2 smoke configs (``decode_paged`` through the state
     pools, and ``prefill``);
  6. run the paper's CNNs (LeNet-5, ResNet-20; random fp32 weights from a
     seed) at batch 256 with every conv on ``apr_conv``, check each
     forward's launches, run ResNet-20 on the memory-resident baseline
     (``apr_conv_hbm``) and on the plain path, time all of them and ResNet-20
     at batch 1, and compare card (kernels) and CPU (plain) logits;
  7. serve full-width rwkv6-3b and then mamba2-2.7b (random bf16 weights
     from a seed, one model at a time) on the PagedServeEngine with its
     StateCache and on the slot ServeEngine, the same 6 requests on 4
     slots: greedy tokens equal, every launch count checked; then a
     1024-token ``bundle.prefill`` on each (B9/B10 over all T), every
     layer's scan held to its plain version on the same inputs;
  8. the tuning path at llama3-8b full width: every registered kernel
     family swept exhaustively (the yardstick), then
     ``warm_cache(sweep=True, prune_top_k=3)`` in a ``scoped_cache`` over
     a fresh cache file, at the paged engine's ``_decode_kernel_shapes()``,
     the projection shapes and each other family's serving shape; then a
     ``PagedServeEngine(tune_cache=...)`` serves phase 4's requests.  No
     candidate may be rejected, the pruned winner must be the exhaustive
     one (or a predicted tie, or within the timer spreads), and the engine
     must launch the tuned tiles;
  9. print the kernels' line, the card's name and power limit, and as the
     last line ``{"ok": true, "device": {...}}``.

Phases 1-7 resolve every kernel's configuration from an empty cache (the
kernels' defaults); only phase 8 scopes a tuned one.

Everything the run measured also goes to ``chiprun_out/chip_smoke.json``.
It needs nothing beyond this repository, PyTorch with CUDA, and nvcc.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: published peaks of one H100 SXM (NVIDIA data sheet; dense bf16 on the
#: tensor cores, fp32 FMA on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
#: |kernel - plain| <= BF16_RTOL * |plain| + ATOL: the two sum the same
#: fp32 products in another order and round once to bf16, so a value on a
#: rounding boundary may land one bf16 ulp (<= 2^-7 relative) apart
BF16_RTOL, ATOL = 2.0 ** -7, 1e-3
#: |int8 flash_decode_paged - plain| <= BF16_RTOL * |plain| + Q_ATOL: the
#: plain version (as the JAX oracle) rounds every dequantized K and V value
#: to bf16 (relative error <= 2^-8), the kernel keeps them fp32 (as the
#: Pallas kernel does); with O(1) values and D = 128 that moves a score by
#: at most ~0.03 and an output by ~0.01.  The kernel is also held to the
#: fp32-dequantized plain version at the bf16 tolerance above.
Q_ATOL = 0.03
#: bound on |logits(card, kernels) - logits(CPU, plain)| for the smoke model,
#: whose logits are O(1): the decode attention kernels keep scores and
#: weights (and dequantized int8 K/V) in fp32 where the plain path rounds
#: them to bf16
SMOKE_LOGITS_BOUND = 0.25
#: |apr_conv - plain| <= CONV_RTOL * |plain| + CONV_RTOL * max |plain|: both
#: sum exact fp32 products in fp32 (no TF32), in another order
CONV_RTOL = 2e-4
#: bound on max |logits diff| / max |logit| between two forwards of a CNN
#: (kernel vs plain, APR vs memory residency): fp32 sum order alone.
#: ResNet-20 has no normalisation, so its logits reach ~1e6 at this init
CNN_LOGITS_RTOL = 1e-4
CNN_BATCH = 256
LLAMA_DECODE_SHAPES = {             # (K, N) -> launches per layer at M = slots
    (4096, 4096): 2,                # wq, wo
    (4096, 1024): 2,                # wk, wv
    (4096, 14336): 2,               # w_gate, w_up
    (14336, 4096): 1,               # w_down
}
LM_HEAD = (4096, 128256)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters: int, warmup: int = 3,
            fill: float = 2e5) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls, between
    two CUDA events.  The stream is held busy first (``torch.cuda._sleep``,
    ``fill`` cycles per call) while the host enqueues every call, so the
    events time the kernels back to back and not the host's launch rate."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * fill))      # 2e5: ~0.1 ms per call
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S) -> dict:
    """The least time the card could take: bytes moved over its memory
    rate or operations over its peak rate for their type (bf16 by
    default), whichever is larger."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return dict(bound_ms=max(t_mem, t_ops), t_mem_ms=t_mem, t_ops_ms=t_ops,
                bound_by="bytes" if t_mem >= t_ops else "operations")


def max_err(got, ref, atol: float = ATOL) -> tuple:
    """(max |got - ref|, whether every element is within tolerance)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    ok = bool((diff <= BF16_RTOL * r.abs() + atol).all()) and \
        bool(g.isfinite().all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def conv_err(got, ref) -> tuple:
    """(max |got - ref|, whether every element is within the conv
    tolerance and finite)."""
    diff = (got - ref).abs()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    ok = bool((diff <= CONV_RTOL * ref.abs() + CONV_RTOL * scale).all()) \
        and bool(got.isfinite().all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def profile_device(torch, fn, reps: int, host=None, counts=None):
    """Device milliseconds per call of ``fn()``, by kernel name, over
    ``reps`` calls traced by ``torch.profiler`` (device-side events only: an
    aten op's own row repeats its kernels); None where the profiler cannot
    trace, since it is a measurement and not a phase.  A dict passed as
    ``host`` receives the host milliseconds per call by op (self CPU
    time) of the same trace, one passed as ``counts`` the device events
    (kernels, copies) per call by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"    profiler unavailable on this machine: {e}")
        return None
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            if host is not None and ev.self_cpu_time_total > 0:
                host[ev.key] = ev.self_cpu_time_total / 1e3 / reps
            continue
        t = ev.self_device_time_total / 1e3 / reps
        if t > 0:
            by_kernel[ev.key] = t
            if counts is not None:
                counts[ev.key] = ev.count / reps
    if not by_kernel:
        print("    profiler recorded no device time")
    return by_kernel


def rel_logits_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


# ------------------------------------------- recurrent families (B9, B10)
#: the recurrent serving path: full-width rwkv6-3b and mamba2-2.7b, 4 slots,
#: prefill chunks of 16, 6 requests on 4 slots (two admitted mid-flight)
RECURRENT_ARCHS = ("rwkv6-3b", "mamba2-2.7b")
RECURRENT_PROMPTS = (24, 57, 96, 40, 33, 70)
RECURRENT_NEW = 16
#: apr_matmul launches per token-forward, counted from the code: rwkv6 has
#: wr, wk, wv, wg, wo, wA, wB, ck, cv, cr in each of 32 layers plus the
#: lm_head; mamba2 w_in and w_out in each of 64 layers plus the lm_head.
#: Phase 7 confirms both on the card.
APR_PER_FORWARD = {"rwkv6-3b": 10 * 32 + 1, "mamba2-2.7b": 2 * 64 + 1}
#: the state pools of 4 slots (StateCache.pool_slots = 2 + 4 * 2 = 10),
#: computed from the configs: rwkv6 32 x 10 x (2 bf16 rows of 2560 + 40
#: fp32 64x64 matrices), mamba2 64 x 10 x (3 x 5376 fp32 conv rows + 80
#: fp32 64x128 states)
STATE_POOL_BYTES = {"rwkv6-3b": 212_992_000, "mamba2-2.7b": 1_719_009_280}
#: the scans' fp32 state, kernel against plain version: the same fp32
#: recurrence, the kernel with FMAs and y's sum in another order;
#: |kernel - plain| <= STATE_RTOL * (|plain| + max |plain|)
STATE_RTOL = 1e-4
#: the scans' y: |kernel - plain| <= BF16_RTOL * |plain| + SCAN_ATOL_REL *
#: max |plain| -- one bf16 ulp where both round the output to bf16, plus
#: the fp32 sum-order difference on the scale of the largest output
SCAN_ATOL_REL = 1e-4


def scan_err(got, ref, rtol: float, atol_rel: float) -> tuple:
    """(max |got - ref|, max |got - ref| / max |ref|, within tolerance)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    scale = float(r.abs().max()) if r.numel() else 0.0
    ok = bool((diff <= rtol * r.abs() + atol_rel * scale).all()) and \
        bool(g.isfinite().all())
    mx = float(diff.max()) if diff.numel() else 0.0
    return mx, mx / max(scale, 1e-30), ok


def rwkv_inputs(torch, gen, dev, b, t, h, d, dtype, init):
    """r, k, v, w, u as the model makes them (w = exp(-exp(.)) in fp32,
    down to ~1e-24), and a nonzero initial state when ``init``."""
    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    r, k, v = (rn(b, t, h, d, scale=0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((b, t, h, d), generator=gen,
                                        device=dev) * 12 - 8))
    u = rn(h, d, scale=0.1).to(dtype)
    s0 = rn(b, h, d, d, scale=0.5) if init else None
    return (r, k, v, w, u), s0


def mamba_inputs(torch, gen, dev, b, t, h, p, n, dtype, init, strided):
    """x, b, c, dt, a, d as the model makes them; with ``strided`` x, b and
    c are column slices of one (B, T, H·P + 2N) tensor, as the fused
    in-projection hands them over."""
    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    if strided:
        big = rn(b, t, h * p + 2 * n, scale=0.5).to(dtype)
        x = big[..., :h * p].reshape(b, t, h, p)
        bm, cm = big[..., h * p:h * p + n], big[..., h * p + n:]
    else:
        x, bm, cm = (rn(*s, scale=0.5).to(dtype)
                     for s in ((b, t, h, p), (b, t, n), (b, t, n)))
    dt = torch.nn.functional.softplus(rn(b, t, h) - 1.0)
    a = -torch.exp(rn(h, scale=0.5))
    d = rn(h)
    h0 = rn(b, h, p, n, scale=0.5) if init else None
    return (x, bm, cm, dt, a, d), h0


def single_mean_square(xf):
    """``rms_norm``'s variance as one mean over d, the CPU path's formula
    (``layers.mean_square`` takes it over 16 groups on the card)."""
    return (xf * xf).mean(dim=-1, keepdim=True)


def norm_invariance(torch, gen, dev, rows: int = 256) -> list:
    """The variance of ``rms_norm`` (``layers.mean_square``) of the same bf16
    rows taken one row at a time (B = 1, a paged prefill step) and inside
    batches of 4 and 16 (the slot engine's and larger): the rows whose fp32
    result differs by any bit, out of ``rows``, at the widths the models
    norm (d_model 2560 and 4096, mamba2's d_inner 5120).  The shipped
    grouped mean must differ in none; the single mean over d (the CPU
    path's formula, run on the card) is printed beside it."""
    from repro_torch.models.layers import mean_square

    out = []
    for d in (2560, 4096, 5120):
        xf = torch.randn((rows, 1, d), generator=gen, device=dev).to(
            torch.bfloat16).float()
        for name, fn in (("grouped", mean_square),
                         ("single", single_mean_square)):
            alone = torch.cat([fn(xf[i:i + 1]) for i in range(rows)])
            for b in (4, 16):
                inside = torch.cat([fn(xf[i:i + b])
                                    for i in range(0, rows, b)])
                out.append(dict(d=d, mean=name, batch=b, rows=rows,
                                rows_differ=int((alone != inside).sum())))
    return out


def scan_correctness(torch, gen, dev) -> list:
    """Phase 2 for B9 and B10: each kernel against its plain version, y and
    the state out, at the decode shape (B = 4, T = 1, full-width heads, a
    nonzero state), at prefill shapes (T = 1024 and a ragged 1000, B = 1
    and 4, from zeros and from a nonzero state), at the smoke shapes and at
    ragged head sizes.  Returns (kernel, case, max abs, max rel, ok) rows."""
    from repro_torch.kernels.mamba2 import mamba2_ref, mamba2_ssd
    from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv6_wkv
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    for b, t, h, d, dtype, init in [
            (4, 1, 40, 64, bf, True),                # decode tick
            (1, 1024, 40, 64, bf, False), (1, 1024, 40, 64, bf, True),
            (4, 1024, 40, 64, bf, False), (1, 1000, 40, 64, bf, False),
            (4, 1000, 40, 64, bf, True),
            (2, 13, 4, 16, bf, True),                # smoke heads
            (2, 9, 3, 48, f32, True), (1, 5, 2, 128, bf, True),
            (3, 7, 2, 80, f32, False)]:
        args, s0 = rwkv_inputs(torch, gen, dev, b, t, h, d, dtype, init)
        y, s = rwkv6_wkv(*args, s_init=s0, return_state=True)
        y_only = rwkv6_wkv(*args, s_init=s0)
        yr, sr = rwkv6_ref(*args, s_init=s0, return_state=True)
        torch.cuda.synchronize()
        ey, ry, oky = scan_err(y, yr, BF16_RTOL, SCAN_ATOL_REL)
        es, rs, oks = scan_err(s, sr, STATE_RTOL, STATE_RTOL)
        rows.append(("rwkv6_wkv", f"B={b} T={t} H={h} D={d} "
                     f"{str(dtype)[6:]} {'state in' if init else 'zeros'} "
                     f"y rel={ry:.2g} state abs={es:.2g} rel={rs:.2g}",
                     ey, oky and oks and torch.equal(y, y_only)))
    for b, t, h, p, n, dtype, init, strided in [
            (4, 1, 80, 64, 128, f32, True, True),    # decode tick (fp32 x)
            (1, 1024, 80, 64, 128, bf, False, True),
            (1, 1024, 80, 64, 128, bf, True, False),
            (4, 1024, 80, 64, 128, bf, False, True),
            (1, 1000, 80, 64, 128, bf, False, False),
            (4, 1000, 80, 64, 128, bf, True, True),
            (2, 13, 8, 16, 16, bf, True, True),      # smoke heads
            (2, 9, 3, 48, 80, bf, True, False), (3, 7, 2, 32, 112, f32,
                                                 False, True)]:
        args, h0 = mamba_inputs(torch, gen, dev, b, t, h, p, n, dtype, init,
                                strided)
        y, s = mamba2_ssd(*args, h_init=h0, return_state=True)
        y_only = mamba2_ssd(*args, h_init=h0)
        yr, sr = mamba2_ref(*args, h_init=h0, return_state=True)
        torch.cuda.synchronize()
        ey, ry, oky = scan_err(y, yr, BF16_RTOL, SCAN_ATOL_REL)
        es, rs, oks = scan_err(s, sr, STATE_RTOL, STATE_RTOL)
        rows.append(("mamba2_ssd", f"B={b} T={t} H={h} P={p} N={n} "
                     f"{str(dtype)[6:]} {'state in' if init else 'zeros'}"
                     f"{' strided' if strided else ''} y rel={ry:.2g} state "
                     f"abs={es:.2g} rel={rs:.2g}", ey,
                     oky and oks and torch.equal(y, y_only)))
    return rows


#: fp32 operations per state element per step that each recurrence needs
#: (the count behind its operation bound; see :func:`scan_timing`)
RWKV6_OPS_PER_ELEMENT = 5
MAMBA2_OPS_PER_ELEMENT = 5


def rotated(make) -> list:
    """Enough input sets ``(args, state)`` from ``make()`` that cycling
    through them reads at least twice the 50 MB L2 between two uses of one
    set."""
    first = make()
    size = sum(x.numel() * x.element_size()
               for x in (*first[0], first[1]) if x is not None)
    return [first] + [make() for _ in range(-(-100_000_000 // size))]


def scan_timing(torch, gen, dev) -> list:
    """Phase 3 for B9 and B10: CUDA-event ms per launch at the decode tick
    (B = 4, T = 1, state in and out) and at a 1024-token prefill (B = 1,
    from zeros, state out), beside the plain version and the bound.  The
    inputs and the state in are rotated past the L2, as the other phase-3
    rows are, so each launch reads them from HBM.

    The bound is the larger of the streams, y and the state read and
    written once at 3.35 TB/s, and the fp32 operations at the fp32 rate.
    The operations are what the function needs per state element (i, j)
    per step, an FMA counted as two:

    * B9, 5 (:data:`RWKV6_OPS_PER_ELEMENT`): kv = k_i v_j (1), S = w_i S +
      kv (2), y_j += r_i S_ij (2), with the bonus taken out of the element
      loop as v_j sum_i r_i u_i k_i (O(D) per step; the kernel spends 7,
      the literal y_j += r_i (S_ij + u_i kv));
    * B10, 5 (:data:`MAMBA2_OPS_PER_ELEMENT`): (dt x_p) b_n (1, with dt x_p
      formed once per row), h = decay h + upd (2), y_p += h c_n (2).

    No single PyTorch call computes either recurrence, so library_ms is
    None."""
    from repro_torch.kernels.mamba2 import mamba2_ref, mamba2_ssd
    from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv6_wkv
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    for label, b, t, init, dtype in (("decode", 4, 1, True, bf),
                                     ("prefill", 1, 1024, False, bf)):
        h, d = 40, 64
        es = 2
        nbytes = (b * t * h * d * (4 * es + 4) + h * d * es
                  + (2 if init else 1) * b * h * d * d * 4)
        sets = rotated(lambda: rwkv_inputs(torch, gen, dev, b, t, h, d,
                                           dtype, init))
        iters = 200 if t == 1 else 20
        t_k = cuda_ms(torch, lambda i: rwkv6_wkv(
            *sets[i % len(sets)][0], s_init=sets[i % len(sets)][1],
            return_state=True), iters)
        t_p = cuda_ms(torch, lambda i: rwkv6_ref(
            *sets[i % len(sets)][0], s_init=sets[i % len(sets)][1],
            return_state=True), 20 if t == 1 else 2, warmup=1)
        rows.append(dict(kernel="rwkv6_wkv", shape=label, B=b, T=t, H=h,
                         D=d, ms=t_k, plain_ms=t_p, library_ms=None,
                         **bound_ms(nbytes, RWKV6_OPS_PER_ELEMENT
                                    * b * t * h * d * d, FP32_FLOPS_PER_S)))
        del sets
    for label, b, t, init, dtype in (("decode", 4, 1, True, f32),
                                     ("prefill", 1, 1024, False, bf)):
        h, p, n = 80, 64, 128
        es = 2 if dtype == bf else 4
        nbytes = (b * t * (2 * h * p * es + 2 * n * es + 4 * h) + 8 * h
                  + (2 if init else 1) * b * h * p * n * 4)
        sets = rotated(lambda: mamba_inputs(torch, gen, dev, b, t, h, p, n,
                                            dtype, init, True))
        iters = 200 if t == 1 else 20
        t_k = cuda_ms(torch, lambda i: mamba2_ssd(
            *sets[i % len(sets)][0], h_init=sets[i % len(sets)][1],
            return_state=True), iters)
        t_p = cuda_ms(torch, lambda i: mamba2_ref(
            *sets[i % len(sets)][0], h_init=sets[i % len(sets)][1],
            return_state=True), 20 if t == 1 else 2, warmup=1)
        rows.append(dict(kernel="mamba2_ssd", shape=label, B=b, T=t, H=h,
                         P=p, N=n, ms=t_k, plain_ms=t_p, library_ms=None,
                         **bound_ms(nbytes, MAMBA2_OPS_PER_ELEMENT
                                    * b * t * h * p * n, FP32_FLOPS_PER_S)))
        del sets
    torch.cuda.empty_cache()
    return rows


def recurrent_smoke_parity(torch, arch: str, seed: int, dev) -> dict:
    """Phase 5 for the recurrent families: the smoke config on the card
    (B9/B10 and apr_matmul) and on the CPU (plain versions), same weights.
    ``paged``: one prefill chunk of 8 (two rows, one padded after 5) through
    the state pools, then 3 decode ticks, each side fed the CPU's greedy
    tokens; ``prefill``: ``bundle.prefill`` of the 8 tokens (B9/B10 over all
    T on the card, the chunked formula on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    scfg = get_config(arch, smoke=True)
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    bundles = {w: build_model(scfg, device=d) for w, d in devices.items()}
    cpu_params = bundles["cpu"].init_params(
        torch.Generator().manual_seed(seed))
    prm = {"cpu": cpu_params,
           "cuda": {k: v.to(dev) for k, v in cpu_params.items()}}
    rng = np.random.default_rng(seed)
    first = rng.integers(1, scfg.vocab_size, (2, 8)).astype(np.int32)

    def on(where, arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(devices[where])
                for a in arrays]

    def record(out, diffs, flips, step):
        diffs.append(float((out["cpu"] - out["cuda"]).abs().max()))
        nxt, got = out["cpu"].argmax(-1), out["cuda"].argmax(-1)
        for row in torch.nonzero(nxt != got).flatten().tolist():
            flips.append(dict(step=step, row=row, cpu_gap=float(
                out["cpu"][row, nxt[row]] - out["cpu"][row, got[row]])))
        return nxt, int((nxt == got).sum())

    res = {}
    # paged: [2 KV columns | read | T writes]; the chunk's last real token
    # of row 0 writes slot 2, of row 1 slot 3; the rest go to trash slot 1
    caches = {w: b_.init_paged_cache(9, 8, state_slots=6)
              for w, b_ in bundles.items()}
    tokens, counts = first, np.array([8, 5], np.int32)
    lengths = np.zeros(2, np.int32)
    writes = np.ones((2, 8), np.int32)
    writes[0, 7], writes[1, 4] = 2, 3
    tables = np.concatenate([np.zeros((2, 3), np.int32), writes], axis=1)
    diffs, flips, agree = [], [], 0
    for step in range(4):
        out = {}
        for where, b_ in bundles.items():
            logits = b_.decode_paged(prm[where], caches[where],
                                     *on(where, (tokens, lengths, counts,
                                                 tables)))
            out[where] = logits[[0, 1], torch.from_numpy(
                counts - 1).long().to(devices[where])].float().cpu()
        nxt, n_eq = record(out, diffs, flips, step)
        agree += n_eq
        tokens = nxt.numpy()[:, None].astype(np.int32)
        lengths = lengths + counts
        counts = np.ones(2, np.int32)
        tables = np.array([[0, 0, 2, 2], [0, 0, 3, 3]], np.int32)
    res["paged"] = dict(max_abs_logits_diff=max(diffs), per_step=diffs,
                        greedy_agree=agree, greedy_total=8, flips=flips,
                        bound=SMOKE_LOGITS_BOUND)
    out = {w: b_.prefill(prm[w], *on(w, (first,)))[0][:, 0].float().cpu()
           for w, b_ in bundles.items()}
    diffs, flips = [], []
    _, agree = record(out, diffs, flips, 0)
    res["prefill"] = dict(max_abs_logits_diff=diffs[0], per_step=diffs,
                          greedy_agree=agree, greedy_total=2, flips=flips,
                          bound=SMOKE_LOGITS_BOUND)
    return res


def recurrent_serving(torch, arch: str, seed: int, dev, checked, finite,
                      reset_counts, llm_counts, check_served) -> dict:
    """Phase 7: full-width ``arch`` (random bf16 weights from ``seed``) on
    the PagedServeEngine with its StateCache (4 slots, prefill chunks of 16)
    and on the slot ServeEngine, the same 6 requests; greedy tokens must be
    equal, and every launch count must be what the path demands.  Then
    ``bundle.prefill`` of one 1024-token prompt with B9/B10 over all T, held
    to the card's plain path and timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba2 import mamba2_ssd
    from repro_torch.kernels.rwkv6 import rwkv6_wkv
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine

    cfg = get_config(arch)
    scan_name = "rwkv6_wkv" if cfg.family == "ssm" else "mamba2_ssd"
    bundle = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size()
                    for t in params.values()) / 1e9
    per_fwd = APR_PER_FORWARD[arch]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in RECURRENT_PROMPTS]
    forward, decode_step = bundle.decode_paged, bundle.decode_step
    bundle.decode_paged = checked(forward)
    kw = dict(device="cuda", slots=4, page_size=16, prefill_chunk=16)

    def expect(token_forwards: int) -> dict:
        return {**{k: 0 for k in llm_counts()},
                "apr_matmul": per_fwd * token_forwards,
                scan_name: cfg.num_layers * token_forwards}

    # one token-forward alone, to confirm the per-forward counts
    warm = PagedServeEngine(bundle, params, **kw)
    warm.submit(Request(rid=-1, prompt=[1] * 20, max_new_tokens=2))
    warm.run_until_drained()
    reset_counts()
    one = np.zeros((4, 16 + 2), np.int32)
    one[:, 16:] = np.arange(2, 6)[:, None]
    forward(params, warm.cache, *[torch.from_numpy(a).to(dev) for a in (
        np.ones((4, 1), np.int32), np.zeros(4, np.int32),
        np.ones(4, np.int32), one)])
    torch.cuda.synchronize()
    per_forward = llm_counts()
    if per_forward != expect(1):
        fail(f"{arch}: one decode forward launched {per_forward}, expected "
             f"{expect(1)}")
    del warm

    reqs = [Request(rid=i, prompt=p, max_new_tokens=RECURRENT_NEW)
            for i, p in enumerate(prompts)]
    engine = PagedServeEngine(bundle, params, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite.clear()
    reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = llm_counts()
    m = engine.metrics
    token_forwards = engine.prefill_chunk * m.prefill_calls + m.decode_calls
    paged = dict(**m.summary(), wall_s=wall, token_forwards=token_forwards,
                 decode_ms_per_tick=1e3 * m.decode_time_s / m.decode_calls,
                 prefill_ms_per_chunk=1e3 * m.prefill_time_s
                 / m.prefill_calls,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 state_pool_bytes=engine.kv_pool_bytes(),
                 state_pool_slots=engine.state.pool_slots,
                 launches=launches, expected_launches=expect(token_forwards))
    # the least a decode tick at 4 slots could take: every weight but the
    # embedding streamed once, the 4 sequences' state read and written
    live_state = (paged["state_pool_bytes"] * engine.slots
                  / engine.state.pool_slots)
    paged["tick_bound_ms"] = (weight_gb * 1e9 - params["embed"].numel()
                              * params["embed"].element_size()
                              + 2 * live_state) / HBM_BYTES_PER_S * 1e3
    check_served(f"phase 7 {arch} paged", reqs, RECURRENT_NEW, launches,
                 expect(token_forwards))
    if paged["state_pool_bytes"] != STATE_POOL_BYTES[arch]:
        fail(f"{arch}: state pools of {paged['state_pool_bytes']} bytes, "
             f"expected {STATE_POOL_BYTES[arch]}")
    paged_out = [r.output for r in reqs]

    # one decode tick at the phase's prompt lengths, reading and writing
    # state slots 2..5: wall time and the profiled device-idle share
    tick = [torch.from_numpy(a).to(dev) for a in (
        np.ones((4, 1), np.int32), np.asarray(RECURRENT_PROMPTS[:4],
                                              np.int32),
        np.ones(4, np.int32), one)]
    forward(params, engine.cache, *tick)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        forward(params, engine.cache, *tick)
    torch.cuda.synchronize()
    tick_wall = (time.perf_counter() - t0) / 5 * 1e3
    counts = {}
    by_kernel = profile_device(torch, lambda: forward(params, engine.cache,
                                                      *tick), 5,
                               counts=counts)
    if by_kernel:
        busy = sum(by_kernel.values())
        paged["profiled_tick"] = dict(
            wall_ms=tick_wall, device_busy_ms=busy,
            idle_share=1 - busy / tick_wall,
            device_ops=sum(counts.values()), top_kernels_ms=dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:8]))
    else:
        paged["profiled_tick"] = dict(wall_ms=tick_wall)
    bundle.decode_paged = forward
    del engine

    # the slot engine on the same requests
    step_ms = []

    def timed_step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = checked(decode_step)(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return logits

    bundle.decode_step = timed_step
    slot_reqs = [Request(rid=i, prompt=p, max_new_tokens=RECURRENT_NEW)
                 for i, p in enumerate(prompts)]
    slot_engine = ServeEngine(bundle, params, device="cuda", slots=4,
                              max_seq=256)
    step_ms.clear()
    finite.clear()
    reset_counts()
    t0 = time.perf_counter()
    for r in slot_reqs:
        slot_engine.submit(r)
    slot_engine.run_until_drained()
    torch.cuda.synchronize()
    slot_wall = time.perf_counter() - t0
    slot_launches = llm_counts()
    bundle.decode_step = decode_step
    del slot_engine
    same = sum(a == b for r, o in zip(slot_reqs, paged_out)
               for a, b in zip(r.output, o))
    slot = dict(wall_s=slot_wall, forwards=len(step_ms),
                ms_per_forward=float(np.mean(step_ms)),
                ms_per_forward_median=float(np.median(step_ms)),
                mean_ttft_s=float(np.mean([r.ttft for r in slot_reqs])),
                tokens_equal_paged=same,
                tokens_total=sum(len(o) for o in paged_out),
                launches=slot_launches, expected_launches=expect(
                    len(step_ms)))
    check_served(f"phase 7 {arch} slot", slot_reqs, RECURRENT_NEW,
                 slot_launches, expect(len(step_ms)))

    # bundle.prefill of one 1024-token prompt, B9/B10 at T = 1024.  The
    # gate is every layer's scan held to its plain version (the per-step
    # scan of ``ref.py``) on the same inputs, with phase 2's tolerances, and
    # finite logits.  The logits' distance from the card's plain path (the
    # chunked formulas, the models' ``use_scan_kernel`` seam set to False)
    # is printed, not gated: at 32 or 64 layers of random bf16 weights
    # one-ulp roundings grow to tenths or more in the logits whatever the
    # scan, and the two plain versions lie as far apart (``PERF.md``)
    from repro_torch.kernels.mamba2 import mamba2_ref
    from repro_torch.kernels.rwkv6 import rwkv6_ref
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models import ssm as ssm_mod
    mod, fn = ((rwkv_mod, "wkv_chunked") if cfg.family == "ssm"
               else (ssm_mod, "ssd_chunked"))
    scan = getattr(mod, fn)
    layer_errs = []

    def per_step(*a, chunk, s_init=None, h_init=None, return_state=False):
        if cfg.family == "ssm":
            r, k, v, logw, u = a
            return rwkv6_ref(r, k, v, torch.exp(logw.float()), u,
                             s_init=s_init, return_state=return_state)
        return mamba2_ref(*a, h_init=h_init, return_state=return_state)

    def shadowed(*a, **kw):
        out = scan(*a, **kw)
        ref = per_step(*a, **kw)
        layer_errs.append((scan_err(out[0], ref[0], BF16_RTOL, SCAN_ATOL_REL),
                           scan_err(out[1], ref[1], STATE_RTOL, STATE_RTOL)))
        return out

    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 1024))
                              ).to(dev)
    logits, times = {}, {}
    seam = mod.use_scan_kernel
    for impl in ("kernel", "shadow", "plain", "per-step"):
        torch.cuda.synchronize()
        reset_counts()
        setattr(mod, fn, {"shadow": shadowed, "per-step": per_step}.get(
            impl, scan))
        if impl == "plain":
            mod.use_scan_kernel = lambda x: False
        t0 = time.perf_counter()
        try:
            out, _ = bundle.prefill(params, prompt)
            torch.cuda.synchronize()
        finally:
            setattr(mod, fn, scan)
            mod.use_scan_kernel = seam
        times[impl] = time.perf_counter() - t0
        logits[impl] = out[0, 0, :cfg.vocab_size].float()
        if impl == "kernel":
            prefill_launches = llm_counts()

    def diff(a, b):
        return float((logits[a] - logits[b]).abs().max())

    err_k, err_pp = diff("kernel", "plain"), diff("per-step", "plain")
    y_rel = max(e[0][1] for e in layer_errs)
    s_rel = max(e[1][1] for e in layer_errs)
    prefill = dict(tokens=1024, kernel_ms=1e3 * times["kernel"],
                   plain_ms=1e3 * times["plain"],
                   per_step_plain_ms=1e3 * times["per-step"],
                   max_abs_logits_diff=err_k, plain_pair_diff=err_pp,
                   max_abs_logit=float(logits["plain"].abs().max()),
                   argmax_equal=bool(torch.equal(logits["kernel"].argmax(),
                                                 logits["plain"].argmax())),
                   layers_checked=len(layer_errs), layer_y_max_rel=y_rel,
                   layer_state_max_rel=s_rel,
                   layers_ok=all(e[0][2] and e[1][2] for e in layer_errs),
                   launches=prefill_launches, expected_launches=expect(1))
    if prefill_launches != expect(1):
        fail(f"{arch}: the 1024-token prefill launched {prefill_launches}, "
             f"expected {expect(1)}")
    if not prefill["layers_ok"] or len(layer_errs) != cfg.num_layers:
        fail(f"{arch}: a layer's scan at T = 1024 disagrees with its plain "
             f"version on the same inputs (y rel {y_rel:.3g}, state rel "
             f"{s_rel:.3g})")
    if not all(bool(v.isfinite().all()) for v in logits.values()):
        fail(f"{arch}: 1024-token prefill logits are not finite")
    del params
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=cfg.num_layers, weight_gb=weight_gb,
                init_s=init_s, per_forward_launches=per_forward, paged=paged,
                slot=slot, prefill_1024=prefill, tokens_equal=same)


# ------------------- matmul families (B1 tiles, B4m, B6, B7m, B8) and tuning
#: the M of the llama3-8b projections: a decode tick over 4 slots, a
#: prefill chunk of 16
PROJ_MS = (4, 16)
#: ragged matmul shapes held at every tile: none a multiple of the tiles
RAGGED_MKN = [(m, k, n) for m in (1, 4, 5, 16) for k in (96, 4096, 14336)
              for n in (40, 1024, 14336)]
ACTIVATIONS = ("none", "relu", "silu", "gelu")
#: silu and gelu of the int8 kernels against the plain version: within 2
#: fp32 ulps of max(|result|, |pre-activation|), before the final rounding
#: (expf / tanhf may round apart; for gelu's cancellation in 1 + tanh the
#: pre-activation's scale is what an ulp of error means)
ACT_ULPS = 2
#: published dense int8 tensor-core peak of one H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
#: candidates phase 8's pruned sweep times: half the matmul families' six
#: tiles (benchmarks/bench_kernels.py:prune_top_k)
PRUNE_TOP_K = 3


def ulps_apart(torch, got, ref, pre) -> float:
    """max |got - ref| in fp32 ulps of max(|ref|, |pre|)."""
    scale = torch.maximum(ref.abs(), pre.abs())
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
    return float(((got.float() - ref).abs() / ulp).max())


def tile_config(tile):
    from repro_torch.bench import BlockConfig
    return BlockConfig.make(block_m=tile[0], block_n=tile[1],
                            block_k=tile[2])


def matmul_family_correctness(torch, gen, dev) -> list:
    """Phase 2 for the matmul families, at the llama3-8b projection shapes
    and the ragged ones, at every tile each kernel compiles: B1 against its
    plain version (bf16 tolerance), B4m equal to B1 at the same tile bit for
    bit, B7m (every activation, bias and none, bf16 and fp32 out) at B1's
    tolerance, B6 and B8 with none/relu bit for bit and with silu/gelu
    within ACT_ULPS fp32 ulps (bf16 out: one bf16 ulp).  One case per
    (kernel, shape), its largest error over tiles and variants."""
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.kernels.apr_matmul.ref import matmul_fused_ref, matmul_ref
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.kernels.quant_matmul.ref import (quant_matmul_fused_ref,
                                                      quant_matmul_ref)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    shapes = [(m, k, n) for m in PROJ_MS for k, n in LLAMA_DECODE_SHAPES]
    for m, k, n in shapes + RAGGED_MKN:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
             ).to(bf16)
        bias = torch.randn((n,), generator=gen, device=dev)
        wq, ws = qm.quantize_weights(w.float())
        stats = {name: [0.0, True, 0] for name in (
            "apr_matmul", "apr_matmul_hbm", "apr_matmul_fused",
            "quant_matmul", "quant_matmul_fused")}

        def note(name, err, ok):
            s = stats[name]
            s[0], s[1], s[2] = max(s[0], err), s[1] and ok, s[2] + 1

        for out in (bf16, f32):
            ref = matmul_ref(x, w, out)
            fused = {(act, bb is None): matmul_fused_ref(x, w, bb, act, out)
                     for act in ACTIVATIONS for bb in (None, bias)}
            for tile in mm.TILES:
                cfg = tile_config(tile)
                b1 = mm.apr_matmul(x, w, out_dtype=out, config=cfg)
                b4 = mm.apr_matmul(x, w, out_dtype=out, config=cfg,
                                   residency="hbm")
                note("apr_matmul", *max_err(b1, ref))
                note("apr_matmul_hbm", max_err(b4, ref)[0],
                     torch.equal(b4, b1))
                for (act, nobias), r in fused.items():
                    got = mm.apr_matmul_fused(
                        x, w, None if nobias else bias, activation=act,
                        out_dtype=out, config=cfg)
                    note("apr_matmul_fused", *max_err(got, r))
            qref = quant_matmul_ref(x, wq, ws, out)
            qfused = {}
            for act in ACTIVATIONS:
                for bb in (None, bias):
                    r = quant_matmul_fused_ref(x, wq, ws, bb, act, out)
                    pre = quant_matmul_fused_ref(x, wq, ws, bb, "none", f32)
                    r32 = quant_matmul_fused_ref(x, wq, ws, bb, act, f32)
                    qfused[(act, bb is None)] = (r, pre, r32)
            for tile in qm.TILES:
                cfg = tile_config(tile)
                got = qm.quant_matmul(x, wq, ws, out_dtype=out, config=cfg)
                note("quant_matmul", max_err(got, qref)[0],
                     torch.equal(got, qref))
                for (act, nobias), (r, pre, r32) in qfused.items():
                    got = qm.quant_matmul_fused(
                        x, wq, ws, None if nobias else bias, activation=act,
                        out_dtype=out, config=cfg)
                    err = max_err(got, r)[0]
                    if act in ("none", "relu"):
                        ok = torch.equal(got, r)
                    elif out == f32:
                        ok = ulps_apart(torch, got, r32, pre) <= ACT_ULPS
                    else:
                        ok = max_err(got, r)[1]
                    note("quant_matmul_fused", err, ok)
        torch.cuda.synchronize()
        for name, (err, ok, n_var) in stats.items():
            cases.append((name, f"M={m} K={k} N={n} ({n_var} tile/variant "
                          f"runs)", err, ok))
        del x, w, bias, wq, ws, fused, qfused
    return cases


def matmul_family_timing(torch, gen, dev, slots: int) -> list:
    """Phase 3 for B4m, B7m, B6 and B8 at the llama3-8b projection shapes
    (M = slots and 16), weights rotated past the 50 MB L2, output bf16,
    default tiles: B4m beside B1 (the paper's comparison at matmul level),
    B7m with bias + silu, B6, B8 with bias + silu.  The int8 rows include
    the activations' quantization; their library yardstick is that
    quantization, ``torch._int_mm`` and the two scale multiplies (+ bias and
    silu for B8), at M = 32 where M <= 16 (``_int_mm`` needs M > 16)."""
    import torch.nn.functional as F
    from repro_torch.core.apr import reduction_hbm_traffic
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.kernels.apr_matmul.ref import matmul_fused_ref, matmul_ref
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.kernels.quant_matmul.ref import (quant_matmul_fused_ref,
                                                      quant_matmul_ref,
                                                      quantize_activations)
    bf16 = torch.bfloat16
    rows = []
    for m in (slots, 16):
        for k, n in LLAMA_DECODE_SHAPES:
            nbuf = min(32, max(1, math.ceil(200e6 / (k * n * 2))))
            ws = [(torch.randn((k, n), generator=gen, device=dev)
                   * k ** -0.5).to(bf16) for _ in range(nbuf)]
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            bias = torch.randn((n,), generator=gen, device=dev)
            bias16 = bias.to(bf16)
            steps = -(-k // mm.DEFAULT_TILE[2])
            t_b1 = cuda_ms(torch, lambda i: mm.apr_matmul(
                x, ws[i % nbuf], out_dtype=bf16), 60)
            t_h = cuda_ms(torch, lambda i: mm.apr_matmul(
                x, ws[i % nbuf], out_dtype=bf16, residency="hbm"), 20,
                fill=2e5 * steps)
            t_p = cuda_ms(torch, lambda i: matmul_ref(x, ws[i % nbuf], bf16),
                          60)
            t_l = cuda_ms(torch, lambda i: torch.matmul(x, ws[i % nbuf]), 60)
            mm_bound = bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n)
            partial = (reduction_hbm_traffic(m * n, steps, 2, "hbm")
                       - reduction_hbm_traffic(m * n, steps, 2, "apr"))
            rows.append(dict(kernel="apr_matmul_hbm", M=m, K=k, N=n, ms=t_h,
                             apr_ms=t_b1, plain_ms=t_p, library_ms=t_l,
                             hbm_steps=steps, partial_bytes=partial,
                             weight_buffers=nbuf, **mm_bound))
            t_f = cuda_ms(torch, lambda i: mm.apr_matmul_fused(
                x, ws[i % nbuf], bias, activation="silu", out_dtype=bf16), 60)
            t_fp = cuda_ms(torch, lambda i: matmul_fused_ref(
                x, ws[i % nbuf], bias, "silu", bf16), 60)
            t_fl = cuda_ms(torch, lambda i: F.silu(torch.addmm(
                bias16, x, ws[i % nbuf])), 60)
            rows.append(dict(kernel="apr_matmul_fused", M=m, K=k, N=n,
                             ms=t_f, plain_ms=t_fp, library_ms=t_fl,
                             epilogue="bias + silu", weight_buffers=nbuf,
                             **bound_ms(2 * (m * k + k * n + m * n) + 4 * n,
                                        2 * m * k * n + 2 * m * n)))
            qs = [qm.quantize_weights(w.float()) for w in ws]
            del ws
            # cuBLASLt's int8 GEMM takes the weight column-major
            qcol = [wq.t().contiguous().t() for wq, _ in qs]
            m_lib = max(m, 32)
            x_lib = torch.randn((m_lib, k), generator=gen, device=dev).to(bf16)

            def lib_q(i, act=None):
                q, s = quantize_activations(x_lib)
                y = torch._int_mm(q, qcol[i % nbuf]) * s * qs[i % nbuf][1]
                if act:
                    y = F.silu(y + bias)
                return y.to(bf16)

            # ~10 PyTorch ops a call: the stream is held busy 0.5 ms per
            # call, longer than the host takes to enqueue one
            q_bytes = 2 * m * k + k * n + 4 * n + 2 * m * n
            t_q = cuda_ms(torch, lambda i: qm.quant_matmul(
                x, *qs[i % nbuf], out_dtype=bf16), 60, fill=1e6)
            t_qp = cuda_ms(torch, lambda i: quant_matmul_ref(
                x, *qs[i % nbuf], bf16), 20, fill=1e6)
            t_ql = cuda_ms(torch, lib_q, 60, fill=1e6)
            t_qa = cuda_ms(torch, lambda i: quantize_activations(x), 60,
                           fill=1e6)
            rows.append(dict(kernel="quant_matmul", M=m, K=k, N=n, ms=t_q,
                             plain_ms=t_qp, library_ms=t_ql,
                             library_m=m_lib, quantize_ms=t_qa,
                             weight_buffers=nbuf,
                             **bound_ms(q_bytes, 2 * m * k * n,
                                        INT8_OPS_PER_S)))
            t_g = cuda_ms(torch, lambda i: qm.quant_matmul_fused(
                x, *qs[i % nbuf], bias, activation="silu", out_dtype=bf16), 60,
                fill=1e6)
            t_gp = cuda_ms(torch, lambda i: quant_matmul_fused_ref(
                x, *qs[i % nbuf], bias, "silu", bf16), 20, fill=1e6)
            t_gl = cuda_ms(torch, lambda i: lib_q(i, "silu"), 60, fill=1e6)
            rows.append(dict(kernel="quant_matmul_fused", M=m, K=k, N=n,
                             ms=t_g, plain_ms=t_gp, library_ms=t_gl,
                             library_m=m_lib, quantize_ms=t_qa,
                             epilogue="bias + silu", weight_buffers=nbuf,
                             **bound_ms(q_bytes + 4 * n, 2 * m * k * n,
                                        INT8_OPS_PER_S)))
            del qs, qcol, x, x_lib
    return rows


def tuning_shapes(engine) -> list:
    """Phase 8's (family, shape) list at full width: the paged engine's
    ``_decode_kernel_shapes()``, the four matmul families (and B4m) at the
    llama3-8b projection shapes, and every other registered family at the
    shape its serving path gives it: the int8 engine's paged attention,
    the slot engine's contiguous attention at max_seq 256, a ResNet-20 conv
    at batch 256, the rwkv6-3b and mamba2-2.7b decode scans."""
    shapes = list(engine._decode_kernel_shapes())
    attn = dict(next(s for f, s in shapes if f == "flash_decode_paged"))
    shapes.append(("flash_decode_paged", {**attn, "kv_int8": 1}))
    for m in PROJ_MS:
        for k, n in LLAMA_DECODE_SHAPES:
            mkn = {"m": m, "k": k, "n": n}
            shapes += [("apr_matmul", mkn), ("apr_matmul", {**mkn, "hbm": 1}),
                       ("apr_matmul_fused", mkn), ("quant_matmul", mkn),
                       ("quant_matmul_fused", mkn)]
    conv = {"b": CNN_BATCH, "h": 32, "w": 32, "c": 16, "hf": 3, "wf": 3,
            "m": 16, "stride": 1, "padding": 1}
    shapes += [("flash_decode", {"b": attn["b"], "hq": attn["hq"],
                                 "hkv": attn["hkv"], "d": attn["d"],
                                 "s": 256}),
               ("apr_conv", conv), ("apr_conv_fused", conv),
               ("rwkv6", {"b": 4, "t": 1, "h": 40, "d": 64}),
               ("mamba2", {"b": 4, "t": 1, "h": 80, "p": 64, "n": 128})]
    seen, unique = set(), []
    for fam, shape in shapes:
        key = (fam, tuple(sorted(shape.items())))
        if key not in seen:
            seen.add(key)
            unique.append((fam, shape))
    return unique


def exhaustive_sweep(torch, shapes, scratch_path, dev) -> dict:
    """Phase 8's yardstick: every (family, shape) swept exhaustively into a
    scratch cache that is never written; with each, the bound of the
    function at that shape (its inputs read once, its output written once,
    or its operations at the peak of their type)."""
    from repro_torch.bench import ConfigCache, autotune, get_spec
    scratch = ConfigCache(scratch_path, autosave=False)
    out = {}
    for fam, shape in shapes:
        spec = get_spec(fam)
        res = autotune(spec, shape, dtype="bfloat16", device=dev,
                       cache=scratch)
        args = spec.make_inputs(shape, "bfloat16", 0, dev)
        y = spec.run(args, spec.default_config(shape))
        nbytes = sum(t.numel() * t.element_size() for t in (*args, y)
                     if isinstance(t, torch.Tensor))
        peak = (INT8_OPS_PER_S if fam.startswith("quant") else
                FP32_FLOPS_PER_S if fam in ("apr_conv", "apr_conv_fused",
                                            "rwkv6", "mamba2")
                else BF16_FLOPS_PER_S)
        out[f"{fam}|{spec.shape_key(shape)}"] = (
            res, bound_ms(nbytes, spec.flops(shape), peak))
        del args, y
    torch.cuda.synchronize()
    return out


def compare_sweeps(shapes, exhaustive, pruned) -> list:
    """Per (family, shape): the pruned sweep's winner, time, spread and
    prediction against the exhaustive one, and whether they agree by the
    reference's rule (the same config, a predicted tie within 1 %, or times
    within the two runs' spreads; benchmarks/bench_kernels.py:12-18)."""
    from repro_torch.bench import get_spec
    from repro_torch.cost import get_profile, rank_candidates
    h100 = get_profile("h100_sxm")
    rows = []
    for fam, shape in shapes:
        spec = get_spec(fam)
        key = f"{fam}|{spec.shape_key(shape)}"
        (ex, bound), pr = exhaustive[key], pruned[key]
        cands = spec.candidates(shape)
        pred = {cfg: est.predicted_us for cfg, est in rank_candidates(
            spec, shape, cands, profile=h100, dtype="bfloat16")}
        ok = pr.ok and ex.ok
        tie = ok and abs(pred[pr.config] - pred[ex.config]) <= \
            0.01 * max(pred[pr.config], pred[ex.config])
        noise = ok and abs(pr.us - ex.us) <= pr.spread_us + ex.spread_us
        rows.append(dict(
            family=fam, shape=dict(shape), shape_key=spec.shape_key(shape),
            winner=pr.config.to_dict() if pr.ok else None,
            us=pr.us, spread_us=pr.spread_us, predicted_us=pr.predicted_us,
            bound_us=bound["bound_ms"] * 1e3, bound_by=bound["bound_by"],
            candidates=len(cands), timed=pr.n_timed,
            rejected=[(c.to_dict(), why)
                      for c, why in pr.rejected + ex.rejected],
            exhaustive_winner=ex.config.to_dict() if ex.ok else None,
            exhaustive_us=ex.us, exhaustive_spread_us=ex.spread_us,
            exhaustive_timed=ex.n_timed,
            agree=("no" if not ok else "same" if pr.config == ex.config
                   else "predicted tie" if tie else "within spread" if noise
                   else "no")))
    return rows


def tuning_path(torch, seed: int, dev, tmpdir, engine_kw, prompts,
                bf16_outputs, checked, finite, reset_counts, llm_counts,
                expected_counts, check_served) -> dict:
    """Phase 8: the tuning layer's main path at llama3-8b full width -- the
    counted window is ``warm_cache(sweep=True, prune_top_k)`` over every
    family inside a scope over a fresh cache file, then the paged engine
    built on that file serving phase 4's requests; the exhaustive sweep
    before it is the pruning's yardstick, outside the window.  Fails unless
    no candidate is rejected, every pruned winner agrees with the
    exhaustive one, ``tuned_configs`` holds the winners, the engine
    launches the tuned tiles and every kernel of the path launched."""
    from repro_torch.bench import ConfigCache, scoped_cache, warm_cache
    from repro_torch.configs import get_config
    from repro_torch.kernels.apr_conv import apr_conv2d, apr_conv2d_fused
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.kernels.apr_matmul import ops as apr_ops
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServeEngine, Request
    cfg = get_config("llama3-8b")
    slots = engine_kw["slots"]
    per_call = 7 * cfg.num_layers + 1
    bundle = build_model(cfg, device=dev)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(
        seed))
    forward = bundle.decode_paged
    bundle.decode_paged = checked(forward)
    shapes = tuning_shapes(PagedServeEngine(bundle, params, **engine_kw))
    t0 = time.perf_counter()
    exhaustive = exhaustive_sweep(torch, shapes,
                                  Path(tmpdir) / "exhaustive.json", dev)
    exhaustive_s = time.perf_counter() - t0
    tune_path = Path(tmpdir) / "tune_cache.json"
    pruned = {}
    reset_counts()
    t0 = time.perf_counter()
    with scoped_cache(ConfigCache(tune_path)):
        winners = warm_cache(shapes, dtype="bfloat16", device=dev,
                             sweep=True, prune_top_k=PRUNE_TOP_K,
                             results=pruned)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    engine = PagedServeEngine(bundle, params, tune_cache=str(tune_path),
                              **engine_kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    before, tiles_before = llm_counts(), dict(apr_matmul.tile_launches)
    finite.clear()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    path_launches = llm_counts()          # the whole counted window
    path_launches.update(apr_conv=apr_conv2d.launches,
                         apr_conv_fused=apr_conv2d_fused.launches)
    serve_launches = {k: v - before[k] for k, v in llm_counts().items()}
    serve_tiles = {t: n - tiles_before.get(t, 0)
                   for t, n in apr_matmul.tile_launches.items()
                   if n - tiles_before.get(t, 0)}
    m = engine.metrics
    # the tile every projection of the served forwards resolves to under
    # the engine's cache: M = slots at a decode tick, the chunk at prefill
    expect_tiles = {}
    with scoped_cache(engine.tune_cache):
        for rows_m, calls in ((slots, m.decode_calls),
                              (engine_kw["prefill_chunk"], m.prefill_calls)):
            for (k, n), cnt in list(LLAMA_DECODE_SHAPES.items()) + [
                    (LM_HEAD, 1 / cfg.num_layers)]:
                tile = apr_ops.resolve_tile("apr_matmul", rows_m, k, n,
                                            "bfloat16", dev.type)
                expect_tiles[tile] = expect_tiles.get(tile, 0) + int(round(
                    cnt * cfg.num_layers * calls))
    rows = compare_sweeps(shapes, exhaustive, pruned)
    tuned_ok = {key: cfg_ is not None and cfg_ == winners[key]
                for key, cfg_ in engine.tuned_configs.items()}
    same = sum(a == b for r, o in zip(reqs, bf16_outputs)
               for a, b in zip(r.output, o))
    tuning = dict(
        shapes=len(shapes), exhaustive_s=exhaustive_s, sweep_s=sweep_s,
        serve_s=serve_s, prune_top_k=PRUNE_TOP_K, rows=rows,
        timed_pruned=sum(r["timed"] for r in rows),
        timed_exhaustive=sum(r["exhaustive_timed"] for r in rows),
        tuned_configs={k: v.to_dict() if v else None
                       for k, v in engine.tuned_configs.items()},
        launches=path_launches, serve_launches=serve_launches,
        serve_tile_launches={str(t): n for t, n in serve_tiles.items()},
        expected_serve_tile_launches={str(t): n for t, n in
                                      expect_tiles.items()},
        tokens_equal_untuned=same, decode_ms_per_tick=1e3 * m.decode_time_s
        / m.decode_calls, decode_tps=m.decode_tps)
    print(f"[8] tuning path, full-width {cfg.name}: {len(shapes)} (family, "
          f"shape)s swept exhaustively in {exhaustive_s:.1f} s, then "
          f"warm_cache(sweep=True, prune_top_k={PRUNE_TOP_K}) in a scope "
          f"over a fresh cache file in {sweep_s:.1f} s; candidates timed "
          f"{tuning['timed_pruned']} pruned against "
          f"{tuning['timed_exhaustive']} exhaustive (bf16 inputs; bound: "
          f"inputs read and output written once at "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s, or the operations at their "
          f"peak):")
    for r in rows:
        shape = " ".join(f"{k}={v}" for k, v in r["shape"].items())
        print(f"    {r['family']:19s} {shape:42s} winner "
              f"{r['winner']} {r['us']:9.2f} us (spread "
              f"{r['spread_us']:.2f}) bound {r['bound_us']:8.2f} us "
              f"({r['bound_by']}) predicted "
              + (f"{r['predicted_us']:8.2f}" if r["predicted_us"] is not None
                 else "    none")
              + f" us; timed {r['timed']}/{r['candidates']}, exhaustive "
              f"{r['exhaustive_winner']} {r['exhaustive_us']:.2f} us "
              f"({r['exhaustive_timed']} timed): {r['agree']}")
    print(f"    PagedServeEngine(tune_cache=...): {m.requests_done}/"
          f"{len(reqs)} requests in {serve_s:.2f} s, "
          f"{tuning['decode_ms_per_tick']:.3f} ms per decode tick; "
          f"tuned_configs {tuning['tuned_configs']}; apr_matmul launches by "
          f"tile {tuning['serve_tile_launches']} (expected from the tuned "
          f"cache {tuning['expected_serve_tile_launches']}); greedy tokens "
          f"equal to phase 4's untuned run {same}/"
          f"{sum(len(o) for o in bf16_outputs)} (information)")
    print(f"    launches of the counted window (sweep + serve): "
          f"{path_launches}")
    bad = [r for r in rows if r["rejected"]]
    if bad:
        fail(f"phase 8: candidates rejected: "
             f"{[(r['family'], r['rejected']) for r in bad]}")
    if any(r["agree"] == "no" for r in rows):
        fail("phase 8: a pruned sweep missed the exhaustive winner beyond "
             "the timer spreads")
    if not tuned_ok or not all(tuned_ok.values()):
        fail(f"phase 8: tuned_configs {engine.tuned_configs} do not hold "
             f"the winners")
    if serve_tiles != expect_tiles:
        fail(f"phase 8: served tiles {serve_tiles} != tuned {expect_tiles}")
    check_served("phase 8", reqs, 16, serve_launches, expected_counts(
        apr_matmul=per_call * (m.decode_calls + m.prefill_calls),
        flash_decode_paged=cfg.num_layers * m.decode_calls))
    unlaunched = [k for k, v in path_launches.items()
                  if not v and k != "apr_matmul_int8w"]
    if unlaunched:
        fail(f"phase 8: no launch of {unlaunched} on the tuning path")
    bundle.decode_paged = forward
    del engine, reqs, bundle, params, exhaustive, pruned
    torch.cuda.empty_cache()
    return tuning


def identity_ablation(torch, seed: int) -> dict:
    """``--ablate``: phase 7's paged-vs-slot greedy-token comparison at full
    width, with each card-side measure the path rests on turned off in
    turn (and both together):

    * ``single-mean rms_norm``: ``rms_norm``'s variance is one mean over d
      on the card, as on the CPU, not the mean over ``NORM_GROUPS`` groups;
    * ``einsum conv`` (mamba2): ``mamba2_decode``'s conv over its window is
      ``torch.einsum("bkc,kc->bc")``, not the ``addcmul`` chain.

    Each variant also runs one ``decode_step`` at B = 4 (the slot engine's
    batch) from a nonzero state and each of its rows alone at B = 1 (a
    paged prefill chunk's batch), and records whether the logits and the
    new state of every row are equal bit for bit.

    Returns, per arch and variant, the equal tokens out of all, the first
    mismatching position of each request and the B = 4 vs B = 1 check, or
    the error the variant raised."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, layers, ssm
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine

    def einsum_conv(window, w):
        return torch.einsum("bkc,kc->bc", window, w)

    def batch_invariant(bundle, params, rng) -> bool:
        dev = bundle.device
        cache = bundle.init_cache(4, 256)
        lengths = torch.zeros(4, dtype=torch.int32, device=dev)
        toks = [torch.from_numpy(rng.integers(
            1, bundle.cfg.vocab_size, (4, 1))).to(dev) for _ in range(4)]
        for t in toks[:3]:                   # a nonzero state
            bundle.decode_step(params, cache, t, lengths)
        whole = dict(cache)
        logits = bundle.decode_step(params, whole, toks[3], lengths)
        for i in range(4):
            row = {k: v[:, i:i + 1].clone() for k, v in cache.items()}
            got = bundle.decode_step(params, row, toks[3][i:i + 1],
                                     lengths[i:i + 1])
            if not torch.equal(got[0], logits[i]) or not all(
                    torch.equal(row[k][:, 0], whole[k][:, i]) for k in row):
                return False
        return True

    measures = {
        "single-mean rms_norm": [(layers, "mean_square",
                                  single_mean_square)],
        "einsum conv": [(ssm, "_conv_step", einsum_conv)],
    }
    variants = {"as shipped": [], **measures,
                "both off": [x for v in measures.values() for x in v]}
    out = {}
    for arch in RECURRENT_ARCHS:
        cfg = get_config(arch)
        bundle = build_model(cfg, device="cuda")
        params = bundle.init_params(
            torch.Generator(device="cuda").manual_seed(seed))
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in RECURRENT_PROMPTS]
        out[arch] = {}
        for name, patches in variants.items():
            if name == "einsum conv" and cfg.family != "mamba":
                continue
            saved = [(m, attr, getattr(m, attr)) for m, attr, _ in patches]
            for m, attr, fn in patches:
                setattr(m, attr, fn)
            t0 = time.perf_counter()
            try:
                outs = []
                for engine in (PagedServeEngine(bundle, params, device="cuda",
                                                slots=4, page_size=16,
                                                prefill_chunk=16),
                               ServeEngine(bundle, params, device="cuda",
                                           slots=4, max_seq=256)):
                    reqs = [Request(rid=i, prompt=p,
                                    max_new_tokens=RECURRENT_NEW)
                            for i, p in enumerate(prompts)]
                    for r in reqs:
                        engine.submit(r)
                    engine.run_until_drained()
                    outs.append([r.output for r in reqs])
                    del engine
                torch.cuda.synchronize()
                first = [next((i for i, (a, b) in enumerate(zip(pa, sl))
                               if a != b), None)
                         for pa, sl in zip(*outs)]
                res = dict(tokens_equal=sum(a == b for pa, sl in zip(*outs)
                                            for a, b in zip(pa, sl)),
                           tokens_total=sum(len(o) for o in outs[0]),
                           first_mismatch=first,
                           step_b4_equals_b1=batch_invariant(bundle, params,
                                                             rng))
            except Exception as e:          # a variant may not run at all
                res = dict(error=f"{type(e).__name__}: {e}")
            finally:
                for m, attr, fn in saved:
                    setattr(m, attr, fn)
            res["seconds"] = time.perf_counter() - t0
            out[arch][name] = res
            print(f"[ablate] {arch:12s} {name:22s} "
                  + (f"raised {res['error']}" if "error" in res else
                     f"paged vs slot tokens {res['tokens_equal']}/"
                     f"{res['tokens_total']}, first mismatch per request "
                     f"{res['first_mismatch']}, decode step B=4 equal to B=1 "
                     f"rows {res['step_b4_equals_b1']}")
                  + f" ({res['seconds']:.1f} s)", flush=True)
        del params, bundle
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"))
    ap.add_argument("--ablate", action="store_true",
                    help="only check rms_norm's batch invariance and serve "
                         "rwkv6-3b and mamba2-2.7b on both engines with each "
                         "card-side measure turned off in turn "
                         "(identity_ablation); writes "
                         "chiprun_out/identity_ablation.json")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch.bench import ConfigCache, set_default_cache
    from repro_torch.configs import get_config
    from repro_torch.core.apr import reduction_hbm_traffic
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_conv import (apr_conv2d, apr_conv2d_fused,
                                              conv2d_fused_ref, conv2d_ref)
    from repro_torch.kernels.apr_conv import ops as conv_ops
    from repro_torch.kernels.apr_matmul import (apr_matmul, apr_matmul_fused,
                                                matmul_ref)
    from repro_torch.kernels.apr_matmul import ops as apr_ops
    from repro_torch.kernels.flash_decode import (
        decode_attention_ref, flash_decode, flash_decode_paged, gather_pages,
        paged_decode_attention_q_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.mamba2 import mamba2_ssd
    from repro_torch.kernels.mamba2 import ops as mamba2_ops
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_fused)
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.kernels.rwkv6 import rwkv6_wkv
    from repro_torch.models import build_model
    from repro_torch.models.cnn import CNNS, conv_geometries, hbm_conv
    from repro_torch.quant import QuantizedTensor, quantize_channelwise
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # tuned configurations only where phase 8 scopes them: every other
    # phase resolves the kernels' defaults from an empty cache that is
    # never written, and nothing reads or writes a cache in the home
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    set_default_cache(ConfigCache(Path(tmp.name) / "untuned.json",
                                  autosave=False))
    if args.ablate:
        _build.build_all({apr_ops.LIBRARY: apr_ops.SIGNATURES,
                          rwkv6_ops.LIBRARY: rwkv6_ops.SIGNATURES,
                          mamba2_ops.LIBRARY: mamba2_ops.SIGNATURES})
        norms = norm_invariance(torch, torch.Generator(
            device="cuda").manual_seed(args.seed), torch.device("cuda"))
        for r in norms:
            print(f"[ablate] rms_norm variance d={r['d']} {r['mean']} mean: "
                  f"{r['rows_differ']}/{r['rows']} rows differ between B = 1 "
                  f"and inside B = {r['batch']}", flush=True)
        path = ROOT / "chiprun_out" / "identity_ablation.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(
            norm_invariance=norms,
            engines=identity_ablation(torch, args.seed)), indent=1))
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()
    phase_s = {}
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        print(f"    ({name}: {phase_s[name]:.1f} s)")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    _build.build_all({apr_ops.LIBRARY: apr_ops.SIGNATURES,
                      fd_ops.LIBRARY: fd_ops.SIGNATURES,
                      conv_ops.LIBRARY: conv_ops.SIGNATURES,
                      qmm_ops.LIBRARY: qmm_ops.SIGNATURES,
                      rwkv6_ops.LIBRARY: rwkv6_ops.SIGNATURES,
                      mamba2_ops.LIBRARY: mamba2_ops.SIGNATURES})
    build_s = time.perf_counter() - t0
    print(f"[1] built {sorted(_build.BUILD_SECONDS) or 'nothing (cached)'} "
          f"in {build_s:.2f} s (nvcc, sm_90a, one process per source)")
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    report["build_s"] = build_s
    phase_done("phase 1")

    # ------------------------------------------------------------ 2 correct
    errs = {"apr_matmul": 0.0, "apr_matmul_int8w": 0.0,
            "flash_decode_paged": 0.0, "flash_decode_paged_int8": 0.0,
            "flash_decode": 0.0, "apr_conv": 0.0, "apr_conv_hbm": 0.0,
            "rwkv6_wkv": 0.0, "mamba2_ssd": 0.0, "apr_matmul_hbm": 0.0,
            "apr_matmul_fused": 0.0, "quant_matmul": 0.0,
            "quant_matmul_fused": 0.0}
    cases = []
    mm_cases = [(m, k, n, 0) for m in (4, 16)
                for (k, n) in list(LLAMA_DECODE_SHAPES) + [LM_HEAD]]
    mm_cases += [(3, 100, 1000, 0),      # K % 8 != 0: masked element loads
                 (3, 4096, 1000, 0),     # N not a multiple of the 64 tile
                 (17, 96, 77, 0),        # ragged M, N and K at once
                 (4, 256, 5000, 0),      # last tile 8 columns wide
                 (9, 130, 6000, 0),      # masked loads, ragged last tile
                 (1, 8, 8, 0),
                 (4, 512, 256, 1)]       # operand 2 bytes off alignment
    for m, k, n, off in mm_cases:
        xb = randn(m * k + off)
        x = xb[off:].view(m, k)
        w = randn(k, n, scale=k ** -0.5)
        for out_dtype in ((torch.bfloat16, torch.float32) if off or m == 3
                          else (torch.bfloat16,)):
            got = apr_matmul(x, w, out_dtype=out_dtype)
            ref = matmul_ref(x, w, out_dtype)
            torch.cuda.synchronize()
            err, ok = max_err(got, ref)
            errs["apr_matmul"] = max(errs["apr_matmul"], err)
            cases.append(("apr_matmul", f"M={m} K={k} N={n} off={off} "
                          f"out={str(out_dtype)[6:]}", err, ok))
        # the int8 weight of w (codes offset like x), against the plain
        # version and, bit for bit, the bf16 kernel on its dequantized copy
        qt = quantize_channelwise(w.float())
        qb = torch.empty(k * n + off, dtype=torch.int8, device=dev)
        qt.q = qb[off:].view(k, n).copy_(qt.q)
        w_deq = qt.dequantize(torch.bfloat16)
        for out_dtype in (torch.bfloat16, torch.float32):
            got = apr_matmul(x, qt, out_dtype=out_dtype)
            ref = matmul_ref(x, w_deq, out_dtype)
            same = apr_matmul(x, w_deq, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err, ok = max_err(got, ref)
            bits = torch.equal(got, same)
            errs["apr_matmul_int8w"] = max(errs["apr_matmul_int8w"], err)
            cases.append(("apr_matmul_int8w", f"M={m} K={k} N={n} off={off} "
                          f"out={str(out_dtype)[6:]} bit-equal={bits}", err,
                          ok and bits))
        del x, xb, w, qt, qb, w_deq

    def paged_inputs(b, hq, hkv, d, ps, p_max, lengths, layers=1):
        need = [-(-n // ps) for n in lengths]
        p_pool = 1 + max(sum(need), 1) + 1
        rng = np.random.default_rng(sum(lengths) + b)
        perm = rng.permutation(np.arange(1, p_pool))
        tables = np.zeros((b, p_max), np.int32)   # padding -> null page 0
        at = 0
        for i, n in enumerate(need):
            tables[i, :n] = perm[at:at + n]
            at += n
        q = randn(b, hq, d)
        kp = randn(layers, p_pool, ps, hkv, d)
        vp = randn(layers, p_pool, ps, hkv, d)
        return (q, kp, vp, torch.tensor(lengths, dtype=torch.int32, device=dev),
                torch.from_numpy(tables).to(dev))

    main_lengths = [40, 96, 150, 196]
    fd_cases = [(4, 32, 8, 128, 16, 16, main_lengths),     # serving shape
                (4, 32, 8, 128, 16, 16, [0, 1, 16, 17]),   # 0, 1, ps, ps+1
                (3, 8, 2, 64, 8, 5, [33, 0, 7]),
                (2, 14, 2, 64, 16, 4, [64, 5])]            # group of 7
    for b, hq, hkv, d, ps, p_max, lengths in fd_cases:
        q, kp, vp, lens, tables = paged_inputs(b, hq, hkv, d, ps, p_max,
                                               lengths)
        got = flash_decode_paged(q, kp[0], vp[0], lens, tables)
        ref = paged_decode_attention_ref(q, kp[0], vp[0], lens, tables)
        torch.cuda.synchronize()
        err, ok = max_err(got, ref)
        zero_rows = [i for i, n in enumerate(lengths) if n == 0]
        ok = ok and all(not got[i].float().any() for i in zero_rows)
        errs["flash_decode_paged"] = max(errs["flash_decode_paged"], err)
        cases.append(("flash_decode_paged", f"B={b} Hq={hq} Hkv={hkv} D={d} "
                      f"ps={ps} P_max={p_max} lengths={lengths}", err, ok))
        # the same pools as int8 codes with per-(slot, head) fp32 scales:
        # against the plain version (bf16-rounded dequant, Q_ATOL) and the
        # plain version on fp32-dequantized pools (bf16 tolerance)
        kq, vq = (quantize_channelwise(t[0], axis=-1) for t in (kp, vp))
        ks, vs = kq.scale[..., 0], vq.scale[..., 0]
        got = flash_decode_paged(q, kq.q, vq.q, lens, tables, k_scales=ks,
                                 v_scales=vs)
        ref = paged_decode_attention_q_ref(q, kq.q, vq.q, ks, vs, lens,
                                           tables)
        ref32 = paged_decode_attention_ref(
            q.float(), kq.dequantize(torch.float32),
            vq.dequantize(torch.float32), lens, tables).to(torch.bfloat16)
        torch.cuda.synchronize()
        err, ok = max_err(got, ref, Q_ATOL)
        err32, ok32 = max_err(got, ref32)
        ok = ok and ok32 and all(not got[i].float().any() for i in zero_rows)
        errs["flash_decode_paged_int8"] = max(
            errs["flash_decode_paged_int8"], err)
        cases.append(("flash_decode_paged_int8", f"B={b} Hq={hq} Hkv={hkv} "
                      f"D={d} ps={ps} P_max={p_max} lengths={lengths} "
                      f"fp32-dequant err={err32:.3g}", err, ok))

    # the contiguous cache of the slot engine, rows of length 0 included:
    # they return the mean of V over all S positions, as the JAX kernel does
    for b, hq, hkv, d, s_len, lengths in [
            (4, 32, 8, 128, 256, [40, 96, 150, 196]),     # serving shape
            (4, 32, 8, 128, 256, [0, 1, 33, 256]),
            (3, 8, 2, 64, 48, [33, 0, 7]),                # S not a chunk mult.
            (2, 14, 2, 64, 64, [64, 0])]:                 # group of 7
        q = randn(b, hq, d)
        k_c, v_c = randn(b, s_len, hkv, d), randn(b, s_len, hkv, d)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = flash_decode(q, k_c, v_c, lens)
        ref = decode_attention_ref(q, k_c, v_c, lens)
        torch.cuda.synchronize()
        err, ok = max_err(got, ref)
        errs["flash_decode"] = max(errs["flash_decode"], err)
        cases.append(("flash_decode", f"B={b} Hq={hq} Hkv={hkv} D={d} "
                      f"S={s_len} lengths={lengths}", err, ok))

    def conv_inputs(xs, fs, dtype=torch.float32):
        """A random NHWC input and an HWIO filter scaled by K^-1/2, so the
        outputs are O(1) and the activations meet both of their sides."""
        x = torch.randn(xs, generator=gen, device=dev).to(dtype)
        k = fs[0] * fs[1] * fs[2]
        f = (torch.randn(fs, generator=gen, device=dev) * k ** -0.5
             ).to(dtype)
        return x, f

    def conv_label(xs, fs, s, p, dtype):
        return (f"x={'x'.join(map(str, xs))} f={'x'.join(map(str, fs))} "
                f"s={s} p={p}{' bf16' if dtype == torch.bfloat16 else ''}")

    # every conv geometry of both nets at batch 1 and CNN_BATCH, the JAX
    # tests' geometries (tests/test_kernels_conv.py), and ragged ones
    conv_cases = {}
    for net in CNNS:
        for batch in (1, CNN_BATCH):
            for g in conv_geometries(net, batch):
                conv_cases[(g["x_shape"], g["f_shape"], g["stride"],
                            g["padding"], torch.float32)] = None
    for b, h, w, c, hf, wf, m, s, p in [
            (1, 32, 32, 1, 5, 5, 6, 1, 0), (1, 14, 14, 6, 5, 5, 16, 1, 0),
            (1, 16, 16, 16, 3, 3, 32, 2, 1), (1, 8, 8, 64, 1, 1, 64, 1, 0),
            (2, 10, 10, 8, 3, 3, 12, 1, 1),
            (3, 9, 11, 1, 3, 3, 5, 2, 1),       # C = 1, stride 2, odd H, W
            (2, 15, 13, 3, 3, 3, 10, 2, 1),     # K = 27, odd H, M = 10
            (2, 7, 7, 24, 3, 3, 40, 1, 1),      # M = 40 in a 64-wide tile
            (1, 9, 9, 8, 3, 3, 70, 1, 0),       # two channel tiles, 64 + 6
            (1, 4, 4, 8, 3, 3, 16, 1, 0),       # 2 x 2 output pixels
            (4, 17, 17, 5, 5, 5, 33, 3, 2)]:    # K = 125, stride 3
        conv_cases[((b, h, w, c), (hf, wf, c, m), s, p, torch.float32)] = None
    for key in [((1, 8, 8, 4), (3, 3, 4, 8), 1, 1),          # the JAX test
                ((2, 32, 32, 3), (3, 3, 3, 16), 1, 1),
                ((2, 15, 13, 16), (3, 3, 16, 32), 2, 1)]:
        conv_cases[key + (torch.bfloat16,)] = None
    for xs, fs, s, p, dtype in conv_cases:
        x, f = conv_inputs(xs, fs, dtype)
        ref = conv2d_ref(x, f, stride=s, padding=p)
        for res in ("apr", "hbm"):
            got = apr_conv2d(x, f, stride=s, padding=p, residency=res)
            torch.cuda.synchronize()
            err, ok = conv_err(got, ref)
            kname = "apr_conv" if res == "apr" else "apr_conv_hbm"
            errs[kname] = max(errs[kname], err)
            cases.append((kname, conv_label(xs, fs, s, p, dtype), err, ok))
        del x, f, ref, got
    # the fused epilogue: every activation, with and without bias
    for xs, fs, s, p in [((3, 32, 32, 1), (5, 5, 1, 6), 1, 0),
                         ((8, 32, 32, 16), (3, 3, 16, 32), 2, 1),
                         ((2, 8, 8, 64), (3, 3, 64, 64), 1, 1)]:
        x, f = conv_inputs(xs, fs)
        bias = torch.randn(fs[3], generator=gen, device=dev)
        for act in ("none", "relu", "silu", "gelu"):
            for bname, bb in (("no bias", None), ("bias (M,)", bias),
                              ("bias (1,M)", bias[None])):
                got = apr_conv2d_fused(x, f, bb, activation=act, stride=s,
                                       padding=p)
                ref = conv2d_fused_ref(x, f, bb, act, stride=s, padding=p)
                torch.cuda.synchronize()
                err, ok = conv_err(got, ref)
                errs["apr_conv"] = max(errs["apr_conv"], err)
                cases.append(("apr_conv", f"{conv_label(xs, fs, s, p, 0)} "
                              f"{act}, {bname}", err, ok))
    for name, case, err, ok in (scan_correctness(torch, gen, dev)
                                + matmul_family_correctness(torch, gen,
                                                            dev)):
        errs[name] = max(errs[name], err)
        cases.append((name, case, err, ok))
    print(f"[2] kernel vs plain version on the card (tolerance "
          f"{BF16_RTOL:.4g}*|plain| + {ATOL:g}; int8 pools "
          f"{BF16_RTOL:.4g}*|plain| + {Q_ATOL:g}; conv kernels "
          f"{CONV_RTOL:g}*|plain| + {CONV_RTOL:g}*max|plain|; scans: y "
          f"{BF16_RTOL:.4g}*|plain| + {SCAN_ATOL_REL:g}*max|plain|, fp32 "
          f"state {STATE_RTOL:g}*(|plain| + max|plain|); matmul families "
          f"at every compiled tile: B4m bit-equal to B1 at the tile, B6/B8 "
          f"none/relu bit-equal, silu/gelu within {ACT_ULPS} fp32 ulps of "
          f"max(|plain|, |pre-activation|) or the bf16 tolerance for bf16 "
          f"out, B7m the bf16 tolerance):")
    for name, shape, err, ok in cases:
        print(f"    {'ok  ' if ok else 'FAIL'} {name:23s} {shape:50s} "
              f"max_abs_err={err:.3g}")
    report["correctness"] = [dict(kernel=n, case=s, max_abs_err=e, ok=o)
                             for n, s, e, o in cases]
    norms = norm_invariance(torch, gen, dev)
    print("    rms_norm variance, rows differing (any bit) between B = 1 and "
          "inside a batch: " + ", ".join(
              f"d={r['d']} {r['mean']} B={r['batch']}: {r['rows_differ']}/"
              f"{r['rows']}" for r in norms))
    report["norm_invariance"] = norms
    if not all(ok for *_, ok in cases):
        fail("a kernel disagrees with its plain version")
    if any(r["rows_differ"] for r in norms if r["mean"] == "grouped"):
        fail("rms_norm's variance depends on the batch on the card")
    phase_done("phase 2")

    # --------------------------------------------------------------- 3 time
    slots = 4
    timing = []
    per_shape = {}
    for m in (slots, 16):
        for k, n in list(LLAMA_DECODE_SHAPES) + [LM_HEAD]:
            nbuf = min(32, max(1, math.ceil(200e6 / (k * n * 2))))
            ws = [randn(k, n, scale=k ** -0.5) for _ in range(nbuf)]
            x = randn(m, k)
            iters = 20 if n > 100_000 else 60
            t_k = cuda_ms(torch, lambda i: apr_matmul(
                x, ws[i % nbuf], out_dtype=torch.bfloat16), iters)
            t_p = cuda_ms(torch, lambda i: matmul_ref(
                x, ws[i % nbuf], torch.bfloat16), iters)
            t_l = cuda_ms(torch, lambda i: torch.matmul(x, ws[i % nbuf]),
                          iters)
            row = dict(kernel="apr_matmul", M=m, K=k, N=n, ms=t_k,
                       plain_ms=t_p, library_ms=t_l, weight_buffers=nbuf,
                       **bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n))
            timing.append(row)
            per_shape[("apr_matmul", m, k, n)] = row
            # the same weights as int8 codes + fp32 column scales; the
            # library yardstick multiplies by the dequantized bf16 weight
            qts = [quantize_channelwise(w.float()) for w in ws]
            deqs = [qt.dequantize(torch.bfloat16) for qt in qts]
            del ws
            t_k = cuda_ms(torch, lambda i: apr_matmul(
                x, qts[i % nbuf], out_dtype=torch.bfloat16), iters)
            t_p = cuda_ms(torch, lambda i: matmul_ref(
                x, qts[i % nbuf].dequantize(torch.bfloat16), torch.bfloat16),
                iters)
            t_l = cuda_ms(torch, lambda i: torch.matmul(x, deqs[i % nbuf]),
                          iters)
            row = dict(kernel="apr_matmul_int8w", M=m, K=k, N=n, ms=t_k,
                       plain_ms=t_p, library_ms=t_l, weight_buffers=nbuf,
                       **bound_ms(2 * m * k + k * n + 4 * n + 2 * m * n,
                                  2 * m * k * n))
            timing.append(row)
            per_shape[("apr_matmul_int8w", m, k, n)] = row
            del qts, deqs, x
    b, hq, hkv, d, ps, p_max = 4, 32, 8, 128, 16, 16
    layers = 32
    q, kp, vp, lens, tables = paged_inputs(b, hq, hkv, d, ps, p_max,
                                           main_lengths, layers=layers)
    live = torch.arange(p_max * ps, device=dev)[None] < lens[:, None].long()

    def library_attention(i):
        kk = gather_pages(kp[i % layers], tables).permute(0, 2, 1, 3)
        vv = gather_pages(vp[i % layers], tables).permute(0, 2, 1, 3)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=live[:, None, None],
            enable_gqa=True)

    t_k = cuda_ms(torch, lambda i: flash_decode_paged(
        q, kp[i % layers], vp[i % layers], lens, tables), 200)
    t_p = cuda_ms(torch, lambda i: paged_decode_attention_ref(
        q, kp[i % layers], vp[i % layers], lens, tables), 50)
    t_l = cuda_ms(torch, library_attention, 50)
    tokens = sum(main_lengths)
    fd_bytes = (2 * b * hq * d * 2 + tokens * hkv * d * 2 * 2
                + b * (p_max + 1) * 4)
    fd_row = dict(kernel="flash_decode_paged", B=b, Hq=hq, Hkv=hkv, D=d,
                  ps=ps, P_max=p_max, lengths=main_lengths, ms=t_k,
                  plain_ms=t_p, library_ms=t_l,
                  **bound_ms(fd_bytes, 4 * tokens * hq * d))
    timing.append(fd_row)
    # the same pools as int8 codes with per-(slot, head) fp32 scales
    kq, vq = (quantize_channelwise(t, axis=-1) for t in (kp, vp))
    ks, vs = kq.scale[..., 0], vq.scale[..., 0]
    del kp, vp

    def library_attention_q(i):
        lay = i % layers
        kk, vv = ((gather_pages(c.q[lay], tables).float()
                   * gather_pages(sc[lay], tables)[..., None]
                   ).to(torch.bfloat16).permute(0, 2, 1, 3)
                  for c, sc in ((kq, ks), (vq, vs)))
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=live[:, None, None],
            enable_gqa=True)

    t_k = cuda_ms(torch, lambda i: flash_decode_paged(
        q, kq.q[i % layers], vq.q[i % layers], lens, tables,
        k_scales=ks[i % layers], v_scales=vs[i % layers]), 200)
    t_p = cuda_ms(torch, lambda i: paged_decode_attention_q_ref(
        q, kq.q[i % layers], vq.q[i % layers], ks[i % layers],
        vs[i % layers], lens, tables), 50)
    t_l = cuda_ms(torch, library_attention_q, 50)
    fdq_bytes = (2 * b * hq * d * 2 + tokens * hkv * (d + 4) * 2
                 + b * (p_max + 1) * 4)
    fdq_row = dict(kernel="flash_decode_paged_int8", B=b, Hq=hq, Hkv=hkv,
                   D=d, ps=ps, P_max=p_max, lengths=main_lengths, ms=t_k,
                   plain_ms=t_p, library_ms=t_l,
                   **bound_ms(fdq_bytes, 4 * tokens * hq * d))
    timing.append(fdq_row)
    del kq, vq, ks, vs
    # the slot engine's contiguous cache at max_seq 256, same lengths; the
    # bound counts the live tokens' K and V
    s_len = 256
    kc, vc = randn(layers, b, s_len, hkv, d), randn(layers, b, s_len, hkv, d)
    live_c = live[:, :s_len]
    t_k = cuda_ms(torch, lambda i: flash_decode(
        q, kc[i % layers], vc[i % layers], lens), 200)
    t_p = cuda_ms(torch, lambda i: decode_attention_ref(
        q, kc[i % layers], vc[i % layers], lens), 50)
    t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        q[:, :, None], kc[i % layers].permute(0, 2, 1, 3),
        vc[i % layers].permute(0, 2, 1, 3), attn_mask=live_c[:, None, None],
        enable_gqa=True), 50)
    fdc_row = dict(kernel="flash_decode", B=b, Hq=hq, Hkv=hkv, D=d, S=s_len,
                   lengths=main_lengths, ms=t_k, plain_ms=t_p, library_ms=t_l,
                   **bound_ms(2 * b * hq * d * 2 + tokens * hkv * d * 2 * 2
                              + b * 4, 4 * tokens * hq * d))
    timing.append(fdc_row)
    del q, kc, vc
    torch.cuda.empty_cache()
    scan_rows = scan_timing(torch, gen, dev)
    mm_rows = matmul_family_timing(torch, gen, dev, slots)
    for r in mm_rows:
        per_shape[(r["kernel"], r["M"], r["K"], r["N"])] = r
    timing.extend(mm_rows)
    print("[3] kernel times (CUDA events, cold weights: buffers rotated past "
          "the 50 MB L2):")
    for r in timing:
        if "M" in r:
            shape = f"M={r['M']:<3d} K={r['K']:<6d} N={r['N']:<7d}"
        else:
            shape = (f"B={r['B']} Hq={r['Hq']} Hkv={r['Hkv']} D={r['D']} "
                     + (f"ps={r['ps']}" if "ps" in r else f"S={r['S']}")
                     + f" lengths={r['lengths']}")
        print(f"    {r['kernel']:23s} {shape:40s} kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['bound_ms'] / r['ms']:.0%} of bound")
    for r in scan_rows:
        shape = " ".join(f"{k}={r[k]}" for k in ("B", "T", "H", "D", "P", "N")
                         if k in r)
        print(f"    {r['kernel']:23s} {r['shape']:7s} {shape:32s} kernel_ms="
              f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=none "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['bound_ms'] / r['ms']:.0%} of bound")
    for r in mm_rows:
        if r["kernel"] == "apr_matmul_hbm":
            print(f"    B4m vs B1 (default tile) M={r['M']} K={r['K']} "
                  f"N={r['N']}: {r['ms']:.4f} vs {r['apr_ms']:.4f} ms, "
                  f"x{r['ms'] / r['apr_ms']:.2f} ({r['hbm_steps']} K steps, "
                  f"+{r['partial_bytes'] / 1e6:.2f} MB of fp32 partials)")
        elif r["kernel"] == "quant_matmul":
            print(f"    quant_matmul M={r['M']} K={r['K']} N={r['N']}: the "
                  f"activations' quantization alone {r['quantize_ms']:.4f} "
                  f"ms of {r['ms']:.4f}; library at M={r['library_m']}")
    timing.extend(scan_rows)
    report["timing"] = timing

    # apr_conv, apr_conv_hbm, the plain version and F.conv2d on every
    # distinct conv of ResNet-20 at CNN_BATCH; inputs of at most 16.8 MB
    # stay in the L2, as one layer's output does for the next
    conv_rows = {}
    for g in conv_geometries("resnet20", CNN_BATCH):
        key = (g["x_shape"], g["f_shape"], g["stride"], g["padding"])
        if key in conv_rows:
            conv_rows[key]["count"] += 1
            continue
        xs, fs, s, p = key
        x, f = conv_inputs(xs, fs)
        x_cl = x.permute(0, 3, 1, 2)          # NHWC memory: channels-last
        w_cl = f.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        k = fs[0] * fs[1] * fs[2]
        steps = -(-k // conv_ops.K_STEP)
        t_k = cuda_ms(torch, lambda i: apr_conv2d(x, f, stride=s, padding=p),
                      50)
        t_h = cuda_ms(torch, lambda i: apr_conv2d(
            x, f, stride=s, padding=p, residency="hbm"), 20,
            fill=2e5 * steps)
        t_p = cuda_ms(torch, lambda i: conv2d_ref(x, f, stride=s, padding=p),
                      50)
        t_l = cuda_ms(torch, lambda i: F.conv2d(x_cl, w_cl, stride=s,
                                                padding=p), 50)
        # the fused epilogue (B7's conv route): bias + ReLU at the flush,
        # against the plain version and F.conv2d with bias, then F.relu
        bias = torch.randn(fs[3], generator=gen, device=dev)
        t_f = cuda_ms(torch, lambda i: apr_conv2d_fused(
            x, f, bias, activation="relu", stride=s, padding=p), 50)
        t_fp = cuda_ms(torch, lambda i: conv2d_fused_ref(
            x, f, bias, "relu", stride=s, padding=p), 50)
        t_fl = cuda_ms(torch, lambda i: F.relu(F.conv2d(
            x_cl, w_cl, bias, stride=s, padding=p)), 50)
        out_elems = CNN_BATCH * ((xs[1] + 2 * p - fs[0]) // s + 1) * \
            ((xs[2] + 2 * p - fs[1]) // s + 1) * fs[3]
        partial_bytes = (reduction_hbm_traffic(out_elems, steps, 4, "hbm")
                         - reduction_hbm_traffic(out_elems, steps, 4, "apr"))
        fused = bound_ms(4 * (x.numel() + f.numel() + fs[3] + out_elems),
                         2 * out_elems * (k + 1), FP32_FLOPS_PER_S)
        conv_rows[key] = dict(
            layer=g["param"], count=1, x_shape=xs, f_shape=fs, stride=s,
            padding=p, K=k, hbm_steps=steps, ms=t_k, hbm_ms=t_h,
            plain_ms=t_p, library_ms=t_l, partial_bytes=partial_bytes,
            fused_ms=t_f, fused_plain_ms=t_fp, fused_library_ms=t_fl,
            fused_bound_ms=fused["bound_ms"],
            **bound_ms(4 * (x.numel() + f.numel() + out_elems),
                       2 * out_elems * k, FP32_FLOPS_PER_S))
        del x, f, x_cl, w_cl, bias
    conv_rows = list(conv_rows.values())
    print(f"    ResNet-20 convs at batch {CNN_BATCH} (CUDA events, warm L2; "
          f"bound: fp32 FMA at {FP32_FLOPS_PER_S / 1e12:g} TFLOP/s or "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s):")
    for r in conv_rows:
        print(f"    {r['layer']:7s} x{r['count']} x={r['x_shape']} "
              f"f={r['f_shape']} s={r['stride']}: apr_conv {r['ms']:.4f} "
              f"apr_conv_hbm {r['hbm_ms']:.4f} ({r['hbm_steps']} steps, "
              f"+{r['partial_bytes'] / 1e6:.1f} MB partials) plain "
              f"{r['plain_ms']:.4f} F.conv2d {r['library_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['bound_ms'] / r['ms']:.0%} of bound; fused bias+relu "
              f"{r['fused_ms']:.4f} plain {r['fused_plain_ms']:.4f} "
              f"F.conv2d+bias,relu {r['fused_library_ms']:.4f} bound "
              f"{r['fused_bound_ms']:.4f}")

    def per_forward(key):
        """Sum over the 21 convs of one ResNet-20 forward at CNN_BATCH."""
        return sum(r["count"] * r[key] for r in conv_rows)

    report["conv_timing"] = conv_rows
    conv_total = {key: per_forward(key) for key in (
        "ms", "hbm_ms", "plain_ms", "library_ms", "bound_ms", "t_mem_ms",
        "t_ops_ms", "partial_bytes", "fused_ms", "fused_plain_ms",
        "fused_library_ms", "fused_bound_ms")}
    report["conv_per_forward"] = conv_total
    print(f"    per ResNet-20 forward: apr_conv {conv_total['ms']:.4f} ms, "
          f"apr_conv_hbm {conv_total['hbm_ms']:.4f} ms (+"
          f"{conv_total['partial_bytes'] / 1e9:.3f} GB of partial sums "
          f"through global memory, L2/HBM), plain "
          f"{conv_total['plain_ms']:.4f} ms, F.conv2d "
          f"{conv_total['library_ms']:.4f} ms, bound "
          f"{conv_total['bound_ms']:.4f} ms; fused bias+relu epilogue "
          f"{conv_total['fused_ms']:.4f} ms, plain "
          f"{conv_total['fused_plain_ms']:.4f} ms, F.conv2d+bias then relu "
          f"{conv_total['fused_library_ms']:.4f} ms, bound "
          f"{conv_total['fused_bound_ms']:.4f} ms")

    def per_tick(key, kernel="apr_matmul", lm_head=True):
        """Sum over one full-width decode tick (M = slots): 7 projections
        in each of 32 layers plus (``lm_head``) the lm_head."""
        layer = sum(cnt * per_shape[(kernel, slots, k, n)][key]
                    for (k, n), cnt in LLAMA_DECODE_SHAPES.items())
        return 32 * layer + (per_shape[(kernel, slots) + LM_HEAD][key]
                             if lm_head else 0.0)

    phase_done("phase 3")

    # -------------------------------------------------------------- 4 serve
    def reset_counts():
        apr_matmul.launches = 0
        apr_matmul.int8_launches = 0
        flash_decode_paged.launches = 0
        flash_decode_paged.int8_launches = 0
        flash_decode.launches = 0
        apr_conv2d.launches = 0
        apr_conv2d.hbm_launches = 0
        apr_conv2d_fused.launches = 0
        rwkv6_wkv.launches = 0
        mamba2_ssd.launches = 0
        apr_matmul.hbm_launches = 0
        apr_matmul.tile_launches.clear()
        apr_matmul_fused.launches = 0
        quant_matmul.launches = 0
        quant_matmul_fused.launches = 0

    def llm_counts() -> dict:
        return {"apr_matmul": apr_matmul.launches,
                "apr_matmul_int8w": apr_matmul.int8_launches,
                "flash_decode_paged": flash_decode_paged.launches,
                "flash_decode_paged_int8": flash_decode_paged.int8_launches,
                "flash_decode": flash_decode.launches,
                "rwkv6_wkv": rwkv6_wkv.launches,
                "mamba2_ssd": mamba2_ssd.launches,
                "apr_matmul_hbm": apr_matmul.hbm_launches,
                "apr_matmul_fused": apr_matmul_fused.launches,
                "quant_matmul": quant_matmul.launches,
                "quant_matmul_fused": quant_matmul_fused.launches}

    def expected_counts(**nonzero) -> dict:
        return {name: nonzero.get(name, 0) for name in llm_counts()}

    cfg = get_config("llama3-8b")
    bundle = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(
        args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
    finite = []
    forward, decode_step = bundle.decode_paged, bundle.decode_step

    def checked(fn):
        """``fn`` that also records whether its logits were finite."""
        def run(*a):
            logits = fn(*a)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits
        return run

    bundle.decode_paged = checked(forward)
    per_call = 7 * cfg.num_layers + 1
    engine_kw = dict(device="cuda", slots=slots, page_size=16,
                     prefill_chunk=16)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (24, 180, 57, 133, 96, 40)]

    def serve_paged(prm, kv_dtype, prompts, max_new):
        """Warm the kernels on a throwaway engine, then serve ``prompts`` on
        a fresh one with every launch count set to 0 just before; returns
        the engine, its requests, the wall seconds and the counts read just
        after."""
        warm = PagedServeEngine(bundle, prm, kv_dtype=kv_dtype, **engine_kw)
        warm.submit(Request(rid=-1, prompt=[1] * 20, max_new_tokens=2))
        warm.run_until_drained()
        del warm
        reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        engine = PagedServeEngine(bundle, prm, kv_dtype=kv_dtype, **engine_kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        finite.clear()
        reset_counts()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return engine, reqs, wall, llm_counts()

    def check_served(tag, reqs, max_new, launches, expect):
        if not all(r.done for r in reqs):
            fail(f"{tag}: not every request finished")
        if any(len(r.output) != max_new for r in reqs):
            fail(f"{tag}: a request produced the wrong number of tokens")
        if not finite or not all(finite):
            fail(f"{tag}: non-finite logits on the serving path")
        if launches != expect:
            fail(f"{tag}: kernel launches {launches} != expected {expect}")

    def paged_summary(engine, wall_s, launches, expect) -> dict:
        m = engine.metrics
        return dict(arch=cfg.name, layers=cfg.num_layers, wall_s=wall_s,
                    kv_dtype=engine.kv_dtype, **m.summary(),
                    decode_ms_per_tick=1e3 * m.decode_time_s / m.decode_calls,
                    prefill_ms_per_chunk=1e3 * m.prefill_time_s
                    / m.prefill_calls,
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                    kv_pool_bytes=engine.kv_pool_bytes(),
                    launches=launches, expected_launches=expect)

    def print_paged(serve, m):
        print(f"    decode {m.decode_tokens} tok in {m.decode_calls} ticks: "
              f"{m.decode_tps:.2f} tok/s, {serve['decode_ms_per_tick']:.3f} "
              f"ms per tick; prefill {m.prefill_tokens} tok in "
              f"{m.prefill_calls} chunks: {m.prefill_tps:.2f} tok/s, "
              f"{serve['prefill_ms_per_chunk']:.3f} ms per chunk")
        print(f"    TTFT mean {m.mean_ttft * 1e3:.2f} ms, p50 "
              f"{m.p50_ttft * 1e3:.2f} ms; peak memory "
              f"{serve['peak_mem_gb']:.2f} GB; KV pools "
              f"{serve['kv_pool_bytes']} bytes ({serve['kv_dtype']}); "
              f"launches {serve['launches']} (expected "
              f"{serve['expected_launches']})")

    # one decode tick at the phase-3 lengths: 4 slots, one new token each,
    # pages of 16 in the engine's 16-page table width
    need = [-(-(n + 1) // 16) for n in main_lengths]
    tick_tables = np.zeros((slots, 16), np.int32)
    at = 1
    for i, n in enumerate(need):
        tick_tables[i, :n] = np.arange(at, at + n)
        at += n
    tick_args = [torch.from_numpy(a).to(dev) for a in (
        np.ones((slots, 1), np.int32), np.asarray(main_lengths, np.int32),
        np.ones(slots, np.int32), tick_tables)]

    def profile_tick(prm, engine) -> dict:
        """Where a decode tick's time goes at the phase-3 lengths: device
        busy time (sum of kernel times on the one stream) against the
        tick's wall time; {} where the profiler cannot trace."""
        forward(prm, engine.cache, *tick_args)          # warm
        torch.cuda.synchronize()
        ticks = 5
        t0 = time.perf_counter()                        # wall, profiler off
        for _ in range(ticks):
            forward(prm, engine.cache, *tick_args)
        torch.cuda.synchronize()
        tick_wall = (time.perf_counter() - t0) / ticks * 1e3
        host = {}
        by_kernel = profile_device(
            torch, lambda: forward(prm, engine.cache, *tick_args), ticks,
            host)
        if not by_kernel:
            return {}
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
        print(f"    decode tick at lengths {main_lengths}: wall "
              f"{tick_wall:.3f} ms, device busy {busy:.3f} ms (profiler), "
              f"idle share {1 - busy / tick_wall:.1%}; host self time "
              f"{sum(host.values()):.3f} ms (profiler on)")
        for name, t in top:
            print(f"      {t:8.3f} ms  {name[:90]}")
        print("      host ops by self time:")
        for name, t in top_host:
            print(f"      {t:8.3f} ms  {name[:90]}")
        return dict(wall_ms=tick_wall, device_busy_ms=busy,
                    idle_share=1 - busy / tick_wall, top_kernels_ms=dict(top),
                    host_self_ms=sum(host.values()),
                    top_host_ops_ms=dict(top_host))

    engine, reqs, wall_s, launches = serve_paged(params, "bfloat16", prompts,
                                                 16)
    m = engine.metrics
    expect = expected_counts(
        apr_matmul=per_call * (m.decode_calls + m.prefill_calls),
        flash_decode_paged=cfg.num_layers * m.decode_calls)
    serve = dict(weight_gb=weight_gb, init_s=init_s,
                 **paged_summary(engine, wall_s, launches, expect))
    report["serve"] = serve
    print(f"[4] served {m.requests_done}/{len(reqs)} requests of full-width "
          f"{cfg.name} ({cfg.num_layers} layers, {weight_gb:.2f} GB bf16 "
          f"weights, init {init_s:.2f} s) in {wall_s:.2f} s wall:")
    print_paged(serve, m)
    check_served("phase 4", reqs, 16, launches, expect)
    bf16_outputs = [r.output for r in reqs]
    serve["profiled_tick"] = profile_tick(params, engine)
    del engine, reqs
    torch.cuda.empty_cache()

    phase_done("phase 4")

    # ------------------------------------------- 4c slot engine, full width
    slot_prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                    for n in (8, 19, 32, 13)]
    step_ms = []

    def timed_step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = checked(decode_step)(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return logits

    bundle.decode_step = timed_step
    warm = ServeEngine(bundle, params, device="cuda", slots=slots,
                       max_seq=256)
    warm.submit(Request(rid=-1, prompt=[1] * 3, max_new_tokens=2))
    warm.run_until_drained()
    del warm
    slot_reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                 for i, p in enumerate(slot_prompts)]
    slot_engine = ServeEngine(bundle, params, device="cuda", slots=slots,
                              max_seq=256)
    torch.cuda.synchronize()
    step_ms.clear()
    finite.clear()
    reset_counts()
    t0 = time.perf_counter()
    for r in slot_reqs:
        slot_engine.submit(r)
    slot_engine.run_until_drained()
    torch.cuda.synchronize()
    slot_wall = time.perf_counter() - t0
    slot_launches = llm_counts()
    slot_expect = expected_counts(apr_matmul=per_call * len(step_ms),
                                  flash_decode=cfg.num_layers * len(step_ms))
    bundle.decode_step = decode_step
    del slot_engine
    # the same requests on the paged engine (bf16 pools)
    engine, paged_reqs, _, _ = serve_paged(params, "bfloat16", slot_prompts,
                                           8)
    del engine
    same = sum(a == b for r, q in zip(slot_reqs, paged_reqs)
               for a, b in zip(r.output, q.output))
    n_tok = sum(len(r.output) for r in slot_reqs)
    ttfts = [r.ttft for r in slot_reqs]
    slot = dict(slots=slots, max_seq=256, prompt_lens=[len(p) for p in
                                                       slot_prompts],
                max_new=8, wall_s=slot_wall, forwards=len(step_ms),
                ms_per_forward=float(np.mean(step_ms)),
                ms_per_forward_median=float(np.median(step_ms)),
                mean_ttft_s=float(np.mean(ttfts)), tokens_equal_paged=same,
                tokens_total=n_tok, launches=slot_launches,
                expected_launches=slot_expect)
    report["serve_slot"] = slot
    print(f"[4c] slot ServeEngine, full-width {cfg.name} bf16: "
          f"{sum(r.done for r in slot_reqs)}/{len(slot_reqs)} requests "
          f"(prompts {slot['prompt_lens']}, 8 new tokens, max_seq 256) in "
          f"{slot_wall:.2f} s wall; {len(step_ms)} decode forwards (prompt "
          f"tokens one by one, then ticks) at {slot['ms_per_forward']:.3f} ms "
          f"mean, {slot['ms_per_forward_median']:.3f} ms median; TTFT mean "
          f"{slot['mean_ttft_s'] * 1e3:.2f} ms; launches {slot_launches} "
          f"(expected {slot_expect}); tokens equal to the PagedServeEngine's "
          f"{same}/{n_tok}")
    check_served("phase 4c", slot_reqs, 8, slot_launches, slot_expect)

    phase_done("phase 4c")

    # --------------------------------------- 4b int8 weights + int8 KV pages
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = bundle.quantize_params(params)      # on the card
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    # the same decode tick with bf16 and with int8 weights + KV, interleaved
    # (bf16, int8, int8, bf16) x 3 on one host: ms until the forward returns
    # (host enqueue) and until the device is done (wall)
    ab_prm = {"bfloat16": params, "int8": qparams}
    ab_cache = {kv: bundle.init_paged_cache(slots * 16 + 1, 16, kv)
                for kv in ab_prm}
    for kv in ab_prm:
        forward(ab_prm[kv], ab_cache[kv], *tick_args)           # warm
    ab = {kv: {"enqueue_ms": [], "wall_ms": []} for kv in ab_prm}
    for _ in range(3):
        for kv in ("bfloat16", "int8", "int8", "bfloat16"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(ab_prm[kv], ab_cache[kv], *tick_args)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            ab[kv]["enqueue_ms"].append((t1 - t0) * 1e3)
            ab[kv]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
    ab = {kv: {key: float(np.median(v)) for key, v in r.items()}
          for kv, r in ab.items()}
    report["tick_ab"] = ab
    print(f"[4b] one decode tick at lengths {main_lengths}, interleaved "
          f"bf16/int8 x 6 each, medians: bf16 enqueue "
          f"{ab['bfloat16']['enqueue_ms']:.3f} ms, wall "
          f"{ab['bfloat16']['wall_ms']:.3f} ms; int8 weights + KV enqueue "
          f"{ab['int8']['enqueue_ms']:.3f} ms, wall "
          f"{ab['int8']['wall_ms']:.3f} ms")
    del params, ab_prm, ab_cache                  # the bf16 weights go
    torch.cuda.empty_cache()
    int8_gb = sum(w.nbytes if isinstance(w, QuantizedTensor)
                  else w.numel() * w.element_size()
                  for w in qparams.values()) / 1e9
    engine, reqs, wall_s, launches = serve_paged(qparams, "int8", prompts, 16)
    m = engine.metrics
    expect = expected_counts(
        apr_matmul_int8w=per_call * (m.decode_calls + m.prefill_calls),
        flash_decode_paged_int8=cfg.num_layers * m.decode_calls)
    serve_q = dict(weight_gb=int8_gb, quantize_s=quant_s,
                   **paged_summary(engine, wall_s, launches, expect))
    same = sum(a == b for r, o in zip(reqs, bf16_outputs)
               for a, b in zip(r.output, o))
    serve_q["tokens_equal_bf16"] = same
    report["serve_int8"] = serve_q
    print(f"[4b] served {m.requests_done}/{len(reqs)} requests of full-width "
          f"{cfg.name} with int8 weights ({int8_gb:.2f} GB, quantized on the "
          f"card in {quant_s:.2f} s) and int8 KV pages in {wall_s:.2f} s "
          f"wall (phase 4, bf16: {serve['decode_ms_per_tick']:.3f} ms per "
          f"tick, {serve['decode_tps']:.2f} tok/s, TTFT mean "
          f"{serve['mean_ttft_s'] * 1e3:.2f} ms, peak "
          f"{serve['peak_mem_gb']:.2f} GB, KV pools "
          f"{serve['kv_pool_bytes']} bytes):")
    print_paged(serve_q, m)
    print(f"    greedy tokens equal to the bf16 run's: {same}/"
          f"{sum(len(o) for o in bf16_outputs)} (information: random "
          f"weights, int8 may flip near-ties)")
    check_served("phase 4b", reqs, 16, launches, expect)
    serve_q["profiled_tick"] = profile_tick(qparams, engine)
    del qparams, engine, reqs, bundle
    torch.cuda.empty_cache()

    phase_done("phase 4b")

    # ----------------------------------------------- 5 card vs CPU, smoke
    scfg = get_config("llama3-8b", smoke=True)
    bundles = {"cpu": build_model(scfg, device="cpu"),
               "cuda": build_model(scfg, device="cuda")}
    cpu_params = bundles["cpu"].init_params(
        torch.Generator().manual_seed(args.seed))
    smoke_params = {"bf16": cpu_params,
                    "int8": bundles["cpu"].quantize_params(cpu_params)}
    smoke_tokens = rng.integers(1, scfg.vocab_size, (2, 8)).astype(np.int32)

    def on(where, arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(where)
                for a in arrays]

    def smoke_parity(kind: str) -> dict:
        """4 steps on the card (kernels) and on the CPU (plain versions),
        each side fed the CPU's greedy tokens.  ``paged_*``: one prefill
        chunk (two slots, one padded) then 3 decode ticks over pools of
        that kv dtype; ``slot``: 4 decode steps over the contiguous cache,
        one slot starting empty."""
        prm_key = "int8" if kind == "paged_int8" else "bf16"
        prm = {"cpu": smoke_params[prm_key],
               "cuda": {k: v.to(dev) for k, v in
                        smoke_params[prm_key].items()}}
        if kind == "slot":
            caches = {w: b_.init_cache(2, 16) for w, b_ in bundles.items()}
            tokens, lengths = smoke_tokens[:, :1], np.array([0, 3], np.int32)
        else:
            kv = "int8" if kind == "paged_int8" else "bfloat16"
            caches = {w: b_.init_paged_cache(9, 8, kv)
                      for w, b_ in bundles.items()}
            tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
            tokens, lengths = smoke_tokens, np.zeros(2, np.int32)
            counts = np.array([8, 5], np.int32)
        diffs, agree, total, flips = [], 0, 0, []
        for step in range(4):
            out = {}
            for where, b_ in bundles.items():
                if kind == "slot":
                    logits = b_.decode_step(prm[where], caches[where],
                                            *on(where, (tokens, lengths)))
                    out[where] = logits[:, 0].float().cpu()
                else:
                    logits = b_.decode_paged(
                        prm[where], caches[where],
                        *on(where, (tokens, lengths, counts, tables)))
                    out[where] = logits[[0, 1], torch.from_numpy(
                        counts - 1).long().to(where)].float().cpu()
            diffs.append(float((out["cpu"] - out["cuda"]).abs().max()))
            nxt, got = out["cpu"].argmax(-1), out["cuda"].argmax(-1)
            agree += int((nxt == got).sum())
            total += 2
            for row in torch.nonzero(nxt != got).flatten().tolist():
                # how far below the CPU's best the card's pick sits on the
                # CPU's own logits
                flips.append(dict(step=step, row=row, cpu_gap=float(
                    out["cpu"][row, nxt[row]] - out["cpu"][row, got[row]])))
            tokens = nxt.numpy()[:, None].astype(np.int32)
            if kind == "slot":
                lengths = lengths + 1
            else:
                lengths = lengths + counts
                counts = np.ones(2, np.int32)
        return dict(max_abs_logits_diff=max(diffs), per_step=diffs,
                    greedy_agree=agree, greedy_total=total, flips=flips,
                    bound=SMOKE_LOGITS_BOUND)

    parity = {kind: smoke_parity(kind)
              for kind in ("paged_bf16", "paged_int8", "slot")}
    for arch in RECURRENT_ARCHS:
        for kind, r in recurrent_smoke_parity(torch, arch, args.seed,
                                              dev).items():
            parity[f"{arch.split('-')[0]}_{kind}"] = r
    report["smoke_parity"] = parity
    print("[5] smoke llama3-8b, rwkv6-3b and mamba2-2.7b, card (kernels) vs "
          f"CPU (plain), same weights (bound {SMOKE_LOGITS_BOUND} on max "
          "|logits diff|):")
    for kind, r in parity.items():
        print(f"    {kind:14s} max |logits diff| "
              f"{r['max_abs_logits_diff']:.4g}, per step "
              f"{[round(x, 4) for x in r['per_step']]}, greedy tokens agree "
              f"{r['greedy_agree']}/{r['greedy_total']}"
              + "".join(f"; step {f['step']} row {f['row']}: the card's token"
                        f" is {f['cpu_gap']:.4g} below the CPU's best on the "
                        f"CPU's logits" for f in r["flips"]))
    for kind, r in parity.items():
        err = r["max_abs_logits_diff"]
        if not math.isfinite(err) or err > SMOKE_LOGITS_BOUND:
            fail(f"{kind}: card and CPU logits differ beyond the bound")

    phase_done("phase 5")

    # ---------------------------------------------------------------- 6 CNNs

    def forward_ms(fn, iters: int) -> float:
        """Host milliseconds per call of ``fn()``, after a warm call,
        ending in a synchronize: what a caller waits for a forward."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    nets = {}
    for name, spec in CNNS.items():
        g = torch.Generator(device=dev).manual_seed(args.seed)
        params = spec["params"](g, device=dev)
        x = torch.randn((CNN_BATCH,) + spec["input"], generator=g, device=dev)
        nets[name] = (spec["forward"], params, x)
        spec["forward"](params, x)                    # warm
    torch.cuda.synchronize()
    # the main path: one forward of each net, every conv on apr_conv
    reset_counts()
    per_net, logits = {}, {}
    for name, (fwd, params, x) in nets.items():
        before = apr_conv2d.launches
        logits[name] = fwd(params, x)
        per_net[name] = apr_conv2d.launches - before
    torch.cuda.synchronize()
    cnn_launches = {"apr_conv": apr_conv2d.launches,
                    "apr_conv_fused": apr_conv2d_fused.launches,
                    "apr_conv_hbm": apr_conv2d.hbm_launches,
                    "apr_matmul": apr_matmul.launches,
                    "flash_decode_paged": flash_decode_paged.launches}
    expect_per_net = {name: len(conv_geometries(name)) for name in CNNS}
    # the baseline path: ResNet-20 with every conv memory-resident
    fwd, params, x = nets["resnet20"]
    reset_counts()
    logits_hbm = fwd(params, x, conv=hbm_conv)
    torch.cuda.synchronize()
    hbm_launches = apr_conv2d.hbm_launches
    expect_hbm = sum(-(-math.prod(g["f_shape"][:3]) // conv_ops.K_STEP)
                     for g in conv_geometries("resnet20"))
    hbm_rel = rel_logits_err(logits_hbm, logits["resnet20"])
    logits_plain = fwd(params, x, conv=conv2d_ref)
    plain_rel = rel_logits_err(logits["resnet20"], logits_plain)
    cnn = dict(batch=CNN_BATCH, launches_per_forward=per_net,
               expected_per_forward=expect_per_net, main_path_launches=
               cnn_launches, hbm_launches=hbm_launches,
               expected_hbm_launches=expect_hbm,
               resnet20_hbm_vs_apr_rel=hbm_rel,
               resnet20_apr_vs_plain_rel=plain_rel,
               max_abs_logit={n: float(v.abs().max())
                              for n, v in logits.items()})
    print(f"[6] CNN inference at batch {CNN_BATCH}: apr_conv launches per "
          f"forward {per_net} (expected {expect_per_net}); ResNet-20 on "
          f"apr_conv_hbm: {hbm_launches} launches (expected {expect_hbm}); "
          f"ResNet-20 max |diff| / max |logit|: hbm vs apr {hbm_rel:.3g}, "
          f"apr vs plain {plain_rel:.3g} (bound {CNN_LOGITS_RTOL:g})")
    if per_net != expect_per_net:
        fail(f"apr_conv launches {per_net} != {expect_per_net}")
    if hbm_launches != expect_hbm:
        fail(f"apr_conv_hbm launches {hbm_launches} != {expect_hbm}")
    for name, v in list(logits.items()) + [("resnet20 hbm", logits_hbm)]:
        if v.shape != (CNN_BATCH, 10) or not bool(torch.isfinite(v).all()):
            fail(f"{name}: logits {tuple(v.shape)} not finite of shape "
                 f"({CNN_BATCH}, 10)")
    if not hbm_rel <= CNN_LOGITS_RTOL or not plain_rel <= CNN_LOGITS_RTOL:
        fail("ResNet-20 forwards disagree beyond the bound")
    del logits, logits_hbm, logits_plain

    # times per forward (host clock around synchronised calls)
    fwd, params, x = nets["resnet20"]
    x1 = x[:1].contiguous()
    runs = [(f"lenet b{CNN_BATCH}", CNN_BATCH, 20, nets["lenet"][0],
             nets["lenet"][1], nets["lenet"][2], apr_conv2d),
            (f"resnet20 b{CNN_BATCH}", CNN_BATCH, 20, fwd, params, x,
             apr_conv2d),
            (f"resnet20 b{CNN_BATCH} hbm", CNN_BATCH, 10, fwd, params, x,
             hbm_conv),
            (f"resnet20 b{CNN_BATCH} plain", CNN_BATCH, 20, fwd, params, x,
             conv2d_ref),
            ("resnet20 b1", 1, 50, fwd, params, x1, apr_conv2d),
            ("resnet20 b1 plain", 1, 50, fwd, params, x1, conv2d_ref)]
    times, rates = {}, {}
    for label, batch, iters, f_, p_, x_, conv in runs:
        times[label] = forward_ms(lambda: f_(p_, x_, conv=conv), iters)
        rates[label] = batch / times[label] * 1e3
        print(f"    {label:22s} {times[label]:9.4f} ms per forward, "
              f"{rates[label]:10.1f} images/s")
    cnn["ms_per_forward"], cnn["images_per_s"] = times, rates
    prof = profile_device(torch, lambda: fwd(params, x), 5)
    if prof:
        busy = sum(prof.values())
        wall = times[f"resnet20 b{CNN_BATCH}"]
        top = sorted(prof.items(), key=lambda kv: -kv[1])[:6]
        cnn["profiled_resnet20"] = dict(wall_ms=wall, device_busy_ms=busy,
                                        idle_share=1 - busy / wall,
                                        top_kernels_ms=dict(top))
        print(f"    ResNet-20 forward at batch {CNN_BATCH}: wall {wall:.3f} "
              f"ms, device busy {busy:.3f} ms (profiler), idle share "
              f"{1 - busy / wall:.1%}")
        for kname, t in top:
            print(f"      {t:8.3f} ms  {kname[:90]}")

    # card (kernels) vs CPU (plain), same weights, batch 2
    parity = {}
    for name, spec in CNNS.items():
        g = torch.Generator().manual_seed(args.seed)
        p_cpu = spec["params"](g, device="cpu")
        x_cpu = torch.randn((2,) + spec["input"], generator=g)
        ref = spec["forward"](p_cpu, x_cpu)
        got = spec["forward"]({k: v.to(dev) for k, v in p_cpu.items()},
                              x_cpu.to(dev)).cpu()
        parity[name] = dict(rel=rel_logits_err(got, ref),
                            max_abs_logit=float(ref.abs().max()),
                            argmax_equal=bool(torch.equal(got.argmax(-1),
                                                          ref.argmax(-1))))
    cnn["card_vs_cpu"] = parity
    report["cnn"] = cnn
    print(f"    card (kernels) vs CPU (plain), batch 2: "
          + ", ".join(f"{n} max|diff|/max|logit| {v['rel']:.3g} (max |logit| "
                      f"{v['max_abs_logit']:.4g}), argmax equal "
                      f"{v['argmax_equal']}" for n, v in parity.items())
          + f" (bound {CNN_LOGITS_RTOL:g})")
    if not all(v["rel"] <= CNN_LOGITS_RTOL and v["argmax_equal"]
               for v in parity.values()):
        fail("CNN logits on the card and the CPU disagree")
    del nets
    phase_done("phase 6")

    # --------------------------------- 7 recurrent serving, full width
    recurrent = {}
    for arch in RECURRENT_ARCHS:
        rec = recurrent_serving(torch, arch, args.seed, dev, checked, finite,
                                reset_counts, llm_counts, check_served)
        recurrent[arch] = rec
        pg, sl, pf = rec["paged"], rec["slot"], rec["prefill_1024"]
        tick = pg["profiled_tick"]
        print(f"[7] {arch} full width ({rec['layers']} layers, "
              f"{rec['weight_gb']:.2f} GB bf16 weights, init "
              f"{rec['init_s']:.2f} s); one token-forward launches "
              f"{rec['per_forward_launches']}")
        print(f"    PagedServeEngine + StateCache: {pg['requests_done']}/"
              f"{len(RECURRENT_PROMPTS)} requests (prompts "
              f"{list(RECURRENT_PROMPTS)}, {RECURRENT_NEW} new tokens, 4 "
              f"slots, prefill chunks of 16) in {pg['wall_s']:.2f} s wall; "
              f"decode {pg['decode_tokens']} tok in {pg['decode_calls']} "
              f"ticks: {pg['decode_tps']:.2f} tok/s, "
              f"{pg['decode_ms_per_tick']:.3f} ms per tick (bound "
              f"{pg['tick_bound_ms']:.3f} ms: weights but the embedding and "
              f"4 states read and written once); prefill "
              f"{pg['prefill_tokens']} tok in {pg['prefill_calls']} chunks: "
              f"{pg['prefill_ms_per_chunk']:.3f} ms per chunk; TTFT mean "
              f"{pg['mean_ttft_s'] * 1e3:.2f} ms, p50 "
              f"{pg['p50_ttft_s'] * 1e3:.2f} ms; peak memory "
              f"{pg['peak_mem_gb']:.2f} GB; state pools "
              f"{pg['state_pool_bytes']} bytes ({pg['state_pool_slots']} "
              f"slots)")
        print(f"    launches {pg['launches']} over {pg['token_forwards']} "
              f"token-forwards (expected {pg['expected_launches']})")
        print(f"    decode tick at lengths {list(RECURRENT_PROMPTS[:4])}: wall "
              f"{tick['wall_ms']:.3f} ms"
              + (f", device busy {tick['device_busy_ms']:.3f} ms "
                 f"(profiler), idle share {tick['idle_share']:.1%}, "
                 f"{tick['device_ops']:.0f} device ops (kernels and copies)"
                 if "idle_share" in tick else ", profiler unavailable"))
        for name, t in tick.get("top_kernels_ms", {}).items():
            print(f"      {t:8.3f} ms  {name[:90]}")
        print(f"    slot ServeEngine: {sl['forwards']} decode forwards in "
              f"{sl['wall_s']:.2f} s wall, {sl['ms_per_forward']:.3f} ms mean "
              f"({sl['ms_per_forward_median']:.3f} median), TTFT mean "
              f"{sl['mean_ttft_s'] * 1e3:.2f} ms; launches {sl['launches']}; "
              f"greedy tokens equal to the paged engine's "
              f"{sl['tokens_equal_paged']}/{sl['tokens_total']}")
        print(f"    prefill of 1024 tokens: kernels {pf['kernel_ms']:.3f} ms, "
              f"plain path (chunked formulas) {pf['plain_ms']:.3f} ms, "
              f"per-step plain scans {pf['per_step_plain_ms']:.3f} ms; "
              f"every layer's scan vs its plain version on the same inputs: "
              f"y max rel {pf['layer_y_max_rel']:.3g}, state max rel "
              f"{pf['layer_state_max_rel']:.3g} ({pf['layers_checked']} "
              f"layers, phase-2 tolerances: the gate); for information, "
              f"last-position logits max |diff| kernel vs plain path "
              f"{pf['max_abs_logits_diff']:.4g}, the two plain versions "
              f"{pf['plain_pair_diff']:.4g} apart (max |logit| "
              f"{pf['max_abs_logit']:.4g}), argmax equal "
              f"{pf['argmax_equal']}; launches {pf['launches']}")
        if sl["tokens_equal_paged"] != sl["tokens_total"]:
            fail(f"{arch}: the slot engine's greedy tokens differ from the "
                 f"paged engine's ({sl['tokens_equal_paged']}/"
                 f"{sl['tokens_total']})")
    report["recurrent"] = recurrent
    phase_done("phase 7")

    # ------------------------- 8 the tuning path at llama3-8b full width
    tuning = tuning_path(torch, args.seed, dev, tmp.name, engine_kw, prompts,
                         bf16_outputs, checked, finite, reset_counts,
                         llm_counts, expected_counts, check_served)
    report["tuning"] = tuning
    phase_done("phase 8")

    # ------------------------------------------------------------- 9 report
    def tick_entry(name, source, replaces, n, kernel=None, row=None):
        """A kernels-line entry timed per full-width decode tick: the 225
        projections of phase 3's ``kernel`` rows, or 32 launches of
        ``row``."""
        if row is None:
            t = {key: per_tick(key, kernel) for key in (
                "ms", "plain_ms", "bound_ms", "library_ms", "t_mem_ms",
                "t_ops_ms")}
            bound_by = "bytes" if t["t_mem_ms"] >= t["t_ops_ms"] \
                else "operations"
        else:
            t = {key: cfg.num_layers * row[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")}
            bound_by = row["bound_by"]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=n, max_abs_err=errs[name], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=bound_by, library_ms=t["library_ms"])

    mm_src = "src/repro_torch/csrc/apr_matmul.cu"
    fd_src = "src/repro_torch/csrc/flash_decode.cu"
    kernels = [
        tick_entry("apr_matmul", mm_src,
                   "src/repro/kernels/apr_matmul/kernel.py:139",
                   serve["launches"]["apr_matmul"], kernel="apr_matmul"),
        tick_entry("apr_matmul_int8w", mm_src,
                   "src/repro/kernels/apr_matmul/kernel.py:139",
                   serve_q["launches"]["apr_matmul_int8w"],
                   kernel="apr_matmul_int8w"),
        tick_entry("flash_decode_paged", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:153",
                   serve["launches"]["flash_decode_paged"], row=fd_row),
        tick_entry("flash_decode_paged_int8", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:81",
                   serve_q["launches"]["flash_decode_paged_int8"],
                   row=fdq_row),
        tick_entry("flash_decode", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:240",
                   slot["launches"]["flash_decode"], row=fdc_row),
    ]
    conv_bound_by = ("bytes" if conv_total["t_mem_ms"] >=
                     conv_total["t_ops_ms"] else "operations")
    for name, key, n, err in (
            ("apr_conv", "ms", cnn_launches["apr_conv"], errs["apr_conv"]),
            ("apr_conv_hbm", "hbm_ms", hbm_launches, errs["apr_conv_hbm"])):
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/apr_conv.cu",
            replaces=("src/repro/kernels/apr_conv/kernel.py:44"
                      if name == "apr_conv" else
                      "src/repro/kernels/apr_matmul/kernel.py:124"),
            launches=n, max_abs_err=err, ms=conv_total[key],
            plain_ms=conv_total["plain_ms"], bound_ms=conv_total["bound_ms"],
            bound_by=conv_bound_by, library_ms=conv_total["library_ms"]))
    # B9 and B10 per full-width decode tick at 4 slots: one launch per
    # layer at the phase-3 decode shape (32 rwkv6 layers, 64 mamba2 ones)
    for name, arch, source, replaces in (
            ("rwkv6_wkv", "rwkv6-3b", "src/repro_torch/csrc/rwkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:61"),
            ("mamba2_ssd", "mamba2-2.7b", "src/repro_torch/csrc/mamba2.cu",
             "src/repro/kernels/mamba2/kernel.py:59")):
        row = next(r for r in scan_rows
                   if r["kernel"] == name and r["shape"] == "decode")
        n_layers = recurrent[arch]["layers"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=recurrent[arch]["paged"]["launches"][name],
            max_abs_err=errs[name], ms=n_layers * row["ms"],
            plain_ms=n_layers * row["plain_ms"],
            bound_ms=n_layers * row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None))
    # B4m, B7m, B6 and B8 per full-width decode tick (M = slots), as if
    # the tick's 224 projections (no lm_head) ran on them; launches are
    # those of phase 8's counted window (the sweep and the tuned engine)
    for name, source, replaces in (
            ("apr_matmul_hbm", mm_src,
             "src/repro/kernels/apr_matmul/kernel.py:124"),
            ("apr_matmul_fused", mm_src,
             "src/repro/kernels/apr_matmul/kernel.py:86"),
            ("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
             "src/repro/kernels/quant_matmul/kernel.py:125"),
            ("quant_matmul_fused", "src/repro_torch/csrc/quant_matmul.cu",
             "src/repro/kernels/quant_matmul/kernel.py:81")):
        t = {key: per_tick(key, name, lm_head=False) for key in (
            "ms", "plain_ms", "bound_ms", "library_ms", "t_mem_ms",
            "t_ops_ms")}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=tuning["launches"][name], max_abs_err=errs[name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes" if t["t_mem_ms"] >= t["t_ops_ms"]
            else "operations", library_ms=t["library_ms"]))
    report["kernels"] = kernels
    report["kernels_note"] = (
        "apr_matmul, apr_matmul_int8w, flash_decode_paged, "
        "flash_decode_paged_int8 and flash_decode: ms, plain_ms, bound_ms and "
        "library_ms are per full-width decode tick (4 slots): 225 projection "
        "shapes, 32 decode-attention launches at the phase-3 lengths "
        "(flash_decode over a max_seq-256 contiguous cache); launches are "
        "those of phase 4 (bf16 paged), 4b (int8 paged) and 4c (slot). "
        "apr_conv and apr_conv_hbm: per ResNet-20 forward at batch "
        f"{CNN_BATCH} (21 convs; library F.conv2d, channels-last fp32 without "
        "TF32); launches are those of phase 6's main path (one LeNet-5 and "
        "one ResNet-20 forward) and of its memory-resident ResNet-20 forward. "
        "rwkv6_wkv and mamba2_ssd: per full-width decode tick (4 slots, "
        "state in and out): 32 and 64 launches at the phase-3 decode shape; "
        "no PyTorch call computes either recurrence (library_ms null); "
        "launches are those of phase 7's PagedServeEngine runs. "
        "apr_matmul_hbm (B4m), apr_matmul_fused (B7m, bias + silu), "
        "quant_matmul (B6) and quant_matmul_fused (B8, bias + silu): per "
        "full-width decode tick's 224 projections (no lm_head) at the "
        "default tile, bf16 out; the int8 rows include the activations' "
        "quantization, their library (quantization, torch._int_mm, the two "
        "scale multiplies, + bias and silu) is timed at M = 32 where "
        "_int_mm refuses M <= 16; launches are those of phase 8's counted "
        "window (warm_cache sweep and the tuned engine's serving)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi could not read the card: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    report["nvidia_smi"] = card
    report["total_s"] = time.perf_counter() - t_start
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    report["phase_s"] = phase_s
    print(f"[9] wrote {out}; total {report['total_s']:.1f} s (per phase "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} })")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
