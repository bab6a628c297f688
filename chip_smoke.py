#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a GPU host

Phases (any failure exits non-zero before the final line):
  1. build the CUDA kernels of ``src/repro_torch/csrc`` with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it and at ragged ones;
  3. time each kernel, its plain version and a PyTorch library call at the
     serving path's shapes with CUDA events, beside the card's bound;
  4. serve full-width llama3-8b (32 layers, random bf16 weights from a seed)
     on the port's PagedServeEngine: 6 ragged requests on 4 slots, and check
     every kernel of the path was launched as often as the path demands;
  5. run the smoke llama3-8b config through ``decode_paged`` on the card
     (kernels) and on the CPU (plain versions) with the same weights, and
     compare the logits;
  6. run the paper's CNNs (LeNet-5, ResNet-20; random fp32 weights from a
     seed) at batch 256 with every conv on ``apr_conv``, check each
     forward's launches, run ResNet-20 on the memory-resident baseline
     (``apr_conv_hbm``) and on the plain path, time all of them and ResNet-20
     at batch 1, and compare card (kernels) and CPU (plain) logits;
  7. print the kernels' line, the card's name and power limit, and as the
     last line ``{"ok": true, "device": {...}}``.

Everything the run measured also goes to ``chiprun_out/chip_smoke.json``.
It needs nothing beyond this repository, PyTorch with CUDA, and nvcc.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
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
#: bound on |logits(card, kernels) - logits(CPU, plain)| for the smoke model,
#: whose logits are O(1): the decode attention kernel keeps scores and
#: weights in fp32 where the plain path rounds them to bf16
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


def max_err(got, ref) -> tuple:
    """(max |got - ref|, whether every element is within tolerance)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    ok = bool((diff <= BF16_RTOL * r.abs() + ATOL).all()) and \
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


def profile_device(torch, fn, reps: int):
    """Device milliseconds per call of ``fn()``, by kernel name, over
    ``reps`` calls traced by ``torch.profiler`` (device-side events only: an
    aten op's own row repeats its kernels); None where the profiler cannot
    trace, since it is a measurement and not a phase."""
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
            continue
        t = ev.self_device_time_total / 1e3 / reps
        if t > 0:
            by_kernel[ev.key] = t
    if not by_kernel:
        print("    profiler recorded no device time")
    return by_kernel


def rel_logits_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.apr import reduction_hbm_traffic
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_conv import (apr_conv2d, apr_conv2d_fused,
                                              conv2d_fused_ref, conv2d_ref)
    from repro_torch.kernels.apr_conv import ops as conv_ops
    from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
    from repro_torch.kernels.apr_matmul import ops as apr_ops
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  gather_pages,
                                                  paged_decode_attention_ref)
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models import build_model
    from repro_torch.models.cnn import CNNS, conv_geometries, hbm_conv
    from repro_torch.serve import PagedServeEngine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    _build.build_all({apr_ops.LIBRARY: apr_ops.SIGNATURES,
                      fd_ops.LIBRARY: fd_ops.SIGNATURES,
                      conv_ops.LIBRARY: conv_ops.SIGNATURES})
    build_s = time.perf_counter() - t0
    print(f"[1] built {sorted(_build.BUILD_SECONDS) or 'nothing (cached)'} "
          f"in {build_s:.2f} s (nvcc, sm_90a, one process per source)")
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    report["build_s"] = build_s

    # ------------------------------------------------------------ 2 correct
    errs = {"apr_matmul": 0.0, "flash_decode_paged": 0.0, "apr_conv": 0.0,
            "apr_conv_hbm": 0.0}
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
        del x, xb, w

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
    print(f"[2] kernel vs plain version on the card (tolerance "
          f"{BF16_RTOL:.4g}*|plain| + {ATOL:g}; conv kernels "
          f"{CONV_RTOL:g}*|plain| + {CONV_RTOL:g}*max|plain|):")
    for name, shape, err, ok in cases:
        print(f"    {'ok  ' if ok else 'FAIL'} {name:19s} {shape:50s} "
              f"max_abs_err={err:.3g}")
    report["correctness"] = [dict(kernel=n, case=s, max_abs_err=e, ok=o)
                             for n, s, e, o in cases]
    if not all(ok for *_, ok in cases):
        fail("a kernel disagrees with its plain version")

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
            per_shape[(m, k, n)] = row
            del ws, x
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
    del q, kp, vp
    torch.cuda.empty_cache()
    print("[3] kernel times (CUDA events, cold weights: buffers rotated past "
          "the 50 MB L2):")
    for r in timing:
        shape = (f"M={r['M']:<3d} K={r['K']:<6d} N={r['N']:<7d}"
                 if r["kernel"] == "apr_matmul" else
                 f"B={r['B']} Hq={r['Hq']} Hkv={r['Hkv']} D={r['D']} "
                 f"ps={r['ps']} lengths={r['lengths']}")
        print(f"    {r['kernel']:19s} {shape:40s} kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['bound_ms'] / r['ms']:.0%} of bound")
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
        out_elems = CNN_BATCH * ((xs[1] + 2 * p - fs[0]) // s + 1) * \
            ((xs[2] + 2 * p - fs[1]) // s + 1) * fs[3]
        partial_bytes = (reduction_hbm_traffic(out_elems, steps, 4, "hbm")
                         - reduction_hbm_traffic(out_elems, steps, 4, "apr"))
        conv_rows[key] = dict(
            layer=g["param"], count=1, x_shape=xs, f_shape=fs, stride=s,
            padding=p, K=k, hbm_steps=steps, ms=t_k, hbm_ms=t_h,
            plain_ms=t_p, library_ms=t_l, partial_bytes=partial_bytes,
            **bound_ms(4 * (x.numel() + f.numel() + out_elems),
                       2 * out_elems * k, FP32_FLOPS_PER_S))
        del x, f, x_cl, w_cl
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
              f"{r['bound_ms'] / r['ms']:.0%} of bound")

    def per_forward(key):
        """Sum over the 21 convs of one ResNet-20 forward at CNN_BATCH."""
        return sum(r["count"] * r[key] for r in conv_rows)

    report["conv_timing"] = conv_rows
    conv_total = {key: per_forward(key) for key in (
        "ms", "hbm_ms", "plain_ms", "library_ms", "bound_ms", "t_mem_ms",
        "t_ops_ms", "partial_bytes")}
    report["conv_per_forward"] = conv_total
    print(f"    per ResNet-20 forward: apr_conv {conv_total['ms']:.4f} ms, "
          f"apr_conv_hbm {conv_total['hbm_ms']:.4f} ms (+"
          f"{conv_total['partial_bytes'] / 1e9:.3f} GB of partial sums "
          f"through global memory, L2/HBM), plain "
          f"{conv_total['plain_ms']:.4f} ms, F.conv2d "
          f"{conv_total['library_ms']:.4f} ms, bound "
          f"{conv_total['bound_ms']:.4f} ms")

    def per_tick(key):
        """Sum over one full-width decode tick (M = slots): 7 projections
        in each of 32 layers plus the lm_head."""
        layer = sum(cnt * per_shape[(slots, k, n)][key]
                    for (k, n), cnt in LLAMA_DECODE_SHAPES.items())
        return 32 * layer + per_shape[(slots,) + LM_HEAD][key]

    # -------------------------------------------------------------- 4 serve
    cfg = get_config("llama3-8b")
    bundle = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(
        args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
    finite = []
    forward = bundle.decode_paged

    def checked_forward(*a):
        logits = forward(*a)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits

    bundle.decode_paged = checked_forward
    engine_kw = dict(device="cuda", slots=slots, page_size=16,
                     prefill_chunk=16)
    warm = PagedServeEngine(bundle, params, **engine_kw)   # first launches
    warm.submit(Request(rid=-1, prompt=[1] * 20, max_new_tokens=2))
    warm.run_until_drained()
    del warm
    rng = np.random.default_rng(args.seed)
    prompt_lens = [24, 180, 57, 133, 96, 40]
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               size=n).tolist(),
                    max_new_tokens=16) for i, n in enumerate(prompt_lens)]
    engine = PagedServeEngine(bundle, params, **engine_kw)
    torch.cuda.reset_peak_memory_stats()
    apr_matmul.launches = 0
    flash_decode_paged.launches = 0
    finite.clear()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"apr_matmul": apr_matmul.launches,
                "flash_decode_paged": flash_decode_paged.launches}
    m = engine.metrics
    per_call = 7 * cfg.num_layers + 1
    expect = {"apr_matmul": per_call * (m.decode_calls + m.prefill_calls),
              "flash_decode_paged": cfg.num_layers * m.decode_calls}
    serve = dict(arch=cfg.name, layers=cfg.num_layers, weight_gb=weight_gb,
                 init_s=init_s, wall_s=wall_s, **m.summary(),
                 decode_ms_per_tick=1e3 * m.decode_time_s / m.decode_calls,
                 prefill_ms_per_chunk=1e3 * m.prefill_time_s / m.prefill_calls,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=launches, expected_launches=expect)
    report["serve"] = serve
    print(f"[4] served {m.requests_done}/{len(reqs)} requests of full-width "
          f"{cfg.name} ({cfg.num_layers} layers, {weight_gb:.2f} GB bf16 "
          f"weights, init {init_s:.2f} s) in {wall_s:.2f} s wall:")
    print(f"    decode {m.decode_tokens} tok in {m.decode_calls} ticks: "
          f"{m.decode_tps:.2f} tok/s, {serve['decode_ms_per_tick']:.3f} ms "
          f"per tick; prefill {m.prefill_tokens} tok in {m.prefill_calls} "
          f"chunks: {m.prefill_tps:.2f} tok/s, "
          f"{serve['prefill_ms_per_chunk']:.3f} ms per chunk")
    print(f"    TTFT mean {m.mean_ttft * 1e3:.2f} ms, p50 "
          f"{m.p50_ttft * 1e3:.2f} ms; peak memory "
          f"{serve['peak_mem_gb']:.2f} GB; launches {launches} "
          f"(expected {expect})")
    if m.requests_done != len(reqs) or not all(r.done for r in reqs):
        fail("not every request finished")
    if any(len(r.output) != 16 for r in reqs):
        fail("a request produced the wrong number of tokens")
    if not finite or not all(finite):
        fail("non-finite logits on the serving path")
    if launches != expect:
        fail(f"kernel launches {launches} != expected {expect}")

    # where a decode tick's time goes: device busy time (sum of kernel
    # times on the one stream) against the tick's wall time, at the
    # phase-3 lengths
    need = [-(-(n + 1) // 16) for n in main_lengths]
    tick_tables = np.zeros((slots, engine.kv.max_pages_per_slot), np.int32)
    at = 1
    for i, n in enumerate(need):
        tick_tables[i, :n] = np.arange(at, at + n)
        at += n
    tick_args = [torch.from_numpy(a).to(dev) for a in (
        np.ones((slots, 1), np.int32), np.asarray(main_lengths, np.int32),
        np.ones(slots, np.int32), tick_tables)]
    forward(params, engine.cache, *tick_args)          # warm
    torch.cuda.synchronize()
    ticks = 5
    t0 = time.perf_counter()                           # wall, profiler off
    for _ in range(ticks):
        forward(params, engine.cache, *tick_args)
    torch.cuda.synchronize()
    tick_wall = (time.perf_counter() - t0) / ticks * 1e3
    by_kernel = profile_device(
        torch, lambda: forward(params, engine.cache, *tick_args), ticks)
    if by_kernel:
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        serve["profiled_tick"] = dict(wall_ms=tick_wall, device_busy_ms=busy,
                                      idle_share=1 - busy / tick_wall,
                                      top_kernels_ms=dict(top))
        print(f"    decode tick at lengths {main_lengths}: wall "
              f"{tick_wall:.3f} ms, device busy {busy:.3f} ms (profiler), "
              f"idle share {1 - busy / tick_wall:.1%}")
        for name, t in top:
            print(f"      {t:8.3f} ms  {name[:90]}")
    del params, engine, bundle
    torch.cuda.empty_cache()

    # ----------------------------------------------- 5 card vs CPU, smoke
    scfg = get_config("llama3-8b", smoke=True)
    cpu_bundle = build_model(scfg, device="cpu")
    gpu_bundle = build_model(scfg, device="cuda")
    cpu_params = cpu_bundle.init_params(
        torch.Generator().manual_seed(args.seed))
    gpu_params = {k: v.to(dev) for k, v in cpu_params.items()}
    caches = {"cpu": cpu_bundle.init_paged_cache(9, 8),
              "cuda": gpu_bundle.init_paged_cache(9, 8)}
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    tokens = rng.integers(1, scfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = np.zeros(2, np.int32)
    counts = np.array([8, 5], np.int32)
    diffs, agree, total = [], 0, 0
    for step in range(4):        # one prefill chunk, then 3 decode ticks
        out = {}
        for where, bnd, prm in (("cpu", cpu_bundle, cpu_params),
                                ("cuda", gpu_bundle, gpu_params)):
            d_ = torch.device(where)
            a = [torch.from_numpy(np.ascontiguousarray(t)).to(d_)
                 for t in (tokens, lengths, counts, tables)]
            logits = bnd.decode_paged(prm, caches[where], *a)
            out[where] = logits[[0, 1], torch.from_numpy(counts - 1).long()
                                .to(d_)].float().cpu()
        diffs.append(float((out["cpu"] - out["cuda"]).abs().max()))
        nxt = out["cpu"].argmax(-1)
        agree += int((nxt == out["cuda"].argmax(-1)).sum())
        total += 2
        lengths = lengths + counts
        counts = np.ones(2, np.int32)
        tokens = nxt.numpy()[:, None].astype(np.int32)
    smoke_err = max(diffs)
    report["smoke_parity"] = dict(max_abs_logits_diff=smoke_err,
                                  per_step=diffs, greedy_agree=agree,
                                  greedy_total=total,
                                  bound=SMOKE_LOGITS_BOUND)
    print(f"[5] smoke llama3-8b, card (kernels) vs CPU (plain), same weights:"
          f" max |logits diff| {smoke_err:.4g} (bound {SMOKE_LOGITS_BOUND}),"
          f" per step {[round(x, 4) for x in diffs]}, greedy tokens agree "
          f"{agree}/{total}")
    if not math.isfinite(smoke_err) or smoke_err > SMOKE_LOGITS_BOUND:
        fail("card and CPU logits differ beyond the bound")

    # ---------------------------------------------------------------- 6 CNNs
    def reset_counts():
        apr_matmul.launches = 0
        flash_decode_paged.launches = 0
        apr_conv2d.launches = 0
        apr_conv2d.hbm_launches = 0
        apr_conv2d_fused.launches = 0

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

    # ------------------------------------------------------------- 7 report
    kernels = [
        dict(name="apr_matmul", route="cuda",
             source="src/repro_torch/csrc/apr_matmul.cu",
             replaces="src/repro/kernels/apr_matmul/kernel.py:139",
             launches=launches["apr_matmul"],
             max_abs_err=errs["apr_matmul"],
             ms=per_tick("ms"), plain_ms=per_tick("plain_ms"),
             bound_ms=per_tick("bound_ms"),
             bound_by=("bytes" if per_tick("t_mem_ms") >= per_tick("t_ops_ms")
                       else "operations"),
             library_ms=per_tick("library_ms")),
        dict(name="flash_decode_paged", route="cuda",
             source="src/repro_torch/csrc/flash_decode_paged.cu",
             replaces="src/repro/kernels/flash_decode/kernel.py:153",
             launches=launches["flash_decode_paged"],
             max_abs_err=errs["flash_decode_paged"],
             ms=cfg.num_layers * fd_row["ms"],
             plain_ms=cfg.num_layers * fd_row["plain_ms"],
             bound_ms=cfg.num_layers * fd_row["bound_ms"],
             bound_by=fd_row["bound_by"],
             library_ms=cfg.num_layers * fd_row["library_ms"]),
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
    report["kernels"] = kernels
    report["kernels_note"] = (
        "apr_matmul and flash_decode_paged: ms, plain_ms, bound_ms and "
        "library_ms are per full-width decode tick (4 slots): 225 apr_matmul "
        "shapes, 32 flash_decode_paged launches at the phase-3 lengths. "
        "apr_conv and apr_conv_hbm: per ResNet-20 forward at batch "
        f"{CNN_BATCH} (21 convs; library F.conv2d, channels-last fp32 without "
        "TF32); launches are those of phase 6's main path (one LeNet-5 and "
        "one ResNet-20 forward) and of its memory-resident ResNet-20 forward")
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
    print(f"[7] wrote {out}; total {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
