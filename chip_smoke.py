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
  6. print the kernels' line, the card's name and power limit, and as the
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

#: published peaks of one H100 SXM (NVIDIA data sheet; dense bf16)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
#: |kernel - plain| <= BF16_RTOL * |plain| + ATOL: the two sum the same
#: fp32 products in another order and round once to bf16, so a value on a
#: rounding boundary may land one bf16 ulp (<= 2^-7 relative) apart
BF16_RTOL, ATOL = 2.0 ** -7, 1e-3
#: bound on |logits(card, kernels) - logits(CPU, plain)| for the smoke model,
#: whose logits are O(1): the decode attention kernel keeps scores and
#: weights in fp32 where the plain path rounds them to bf16
SMOKE_LOGITS_BOUND = 0.25
LLAMA_DECODE_SHAPES = {             # (K, N) -> launches per layer at M = slots
    (4096, 4096): 2,                # wq, wo
    (4096, 1024): 2,                # wk, wv
    (4096, 14336): 2,               # w_gate, w_up
    (14336, 4096): 1,               # w_down
}
LM_HEAD = (4096, 128256)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls, between
    two CUDA events.  The stream is held busy first (``torch.cuda._sleep``)
    while the host enqueues every call, so the events time the kernels
    back to back and not the host's launch rate."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 2e5))       # ~0.1 ms of cycles per call
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes moved over its memory
    rate or operations over its bf16 rate, whichever is larger."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_mem, t_ops), t_mem_ms=t_mem, t_ops_ms=t_ops,
                bound_by="bytes" if t_mem >= t_ops else "operations")


def max_err(got, ref) -> tuple:
    """(max |got - ref|, whether every element is within tolerance)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    ok = bool((diff <= BF16_RTOL * r.abs() + ATOL).all()) and \
        bool(g.isfinite().all())
    return float(diff.max()) if diff.numel() else 0.0, ok


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
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
    from repro_torch.kernels.apr_matmul import ops as apr_ops
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  gather_pages,
                                                  paged_decode_attention_ref)
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models import build_model
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
                      fd_ops.LIBRARY: fd_ops.SIGNATURES})
    build_s = time.perf_counter() - t0
    print(f"[1] built {sorted(_build.BUILD_SECONDS) or 'nothing (cached)'} "
          f"in {build_s:.2f} s (nvcc, sm_90a, one process per source)")
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    report["build_s"] = build_s

    # ------------------------------------------------------------ 2 correct
    errs = {"apr_matmul": 0.0, "flash_decode_paged": 0.0}
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
    print(f"[2] kernel vs plain version on the card "
          f"(tolerance {BF16_RTOL:.4g}*|plain| + {ATOL:g}):")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ticks):
                forward(params, engine.cache, *tick_args)
            torch.cuda.synchronize()
    except RuntimeError as e:    # the profiler is a measurement, not a phase
        print(f"    profiler unavailable on this machine: {e}")
        prof = None
    by_kernel = {}             # device-side events only: an aten op's own
    for ev in (prof.key_averages() if prof is not None else ()):  # row
        if ev.device_type != DeviceType.CUDA:         # repeats its kernels
            continue
        t = ev.self_device_time_total / 1e3 / ticks
        if t > 0:
            by_kernel[ev.key] = t
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
    elif prof is not None:
        print("    profiler recorded no device time")
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

    # ------------------------------------------------------------- 6 report
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
    report["kernels"] = kernels
    report["kernels_note"] = ("ms, plain_ms, bound_ms and library_ms are per "
                              "full-width decode tick (4 slots): 225 "
                              "apr_matmul shapes, 32 flash_decode_paged "
                              "launches at the phase-3 lengths")
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
    print(f"[6] wrote {out}; total {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
