"""Serving launcher of the port: asyncio streaming server over paged
continuous batching (or the contiguous slot engine), on the GPU unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --int8-weights --kv-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --engine slot
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --state-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --kv-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b --int8-weights
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b --engine slot
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --draft-model ngram

It serves the arch's smoke config with random weights (seed 0), as the JAX
launcher does.  Requests are submitted through
:class:`repro_torch.serve.AsyncServeFrontend` and stream their tokens back
concurrently.  ``--prefix-sharing`` turns on the refcounted prefix cache;
``--slo-mix`` marks every other request TTFT-class; ``--int8-weights``
serves the int8-weight variant of the params and ``--kv-dtype int8`` int8
KV pages (paged engine).  The MoE archs (``arctic-480b``,
``llama4-maverick-400b-a17b``) and the vlm ``internvl2-1b`` serve text
tokens on either engine, as the JAX launcher does (the vlm's vision
prefix reaches ``forward`` / ``prefill`` alone).  The recurrent archs (``rwkv6-3b``,
``mamba2-2.7b``) serve from state pools, and the hybrid ``zamba2-1.2b``
from state pools and KV pages behind one block table (its shared
attention's); ``--state-dtype int8`` stores their large state leaves int8
(paged engine).  ``--draft-model`` serves on the speculative engine
(:mod:`repro_torch.spec`): ``ngram`` self-drafts, ``auto`` takes the arch's
registered draft model (``configs.DRAFT_FOR``) and any other value names a
draft config (``configs.DRAFTS``); a draft model's weights come from seed
1; ``--spec-k`` proposals are verified a step a slot.
"""
from __future__ import annotations

import argparse
import asyncio

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--engine", choices=("paged", "slot"), default="paged")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the hand-written kernels) or "
                         "'cpu' (their plain PyTorch versions)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page pool size (default: slots * 256/page_size)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="refcounted prefix cache with copy-on-write pages")
    ap.add_argument("--slo-mix", action="store_true",
                    help="submit every other request as TTFT-class (priority "
                         "admission; the rest are throughput-class FIFO)")
    ap.add_argument("--int8-weights", action="store_true",
                    help="serve the int8-weight variant "
                         "(repro_torch.quant.quantize_params)")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "int8"),
                    default="bfloat16",
                    help="paged KV page-pool storage dtype")
    ap.add_argument("--state-dtype", choices=("float32", "int8"),
                    default="float32",
                    help="recurrent-state pool storage dtype (rwkv6-3b, "
                         "mamba2-2.7b, zamba2-1.2b; paged engine)")
    ap.add_argument("--draft-model", default=None,
                    help="speculative decoding draft: 'ngram', 'auto', or a "
                         "draft arch name (repro_torch.spec; paged engine "
                         "only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens verified per step per slot")
    args = ap.parse_args(argv)

    from ..configs import get_config, get_draft_config
    from ..models import build_draft_model, build_model
    from ..serve import (SLO_THROUGHPUT, SLO_TTFT, AsyncServeFrontend,
                         PagedServeEngine, ServeEngine)

    cfg = get_config(args.arch, smoke=True)
    bundle = build_model(cfg, device=args.device)
    params = bundle.init_params()
    if args.int8_weights:
        params = bundle.quantize_params(params)
    if args.draft_model and args.engine != "paged":
        raise SystemExit(f"--draft-model requires the paged engine (got "
                         f"--engine {args.engine})")
    if args.engine == "paged":
        engine_kw = dict(device=args.device, slots=args.slots,
                         page_size=args.page_size, num_pages=args.num_pages,
                         prefill_chunk=args.prefill_chunk,
                         kv_dtype=args.kv_dtype, state_dtype=args.state_dtype,
                         prefix_sharing=args.prefix_sharing)
        if args.draft_model:
            from ..spec import SpeculativeServeEngine

            if args.draft_model == "ngram":
                draft_cfg = None
            elif args.draft_model == "auto":
                draft_cfg = get_draft_config(args.arch, smoke=True)
            else:  # an explicit *draft* arch name (not a target arch)
                draft_cfg = get_draft_config(args.draft_model, smoke=True,
                                             pairing=False)
                if draft_cfg is None:
                    raise SystemExit(
                        f"no draft config registered as {args.draft_model!r}")
            if draft_cfg is None:
                print(f"speculative: ngram self-draft, k={args.spec_k}")
                engine = SpeculativeServeEngine(
                    bundle, params, spec_k=args.spec_k, **engine_kw)
            else:
                print(f"speculative: draft={draft_cfg.name}, k={args.spec_k}")
                draft_bundle = build_draft_model(cfg, draft_cfg,
                                                 device=args.device)
                draft_params = draft_bundle.init_params(torch.Generator(
                    device=draft_bundle.device).manual_seed(1))
                engine = SpeculativeServeEngine(
                    bundle, params, spec_k=args.spec_k,
                    draft_bundle=draft_bundle, draft_params=draft_params,
                    **engine_kw)
        else:
            engine = PagedServeEngine(bundle, params, **engine_kw)
    else:
        if args.kv_dtype != "bfloat16":
            print(f"note: --kv-dtype {args.kv_dtype} only applies to the "
                  "paged engine; the slot engine keeps its bf16 cache")
        if args.state_dtype != "float32":
            print(f"note: --state-dtype {args.state_dtype} only applies to "
                  "the paged engine")
        if args.prefix_sharing:
            print("note: --prefix-sharing only applies to the paged engine")
        engine = ServeEngine(bundle, params, device=args.device,
                             slots=args.slots,
                             max_seq=max(128, args.prompt_len + args.max_new
                                         + 2))

    # a shared prompt head (the "system prompt") + a per-request tail, so
    # --prefix-sharing has something to dedupe
    head_len = max(args.prompt_len // 2, 1)
    head = list(range(2, 2 + head_len))

    async def serve() -> list:
        async with AsyncServeFrontend(engine) as front:
            streams = []
            for i in range(args.requests):
                slo = (SLO_TTFT if args.slo_mix and i % 2 else
                       SLO_THROUGHPUT)
                tail = [100 + i] * (args.prompt_len - head_len)
                streams.append(await front.submit(
                    head + tail, max_new_tokens=args.max_new, slo=slo))
            await asyncio.gather(*(s.drain() for s in streams))
            return [s.metrics() for s in streams]

    rows = asyncio.run(serve())

    done = sum(1 for row in rows if row["tokens"] > 0)
    print(f"served {done}/{args.requests} requests on {engine.device}")
    for row in rows:
        ttft = f"{row['ttft_s'] * 1e3:.1f}ms" if row["ttft_s"] else "-"
        lat = f"{row['latency_s'] * 1e3:.1f}ms" if row["latency_s"] else "-"
        print(f"  r{row['rid']:<3} slo={row['slo']:<10} "
              f"tokens={row['tokens']:<4} ttft={ttft:<9} latency={lat:<9} "
              f"preempt={row['preemptions']} jumped={row['queue_jumped']}")
    if not isinstance(engine, PagedServeEngine):
        return
    pools = ([f"kv pool {args.kv_dtype}"] if "k" in engine.cache else []) \
        + ([f"state pools {args.state_dtype}"] if engine.state else [])
    print(f"  {' + '.join(pools)}: {engine.kv_pool_bytes()} bytes"
          + (f" ({engine.state.pool_slots} state slots)" if engine.state
             else ""))
    m = engine.metrics
    print(f"  ticks={m.ticks}  prefill={m.prefill_tokens} tok "
          f"({m.prefill_tps:.1f} tok/s)  decode={m.decode_tokens} tok "
          f"({m.decode_tps:.1f} tok/s)")
    if m.ttfts:
        print(f"  ttft mean={m.mean_ttft * 1e3:.1f}ms "
              f"p50={m.p50_ttft * 1e3:.1f}ms")
    print(f"  page utilization peak={m.peak_page_utilization:.0%} "
          f"mean={m.mean_page_utilization:.0%}  "
          f"preemptions={m.preemptions}")
    if m.prefix_hit_requests or m.cow_copies:
        print(f"  prefix cache: hits={m.prefix_hit_requests} req / "
              f"{m.prefix_hit_tokens} tok  cow={m.cow_copies}  "
              f"effective-KV x{m.effective_kv_multiplier:.2f} "
              f"({m.prompt_pages_logical} logical / "
              f"{m.prompt_pages_unique} unique pages)")
    if m.spec_steps:
        print(f"  speculative: acceptance={m.acceptance_rate:.0%}  "
              f"tokens/step={m.tokens_per_step:.2f}  "
              f"decode tok/s incl draft={m.spec_decode_tps:.1f}")


if __name__ == "__main__":
    main()
