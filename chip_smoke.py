#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a GPU host
    python3 chip_smoke.py --ablate   # only rms_norm's batch invariance and
                                     # the paged/slot token ablation
    python3 chip_smoke.py --baseline --out baseline.json
                                     # only the memory-resident baselines
                                     # B4m and B4c beside B1 and B5, the
                                     # phase-2 conv outputs' digests and
                                     # the baselines' SASS
    python3 chip_smoke.py --qmm-ablation --out qmm.json
                                     # only B6 and variants of its source:
                                     # other exact forms of the codes, 8
                                     # warps, and timing-only ablations
    python3 chip_smoke.py --kernel-sweep --out sweep.json
                                     # only B2/B2q at the serving shape
                                     # (bf16 and fp32 q), B3 against its
                                     # longest length, B1 bf16/int8/fp32
                                     # (and fp32 x int8) and B6/B8 at the
                                     # projections, at each split count,
                                     # B6's K loop from its SASS, and B9 /
                                     # B10 at the decode tick and a
                                     # 1024-token prefill (each compiled
                                     # configuration too)
    python3 chip_smoke.py --scan-ablation --out scan_ablation.json
                                     # only B9 / B10 beside variants of
                                     # their source that drop one piece
    python3 chip_smoke.py --conv-ablation --out conv_ablation.json
                                     # only B5 beside variants of its
                                     # source that drop one piece
    python3 chip_smoke.py --decode-ab scratch_tree --out decode_ab.json
                                     # only the decode kernels of this
                                     # tree beside an older tree's: the
                                     # G <= 8 kernels' ptxas counts and
                                     # output bits equal, the G = 12 and
                                     # 16 cases against the plain version
    python3 chip_smoke.py --matmul-ptxas-ab scratch_tree --out ab.json
                                     # only apr_matmul.cu of this tree
                                     # beside an older tree's: every older
                                     # kernel's ptxas counts equal
    python3 chip_smoke.py --scan-bwd-ab scratch_tree --out scan_bwd_ab.json
                                     # only phase 9e-a's timed backward
                                     # cases (B9 / B10 at the bf16
                                     # training shapes) on this tree and
                                     # an older one, each in its own
                                     # process: ms, error and the ratio

Phases (any failure exits non-zero before the final line):
  1. build the CUDA kernels of ``src/repro_torch/csrc`` with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it and at ragged ones: ``apr_matmul``
     with bf16 and int8 weights (the int8 one at every tile it compiles,
     also bit for bit against the bf16 kernel on the dequantized weight),
     ``flash_decode_paged`` over bf16, int8 and fp32 pools (bf16 or fp32
     q) and ``flash_decode`` over a contiguous bf16 or fp32 cache, both at
     every split count (``lengths == 0`` rows and empty splits included,
     pages of 4, 5, 8 and 16 shuffled across the pool, out-of-pool table
     padding, S up to 4096, each case launched twice for equal bits),
     ``apr_matmul`` and ``apr_matmul_fused`` on fp32 operands, the conv
     kernels, and the recurrence
     kernels ``rwkv6_wkv`` (B9) and ``mamba2_ssd`` (B10) with their state in
     and out, at the decode tick, at 1024- and 1000-token prefills, at the
     smoke shapes and (B10) at zamba2's N = 64 decode tick and 1024-token
     forward, and bit for bit against themselves: across every
     compiled configuration (staging depth x tile x lanes), a batch row
     alone against it inside B = 4, one T = 37 call against 37 calls at
     T = 1 with the state carried, and one device kernel a call; and
     ``rms_norm``'s variance, row for row, at B = 1 and
     inside batches of 4 and 16; a row's bits across the batch: B1 under
     its default configuration at M = 1, 4, 16, 20, 64, 128 and 1024
     (llama3-8b's projections, bf16 -- on wide tiles from M = 128 -- and
     fp32), B2, B2q and B3 under their default split
     at B = 1, 4 and 20 (llama3-8b's and zamba2's geometry; B2 and B2q at
     B = 20 also against their plain version), and folded T > 1 paged calls
     (a prefill chunk's B = 1, T = 16, whole and partial, and a verify
     step's 4 x 5 rows) against T = 1 calls, all bit for bit, and the
     plain version at phase 2's tolerances; and the matmul families at
     every tile
     their kernels compile, at the llama3-8b projection shapes and ragged
     ones: ``apr_matmul`` (B1), its memory-resident baseline (B4m, one
     launch a call, equal to B1 at the same tile bit for bit; on fp32
     operands within the fp32 bound), ``apr_matmul_fused`` (B7m),
     ``quant_matmul`` (B6) and ``quant_matmul_fused`` (B8) with every
     activation, bias and none, bf16 and fp32 out, over bf16 and fp32 x at
     every tile x split count (none/relu bit-equal to the plain version,
     the same bits across tiles and split counts, twice bit-equal, rows of
     .5 ties, one device kernel a call by the profiler); B1 and B7m at every
     tile x split count (split-K over a thread-block cluster) against the
     split plain version, twice bit-equal and bit-equal across tiles at one
     split count (B4m and the int8-weight kernel bit-equal to B1 at one
     split); the fp32 body likewise, and over int8 weights bit-equal to the
     fp32 body on the dequantized weight; the decode kernels under an fp32
     q over bf16 and int8 pools and a bf16 cache at every split count; the
     moe and vlm families' shapes: B1 at the routers (K = 7168 / 5120, N =
     128), the experts' projections and internvl2-1b's 896-wide ones at M
     = 1, 2, 4, 16 and 64 (each row bit-equal to its row at M = 64; over
     int8 weights at llama4's expert shapes), B2/B2q/B3 at arctic-480b's,
     llama4-maverick's and internvl2-1b's geometries at every split count
     (and a row's bits across B), and B5/B4c at MobileNet-V1's 14 convs at
     batch 1 and 256; B2, B2q and B3 at GQA groups wider than 8
     (starcoder2-15b's 12 over 4 kv heads, chatglm3-6b's 16 over 2, and
     12 or 16 over one head at D % 4 != 0 and pages of 5), every split
     count, every pool and q dtype, twice bit-equal, padded tables and
     length-0 rows, a row's bits across B, and B2 over pages bit-equal to
     B3 over the same K/V at every geometry; the folded T > 1 call's
     padded rows (each attending up to its own index) against the plain
     version too; and the graph path's fused kernels at its shapes: B7m
     (relu, no bias, fp32) at LeNet-5's FC layers, B7 (relu) at
     ResNet-20's ten relu convs at batch 256, B6 and B8 at the head
     (:func:`graph_kernel_checks`); B1's wide body: one wgmma chain
     against the WMMA chain on random and hard operands, bit for bit
     (:func:`mma_probe`, gated), and every wide tile against the 16 x 64 x
     64 tile at every split count, bf16 and fp32 out and B7m's
     activations, bit for bit, at M = 17 to 3000 on llama3-8b's and
     whisper's projections (:func:`wide_bit_checks`);
  3. time each kernel, its plain version and a PyTorch library call at the
     serving path's shapes with CUDA events, beside the card's bound (B1
     also at phase 4d's prefill M = 1024, against ``torch.matmul``; B4m,
     B6, B7m and B8 at the llama3-8b projection shapes, B4m beside B1, B6
     at each split count beside the plain quantization's time;
     ``flash_decode`` also at S = 4096 near full; ``flash_decode_paged``
     over bf16, fp32 and int8 pools and ``flash_decode`` over a bf16 and
     an fp32 cache at each split count, and under an fp32 q over bf16 and
     int8 pools and a bf16 cache; B1, B7m and the fp32 body (fp32 and int8
     weights) at each split count, with per-tick totals; B2 over 20 and 64
     rows at each split count, :data:`WIDE_BATCHES`; B2, B2q and B3 at
     starcoder2-15b's and chatglm3-6b's 4-slot ticks, :data:`WIDE_TIMING`;
     the decode kernels' ptxas registers, spills and static shared memory;
     B1 at whisper's prefill M = 3000, and the wide tiles against the 16 x
     64 x 64 tile and ``torch.matmul`` over M = 64 to 3000,
     :func:`wide_sweep`);
  4. serve full-width llama3-8b (32 layers, random bf16 weights from a seed)
     on the port's PagedServeEngine: 6 ragged requests on 4 slots, and check
     every kernel of the path was launched as often as the path demands
     (prefill chunks attend on ``flash_decode_paged`` too, T folded into
     the batch);
  4g. serve phase 4's requests on ``PagedServeEngine(use_graph=True)``:
     both steps traced on the card at full width, fused by the cost
     model's schedule and run by the graph executor (B1 for every matmul
     node, B2 for the attention node); tokens gated equal to phase 4's,
     node and cluster counts, schedule and bytes, ms a tick and a profiled
     tick's idle share; after 4b the first 3 requests (8 new tokens) with
     int8 weights and int8 KV pages: the head folds into ``quant_matmul`` (B6, or B8 under a fused
     epilogue; launches gated to folded nodes x steps), one tick's logits
     gated against the plain step's within the bound of the head's
     activation quantization (:func:`quant_head_bound`), tokens against
     4b's printed;
  4f. serve phase 4's requests on ``PagedServeEngine(kv_dtype="float32")``
     (fp32 KV pools under the bf16 model: every decode tick's attention on
     ``flash_decode_paged`` over fp32 pools), tokens against phase 4's;
  4c. serve full-width llama3-8b bf16 on the slot ServeEngine (4 requests,
     max_seq 256; ``flash_decode`` under every layer), and the same requests
     on the PagedServeEngine: greedy tokens equal;
  4d. the dense whole-sequence entry points at full width: llama3-8b
     ``bundle.forward`` and ``bundle.prefill(max_seq=T + 16)`` at B = 2,
     T = 512 (B1 at M = 1024), their launches, times and peak memory, and 8
     greedy decode ticks (B1, B3) from the prefilled cache;
  4e. speculative decoding at full width: phase 4's requests on the
     ``SpeculativeServeEngine`` (4 slots, spec_k = 4; verify steps run B1 at
     M = 20 and B2 over 20 rows) with the n-gram draft and with a
     ``ModelDraft`` of full-width llama3-8b-draft (random weights from the
     seed + 1), with the oracle (llama3-8b as its own ``ModelDraft``, one
     proposal corrupted at a depth going round 0..spec_k: every verify row
     emits, the draft rolls back after partial accepts; each step's
     accepted count gated, :class:`CorruptedDraft`), and after 4b with
     int8 weights and KV and the n-gram draft: greedy tokens equal to the
     plain paged engine's (phase 4's, 4b's), acceptance, tokens a step, ms
     a verify step and the launches gated against the code's counts (the
     draft model's forwards counted);
  4b. quantize the weights on the card, free the bf16 ones, and serve the 6
     requests of phase 4 with int8 weights and int8 KV pages (int8-weight
     ``apr_matmul``, int8 ``flash_decode_paged``); it runs after 4c so that
     its peak memory is the int8 deployment's;
  5. run the smoke llama3-8b config on the card (kernels) and on the CPU
     (plain versions) with the same weights, and compare the logits and
     greedy tokens: ``decode_paged`` in bf16, ``decode_paged`` with int8
     weights and int8 KV, ``decode_step`` on the slot cache, ``forward``
     and ``prefill`` with bf16 and fp32 parameters; the same for the rwkv6,
     mamba2 and zamba2 smoke configs (``decode_paged`` through the state
     pools -- and the hybrid's KV pages -- and ``prefill``; the hybrid also
     ``decode_step`` on its slot cache and ``forward``); ``decode_paged``
     over fp32 KV pools, and a
     ``PagedServeEngine(kv_dtype="float32")`` serving the bf16 smoke model
     on the fp32-pool kernel; then the smoke model with fp32 parameters
     served by the engines on the card (the fp32 body; the decode kernels
     with an fp32 q) and on the CPU -- the PagedServeEngine on fp32, bf16
     and int8 pools, with int8 weights on fp32 pools, and the slot
     ServeEngine: every forward's logits within 1e-3, greedy tokens equal,
     the launches exactly those of the path; and the smoke arctic-480b,
     llama4-maverick-400b-a17b and internvl2-1b: ``decode_paged`` over
     bf16 pools, with int8 weights over int8 pools and with fp32 params
     over fp32 pools, ``decode_step``, and ``forward`` / ``prefill`` (after
     8 vision embeddings for the vlm) with bf16 and fp32 params, every
     row's routing compared (padded positions' too); the same for the
     G-wide smoke variants of starcoder2-15b (12 query heads of 128 over
     one kv head) and chatglm3-6b (16), which run the wide decode kernels;
     and arctic's and llama4's smoke configs at the published capacity
     factor on the card's PagedServeEngine, every forward replayed on the
     CPU: the dropped dispatches by request equal (:func:`capacity_drops`);
  6. run the paper's CNNs (LeNet-5, ResNet-20, MobileNet-V1; random fp32
     weights from a seed) at batch 256 with every dense conv on
     ``apr_conv`` (MobileNet's 13 depthwise convs plain ``F.conv2d``, as
     the JAX model computes them outside any kernel), check each forward's
     launches, run ResNet-20 and MobileNet-V1 on the memory-resident
     baseline (``apr_conv_hbm``, one launch a conv) and on the plain path,
     time all of them and both at batch 1 (with MobileNet's depthwise
     share by CUDA events), and compare card (kernels) and CPU (plain)
     logits;
  6g. LeNet-5 and ResNet-20 at batch 256 through ``graph.compile_fn``
     (traced on the card), fused and unfused: logits against the eager
     forward's within phase 6's bound, launches gated (B7m twice a LeNet-5
     forward, B7 ten times a ResNet-20 one), ms a forward fused, unfused
     and eager (CUDA events), and B7m / B7 per forward against their plain
     versions and bounds;
  7. serve rwkv6-3b, mamba2-2.7b and the zamba2-1.2b hybrid at published
     widths, depth cut to about a quarter (:data:`RECURRENT_LAYERS`; random
     bf16 weights from a seed, one model at a time) on the
     PagedServeEngine with its StateCache (the hybrid's shared attention on
     KV pages behind the same table, B2) and on the slot ServeEngine (B3),
     the same 6 requests on 4 slots: greedy tokens equal (the hybrid's
     too: its engines attend on B2 and B3 at one split count), every
     launch count checked, a profiled decode tick; zamba2 and rwkv6 (4
     requests) also on the ``SpeculativeServeEngine`` (state-ring restore,
     KV truncate on the hybrid) with the n-gram draft and with the oracle
     (a :class:`Replay` of the paged tokens under :class:`CorruptedDraft`:
     every ring depth restored, each step's accepted count gated), tokens
     equal to the paged engine's; then a 1024-token ``bundle.prefill`` on
     each (``bundle.forward`` on the hybrid; B9/B10 over all T), every
     layer's scan held to its plain version on the same inputs, its ms and
     the scans' share of it (CUDA events);
  7b. the moe and vlm families at published widths (random bf16 weights
     drawn on the card, one model at a time): arctic-480b cut to 2 layers
     and llama4-maverick to one super-block (a dense and an MoE layer)
     serve phase 4's requests on 4 slots at the published capacity factor
     1.25 (paged; arctic also slot; llama4 also with int8 weights and int8
     KV), with the dropped dispatches, ms a tick and a profiled tick
     against its byte floor, then drop-free (factor E / k): paged and slot
     tokens gated equal, and arctic's n-gram speculative tokens equal to
     the paged engine's; every run's B1 launches gated against its routing
     (3 a non-empty expert).  internvl2-1b at full size: ``forward`` and
     ``prefill`` at B = 2 over 256 stubbed vision embeddings and 256
     tokens, 8 decode ticks from the prefilled cache (B3), and the 6
     requests on both engines, tokens gated equal;
  7c. groups wider than 8 and the audio family at full width:
     starcoder2-15b (44 GB bf16) and chatglm3-6b (12.5 GB) serve phase 4's
     requests on the paged (B1 + B2) and slot (B1 + B3) engines, tokens
     gated equal, a decode tick against its byte floor, starcoder2 also
     with int8 weights and KV (B1 int8, B2q); whisper-large-v3 prefills 2
     rows of 1500 stub frames (again with 16 x 64 x 64 pinned, bits gated
     equal, and one profiled prefill of each), decodes 8 ticks from that
     cache (B1, B3 at G = 1, D = 64) and serves phase 4's requests on the
     slot engine, every run's launches gated (:func:`wide_serving`, :func:`whisper_full`);
  8. the tuning path at llama3-8b full width: every registered kernel
     family (the int8-weight tiles and both decode kernels' split counts
     included) swept exhaustively (the yardstick), then
     ``warm_cache(sweep=True, prune_top_k=3)`` in a ``scoped_cache`` over
     a fresh cache file, at the paged engine's ``_decode_kernel_shapes()``,
     the projection shapes and each other family's serving shape; then a
     ``PagedServeEngine(tune_cache=...)`` serves phase 4's requests.  No
     candidate may be rejected, the pruned winner must be the exhaustive
     one (or a predicted tie, or within the timer spreads), and the engine
     must launch the tuned tiles;
  9. training (:func:`train_matmul_checks`, :func:`train_smoke_parity`,
     :func:`train_launcher_resume`, :func:`train_full`): 9a B1 under
     autograd (``AprMatmulFunction``) at llama3-8b's projections and head
     at M = 1024 (bf16; fp32 at two), dX and dW within phase 2's bound of
     autograd through ``matmul_ref``, each product, the transposes and
     ``torch.matmul`` timed; 9b the smoke llama3-8b (AdamW, Adafactor) and
     internvl2-1b (the vlm mask) train 3 steps on the card and on the CPU
     from the same params and batches, losses and grad norms within the
     stated bounds, and an fp32-params step 0 within 1e-3; 9c
     ``repro_torch.launch.train`` 20 steps, then ``--resume`` for 10,
     against 30 in one run, losses equal bit for bit; 9d llama3-8b at full
     width cut to 4 layers, AdamW, B = 2, T = 512, 5 steps: finite losses,
     115 B1 launches a step (29 forward, 28 recompute, 58 backward), ms a
     step, tokens/s, peak memory, a profiled step and the optimizer's
     share; 9e the recurrent and audio families' training
     (:func:`scan_grad_checks`, :func:`train_recurrent_smoke_parity`,
     :func:`train_recurrent_full`): 9e-a B9's and B10's backward kernels
     (``csrc/rwkv6_bwd.cu``, ``csrc/mamba2_bwd.cu``) against their plain
     versions at rwkv6-3b's, mamba2-2.7b's and zamba2-1.2b's training
     shapes (bf16, fp32), at T = 1, 37 and 1024, B = 1 and decays near
     1e-24 and near 1, twice bit-equal, timed against their bounds, each
     timed case with its launch geometry (blocks, blocks an SM, shared
     memory a block, steps a chunk) and its fixed-order reduce's ms; 9e-b
     the rwkv6-3b, mamba2-2.7b, zamba2-1.2b and whisper-large-v3 smoke
     configs train 3 steps on the card and on the CPU, losses and grad
     norms within the stated bounds; 9e-c the same archs at full width with
     their depth cut (4 layers; zamba2 one super-block; whisper 4 + 4 over
     1500 frames), AdamW, B = 2, T = 512, 3 steps: finite losses, B1's and
     B9/B10's forward, recompute and backward launches a step gated, no
     plain backward on the card, ms a step, tokens/s, peak memory and the
     optimizer's share; 9f the moe family's training
     (:func:`moe_grad_checks`, :func:`train_moe_smoke_parity`,
     :func:`train_moe_full`): 9f-a B1 at the expert backward's shapes
     (queues of 1, 5, 13, 20 rows at arctic's and llama4's widths, dW
     written into a slice) within phase 2's bound, timed; 9f-b the
     arctic-480b and llama4-maverick smoke configs (Adafactor) on the card
     and on the CPU, the CPU routing as the card did: an fp32 step 0 within
     1e-3 of each leaf's max and 3 bf16 steps within 9b's bounds, swaps
     from equal params near-ties; 9f-c both at published widths with the
     depth cut (arctic one layer, B = 2; llama4 one super-block, B = 1; T =
     512), 3 Adafactor steps with donate: finite losses, B1 launches a step
     as the host-read expert counts imply, peak memory over params + grads
     below the largest expert leaf, ms a step, the update's share, and a
     fifth step timing the expert backward;
  10. print the kernels' line, the card's name and power limit, and as the
     last line ``{"ok": true, "device": {...}}``.

Phases 1-7 resolve every kernel's configuration from an empty cache (the
kernels' defaults); only phase 8 scopes a tuned one.

Everything the run measured also goes to ``chiprun_out/chip_smoke.json``.
It needs nothing beyond this repository, PyTorch with CUDA, and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
import types
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
#: bound on |logits(card) - logits(CPU)| for the smoke model with fp32
#: parameters (on fp32, bf16 or int8 KV pools, with fp32 or int8 weights,
#: on either engine): both compute in fp32 throughout and differ only in
#: the order of their sums (split ranges and 8 interleaved chains over K on
#: the card, the canonical split-K on the CPU; the attention's online
#: softmax), a few fp32 ulps of O(1) logits per layer; a K/V value that
#: lands on the other side of a bf16 rounding or an int8 code moves the
#: logits by ~1e-5 more (the CPU tests' JAX-vs-port gap on such pools)
F32_SMOKE_LOGITS_BOUND = 1e-3
#: the same over int8 KV pools when the card's and the CPU's pools differ
#: in some code: a K or V value within an fp32 ulp of a rounding boundary
#: takes the neighbouring int8 code on one side (one code is amax/127 of
#: its (token, head) vector, ~1e-2 of O(1) values), which moves O(1) logits
#: by up to ~5e-3 (5.2e-3 on an H100); with no code apart the int8-pool
#: run is held to F32_SMOKE_LOGITS_BOUND
F32_INT8_CODE_LOGITS_BOUND = 2e-2
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


#: the host calls by which a kernel, a copy or a fill reaches the card, as
#: the profiler names them (runtime and driver API)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
def profile_device(torch, fn, reps: int, host=None, counts=None,
                   launches=None, trace=None, pad_s: float = 0.0):
    """Device milliseconds per call of ``fn()``, by kernel name, over
    ``reps`` calls traced by ``torch.profiler`` (device-side events only: an
    aten op's own row repeats its kernels); None where the profiler cannot
    trace, since it is a measurement and not a phase.  The card is
    synchronized when the window opens, and the calls run ``pad_s`` seconds
    after that and end ``pad_s`` before it closes.  A dict passed as ``host`` receives the host milliseconds per
    call by op (self CPU time) of the same trace, one passed as ``counts``
    the device events (kernels, copies) per call by name, one passed as
    ``launches`` the host calls of :data:`LAUNCH_CALLS` per call by name,
    one passed as ``trace`` the start of the first device event and of the
    first launch call, in µs from the trace's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(pad_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
    except RuntimeError as e:
        print(f"    profiler unavailable on this machine: {e}")
        return None
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            if host is not None and ev.self_cpu_time_total > 0:
                host[ev.key] = ev.self_cpu_time_total / 1e3 / reps
            if launches is not None and ev.key in LAUNCH_CALLS:
                launches[ev.key] = ev.count / reps
            continue
        t = ev.self_device_time_total / 1e3 / reps
        if t > 0:
            by_kernel[ev.key] = t
            if counts is not None:
                counts[ev.key] = ev.count / reps
    if trace is not None:
        starts = {"device": [], "launch": []}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                starts["device"].append(ev.time_range.start)
            elif ev.name in LAUNCH_CALLS:
                starts["launch"].append(ev.time_range.start)
        trace.update({f"first_{k}_us": min(v, default=None)
                      for k, v in starts.items()})
    if not by_kernel:
        print("    profiler recorded no device time")
    return by_kernel


def one_kernel_a_call(torch, fn, kernel: str, reps: int = 5,
                      tries: int = 3):
    """``(ok, text)``: whether each call of ``fn()`` runs exactly one
    device kernel, the one whose name holds ``kernel``, by
    :func:`profile_device`, and the profiler's account.  The host side of
    the trace counts every launch, copy and fill (:data:`LAUNCH_CALLS`):
    it must be one a call.  The device side names what ran: only
    ``kernel``, at most one a call, and at least one event in the trace.
    A device side with fewer events than launch calls lost records (the
    profiler can drop device records, see :func:`profiler_probe`), so the
    session is profiled again, up to ``tries`` in all, or up to twice
    that while no session has recorded a device event (such a trace names
    no kernel to judge); where every session lost some, the launch calls
    are the count and the text says so."""
    for session in range(1, 2 * tries + 1):
        events, calls = {}, {}
        if profile_device(torch, fn, reps, counts=events,
                          launches=calls) is None:
            return False, "profiler unavailable"
        kernels, issued = sum(events.values()), sum(calls.values())
        if kernels >= issued or (session >= tries and kernels > 0):
            break
    ok = (issued == 1 and 0 < kernels <= 1
          and all(kernel in key for key in events))
    lost = "" if kernels >= issued else ", device records lost"
    return ok, (f"{issued:g} launch call(s) and {kernels:g} device "
                f"kernel(s) a call ({session} profiler session(s){lost})")


def rel_logits_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


# ------------------------------------------- recurrent families (B9, B10)
#: the recurrent serving path: full-width rwkv6-3b, mamba2-2.7b and the
#: zamba2-1.2b hybrid, 4 slots, prefill chunks of 16, 6 requests on 4 slots
#: (two admitted mid-flight)
RECURRENT_ARCHS = ("rwkv6-3b", "mamba2-2.7b", "zamba2-1.2b")
RECURRENT_PROMPTS = (24, 57, 96, 40, 33, 70)
RECURRENT_NEW = 16
#: the phase-7 archs also served on the SpeculativeServeEngine (n-gram
#: draft, SPEC_K proposals a step: state-ring restore, and on the hybrid KV
#: truncate too), with the requests (the first n of the phase's) and new
#: tokens each; a request's tokens do not depend on the batch it rides in,
#: so they are held to the first tokens of the paged run's
SPEC_STATE_ARCHS = {"rwkv6-3b": (4, 16), "zamba2-1.2b": (6, 16)}
#: phase 7's depth: each arch at its published widths, cut to about a
#: quarter of its layers (the hybrid to 1 of its 6 super-blocks and a
#: 4-layer tail) so that the whole run, phases 7c and 9e included, stays
#: well inside its time limit on a slow host (rwkv6-3b has 32 layers,
#: mamba2-2.7b 64, zamba2-1.2b 38; at about half depth the run took 1001
#: to 1109 s on one)
RECURRENT_LAYERS = {"rwkv6-3b": 8, "mamba2-2.7b": 16, "zamba2-1.2b": 10}
#: phase 4g's int8 run: the first requests of phase 4's and their new
#: tokens (the bf16 run serves all 6 with 16 each, gated 96/96)
GRAPH_INT8_REQUESTS, GRAPH_INT8_NEW = 3, 8


def attn_per_forward(cfg) -> int:
    """Decode-attention launches per token-forward: the hybrid's shared
    attention, once a super-block (B2 on the paged engine, B3 on the slot
    engine); none for the recurrent families."""
    return cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0


def apr_per_forward(cfg) -> int:
    """apr_matmul launches per token-forward, counted from the code: rwkv6
    has wr, wk, wv, wg, wo, wA, wB, ck, cv, cr in each layer plus the
    lm_head; mamba2 w_in and w_out in each layer plus the lm_head; zamba2
    w_in and w_out in each mamba layer, wq, wk, wv and wo in each shared-
    attention application, and the lm_head.  Phase 7 confirms them on the
    card."""
    if cfg.family == "ssm":
        return 10 * cfg.num_layers + 1
    return 2 * cfg.num_layers + 4 * attn_per_forward(cfg) + 1


def state_pool_bytes(cfg) -> int:
    """The cache pools of 4 slots (StateCache.pool_slots = 2 + 4 * 2 = 10;
    the page pool 4 x 16 pages + the null page), computed from the
    configs: a rwkv6 layer 10 x (2 bf16 rows of 2560 + 40 fp32 64x64
    matrices), a mamba2 layer 10 x (3 x 5376 fp32 conv rows + 80 fp32
    64x128 states), a zamba2 mamba layer 10 x (3 x 4224 fp32 conv rows +
    64 fp32 64x64 states) and a shared-attention application K and V
    pages, 2 x 65 x 16 x 32 x 64 bf16 (the full depths: 212,992,000,
    1,719,009,280 and 468,838,400 bytes)."""
    per_layer = {"ssm": 10 * (2 * 2560 * 2 + 40 * 64 * 64 * 4),
                 "mamba": 10 * (3 * 5376 * 4 + 80 * 64 * 128 * 4),
                 "hybrid": 10 * (3 * 4224 * 4 + 64 * 64 * 64 * 4)}
    return (cfg.num_layers * per_layer[cfg.family]
            + attn_per_forward(cfg) * 2 * 65 * 16 * 32 * 64 * 2)
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
            (4, 1, 64, 64, 64, f32, True, True),     # zamba2: decode tick
            (1, 1024, 64, 64, 64, bf, False, True),  # and a 1024 forward
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


def scan_bit_checks(torch, gen, dev) -> list:
    """Phase 2's bit checks of B9 and B10 (one y reduction order a row or
    column, whatever the launch): y and the state out equal bit for bit
    across every compiled configuration (``compiled_configs()``: staging
    depth x rows or columns a block x lanes) at the decode tick, at T = 37
    and at a ragged head size; each batch row computed alone equal to the
    same row inside B = 4; one T = 37 call equal to 37 calls at T = 1 with
    the state carried; and exactly one device kernel a call (the
    profiler's device events, and one count on the wrapper's counter).
    Returns (kernel, case, 0.0, ok) rows."""
    from repro_torch.kernels.mamba2 import ops as m2
    from repro_torch.kernels.rwkv6 import ops as r6
    bf, f32 = torch.bfloat16, torch.float32
    rows = []

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    rwkv_cases = [(4, 1, 40, 64, bf), (2, 37, 40, 64, bf), (3, 19, 2, 48, f32)]
    mamba_cases = [(4, 1, 80, 64, 128, f32), (2, 37, 80, 64, 128, bf),
                   (3, 19, 2, 48, 80, bf),     # 32-row tiles span heads
                   (4, 1, 64, 64, 64, f32),    # zamba2's decode tick and
                   (1, 1024, 64, 64, 64, bf)]  # 1024-token forward (N = 64)
    for kernel, ops, cases in (("rwkv6_wkv", r6, rwkv_cases),
                               ("mamba2_ssd", m2, mamba_cases)):
        fn = r6.rwkv6_wkv if kernel == "rwkv6_wkv" else m2.mamba2_ssd
        state_kw = "s_init" if kernel == "rwkv6_wkv" else "h_init"
        for dims in cases:
            *shape, dtype = dims
            if kernel == "rwkv6_wkv":
                args, s0 = rwkv_inputs(torch, gen, dev, *shape, dtype, True)
            else:
                args, s0 = mamba_inputs(torch, gen, dev, *shape, dtype, True,
                                        True)
            configs = sorted(ops.compiled_configs())
            outs = [fn(*args, **{state_kw: s0}, return_state=True,
                       config=cfg) for cfg in configs]
            torch.cuda.synchronize()
            differ = [c.to_dict() for c, o in zip(configs, outs)
                      if not same(o, outs[0])]
            rows.append((kernel, f"{shape} {str(dtype)[6:]}: "
                         f"{len(configs) - len(differ)}/{len(configs)} "
                         f"compiled configurations bit-equal"
                         + (f" (differ: {differ[:3]})" if differ else ""),
                         0.0, not differ))
        # a row alone against the same row inside B = 4, T = 1 and T = 37
        for t in (1, 37):
            shape = ((4, t, 40, 64) if kernel == "rwkv6_wkv"
                     else (4, t, 80, 64, 128))
            if kernel == "rwkv6_wkv":
                args, s0 = rwkv_inputs(torch, gen, dev, *shape, bf, True)
                batched = args
                alone = [([a[i:i + 1].contiguous() for a in args[:4]]
                          + [args[4]], s0[i:i + 1].contiguous())
                         for i in range(4)]
            else:
                args, s0 = mamba_inputs(torch, gen, dev, *shape, bf, True,
                                        True)
                batched = args
                alone = [([a[i:i + 1] for a in args[:4]] + list(args[4:]),
                          s0[i:i + 1].contiguous()) for i in range(4)]
            y, s = fn(*batched, **{state_kw: s0}, return_state=True)
            ok = True
            for i, (a, si) in enumerate(alone):
                yi, ss = fn(*a, **{state_kw: si}, return_state=True)
                ok = ok and torch.equal(yi, y[i:i + 1]) and \
                    torch.equal(ss, s[i:i + 1])
            torch.cuda.synchronize()
            rows.append((kernel, f"B=4 T={t}: each row alone bit-equal to "
                         f"it inside the batch", 0.0, ok))
        # one T = 37 call against 37 calls at T = 1, the state carried
        shape = (2, 37, 40, 64) if kernel == "rwkv6_wkv" else \
            (2, 37, 80, 64, 128)
        if kernel == "rwkv6_wkv":
            args, s0 = rwkv_inputs(torch, gen, dev, *shape, bf, True)
            steps = [[a[:, i:i + 1].contiguous() for a in args[:4]]
                     + [args[4]] for i in range(37)]
        else:
            args, s0 = mamba_inputs(torch, gen, dev, *shape, bf, True, True)
            steps = [[a[:, i:i + 1] for a in args[:3]]
                     + [args[3][:, i:i + 1].contiguous()] + list(args[4:])
                     for i in range(37)]
        y, s = fn(*args, **{state_kw: s0}, return_state=True)
        carried, ys = s0, []
        for a in steps:
            yi, carried = fn(*a, **{state_kw: carried}, return_state=True)
            ys.append(yi)
        torch.cuda.synchronize()
        ok = torch.equal(torch.cat(ys, dim=1), y) and torch.equal(carried, s)
        rows.append((kernel, "T=37 in one call bit-equal to 37 calls at "
                     "T=1 with the state carried", 0.0, ok))
        # one device kernel a call, at the decode tick and at T = 37
        for t in (1, 37):
            if kernel == "rwkv6_wkv":
                args, s0 = rwkv_inputs(torch, gen, dev, 4, t, 40, 64, bf,
                                       True)
            else:
                args, s0 = mamba_inputs(torch, gen, dev, 4, t, 80, 64, 128,
                                        f32 if t == 1 else bf, True, True)

            def call():
                return fn(*args, **{state_kw: s0}, return_state=True)

            before = fn.launches
            call()
            torch.cuda.synchronize()
            launched = fn.launches - before
            one, text = one_kernel_a_call(
                torch, call, "wkv_kernel" if kernel == "rwkv6_wkv"
                else "ssd_kernel")
            rows.append((kernel, f"B=4 T={t}: {text}, {launched} "
                         f"launch(es) counted", 0.0, one and launched == 1))
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


def print_scan_row(r) -> None:
    shape = " ".join(f"{k}={r[k]}" for k in ("B", "T", "H", "D", "P", "N")
                     if k in r)
    print(f"    {r['kernel']:23s} {r['shape']:7s} {shape:32s} kernel_ms="
          f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=none "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
          f"{r['bound_ms'] / r['ms']:.0%} of bound")


#: the scans' shapes that ``scan_config_sweep`` times at every compiled
#: configuration: phase 3's decode tick and 1024-token prefill
SCAN_SWEEP = {"rwkv6_wkv": ((4, 1, 40, 64, "bfloat16", True),
                            (1, 1024, 40, 64, "bfloat16", False)),
              "mamba2_ssd": ((4, 1, 80, 64, 128, "float32", True),
                             (1, 1024, 80, 64, 128, "bfloat16", False))}


def scan_config_sweep(torch, gen, dev) -> list:
    """CUDA-event ms per launch of B9 and B10 at every configuration their
    kernels compile (``compiled_configs()``), at the shapes of
    :data:`SCAN_SWEEP`, inputs rotated past the L2 as in phase 3; empty on
    a tree whose wrappers take one configuration."""
    from repro_torch.kernels.mamba2 import ops as m2
    from repro_torch.kernels.rwkv6 import ops as r6
    out = []
    for kernel, ops in (("rwkv6_wkv", r6), ("mamba2_ssd", m2)):
        if not hasattr(ops, "compiled_configs"):
            continue
        fn = r6.rwkv6_wkv if kernel == "rwkv6_wkv" else m2.mamba2_ssd
        kw = "s_init" if kernel == "rwkv6_wkv" else "h_init"
        for *shape, dtype, init in SCAN_SWEEP[kernel]:
            dt = getattr(torch, dtype)
            if kernel == "rwkv6_wkv":
                sets = rotated(lambda: rwkv_inputs(torch, gen, dev, *shape,
                                                   dt, init))
            else:
                sets = rotated(lambda: mamba_inputs(torch, gen, dev, *shape,
                                                    dt, init, True))
            default = ops.resolve_launch(*shape, dtype)
            times = {}
            for cfg in sorted(ops.compiled_configs()):
                times[cfg] = cuda_ms(torch, lambda i: fn(
                    *sets[i % len(sets)][0], **{kw: sets[i % len(sets)][1]},
                    return_state=True, config=cfg),
                    100 if shape[1] == 1 else 10, warmup=2)
            best = min(times, key=times.get)
            out.append(dict(kernel=kernel, shape=shape, dtype=dtype,
                            default=default.to_dict(),
                            default_ms=times[default],
                            best=best.to_dict(), best_ms=times[best],
                            ms={str(sorted(c.to_dict().items())): t
                                for c, t in sorted(times.items(),
                                                   key=lambda kv: kv[1])}))
            print(f"    {kernel} {shape} {dtype}: default {default.to_dict()} "
                  f"{times[default]:.4f} ms, best {best.to_dict()} "
                  f"{times[best]:.4f} ms; fastest five: " + ", ".join(
                      f"{c.to_dict()} {t:.4f}" for c, t in sorted(
                          times.items(), key=lambda kv: kv[1])[:5]))
            del sets
    torch.cuda.empty_cache()
    return out


def recurrent_smoke_parity(torch, arch: str, seed: int, dev) -> dict:
    """Phase 5 for the recurrent families and the hybrid: the smoke config
    on the card (B9/B10, apr_matmul and, for the hybrid, B2/B3) and on the
    CPU (plain versions), same weights.  ``paged``: one prefill chunk of 8
    (two rows, one padded after 5) through the state pools and, for the
    hybrid, KV pages 1-2 and 3-4 of the table, then 3 decode ticks, each
    side fed the CPU's greedy tokens; ``prefill``: ``bundle.prefill`` of the
    8 tokens (B9/B10 over all T on the card, the chunked formula on the
    CPU).  The hybrid adds ``slot``: 4 decode steps on the slot cache (one
    row starting empty, one at length 3), and ``forward``: every position of
    ``bundle.forward`` over the 8 tokens."""
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

    def result(diffs, flips, agree, total):
        return dict(max_abs_logits_diff=max(diffs), per_step=diffs,
                    greedy_agree=agree, greedy_total=total, flips=flips,
                    bound=SMOKE_LOGITS_BOUND)

    res = {}
    # paged: [3 KV columns | read | T writes]; the chunk's last real token
    # of row 0 writes state slot 2, of row 1 slot 3; the rest go to trash
    # slot 1; row 0's KV on pages 1-2, row 1's on pages 3-4
    caches = {w: b_.init_paged_cache(9, 8, state_slots=6)
              for w, b_ in bundles.items()}
    tokens, counts = first, np.array([8, 5], np.int32)
    lengths = np.zeros(2, np.int32)
    pages = np.array([[1, 2, 0], [3, 4, 0]], np.int32)
    writes = np.ones((2, 8), np.int32)
    writes[0, 7], writes[1, 4] = 2, 3
    tables = np.concatenate([pages, np.zeros((2, 1), np.int32), writes],
                            axis=1)
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
        tables = np.concatenate([pages, [[2, 2], [3, 3]]], axis=1).astype(
            np.int32)
    res["paged"] = result(diffs, flips, agree, 8)
    out = {w: b_.prefill(prm[w], *on(w, (first,)))[0][:, 0].float().cpu()
           for w, b_ in bundles.items()}
    diffs, flips = [], []
    _, agree = record(out, diffs, flips, 0)
    res["prefill"] = result(diffs, flips, agree, 2)
    if scfg.family != "hybrid":
        return res
    caches = {w: b_.init_cache(2, 16) for w, b_ in bundles.items()}
    tokens, lengths = first[:, :1], np.array([0, 3], np.int32)
    diffs, flips, agree = [], [], 0
    for step in range(4):
        out = {w: b_.decode_step(prm[w], caches[w], *on(w, (
            tokens, lengths)))[:, 0].float().cpu()
            for w, b_ in bundles.items()}
        nxt, n_eq = record(out, diffs, flips, step)
        agree += n_eq
        tokens = nxt.numpy()[:, None].astype(np.int32)
        lengths = lengths + 1
    res["slot"] = result(diffs, flips, agree, 8)
    out = {w: b_.forward(prm[w], *on(w, (first,))).float().cpu().reshape(
        16, -1) for w, b_ in bundles.items()}
    diffs, flips = [], []
    _, agree = record(out, diffs, flips, 0)
    res["forward"] = result(diffs, flips, agree, 16)
    return res


def recurrent_serving(torch, arch: str, seed: int, dev, checked, finite,
                      reset_counts, llm_counts, check_served) -> dict:
    """Phase 7: full-width ``arch`` (random bf16 weights from ``seed``) on
    the PagedServeEngine with its StateCache (4 slots, prefill chunks of 16;
    the hybrid's shared attention on KV pages behind the same table) and on
    the slot ServeEngine, the same 6 requests; the greedy tokens of the two
    are compared (the caller gates them), and every launch count must be
    what the path demands.  Then ``bundle.prefill`` of one 1024-token prompt
    (``bundle.forward`` for the hybrid, whose prefill is the forward's last
    row) with B9/B10 over all T, held to the card's plain path and
    timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba2 import mamba2_ssd
    from repro_torch.kernels.rwkv6 import rwkv6_wkv
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine

    cfg = dataclasses.replace(get_config(arch),
                              num_layers=RECURRENT_LAYERS[arch])
    scan_name = "rwkv6_wkv" if cfg.family == "ssm" else "mamba2_ssd"
    hybrid = cfg.family == "hybrid"
    bundle = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size()
                    for t in params.values()) / 1e9
    per_fwd = apr_per_forward(cfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in RECURRENT_PROMPTS]
    forward, decode_step = bundle.decode_paged, bundle.decode_step
    bundle.decode_paged = checked(forward)
    kw = dict(device="cuda", slots=4, page_size=16, prefill_chunk=16)

    def expect(token_forwards: int, attention: str = None) -> dict:
        """The launches of ``token_forwards`` token-forwards, the hybrid's
        shared attention on ``attention`` (B2 ``flash_decode_paged`` or B3
        ``flash_decode``; none in a whole-sequence forward)."""
        out = {**{k: 0 for k in llm_counts()},
               "apr_matmul": per_fwd * token_forwards,
               scan_name: cfg.num_layers * token_forwards}
        if attention:
            out[attention] = attn_per_forward(cfg) * token_forwards
        return out

    # one token-forward alone, to confirm the per-forward counts
    warm = PagedServeEngine(bundle, params, **kw)
    warm.submit(Request(rid=-1, prompt=[1] * 20, max_new_tokens=2))
    warm.run_until_drained()
    reset_counts()
    # [16 KV page columns | read | write]: distinct pages for each row's
    # positions (the hybrid reads them; the recurrent families do not),
    # state slots 2..5 read and written
    one = np.zeros((4, 16 + 2), np.int32)
    one[:, 16:] = np.arange(2, 6)[:, None]
    at = 1
    for i, n in enumerate(RECURRENT_PROMPTS[:4]):
        need = -(-(n + 1) // 16)
        one[i, :need] = np.arange(at, at + need)
        at += need
    forward(params, warm.cache, *[torch.from_numpy(a).to(dev) for a in (
        np.ones((4, 1), np.int32), np.zeros(4, np.int32),
        np.ones(4, np.int32), one)])
    torch.cuda.synchronize()
    per_forward = llm_counts()
    if per_forward != expect(1, "flash_decode_paged"):
        fail(f"{arch}: one decode forward launched {per_forward}, expected "
             f"{expect(1, 'flash_decode_paged')}")
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
                 launches=launches, expected_launches=expect(
                     token_forwards, "flash_decode_paged"))
    # the least a decode tick at 4 slots could take: every weight but the
    # embedding streamed once, the 4 sequences' state read and written (the
    # hybrid's KV at these lengths, ~5 MB, left out)
    live_state = (paged["state_pool_bytes"] * engine.slots
                  / engine.state.pool_slots)
    paged["tick_bound_ms"] = (weight_gb * 1e9 - params["embed"].numel()
                              * params["embed"].element_size()
                              + 2 * live_state) / HBM_BYTES_PER_S * 1e3
    check_served(f"phase 7 {arch} paged", reqs, RECURRENT_NEW, launches,
                 expect(token_forwards, "flash_decode_paged"))
    if paged["state_pool_bytes"] != state_pool_bytes(cfg):
        fail(f"{arch}: state pools of {paged['state_pool_bytes']} bytes, "
             f"expected {state_pool_bytes(cfg)}")
    paged_out = [r.output for r in reqs]

    # one decode tick at the phase's prompt lengths, reading and writing
    # state slots 2..5 (and the pages of ``one``): wall time and the
    # profiled device-idle share
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
                    len(step_ms), "flash_decode"))
    check_served(f"phase 7 {arch} slot", slot_reqs, RECURRENT_NEW,
                 slot_launches, expect(len(step_ms), "flash_decode"))

    # the speculative engine on the same requests, with the n-gram draft
    # and with the oracle (the paged run's tokens, corrupted at a depth
    # going round 0..SPEC_K): every verify step runs spec_k + 1
    # token-forwards (the recurrent paths step one token at a time),
    # rejected proposals roll back the KV pages and restore the state ring;
    # tokens gated equal to the paged engine's
    spec = spec_oracle = None
    if arch in SPEC_STATE_ARCHS:
        from repro_torch.spec import NgramDraft, SpeculativeServeEngine
        spec_n, spec_new = SPEC_STATE_ARCHS[arch]
        spec_ref = [o[:spec_new] for o in paged_out[:spec_n]]

        def serve_spec(tag, draft):
            bundle.decode_paged = checked(forward)
            spec_reqs = [Request(rid=i, prompt=p, max_new_tokens=spec_new)
                         for i, p in enumerate(prompts[:spec_n])]
            spec_engine = SpeculativeServeEngine(
                bundle, params, spec_k=SPEC_K, draft=draft, **kw)
            finite.clear()
            reset_counts()
            t0 = time.perf_counter()
            for r in spec_reqs:
                spec_engine.submit(r)
            spec_engine.run_until_drained()
            torch.cuda.synchronize()
            spec_wall = time.perf_counter() - t0
            spec_launches = llm_counts()
            bundle.decode_paged = forward
            sm = spec_engine.metrics
            spec_forwards = (spec_engine.prefill_chunk * sm.prefill_calls
                             + (SPEC_K + 1) * sm.decode_calls)
            spec_same = sum(a == b for r, o in zip(spec_reqs, spec_ref)
                            for a, b in zip(r.output, o))
            run = dict(**sm.summary(), wall_s=spec_wall, spec_k=SPEC_K,
                       max_new=spec_new, draft=tag,
                       token_forwards=spec_forwards,
                       ms_per_verify_step=1e3 * sm.decode_time_s
                       / sm.decode_calls,
                       state_restores=spec_engine.state.stats["restores"],
                       tokens_equal_paged=spec_same,
                       tokens_total=sum(len(o) for o in spec_ref),
                       launches=spec_launches, expected_launches=expect(
                           spec_forwards, "flash_decode_paged"))
            check_served(f"phase 7 {arch} spec ({tag})", spec_reqs,
                         spec_new, spec_launches,
                         expect(spec_forwards, "flash_decode_paged"))
            if spec_same != run["tokens_total"]:
                fail(f"phase 7 {arch} ({tag}): speculative tokens differ "
                     f"from the paged engine's ({spec_same}/"
                     f"{run['tokens_total']})")
            if isinstance(draft, CorruptedDraft):
                run["steps_by_accepted"] = draft.check(
                    f"phase 7 {arch} ({tag})")
            return run

        spec = serve_spec("n-gram draft", NgramDraft())
        spec_oracle = serve_spec("oracle, corrupted at depth 0..4",
                                 CorruptedDraft(Replay(spec_ref),
                                                cfg.vocab_size, SPEC_K))

    # bundle.prefill of one 1024-token prompt (the hybrid: bundle.forward,
    # whose last row its prefill is), B9/B10 at T = 1024.  The
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
        # y, and the state out where the caller asks for it (a prefill
        # does, the hybrid's forward does not)
        out = scan(*a, **kw)
        ref = per_step(*a, **kw)
        if not kw.get("return_state"):
            layer_errs.append((scan_err(out, ref, BF16_RTOL, SCAN_ATOL_REL),
                               (0.0, 0.0, True)))
            return out
        layer_errs.append((scan_err(out[0], ref[0], BF16_RTOL, SCAN_ATOL_REL),
                           scan_err(out[1], ref[1], STATE_RTOL, STATE_RTOL)))
        return out

    scan_events = []

    def timed(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = scan(*a, **kw)
        end.record()
        scan_events.append((start, end))
        return out

    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 1024))
                              ).to(dev)
    logits, times = {}, {}
    seam = mod.use_scan_kernel
    for impl in ("kernel", "shadow", "plain", "per-step"):
        torch.cuda.synchronize()
        reset_counts()
        setattr(mod, fn, {"shadow": shadowed, "per-step": per_step,
                          "kernel": timed}[impl] if impl != "plain"
                else scan)
        if impl == "plain":
            mod.use_scan_kernel = lambda x: False
        t0 = time.perf_counter()
        try:
            out = (bundle.forward(params, prompt)[:, -1:] if hybrid
                   else bundle.prefill(params, prompt)[0])
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
    scan_ms = sum(a.elapsed_time(b) for a, b in scan_events)
    prefill = dict(tokens=1024, entry="forward" if hybrid else "prefill",
                   kernel_ms=1e3 * times["kernel"],
                   scan_ms=scan_ms, scan_share=scan_ms / 1e3
                   / times["kernel"], scan_launches=len(scan_events),
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
                slot=slot, spec=spec, spec_oracle=spec_oracle,
                prefill_1024=prefill,
                tokens_equal=same)


# ------------------------------------- the moe and vlm families (B1-B3)
#: phase 2's B1 shapes of the moe and vlm families, (K, N): the routers,
#: the experts' projections of arctic-480b and llama4-maverick, and
#: internvl2-1b's projections and lm_head (896 wide)
MOE_VLM_MM_SHAPES = [(7168, 128), (5120, 128),
                     (7168, 4864), (4864, 7168), (5120, 8192), (8192, 5120),
                     (896, 896), (896, 128), (896, 4864), (4864, 896),
                     (896, 151808)]
#: the M of those checks: one row, a decode tick's queue, a prefill
#: chunk's, up to a 4-slot chunk's rows
MOE_ROW_MS = (1, 2, 4, 16, 64)
#: phase 7b: the MoE archs at published widths, depth cut to this many
#: layers (arctic: 2 MoE layers; llama4: one super-block of a dense and an
#: MoE layer), served at the published capacity factor and drop-free
MOE_LAYERS = {"arctic-480b": 2, "llama4-maverick-400b-a17b": 2}
#: the capacity factor at which no dispatch drops: E / k, so the capacity
#: is the call's row count
MOE_DROP_FREE = {"arctic-480b": 64.0, "llama4-maverick-400b-a17b": 128.0}
#: phase 4's requests (prompt lengths; 16 new tokens each), drawn below
#: each model's own vocab
SERVE_PROMPTS = (24, 180, 57, 133, 96, 40)
#: phase 7b's internvl2-1b whole sequence: B rows of the published 256
#: stubbed vision embeddings then VLM_TEXT text tokens
VLM_B, VLM_TEXT, VLM_TICKS = 2, 256, 8


def moe_vlm_matmul_checks(torch, gen, dev) -> list:
    """Phase 2: B1 (bf16 weights, and over int8 weights at llama4's expert
    shapes, as its int8 run serves them) at :data:`MOE_VLM_MM_SHAPES` under
    the default configuration: each call at every M of :data:`MOE_ROW_MS`
    gives the first M rows of the M = 64 call bit for bit (a row's bits do
    not depend on the queue it rides in), and the M = 64 call is held to
    the plain version at the bf16 tolerance."""
    from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
    from repro_torch.quant import quantize_channelwise
    cases, m_max = [], max(MOE_ROW_MS)
    for k, n in MOE_VLM_MM_SHAPES:
        x = torch.randn((m_max, k), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(
            torch.bfloat16)
        weights = [("apr_matmul", w, w)]
        if (k, n) in ((5120, 8192), (8192, 5120)):
            qt = quantize_channelwise(w.float())
            weights.append(("apr_matmul_int8w", qt,
                            qt.dequantize(torch.bfloat16)))
        for name, ww, w_plain in weights:
            outs = {m: apr_matmul(x[:m], ww) for m in MOE_ROW_MS}
            ref = matmul_ref(x, w_plain, torch.bfloat16)
            torch.cuda.synchronize()
            same = all(torch.equal(o, outs[m_max][:m])
                       for m, o in outs.items())
            err, ok = max_err(outs[m_max], ref)
            cases.append((name, f"K={k} N={n} rows at M={list(MOE_ROW_MS)} "
                          f"bit-equal to M={m_max}'s {same}, vs plain", err,
                          ok and same))
        del x, w, weights, outs
    return cases


def route_flips(sel, logits, sel_card, **where) -> list:
    """The rows whose experts differ between the CPU's selections ``sel``
    (t, k) and the card's ``sel_card``, each with how far the card's extra
    expert sits below the CPU's k-th router logit (``logits``, the CPU's
    fp32 router logits) and whether that is within a bf16 ulp of it (a
    near-tie: the router is a product in the activations' dtype, so the
    card's and the CPU's sums may round two such experts into the other
    order); ``where`` is added to each entry."""
    out = []
    for row in range(sel.shape[0]):
        extra = set(sel_card[row].tolist()) - set(sel[row].tolist())
        if not extra:
            continue
        kth = float(logits[row].sort(descending=True).values[
            sel.shape[1] - 1])
        ulp = 2.0 ** (math.floor(math.log2(max(abs(kth), 1e-30))) - 7)
        gap = max(kth - float(logits[row, e]) for e in extra)
        out.append(dict(where, row=row, gap=gap, ulp=ulp,
                        near_tie=gap <= ulp))
    return out


def family_smoke_parity(torch, arch: str, seed: int, dev,
                        scfg=None) -> dict:
    """Phase 5 for the moe and vlm families and the dense G-wide smoke
    variants (``scfg``; the arch's smoke config by default): the config on
    the card (B1, B2/B2q, B3) and on the CPU (plain versions), same
    weights.  ``paged_*``: one prefill chunk of 8 (two rows, one padded
    after 5: its padded rows route too) then 3 decode ticks over bf16
    pools (bf16 params), int8 pools with int8 weights (the router full
    precision), and fp32 pools with fp32 params; ``slot``: 4 decode steps
    on the slot cache
    (one row starting empty); ``forward_*`` / ``prefill_*``: every position
    of ``bundle.forward`` and ``bundle.prefill``'s last one over the 8
    tokens, after the 8 stubbed vision embeddings for the vlm, bf16 and
    fp32 params.  Each side is fed the CPU's greedy tokens; bound
    SMOKE_LOGITS_BOUND (bf16) or F32_SMOKE_LOGITS_BOUND (fp32).

    The router is a product in the activations' dtype on both sides (as
    in JAX), so where two experts' router logits lie within a bf16 ulp the
    card's and the CPU's sums may round them into the other order and
    route a token to another expert: its logits then differ by O(1), and
    so do the later steps that attend to its K/V.  Each side's routing is
    recorded; a step whose routing differs is gated to be such a near-tie
    (on the CPU's router logits, each expert only the card picked within
    a bf16 ulp of the CPU's k-th logit) and, from it on, its logits are
    reported and not held to the bound (``routing_flips``).  Every row's
    routing is compared, padded positions' included: on the card a padded
    position attends up to its own index over its row's table, as on the
    CPU, so it routes from the same hidden state."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import linear
    scfg = scfg or get_config(arch, smoke=True)
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    bundles = {w: build_model(scfg, device=d) for w, d in devices.items()}
    cpu_params = bundles["cpu"].init_params(
        torch.Generator().manual_seed(seed))
    variants = {"bf16": cpu_params,
                "int8": bundles["cpu"].quantize_params(cpu_params),
                "fp32": {k: v.float() for k, v in cpu_params.items()}}
    rng = np.random.default_rng(seed)
    first = rng.integers(1, scfg.vocab_size, (2, 8)).astype(np.int32)
    prefix = None
    if scfg.vision_tokens:
        prefix = torch.from_numpy(rng.standard_normal(
            (2, scfg.vision_tokens, scfg.d_model)).astype(np.float32))
    routes = {"cpu": [], "cuda": []}
    route_of = moe_mod.route
    side = ["cpu"]                     # the side whose forward is running

    def recorded(x, w, cfg, capacity):
        r = route_of(x, w, cfg, capacity)
        logits = linear(x, w).float() if side[0] == "cpu" else None
        routes[side[0]].append((r.expert.reshape(x.shape[0], -1).cpu(),
                                logits))
        return r

    def on(where, arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(devices[where])
                for a in arrays]

    def params_on(label):
        return {"cpu": variants[label],
                "cuda": {k: v.to(dev) for k, v in variants[label].items()}}

    def flips_of(step) -> list:
        """The routing differences of this step's calls (cleared after) on
        every one of the calls' B·T rows, padded ones included, each
        checked to be a router near-tie (:func:`route_flips`)."""
        out = []
        for call, ((sel, logits), (sel_c, _)) in enumerate(zip(
                routes["cpu"], routes["cuda"])):
            out += route_flips(sel, logits, sel_c, step=step, call=call)
        if len(routes["cpu"]) != len(routes["cuda"]):
            out.append(dict(step=step, calls=(len(routes["cpu"]),
                                              len(routes["cuda"])),
                            near_tie=False))
        routes["cpu"].clear()
        routes["cuda"].clear()
        return out

    def record(out, diffs, flips, step):
        diffs.append(float((out["cpu"] - out["cuda"]).abs().max()))
        nxt, got = out["cpu"].argmax(-1), out["cuda"].argmax(-1)
        for row in torch.nonzero(nxt != got).flatten().tolist():
            flips.append(dict(step=step, row=row, cpu_gap=float(
                out["cpu"][row, nxt[row]] - out["cpu"][row, got[row]])))
        return nxt, int((nxt == got).sum())

    def result(diffs, flips, agree, total, bound, routing):
        """Held to ``bound``: the steps before the first routing flip."""
        first_flip = min((f["step"] for f in routing), default=len(diffs))
        held = diffs[:first_flip]
        return dict(max_abs_logits_diff=max(held, default=0.0),
                    per_step=diffs, greedy_agree=agree, greedy_total=total,
                    flips=flips, bound=bound, routing_flips=routing,
                    steps_held=len(held))

    res = {}
    moe_mod.route = recorded
    try:
        for label, kv, bound in (("bf16", "bfloat16", SMOKE_LOGITS_BOUND),
                                 ("int8", "int8", SMOKE_LOGITS_BOUND),
                                 ("fp32", "float32", F32_SMOKE_LOGITS_BOUND)):
            prm = params_on(label)
            caches = {w: b_.init_paged_cache(9, 8, kv)
                      for w, b_ in bundles.items()}
            tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
            tokens, counts = first, np.array([8, 5], np.int32)
            lengths = np.zeros(2, np.int32)
            diffs, flips, agree, routing = [], [], 0, []
            for step in range(4):
                out = {}
                for where, b_ in bundles.items():
                    side[0] = where
                    logits = b_.decode_paged(prm[where], caches[where], *on(
                        where, (tokens, lengths, counts, tables)))
                    out[where] = logits[[0, 1], torch.from_numpy(
                        counts - 1).long().to(devices[where])].float().cpu()
                routing += flips_of(step)
                nxt, n_eq = record(out, diffs, flips, step)
                agree += n_eq
                tokens = nxt.numpy()[:, None].astype(np.int32)
                lengths, counts = lengths + counts, np.ones(2, np.int32)
            res[f"paged_{label}"] = result(diffs, flips, agree, 8, bound,
                                           routing)
        prm = params_on("bf16")
        caches = {w: b_.init_cache(2, 16) for w, b_ in bundles.items()}
        tokens, lengths = first[:, :1], np.array([0, 3], np.int32)
        diffs, flips, agree, routing = [], [], 0, []
        for step in range(4):
            out = {}
            for w, b_ in bundles.items():
                side[0] = w
                out[w] = b_.decode_step(prm[w], caches[w], *on(w, (
                    tokens, lengths)))[:, 0].float().cpu()
            routing += flips_of(step)
            nxt, n_eq = record(out, diffs, flips, step)
            agree += n_eq
            tokens = nxt.numpy()[:, None].astype(np.int32)
            lengths = lengths + 1
        res["slot"] = result(diffs, flips, agree, 8, SMOKE_LOGITS_BOUND,
                             routing)
        for label, bound in (("bf16", SMOKE_LOGITS_BOUND),
                             ("fp32", F32_SMOKE_LOGITS_BOUND)):
            prm = params_on(label)
            dtype = torch.float32 if label == "fp32" else torch.bfloat16
            for entry in ("forward", "prefill"):
                out = {}
                for w, b_ in bundles.items():
                    side[0] = w
                    pe = (None if prefix is None
                          else prefix.to(dtype).to(devices[w]))
                    toks = on(w, (first,))[0]
                    lg = (b_.forward(prm[w], toks, prefix_embeds=pe)
                          if entry == "forward" else
                          b_.prefill(prm[w], toks, max_seq=32,
                                     prefix_embeds=pe)[0])
                    out[w] = lg.float().cpu().reshape(-1, lg.shape[-1])
                routing = flips_of(0)
                diffs, flips = [], []
                _, agree = record(out, diffs, flips, 0)
                res[f"{entry}_{label}"] = result(
                    diffs, flips, agree, out["cpu"].shape[0], bound, routing)
    finally:
        moe_mod.route = route_of
    bad = [f for r in res.values() for f in r["routing_flips"]
           if not f["near_tie"]]
    if bad:
        fail(f"phase 5 {arch}: card and CPU route differently away from a "
             f"router near-tie: {bad[:4]}")
    return res


def serve_counted(torch, bundle, prm, kind: str, prompts, max_new: int,
                  finite, reset_counts, llm_counts, kv_dtype="bfloat16"):
    """Serve ``prompts`` (``max_new`` tokens each) on a fresh engine of
    ``kind`` -- ``"paged"`` (PagedServeEngine, 4 slots, pages and chunks
    of 16), ``"slot"`` (ServeEngine, 4 slots, max_seq 256) or ``"spec"``
    (the n-gram SpeculativeServeEngine over the paged one, spec_k =
    SPEC_K) -- with every launch count set to 0 just before and read just
    after.  Returns a dict: outputs, wall seconds, the launches, the
    target forwards (paged: decode ticks + prefill chunks + verify steps;
    slot: decode steps), ms a decode forward, the engine metrics' summary
    (not the slot engine's, which keeps none) and peak memory."""
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine
    from repro_torch.spec import NgramDraft, SpeculativeServeEngine
    kw = dict(device="cuda", slots=4, page_size=16, prefill_chunk=16,
              kv_dtype=kv_dtype)
    step_ms = []
    if kind == "slot":
        inner = bundle.decode_step

        def timed_step(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = inner(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits
        bundle.decode_step = timed_step
        engine = ServeEngine(bundle, prm, device="cuda", slots=4, max_seq=256)
    else:
        inner = bundle.decode_paged

        def checked(*a):
            logits = inner(*a)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits
        bundle.decode_paged = checked
        engine = (SpeculativeServeEngine(bundle, prm, spec_k=SPEC_K,
                                         draft=NgramDraft(), **kw)
                  if kind == "spec" else PagedServeEngine(bundle, prm, **kw))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite.clear()
    reset_counts()
    t0 = time.perf_counter()
    try:
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
    finally:
        if kind == "slot":
            bundle.decode_step = inner
        else:
            bundle.decode_paged = inner
    out = dict(kind=kind, kv_dtype=kv_dtype, wall_s=time.perf_counter() - t0,
               launches=llm_counts(), outputs=[r.output for r in reqs],
               done=all(r.done for r in reqs),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if kind == "slot":
        out.update(forwards=len(step_ms), ms_per_tick=float(np.mean(step_ms)),
                   ms_per_tick_median=float(np.median(step_ms)))
    else:
        m = engine.metrics
        out.update(forwards=m.decode_calls + m.prefill_calls,
                   ms_per_tick=1e3 * m.decode_time_s / m.decode_calls,
                   ms_per_prefill_chunk=1e3 * m.prefill_time_s
                   / m.prefill_calls, **m.summary())
    out["reqs"] = reqs
    del engine
    return out


def tokens_equal(a, b) -> tuple:
    """(equal tokens, tokens) of two runs' outputs, position by
    position."""
    return (sum(x == y for oa, ob in zip(a, b) for x, y in zip(oa, ob)),
            sum(len(o) for o in b))


def moe_serving(torch, arch: str, seed: int, dev, finite, reset_counts,
                llm_counts, check_served) -> dict:
    """Phase 7b for an MoE arch: published widths, depth cut to
    :data:`MOE_LAYERS` (random bf16 weights drawn on the card from
    ``seed``), phase 4's requests (:data:`SERVE_PROMPTS`, 16 new tokens,
    prompts below the arch's vocab) on 4 slots.  At the published capacity
    factor: the paged engine (and arctic's slot engine), with the dropped
    dispatches, ms a tick, a profiled tick's idle share against its byte
    floor, and llama4 also with int8 weights and int8 KV (quantized on the
    card, the bf16 weights freed first).  Drop-free (:data:`MOE_DROP_FREE`):
    the paged and slot engines' tokens gated equal, and arctic's n-gram
    speculative engine's equal to the paged engine's.  Every run's B1
    launches are gated against the count its routing gives: per forward
    the attention's 4 and the head's 1, each dense layer's 3, each MoE
    layer's router and (arctic) dense residual, and 3 for every expert
    with a non-empty queue, as ``moe.expert_counts`` read them."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.quant import QuantizedTensor

    cfg = dataclasses.replace(get_config(arch), num_layers=MOE_LAYERS[arch])
    n_moe = cfg.num_layers // cfg.moe_every
    n_dense = cfg.num_layers - n_moe
    res_ff = 3 if cfg.dense_residual_ff else 0
    bundle = build_model(cfg, device="cuda")
    free = build_model(dataclasses.replace(
        cfg, moe_capacity_factor=MOE_DROP_FREE[arch]), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size()
                    for t in params.values()) / 1e9
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in SERVE_PROMPTS]

    routing = dict(calls=0, nonempty=0, dropped=0, dispatches=0, read_s=0.0)
    counts_of = moe_mod.expert_counts

    def counted(r):
        t0 = time.perf_counter()
        counts = counts_of(r)
        routing["read_s"] += time.perf_counter() - t0
        routing["calls"] += 1
        routing["nonempty"] += sum(c > 0 for c in counts)
        routing["dropped"] += sum(max(c - r.capacity, 0) for c in counts)
        routing["dispatches"] += sum(counts)
        return counts

    def expect(forwards: int, int8: bool, attention: str) -> dict:
        """The launches of ``forwards`` forwards whose MoE layers ran
        ``routing["nonempty"]`` experts in all (int8 weights: the router
        stays bf16, on B1)."""
        per_fwd = (4 * cfg.num_layers + 3 * n_dense
                   + (1 + res_ff) * n_moe + 1)
        weights = per_fwd * forwards + 3 * routing["nonempty"]
        out = {k: 0 for k in llm_counts()}
        if int8:
            out["apr_matmul"] = n_moe * forwards
            out["apr_matmul_int8w"] = weights - n_moe * forwards
        else:
            out["apr_matmul"] = weights
        out[attention] = cfg.num_layers * forwards
        return out

    def run(tag, b_, prm, kind, kv_dtype="bfloat16", int8=False) -> dict:
        for key in routing:
            routing[key] = 0
        r = serve_counted(torch, b_, prm, kind, prompts, 16, finite,
                          reset_counts, llm_counts, kv_dtype)
        attention = ("flash_decode" if kind == "slot" else
                     "flash_decode_paged_int8" if kv_dtype == "int8" else
                     "flash_decode_paged")
        r["expected_launches"] = expect(r["forwards"], int8, attention)
        r["routing"] = dict(routing, read_ms_per_layer=1e3
                            * routing["read_s"] / max(routing["calls"], 1),
                            capacity_factor=b_.cfg.moe_capacity_factor)
        check_served(f"phase 7b {arch} {tag}", r.pop("reqs"), 16,
                     r["launches"], r["expected_launches"])
        if routing["calls"] != n_moe * r["forwards"]:
            fail(f"phase 7b {arch} {tag}: {routing['calls']} routings for "
                 f"{r['forwards']} forwards of {n_moe} MoE layers")
        rt = r["routing"]
        print(f"    {tag}: {kind} engine, capacity factor "
              f"{rt['capacity_factor']:g}, {r['forwards']} forwards in "
              f"{r['wall_s']:.2f} s wall, {r['ms_per_tick']:.3f} ms a decode "
              f"{'step' if kind == 'slot' else 'forward'}; routing: "
              f"{rt['dispatches']} dispatches, {rt['dropped']} dropped, "
              f"{rt['nonempty']} expert launches of 3 B1 "
              f"({rt['nonempty'] / max(rt['calls'], 1):.2f} experts a MoE "
              f"layer), the counts' host read {rt['read_ms_per_layer']:.3f} "
              f"ms a MoE layer; launches {r['launches']['apr_matmul']} "
              f"apr_matmul + {r['launches']['apr_matmul_int8w']} int8w + "
              f"{r['launches'][attention]} {attention} (expected "
              f"{r['expected_launches']['apr_matmul']} + "
              f"{r['expected_launches']['apr_matmul_int8w']} + "
              f"{r['expected_launches'][attention]}); peak "
              f"{r['peak_mem_gb']:.2f} GB", flush=True)
        return r

    out = dict(arch=arch, layers=cfg.num_layers, weight_gb=weight_gb,
               init_s=init_s, runs={})
    print(f"[7b] {arch} at published widths (d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), {cfg.num_layers} layers: {weight_gb:.2f} GB "
          f"bf16 weights drawn on the card in {init_s:.2f} s", flush=True)
    moe_mod.expert_counts = counted
    try:
        # warm the kernels at these shapes on a throwaway run
        serve_counted(torch, bundle, params, "paged", [prompts[0][:20]], 2,
                      finite, reset_counts, llm_counts)
        runs = out["runs"]
        runs["paged"] = run("published factor, paged", bundle, params,
                            "paged")
        out["tick"] = paged_tick(torch, bundle, params, cfg, rng, dev,
                                 routing)
        if arch == "arctic-480b":
            runs["slot"] = run("published factor, slot", bundle, params,
                               "slot")
            same, total = tokens_equal(runs["slot"]["outputs"],
                                       runs["paged"]["outputs"])
            print(f"    information: at the published factor a token's "
                  f"routing depends on the rows beside it (capacity): "
                  f"slot/paged tokens {same}/{total}")
        runs["paged_drop_free"] = run("drop-free, paged", free, params,
                                      "paged")
        runs["slot_drop_free"] = run("drop-free, slot", free, params, "slot")
        same, total = tokens_equal(runs["slot_drop_free"]["outputs"],
                                   runs["paged_drop_free"]["outputs"])
        out["drop_free_slot_vs_paged"] = (same, total)
        print(f"    drop-free: slot/paged greedy tokens {same}/{total}")
        if same != total:
            fail(f"phase 7b {arch}: drop-free slot and paged tokens differ "
                 f"({same}/{total})")
        if arch == "arctic-480b":
            runs["spec_drop_free"] = run("drop-free, n-gram spec", free,
                                         params, "spec")
            same, total = tokens_equal(runs["spec_drop_free"]["outputs"],
                                       runs["paged_drop_free"]["outputs"])
            out["spec_vs_paged"] = (same, total)
            sp = runs["spec_drop_free"]
            print(f"    n-gram SpeculativeServeEngine (spec_k={SPEC_K}): "
                  f"acceptance {sp['acceptance_rate']:.3f}, "
                  f"{sp['tokens_per_step']:.3f} tokens a step; greedy "
                  f"tokens equal to the paged engine's {same}/{total}")
            if same != total:
                fail(f"phase 7b {arch}: speculative tokens differ from the "
                     f"paged engine's ({same}/{total})")
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qparams = bundle.quantize_params(params)
            torch.cuda.synchronize()
            quant_s = time.perf_counter() - t0
            del params
            torch.cuda.empty_cache()
            int8_gb = sum(w.nbytes if isinstance(w, QuantizedTensor)
                          else w.numel() * w.element_size()
                          for w in qparams.values()) / 1e9
            print(f"    int8 weights: {int8_gb:.2f} GB, quantized on the "
                  f"card in {quant_s:.2f} s, the bf16 weights freed")
            runs["paged_int8"] = run("published factor, int8 weights + "
                                     "int8 KV, paged", bundle, qparams,
                                     "paged", kv_dtype="int8", int8=True)
            runs["paged_int8"].update(weight_gb=int8_gb, quantize_s=quant_s)
            same, total = tokens_equal(runs["paged_int8"]["outputs"],
                                       runs["paged"]["outputs"])
            print(f"    information: int8 tokens equal to bf16's {same}/"
                  f"{total} (random weights; int8 moves near-ties and, at "
                  f"the published factor, the routing)")
            params = qparams
    finally:
        moe_mod.expert_counts = counts_of
    del params
    torch.cuda.empty_cache()
    return out


def paged_tick(torch, bundle, params, cfg, rng, dev, routing=None) -> dict:
    """One decode tick of the paged path at 4 slots, lengths
    :data:`MAIN_LENGTHS` and random tokens: wall ms (5 ticks), a profiled
    tick's device-busy time and idle share, and its byte floor -- every
    weight it reads once (attention, dense FFNs, routers, residuals, the
    head; of an MoE model's experts those it routes to, counted in
    ``routing``) and the K/V of the live tokens -- over the card's memory
    rate."""
    moe = routing is not None
    slots, ps = 4, 16
    tables = np.zeros((slots, 16), np.int32)
    at = 1
    for i, n in enumerate(MAIN_LENGTHS):
        need = -(-(n + 1) // ps)
        tables[i, :need] = np.arange(at, at + need)
        at += need
    cache = bundle.init_paged_cache(at + 1, ps)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(1, cfg.vocab_size, (slots, 1)).astype(np.int32),
        np.asarray(MAIN_LENGTHS, np.int32), np.ones(slots, np.int32),
        tables)]
    fwd = bundle.decode_paged
    fwd(params, cache, *args)
    torch.cuda.synchronize()
    for key in routing or {}:
        routing[key] = 0
    t0 = time.perf_counter()
    for _ in range(5):
        fwd(params, cache, *args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    experts = routing["nonempty"] / 5 if moe else 0
    expert_bytes = 3 * cfg.d_model * cfg.d_ff * 2
    dense_bytes = sum(t.numel() * t.element_size() for k, t in params.items()
                      if k != "embed" and ".moe.w_" not in k)
    kv_bytes = (sum(MAIN_LENGTHS) + slots) * cfg.num_layers * 2 \
        * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    floor_bytes = dense_bytes + experts * expert_bytes + kv_bytes
    tick = dict(wall_ms=wall, floor_gb=floor_bytes / 1e9,
                floor_ms=floor_bytes / HBM_BYTES_PER_S * 1e3)
    if moe:
        tick.update(experts_a_tick=experts, read_ms_per_layer=1e3
                    * routing["read_s"] / max(routing["calls"], 1))
        # the counts' read alone, the card idle: what the host pays beyond
        # waiting for the router's result
        counts = torch.zeros(cfg.num_experts, dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            counts.tolist()
        tick["idle_read_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    by_kernel = profile_device(torch, lambda: fwd(params, cache, *args), 5)
    if by_kernel:
        busy = sum(by_kernel.values())
        tick.update(device_busy_ms=busy, idle_share=1 - busy / wall,
                    top_kernels_ms=dict(sorted(by_kernel.items(),
                                               key=lambda kv: -kv[1])[:6]))
    print(f"    decode tick at lengths {MAIN_LENGTHS} (4 slots, random "
          f"tokens): wall {wall:.3f} ms, "
          + (f"{experts:g} experts launched a tick, " if moe else "")
          + f"byte floor {tick['floor_gb']:.3f} GB = "
          f"{tick['floor_ms']:.3f} ms"
          + (f", device busy {tick['device_busy_ms']:.3f} ms (profiler), "
             f"idle share {tick['idle_share']:.1%}" if by_kernel else "")
          + (f"; the counts' host read {tick['read_ms_per_layer']:.3f} ms a "
             f"MoE layer in the tick ({tick['idle_read_ms']:.4f} ms with "
             f"the card idle)" if moe else ""), flush=True)
    for name, t in tick.get("top_kernels_ms", {}).items():
        print(f"      {t:8.3f} ms  {name[:90]}")
    del cache
    return tick


def vlm_full(torch, seed: int, dev, finite, reset_counts, llm_counts,
             check_served) -> dict:
    """Phase 7b for internvl2-1b at full size (24 layers, published
    widths; random bf16 weights from ``seed``): ``bundle.forward`` and
    ``bundle.prefill`` at B = :data:`VLM_B` over the published 256 stubbed
    vision embeddings then :data:`VLM_TEXT` text tokens (B1 at M = B x
    512), their launches (169 B1 each) and times; :data:`VLM_TICKS` greedy
    decode ticks from the prefilled cache (B1, B3); then phase 4's
    requests on the paged and slot engines, greedy tokens gated equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("internvl2-1b")
    bundle = build_model(cfg, device="cuda")
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(seed))
    weight_gb = sum(t.numel() * t.element_size()
                    for t in params.values()) / 1e9
    per_call = 7 * cfg.num_layers + 1
    zero = {k: 0 for k in llm_counts()}
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (VLM_B, VLM_TEXT))).to(dev)
    vision = (torch.randn((VLM_B, cfg.vision_tokens, cfg.d_model),
                          generator=torch.Generator(device=dev).manual_seed(
                              seed + 2), device=dev) * 0.02).to(
        torch.bfloat16)
    s = cfg.vision_tokens + VLM_TEXT
    out = dict(arch=cfg.name, layers=cfg.num_layers, weight_gb=weight_gb,
               B=VLM_B, vision_tokens=cfg.vision_tokens, text_tokens=VLM_TEXT)

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        reset_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        expect = dict(zero, apr_matmul=per_call)
        out[name] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                         event_ms=start.elapsed_time(end),
                         launches=llm_counts(), expected_launches=expect)
        if out[name]["launches"] != expect:
            fail(f"phase 7b internvl2-1b {name}: launches "
                 f"{out[name]['launches']} != expected {expect}")
        return res

    logits = timed("forward", lambda: bundle.forward(
        params, tokens, prefix_embeds=vision))
    last, cache = timed("prefill", lambda: bundle.prefill(
        params, tokens, max_seq=s + MAX_SEQ_PAD, prefix_embeds=vision))
    v = cfg.padded_vocab
    if (logits.shape != (VLM_B, s, v) or last.shape != (VLM_B, 1, v)
            or not bool(torch.isfinite(logits).all())
            or not bool(torch.isfinite(last).all())):
        fail(f"phase 7b internvl2-1b: logits {tuple(logits.shape)} / "
             f"{tuple(last.shape)} not finite of shape ({VLM_B}, {s} or 1, "
             f"{v})")
    out["prefill_vs_forward_last"] = float(
        (last[:, 0, :cfg.vocab_size].float()
         - logits[:, -1, :cfg.vocab_size].float()).abs().max())
    del logits
    finite.clear()
    reset_counts()
    nxt = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    lengths = torch.full((VLM_B,), s, dtype=torch.int32, device=dev)
    generated, tick_ms = [], []
    for _ in range(VLM_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_logits = bundle.decode_step(params, cache, nxt, lengths)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(bool(torch.isfinite(step_logits).all()))
        nxt = step_logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        generated.append(nxt[:, 0].tolist())
        lengths = lengths + 1
    launches = llm_counts()
    expect = dict(zero, apr_matmul=per_call * VLM_TICKS,
                  flash_decode=cfg.num_layers * VLM_TICKS)
    out["decode_from_prefill"] = dict(
        ticks=VLM_TICKS, tokens=generated, ms_per_tick=float(np.mean(
            tick_ms)), launches=launches, expected_launches=expect)
    if not all(finite) or launches != expect:
        fail(f"phase 7b internvl2-1b: decode from the prefilled cache: "
             f"finite {all(finite)}, launches {launches} != {expect}")
    del cache, last
    f, p = out["forward"], out["prefill"]
    print(f"[7b] internvl2-1b full size ({cfg.num_layers} layers, "
          f"{weight_gb:.2f} GB bf16): forward of {cfg.vision_tokens} vision "
          f"embeddings + {VLM_TEXT} tokens at B={VLM_B} {f['wall_ms']:.2f} "
          f"ms wall, {f['event_ms']:.2f} ms CUDA events; prefill (max_seq "
          f"{s + MAX_SEQ_PAD}) {p['wall_ms']:.2f} ms wall, "
          f"{p['event_ms']:.2f} ms CUDA events; {per_call} apr_matmul "
          f"launches each; prefill's last logits vs forward's last row max "
          f"|diff| {out['prefill_vs_forward_last']:.4g}; {VLM_TICKS} decode "
          f"ticks from the prefilled cache {np.mean(tick_ms):.3f} ms a tick, "
          f"tokens {generated}", flush=True)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in SERVE_PROMPTS]
    for kind, attention in (("paged", "flash_decode_paged"),
                            ("slot", "flash_decode")):
        r = serve_counted(torch, bundle, params, kind, prompts, 16, finite,
                          reset_counts, llm_counts)
        r["expected_launches"] = dict(
            zero, apr_matmul=per_call * r["forwards"],
            **{attention: cfg.num_layers * r["forwards"]})
        check_served(f"phase 7b internvl2-1b {kind}", r.pop("reqs"), 16,
                     r["launches"], r["expected_launches"])
        out[kind] = r
        print(f"    {kind} engine: {r['forwards']} forwards in "
              f"{r['wall_s']:.2f} s wall, {r['ms_per_tick']:.3f} ms a decode "
              f"{'step' if kind == 'slot' else 'tick'}; launches "
              f"{r['launches']['apr_matmul']} apr_matmul + "
              f"{r['launches'][attention]} {attention}", flush=True)
    same, total = tokens_equal(out["slot"]["outputs"],
                               out["paged"]["outputs"])
    out["slot_vs_paged"] = (same, total)
    print(f"    slot/paged greedy tokens {same}/{total}")
    if same != total:
        fail(f"phase 7b internvl2-1b: slot and paged tokens differ "
             f"({same}/{total})")
    del params
    torch.cuda.empty_cache()
    return out


#: phase 5's capacity-drop runs: the smoke MoE configs (drop-free at their
#: factor of 64) at the published factor, 6 requests on 4 slots
DROP_FACTOR = 1.25
DROP_PROMPTS = (5, 17, 9, 12, 3, 14)


def capacity_drops(torch, arch: str, seed: int, dev) -> dict:
    """Phase 5: ``arch``'s smoke config at the published capacity factor
    (:data:`DROP_FACTOR`) on the card's ``PagedServeEngine`` (4 slots,
    pages and prefill chunks of 8, bf16 pools), :data:`DROP_PROMPTS`
    requests of 6 new tokens.  Every ``decode_paged`` call the engine makes
    is recorded and replayed on the CPU bundle (plain versions) in order,
    over a cache of the same pools, so both sides route the same tokens
    with the same K/V history.  Each routing call's kept and dropped
    dispatches are attributed by row to the request the engine serves
    there (``"padding"`` for padded positions and idle slots, which route
    too).  Up to the first call whose selections differ, each call's
    kept/dropped masks must be equal on both sides, so the drops by
    request are equal; after it the drops are reported, not held (the
    flipped token's hidden state differs from then on).  The card's and
    the CPU's router logits differ by the bf16 noise of the hidden states
    (ROADMAP C.0, "card against CPU"), so over a run of 25 forwards a
    selection may flip at a gap of a few bf16 ulps (2-4 on an H100, on
    real and padded rows alike): the differing rows' gap on the CPU's router
    logits must lie within the larger of a bf16 ulp (phase 5's near-tie
    rule) and the router-logit noise of the real rows up to that call,
    and the padded rows' noise within twice the real rows' (a padded row
    held like a real one; before the padded-row repair it attended over
    other positions than on the CPU and parted by O(1))."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import linear
    from repro_torch.serve import PagedServeEngine, Request
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              moe_capacity_factor=DROP_FACTOR)
    bundles = {"cpu": build_model(cfg, device="cpu"),
               "cuda": build_model(cfg, device="cuda")}
    cpu_params = bundles["cpu"].init_params(
        torch.Generator().manual_seed(seed))
    params = {"cpu": cpu_params,
              "cuda": {k: v.to(dev) for k, v in cpu_params.items()}}
    rng = np.random.default_rng(seed + 5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in DROP_PROMPTS]
    routes = {"cpu": [], "cuda": []}
    side = ["cuda"]
    route_of = moe_mod.route

    def recorded(x, w, cfg_, capacity):
        r = route_of(x, w, cfg_, capacity)
        k = cfg_.experts_per_token
        routes[side[0]].append((r.expert.reshape(-1, k).cpu(),
                                r.keep.reshape(-1, k).cpu(),
                                linear(x, w).float().cpu()))
        return r

    calls = []                   # (args on the CPU, the row owners)
    engine = PagedServeEngine(bundles["cuda"], params["cuda"], device="cuda",
                              slots=4, page_size=8, prefill_chunk=8)
    inner = bundles["cuda"].decode_paged

    def record(prm, cache, tokens, lengths, counts, tables):
        b, t = tokens.shape
        host = [a.cpu() for a in (tokens, lengths, counts, tables)]
        owner_of = []
        for row in range(b):
            if b == engine.slots:                 # the decode tick
                slot = row
            else:                                 # a request's prefill
                slot = next(s_ for s_ in range(engine.slots)
                            if engine.active[s_] is not None
                            and np.array_equal(engine.kv.block_tables[s_][
                                :tables.shape[1]], host[3][row].numpy()))
            req = engine.active[slot]
            owner_of += [req.rid if req is not None and i < int(host[2][row])
                         else "padding" for i in range(t)]
        calls.append((host, owner_of))
        return inner(prm, cache, tokens, lengths, counts, tables)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    moe_mod.route = recorded
    bundles["cuda"].decode_paged = record
    try:
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        side[0] = "cpu"
        cache = bundles["cpu"].init_paged_cache(engine.cache["k"].shape[2],
                                                8)
        for host, _ in calls:
            bundles["cpu"].decode_paged(params["cpu"], cache, *host)
    finally:
        moe_mod.route = route_of
        bundles["cuda"].decode_paged = inner
    if len(routes["cpu"]) != len(routes["cuda"]) or not routes["cpu"]:
        fail(f"phase 5 {arch} at factor {DROP_FACTOR}: "
             f"{len(routes['cuda'])} routings on the card, "
             f"{len(routes['cpu'])} on the CPU")
    per_call = len(routes["cpu"]) // len(calls)
    drops = {"cpu": {}, "cuda": {}}
    held = {"cpu": {}, "cuda": {}}
    first_flip, flips, masks_differ = None, [], []
    # |router logits, card - CPU| up to the first flip (its flipped rows
    # left out), on real and on padded rows: the hidden states' agreement
    # the routing rests on
    noise = {"real": 0.0, "padding": 0.0}
    for n, ((sel, keep, logits), (sel_c, keep_c, logits_c)) in enumerate(
            zip(routes["cpu"], routes["cuda"])):
        owners = calls[n // per_call][1]
        call_flips = route_flips(sel, logits, sel_c, call=n)
        for f in call_flips:
            f.update(owner=str(owners[f["row"]]), logits_diff=float(
                (logits[f["row"]] - logits_c[f["row"]]).abs().max()))
        if first_flip is None:
            flipped = {f["row"] for f in call_flips}
            for row, diff in enumerate((logits - logits_c).abs().amax(-1)
                                       .tolist()):
                kind = "padding" if owners[row] == "padding" else "real"
                if row not in flipped:
                    noise[kind] = max(noise[kind], diff)
        if call_flips and first_flip is None:
            first_flip, flips = n, call_flips
        for where, kp in (("cpu", keep), ("cuda", keep_c)):
            for row, dropped in enumerate((~kp).sum(-1).tolist()):
                for dst in (drops, held) if first_flip is None else (drops,):
                    dst[where][owners[row]] = (dst[where].get(owners[row], 0)
                                               + dropped)
        if first_flip is None and not torch.equal(keep, keep_c):
            masks_differ.append(n)
    out = dict(arch=arch, capacity_factor=DROP_FACTOR, calls=len(calls),
               routings=len(routes["cpu"]), first_flip=first_flip,
               flips=flips, masks_differ_before_flip=masks_differ,
               router_logits_diff_before_flip=noise,
               drops_by_request={w: {str(k): v for k, v in d.items()}
                                 for w, d in drops.items()},
               held_drops_by_request={w: {str(k): v for k, v in d.items()}
                                      for w, d in held.items()},
               tokens=[r.output for r in reqs])
    print(f"    {arch} smoke at capacity factor {DROP_FACTOR}, card's "
          f"PagedServeEngine replayed on the CPU ({len(calls)} forwards, "
          f"{len(routes['cpu'])} routings): dropped dispatches by request, "
          f"card {out['drops_by_request']['cuda']}, CPU "
          f"{out['drops_by_request']['cpu']}; "
          + ("no routing differs" if first_flip is None else
             f"routing first differs at routing {first_flip} (rows "
             f"{[(f['row'], f['owner'], round(f['gap'], 5), f['ulp'],
                  round(f['logits_diff'], 5)) for f in flips]}"
             f" as (row, request, gap, bf16 ulp, the row's max |router "
             f"logits diff|); held before it: card "
             f"{out['held_drops_by_request']['cuda']}, CPU "
             f"{out['held_drops_by_request']['cpu']})")
          + f"; max |router logits, card - CPU| before it: real rows "
          f"{noise['real']:.4g}, padded rows {noise['padding']:.4g}",
          flush=True)
    for f in flips:
        f["explained"] = f["gap"] <= max(f["ulp"], noise["real"])
    if masks_differ or not all(f["explained"] for f in flips):
        fail(f"phase 5 {arch} at factor {DROP_FACTOR}: the card's drops "
             f"differ from the CPU's beyond the router-logit agreement of "
             f"real rows (masks differ at routings {masks_differ[:4]}, "
             f"flips {flips[:4]}, real rows' noise {noise['real']:.4g})")
    if noise["padding"] > 2 * max(noise["real"], 2.0 ** -8):
        fail(f"phase 5 {arch} at factor {DROP_FACTOR}: padded rows' router "
             f"logits part from the CPU's by {noise['padding']:.4g}, beyond "
             f"twice the real rows' {noise['real']:.4g}")
    if first_flip is None and drops["cpu"] != drops["cuda"]:
        fail(f"phase 5 {arch} at factor {DROP_FACTOR}: drops by request "
             f"differ: {out['drops_by_request']}")
    return out


#: phase 7c: the archs whose GQA group is wider than 8, at full width
WIDE_ARCHS = ("starcoder2-15b", "chatglm3-6b")
#: phase 5: their G-wide smoke variants, (arch, G): G query heads of 128
#: over one kv head, 2 layers of d 64 (starcoder2's group, chatglm3's)
WIDE_SMOKE = (("starcoder2-15b", 12), ("chatglm3-6b", 16))


def wide_variant(cfg, groups: int):
    """The G-wide narrow variant of a full-width config: ``groups`` query
    heads over one kv head of 128, the smoke depth and widths."""
    from repro_torch.configs import scale_down
    return scale_down(cfg, num_heads=groups, num_kv_heads=1, head_dim=128,
                      name=f"{cfg.name}-g{groups}")


def quantize_streaming(torch, bundle, params) -> dict:
    """``bundle.quantize_params(params)`` one tensor at a time, each bf16
    tensor dropped from ``params`` (emptied) as soon as its int8 copy
    exists, so the card never holds both copies of the weights (44 GB of
    starcoder2-15b beside its 22 GB of int8)."""
    out = {}
    for name in list(params):
        out.update(bundle.quantize_params({name: params.pop(name)}))
    torch.cuda.empty_cache()
    return out


def wide_serving(torch, arch: str, seed: int, dev, finite, reset_counts,
                 llm_counts, check_served) -> dict:
    """Phase 7c for a GQA group wider than 8 (starcoder2-15b: 12, chatglm3-
    6b: 16) at full width (random bf16 weights drawn on the card from
    ``seed``): phase 4's requests (:data:`SERVE_PROMPTS`, 16 new tokens)
    on 4 slots on the paged engine (B1 + B2) and the slot engine (B1 +
    B3), tokens gated equal, each run's launches gated (``7 L + 1`` B1 and
    ``L`` decode-attention launches a forward); a decode tick at the
    phase-3 lengths against its byte floor, with a profiled tick's idle
    share; starcoder2 also with int8 weights (quantized on the card, the
    bf16 weights dropped as they go) and int8 KV (B1 int8, B2q)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant import QuantizedTensor
    cfg = get_config(arch)
    bundle = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size()
                    for t in params.values()) / 1e9
    per_fwd = 7 * cfg.num_layers + 1
    zero = {k: 0 for k in llm_counts()}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in SERVE_PROMPTS]
    out = dict(arch=arch, layers=cfg.num_layers, weight_gb=weight_gb,
               init_s=init_s, group=cfg.num_heads // cfg.num_kv_heads)
    print(f"[7c] {arch} full width ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}: a group of {out['group']}, d_ff "
          f"{cfg.d_ff}): {weight_gb:.2f} GB bf16 weights drawn on the card "
          f"in {init_s:.2f} s", flush=True)
    serve_counted(torch, bundle, params, "paged", [prompts[0][:20]], 2,
                  finite, reset_counts, llm_counts)       # warm-up

    def run(kind, prm, kv_dtype="bfloat16", int8=False):
        r = serve_counted(torch, bundle, prm, kind, prompts, 16, finite,
                          reset_counts, llm_counts, kv_dtype)
        attention = ("flash_decode" if kind == "slot" else
                     "flash_decode_paged_int8" if kv_dtype == "int8" else
                     "flash_decode_paged")
        r["expected_launches"] = dict(zero, **{
            "apr_matmul_int8w" if int8 else "apr_matmul":
                per_fwd * r["forwards"],
            attention: cfg.num_layers * r["forwards"]})
        check_served(f"phase 7c {arch} {kind} {kv_dtype}", r.pop("reqs"), 16,
                     r["launches"], r["expected_launches"])
        print(f"    {kind} engine{', int8 weights + int8 KV' if int8 else ''}"
              f": {r['forwards']} forwards in {r['wall_s']:.2f} s wall, "
              f"{r['ms_per_tick']:.3f} ms a decode "
              f"{'step' if kind == 'slot' else 'tick'}; launches "
              f"{r['launches']['apr_matmul_int8w' if int8 else 'apr_matmul']}"
              f" B1 + {r['launches'][attention]} {attention} (expected "
              f"{r['expected_launches']}); peak {r['peak_mem_gb']:.2f} GB",
              flush=True)
        return r

    out["paged"] = run("paged", params)
    out["tick"] = paged_tick(torch, bundle, params, cfg, rng, dev)
    out["slot"] = run("slot", params)
    same, total = tokens_equal(out["slot"]["outputs"],
                               out["paged"]["outputs"])
    out["slot_vs_paged"] = (same, total)
    print(f"    slot/paged greedy tokens {same}/{total}", flush=True)
    if same != total:
        fail(f"phase 7c {arch}: slot and paged tokens differ ({same}/"
             f"{total})")
    if arch == "starcoder2-15b":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = quantize_streaming(torch, bundle, params)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        int8_gb = sum(w.nbytes if isinstance(w, QuantizedTensor)
                      else w.numel() * w.element_size()
                      for w in params.values()) / 1e9
        print(f"    int8 weights: {int8_gb:.2f} GB, quantized on the card "
              f"in {quant_s:.2f} s (the bf16 weights dropped as they go)",
              flush=True)
        out["paged_int8"] = run("paged", params, kv_dtype="int8", int8=True)
        out["paged_int8"].update(weight_gb=int8_gb, quantize_s=quant_s)
        same, total = tokens_equal(out["paged_int8"]["outputs"],
                                   out["paged"]["outputs"])
        print(f"    information: int8 tokens equal to bf16's {same}/{total} "
              f"(random weights; int8 moves near-ties)", flush=True)
    del params
    torch.cuda.empty_cache()
    return out


#: phase 7c's whisper-large-v3 prefill: B rows of F frames (the published
#: 1500) and a prompt of T tokens, then decode ticks from its cache
WHISPER_B, WHISPER_T, WHISPER_TICKS = 2, 16, 8


def whisper_full(torch, seed: int, dev, finite, reset_counts, llm_counts,
                 check_served) -> dict:
    """Phase 7c for whisper-large-v3 at full size (32 encoder and 32
    decoder layers, published widths; random bf16 weights from ``seed``):
    ``bundle.prefill`` over :data:`WHISPER_B` rows of random stub frames
    (the published 1500 a row) and a :data:`WHISPER_T`-token prompt (B1
    under every projection, 513 launches: the encoder's 6 a layer, the
    decoder's 10 and the head), its time (CUDA events); then
    :data:`WHISPER_TICKS` greedy decode ticks from that cache (257 B1 and
    32 B3 a tick: self-attention at G = 1, D = 64; the cross-attention over
    the 1500 frames plain, as in the JAX model); then phase 4's requests
    on the slot engine, which decodes against the zero cross K/V of its
    cache as the JAX engine does (no frames reach it), launches gated, and
    a 4-slot decode tick at the phase-3 lengths against its byte floor
    (the decoder's and the head's weights, the cross K/V and the live
    self K/V read once).  The prefill also runs with every B1 launch
    pinned to the 16 x 64 x 64 tile (:func:`narrow_cache`), timed in the
    same way, its logits and cache gated bit-equal to the default run's
    (whose projections over the frames run on wide tiles); one more of
    each is profiled (device-busy time, B1's part, the idle share)."""
    from repro_torch.bench import scoped_cache
    from repro_torch.configs import get_config
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.models import build_model
    cfg = get_config("whisper-large-v3")
    bundle = build_model(cfg, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = bundle.init_params(gen)
    weight_gb = sum(t.numel() * t.element_size()
                    for t in params.values()) / 1e9
    L, le = cfg.num_layers, cfg.encoder_layers
    prefill_b1 = 6 * le + 10 * L + 1
    tick_b1 = 8 * L + 1
    zero = {k: 0 for k in llm_counts()}
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (WHISPER_B, WHISPER_T))).to(dev)
    frames = torch.randn((WHISPER_B, cfg.encoder_frames, cfg.d_model),
                         generator=gen, device=dev).to(torch.bfloat16)
    out = dict(arch=cfg.name, layers=L, encoder_layers=le,
               weight_gb=weight_gb, B=WHISPER_B, frames=cfg.encoder_frames,
               prompt=WHISPER_T)
    max_seq = WHISPER_T + MAX_SEQ_PAD

    def prefill(name):
        bundle.prefill(params, tokens, max_seq, frames=frames)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        t0 = time.perf_counter()
        start.record()
        res = bundle.prefill(params, tokens, max_seq, frames=frames)
        end.record()
        torch.cuda.synchronize()
        out[name] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                         event_ms=start.elapsed_time(end),
                         launches=llm_counts(),
                         wide_launches=apr_matmul.wide_launches,
                         expected_launches=dict(zero, apr_matmul=prefill_b1))
        return res

    with scoped_cache(narrow_cache()):
        last_n, cache_n = prefill("prefill_narrow")
    last, cache = prefill("prefill")
    same = torch.equal(last, last_n) and all(
        torch.equal(cache[key], cache_n[key]) for key in cache)
    out["narrow_bit_equal"] = same
    del last_n, cache_n

    # where each prefill's time goes: the device's busy time and B1's share
    # of it in one profiled prefill, against the prefill's CUDA-event time
    def profiled(name):
        by_kernel = profile_device(torch, lambda: bundle.prefill(
            params, tokens, max_seq, frames=frames), 1)
        if by_kernel:
            busy = sum(by_kernel.values())
            out[name]["profile"] = dict(
                device_busy_ms=busy,
                b1_ms=sum(t for k, t in by_kernel.items()
                          if "apr_matmul_kernel" in k or "wide_kernel" in k),
                wide_ms=sum(t for k, t in by_kernel.items()
                            if "wide_kernel" in k),
                idle_share=1 - busy / out[name]["event_ms"],
                top_kernels_ms=dict(sorted(by_kernel.items(),
                                           key=lambda kv_: -kv_[1])[:6]))
    with scoped_cache(narrow_cache()):
        profiled("prefill_narrow")
    profiled("prefill")
    expect = out["prefill"]["expected_launches"]
    # over the frames: the encoder's 6 projections a layer, the decoder's
    # cross K and V
    wide = (out["prefill"]["wide_launches"],
            out["prefill_narrow"]["wide_launches"])
    if not same or wide != (6 * le + 2 * L, 0) or out["prefill_narrow"][
            "launches"] != expect:
        fail(f"phase 7c whisper-large-v3 prefill with the 16 x 64 x 64 "
             f"tile pinned: bit-equal {same}, wide launches {wide} "
             f"(expected ({6 * le + 2 * L}, 0)), launches "
             f"{out['prefill_narrow']['launches']}")
    if out["prefill"]["launches"] != expect or not bool(
            torch.isfinite(last).all()) or last.shape != (
            WHISPER_B, 1, cfg.padded_vocab):
        fail(f"phase 7c whisper-large-v3 prefill: launches "
             f"{out['prefill']['launches']} (expected {expect}), logits "
             f"{tuple(last.shape)} finite {bool(torch.isfinite(last).all())}")
    finite.clear()
    reset_counts()
    nxt = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    lengths = torch.full((WHISPER_B,), WHISPER_T, dtype=torch.int32,
                         device=dev)
    generated, tick_ms = [], []
    for _ in range(WHISPER_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = bundle.decode_step(params, cache, nxt, lengths)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(bool(torch.isfinite(logits).all()))
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        generated.append(nxt[:, 0].tolist())
        lengths = lengths + 1
    launches = llm_counts()
    expect = dict(zero, apr_matmul=tick_b1 * WHISPER_TICKS,
                  flash_decode=L * WHISPER_TICKS)
    out["decode_from_prefill"] = dict(
        ticks=WHISPER_TICKS, tokens=generated,
        ms_per_tick=float(np.mean(tick_ms)), launches=launches,
        expected_launches=expect)
    if not all(finite) or launches != expect:
        fail(f"phase 7c whisper-large-v3: decode from the prefilled cache: "
             f"finite {all(finite)}, launches {launches} != {expect}")
    cross_gb = cache["cross_k"].numel() * 2 * 2 / 1e9
    del cache, last
    print(f"[7c] whisper-large-v3 full size ({le} + {L} layers, "
          f"{weight_gb:.2f} GB bf16): prefill of {cfg.encoder_frames} "
          f"frames and {WHISPER_T} tokens at B={WHISPER_B} "
          f"{out['prefill']['wall_ms']:.2f} ms wall, "
          f"{out['prefill']['event_ms']:.2f} ms CUDA events, {prefill_b1} "
          f"apr_matmul launches, {out['prefill']['wide_launches']} on wide "
          f"tiles (16 x 64 x 64 pinned: "
          f"{out['prefill_narrow']['event_ms']:.2f} ms, bit-equal {same}; "
          f"cross K/V {cross_gb:.3f} GB); "
          f"{WHISPER_TICKS} decode ticks from its cache "
          f"{np.mean(tick_ms):.3f} ms a tick ({tick_b1} apr_matmul + {L} "
          f"flash_decode each), tokens {generated}", flush=True)
    for name in ("prefill", "prefill_narrow"):
        if "profile" in out[name]:
            p = out[name]["profile"]
            print(f"    profiled {name}: device busy {p['device_busy_ms']:.2f} "
                  f"ms of {out[name]['event_ms']:.2f} ms events (idle share "
                  f"{p['idle_share']:.1%}), B1 {p['b1_ms']:.2f} ms (wide "
                  f"tiles {p['wide_ms']:.2f})", flush=True)
            for kname, t in p["top_kernels_ms"].items():
                print(f"      {t:8.3f} ms  {kname[:90]}")
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in SERVE_PROMPTS]
    r = serve_counted(torch, bundle, params, "slot", prompts, 16, finite,
                      reset_counts, llm_counts)
    r["expected_launches"] = dict(zero, apr_matmul=tick_b1 * r["forwards"],
                                  flash_decode=L * r["forwards"])
    check_served("phase 7c whisper-large-v3 slot", r.pop("reqs"), 16,
                 r["launches"], r["expected_launches"])
    out["slot"] = r
    print(f"    slot engine: {r['forwards']} forwards in {r['wall_s']:.2f} s "
          f"wall, {r['ms_per_tick']:.3f} ms a decode step; launches "
          f"{r['launches']['apr_matmul']} apr_matmul + "
          f"{r['launches']['flash_decode']} flash_decode; peak "
          f"{r['peak_mem_gb']:.2f} GB", flush=True)
    # a 4-slot tick at the phase-3 lengths, its byte floor: the decoder's
    # and the head's weights, the cross K/V and the live self K/V
    slots = 4
    cache = bundle.init_cache(slots, 256)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(1, cfg.vocab_size, (slots, 1)).astype(np.int32),
        np.asarray(MAIN_LENGTHS, np.int32))]
    step = lambda: bundle.decode_step(params, cache, *args)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    weights = sum(t.numel() * t.element_size() for k, t in params.items()
                  if k.startswith("dec.") or k in ("lm_head", "final_norm"))
    kv = slots * L * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2 * (
        cfg.encoder_frames + sum(MAIN_LENGTHS) / slots + 1)
    tick = dict(wall_ms=wall, floor_gb=(weights + kv) / 1e9,
                floor_ms=(weights + kv) / HBM_BYTES_PER_S * 1e3)
    by_kernel = profile_device(torch, step, 5)
    if by_kernel:
        busy = sum(by_kernel.values())
        tick.update(device_busy_ms=busy, idle_share=1 - busy / wall,
                    top_kernels_ms=dict(sorted(by_kernel.items(),
                                               key=lambda kv_: -kv_[1])[:6]))
    out["tick"] = tick
    print(f"    decode tick at lengths {MAIN_LENGTHS} (4 slots, the cross "
          f"K/V of 1500 frames): wall {wall:.3f} ms, byte floor "
          f"{tick['floor_gb']:.3f} GB = {tick['floor_ms']:.3f} ms"
          + (f", device busy {tick['device_busy_ms']:.3f} ms (profiler), "
             f"idle share {tick['idle_share']:.1%}" if by_kernel else ""),
          flush=True)
    for name, t in tick.get("top_kernels_ms", {}).items():
        print(f"      {t:8.3f} ms  {name[:90]}")
    del cache, params
    torch.cuda.empty_cache()
    return out


# ------------------------------- the dense whole-sequence entry points
#: phase 4d's batch: B rows of T tokens (B x T = PREFILL_M), the prefilled
#: cache MAX_SEQ_PAD longer than T, and the decode ticks run from it
DENSE_B, DENSE_T, MAX_SEQ_PAD, DENSE_TICKS = 2, 512, 16, 8
#: positions of the prefilled cache held (printed) against the cache that
#: ``lm_decode_step`` builds token by token
DENSE_KV_CHECK = 64


def narrow_cache():
    """A :class:`~repro_torch.bench.ConfigCache` that pins every bf16
    launch of B1 and B7m (APR residency, bf16 weight) to the 16 x 64 x 64
    tile at the default split count, for ``scoped_cache``: a whole path on
    the tile the decode tick runs, to hold the wide tiles' bits to."""
    from repro_torch.bench import BlockConfig, ConfigCache
    from repro_torch.kernels.apr_matmul import ops as mm

    class Narrow(ConfigCache):
        def lookup(self, kernel, shape_key, dtype, backend):
            if (kernel in (mm.KERNEL_NAME, mm.FUSED_KERNEL_NAME)
                    and dtype == "bfloat16" and "_reshbm" not in shape_key
                    and "_wint8" not in shape_key):
                bm, bn, bk = mm.DEFAULT_TILE
                return BlockConfig.make(block_m=bm, block_n=bn, block_k=bk)
            return None
    return Narrow(Path(tempfile.mkdtemp(prefix="narrow_")) / "pin.json",
                  autosave=False)


def dense_whole_sequence(torch, bundle, params, rng, finite, reset_counts,
                         llm_counts, expected_counts) -> dict:
    """Phase 4d: full-width llama3-8b (``bundle`` and ``params`` of phase
    4) through ``bundle.forward`` and ``bundle.prefill(max_seq=T + 16)`` at
    B = 2, T = 512, every projection on B1 at M = B x T: wall and CUDA-event
    ms, peak memory, and the launches, which must be the 225 B1 launches
    of one forward each (32 layers x 7 + the lm_head, from the code).  For
    information: prefill's logits against forward's last row, and the
    first :data:`DENSE_KV_CHECK` positions of prefill's K/V against the
    cache ``decode_step`` builds token by token: layer 0's are the same
    bits (B1's split count follows K and N alone, so a row's bits do not
    depend on M), deeper layers differ by the attention before them (the
    whole-sequence path's plain score products against B3).  Gate: finite
    logits of the shapes expected, the launch counts (every projection at
    M = B x T on a wide tile: all 225 of the forward, the prefill's but its
    last-row head), and :data:`DENSE_TICKS` greedy decode ticks that run
    from the prefilled cache (B1 and B3 launches as the path demands).
    Then both again with every B1 launch pinned to the 16 x 64 x 64 tile
    (:func:`narrow_cache`): logits and the prefilled cache bit-equal to the
    default run's."""
    from repro_torch.bench import scoped_cache
    from repro_torch.kernels.apr_matmul import apr_matmul
    cfg = bundle.cfg
    per_call = 7 * cfg.num_layers + 1
    dev = bundle.device
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (DENSE_B, DENSE_T))).to(dev)
    out = dict(B=DENSE_B, T=DENSE_T, max_seq=DENSE_T + MAX_SEQ_PAD)

    def run(name, fn):
        """One warm call, then one counted and timed call: the result and
        its launches, wall ms (host clock to a synchronize), CUDA-event ms
        and peak memory."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                         event_ms=start.elapsed_time(end),
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                         launches=llm_counts(),
                         wide_launches=apr_matmul.wide_launches,
                         expected_launches=expected_counts(
                             apr_matmul=per_call))
        if out[name]["launches"] != out[name]["expected_launches"]:
            fail(f"phase 4d {name}: kernel launches {out[name]['launches']}"
                 f" != expected {out[name]['expected_launches']}")
        return res

    logits = run("forward", lambda: bundle.forward(params, tokens))
    last, cache = run("prefill", lambda: bundle.prefill(
        params, tokens, max_seq=DENSE_T + MAX_SEQ_PAD))
    with scoped_cache(narrow_cache()):
        same = dict(logits=torch.equal(logits, run(
            "forward_narrow", lambda: bundle.forward(params, tokens))))
        last_n, cache_n = run("prefill_narrow", lambda: bundle.prefill(
            params, tokens, max_seq=DENSE_T + MAX_SEQ_PAD))
    same["prefill_logits"] = torch.equal(last, last_n)
    same["prefill_cache"] = all(torch.equal(cache[key], cache_n[key])
                                for key in cache)
    del last_n, cache_n
    out["narrow_bit_equal"] = same
    wide = {name: out[name]["wide_launches"] for name in (
        "forward", "prefill", "forward_narrow", "prefill_narrow")}
    if wide != dict(forward=per_call, prefill=per_call - 1,
                    forward_narrow=0, prefill_narrow=0):
        fail(f"phase 4d: wide-tile launches {wide}: expected every "
             f"projection at M = {DENSE_B * DENSE_T} wide, none pinned")
    if not all(same.values()):
        fail(f"phase 4d: with the 16 x 64 x 64 tile pinned, logits and the "
             f"prefilled cache are not the default run's bits: {same}")
    # where a forward's time goes: the device's busy time (profiler)
    # against the forward's CUDA-event time
    by_kernel = profile_device(torch, lambda: bundle.forward(params, tokens),
                               1)
    if by_kernel:
        busy = sum(by_kernel.values())
        out["forward_profile"] = dict(
            device_busy_ms=busy,
            wide_ms=sum(t for k, t in by_kernel.items() if "wide_kernel" in k),
            idle_share=1 - busy / out["forward"]["event_ms"],
            top_kernels_ms=dict(sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1])[:6]))
    v = cfg.padded_vocab
    if (logits.shape != (DENSE_B, DENSE_T, v) or last.shape != (DENSE_B, 1, v)
            or not bool(torch.isfinite(logits).all())
            or not bool(torch.isfinite(last).all())):
        fail(f"phase 4d: logits {tuple(logits.shape)} / {tuple(last.shape)} "
             f"not finite of shape ({DENSE_B}, {DENSE_T} or 1, {v})")
    live = slice(0, cfg.vocab_size)
    out["prefill_vs_forward_last"] = dict(
        max_abs_diff=float((last[:, 0, live].float()
                            - logits[:, -1, live].float()).abs().max()),
        argmax_equal=bool(torch.equal(last[:, 0].argmax(-1),
                                      logits[:, -1].argmax(-1))))
    del logits
    # the first positions again, token by token through the decode path
    steps = bundle.init_cache(DENSE_B, DENSE_KV_CHECK)
    for t in range(DENSE_KV_CHECK):
        bundle.decode_step(params, steps, tokens[:, t:t + 1], torch.full(
            (DENSE_B,), t, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    kv = {}
    for name in ("k", "v"):
        a = cache[name][:, :, :, :DENSE_KV_CHECK].float()
        b = steps[name].float()
        kv[name] = dict(max_abs_diff=float((a - b).abs().max()),
                        values_differ=int((a != b).sum()),
                        values=a.numel(),
                        layer0_equal=bool(torch.equal(a[0], b[0])))
    out["prefill_kv_vs_decode_steps"] = kv
    del steps
    # greedy decode ticks from the prefilled cache
    finite.clear()
    reset_counts()
    nxt = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    lengths = torch.full((DENSE_B,), DENSE_T, dtype=torch.int32, device=dev)
    generated, tick_ms = [], []
    for _ in range(DENSE_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_logits = bundle.decode_step(params, cache, nxt, lengths)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        finite.append(bool(torch.isfinite(step_logits).all()))
        nxt = step_logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        generated.append(nxt[:, 0].tolist())
        lengths = lengths + 1
    launches = llm_counts()
    expect = expected_counts(apr_matmul=per_call * DENSE_TICKS,
                             flash_decode=cfg.num_layers * DENSE_TICKS)
    out["decode_from_prefill"] = dict(
        ticks=DENSE_TICKS, tokens=generated, ms_per_tick=float(
            np.mean(tick_ms)), launches=launches, expected_launches=expect)
    if not all(finite) or launches != expect:
        fail(f"phase 4d: decode from the prefilled cache: finite "
             f"{all(finite)}, launches {launches} != expected {expect}")
    del cache, last
    torch.cuda.empty_cache()
    f, p = out["forward"], out["prefill"]
    print(f"[4d] full-width {cfg.name} whole sequence, B={DENSE_B} "
          f"T={DENSE_T} (B1 at M={DENSE_B * DENSE_T}): forward "
          f"{f['wall_ms']:.2f} ms wall, {f['event_ms']:.2f} ms CUDA events, "
          f"peak {f['peak_mem_gb']:.2f} GB; prefill (max_seq "
          f"{out['max_seq']}) {p['wall_ms']:.2f} ms wall, "
          f"{p['event_ms']:.2f} ms CUDA events, peak "
          f"{p['peak_mem_gb']:.2f} GB; launches each {f['launches']['apr_matmul']} "
          f"apr_matmul (expected {per_call}), no other kernel; on wide "
          f"tiles {f['wide_launches']} and {p['wide_launches']}")
    fn, pn = out["forward_narrow"], out["prefill_narrow"]
    print(f"    the 16 x 64 x 64 tile pinned: forward {fn['event_ms']:.2f} ms, "
          f"prefill {pn['event_ms']:.2f} ms CUDA events; bit-equal to the "
          f"wide run: {same}")
    if "forward_profile" in out:
        fp = out["forward_profile"]
        print(f"    a profiled forward: device busy {fp['device_busy_ms']:.2f} "
              f"ms ({fp['wide_ms']:.2f} in the wide body), idle share "
              f"{fp['idle_share']:.1%} of the unprofiled forward's events")
    pv = out["prefill_vs_forward_last"]
    print(f"    information: prefill's logits vs forward's last row max "
          f"|diff| {pv['max_abs_diff']:.4g}, argmax equal "
          f"{pv['argmax_equal']}; prefill's K/V at positions "
          f"< {DENSE_KV_CHECK} vs decode_step token by token: "
          + ", ".join(f"{n} max |diff| {r['max_abs_diff']:.4g} "
                      f"({r['values_differ']}/{r['values']} values differ, "
                      f"layer 0 bit-equal {r['layer0_equal']})"
                      for n, r in kv.items()))
    d = out["decode_from_prefill"]
    print(f"    {DENSE_TICKS} greedy decode ticks from the prefilled cache: "
          f"{d['ms_per_tick']:.3f} ms a tick, tokens {d['tokens']}, "
          f"launches {launches}")
    return out


# ------------------------------- a row's bits do not depend on the batch
#: phase 2's row-bits checks: the M of B1 (a lone row, the 4-slot tick, a
#: prefill chunk, a 4-slot verify step at spec_k = 4, 64 rows, the first
#: M of the wide tiles, phase 4d's forward) and the B of the decode
#: kernels (a paged prefill chunk's token, the 4-slot tick, the verify
#: step's 4 x 5 rows)
ROW_MS = (1, 4, 16, 20, 64, 128, 1024)
ROW_BS = (1, 4, 20)
#: (model, Hq, Hkv, D) of the decode geometries held across B
ROW_GEOMETRIES = (("llama3-8b", 32, 8, 128), ("zamba2-1.2b", 32, 32, 64),
                  ("arctic-480b", 56, 8, 128),
                  ("llama4-maverick-400b-a17b", 40, 8, 128),
                  ("internvl2-1b", 14, 2, 64), ("starcoder2-15b", 48, 4, 128),
                  ("chatglm3-6b", 32, 2, 128))
#: the folded T > 1 calls of phase 2, (T, the real tokens of each row): a
#: prefill chunk of 16 at B = 1, whole and the last one of a prompt, and
#: a 4-slot verify step at spec_k = 4 (20 rows), all real and ragged
ROW_FOLDS = ((16, (16,)), (16, (11,)), (5, (5, 5, 5, 5)), (5, (5, 3, 1, 0)))


def row_bits_checks(torch, gen, dev) -> tuple:
    """Phase 2: a row's bits do not depend on the batch.  B1 under its
    default configuration at every M of :data:`ROW_MS`, on llama3-8b's
    projections and lm_head, bf16 and fp32 operands: the M rows of each
    call bit-equal to the first M rows of the call at M = 1024.  B2 (bf16
    pools), B2q (int8 pools) and B3 under their default split count at
    every B of :data:`ROW_BS`, at llama3-8b's and zamba2's geometry (pages
    of 16, 16 a table; the slot cache at S = 256): each call's rows
    bit-equal to the first rows of the call at B = 20, and the B = 20
    call of B2 and B2q held to its plain version on the same inputs at
    phase 2's paged tolerances.  The folded T > 1 paged call
    (``layers.paged_attention_folded``: a prefill chunk's or a verify
    step's attention) at each of :data:`ROW_FOLDS`, bf16 and int8 pools:
    every real row bit-equal to a T = 1 call at the same length, and every
    row, padded ones included (each attends to the positions at or before
    its own, as on the CPU), held to the plain version.  B2 over pages and
    B3 over a contiguous cache of the same K/V give the same bits at their
    default splits at every geometry (a case each).  Returns (cases,
    info): info holds that comparison by geometry."""
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, paged_decode_attention_q_ref,
        paged_decode_attention_ref)
    from repro_torch.models.layers import paged_attention_folded
    from repro_torch.quant import quantize_channelwise

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def first_rows_equal(outs):
        ref = outs[max(outs)]
        diffs = [float((o.float() - ref[:n].float()).abs().max())
                 for n, o in outs.items()]
        return max(diffs), all(torch.equal(o, ref[:n])
                               for n, o in outs.items())

    cases, info = [], []
    m_max = max(ROW_MS)
    for dtype, name in ((torch.bfloat16, "apr_matmul"),
                        (torch.float32, "apr_matmul_f32")):
        for k, n in list(LLAMA_DECODE_SHAPES) + [LM_HEAD]:
            x = randn(m_max, k, dtype=dtype)
            w = randn(k, n, scale=k ** -0.5, dtype=dtype)
            outs = {m: apr_matmul(x[:m], w) for m in ROW_MS}
            torch.cuda.synchronize()
            err, ok = first_rows_equal(outs)
            cases.append((name, f"row bits across M={list(ROW_MS)} K={k} "
                          f"N={n} {str(dtype)[6:]} default config", err, ok))
            del x, w, outs
    b_max, ps, p_max = max(ROW_BS), 16, 16
    s_len = ps * p_max
    lengths = torch.tensor([(37 * i + 24) % s_len + 1 for i in range(b_max)],
                           dtype=torch.int32, device=dev)
    tables = torch.arange(1, 1 + b_max * p_max, dtype=torch.int32,
                          device=dev).reshape(b_max, p_max)
    for label, hq, hkv, d in ROW_GEOMETRIES:
        q = randn(b_max, hq, d)
        kp, vp = (randn(1 + b_max * p_max, ps, hkv, d) for _ in "kv")
        kq, vq = (quantize_channelwise(a.float(), axis=-1) for a in (kp, vp))
        pools = {"flash_decode_paged": (kp, vp, {}),
                 "flash_decode_paged_int8": (kq.q, vq.q, dict(
                     k_scales=kq.scale[..., 0].contiguous(),
                     v_scales=vq.scale[..., 0].contiguous()))}

        def plain(name, qq, lens, tabs):
            """The plain version of ``name`` over the pool on these rows."""
            kk, vv, sc = pools[name]
            if sc:
                return paged_decode_attention_q_ref(
                    qq, kk, vv, sc["k_scales"], sc["v_scales"], lens, tabs)
            return paged_decode_attention_ref(qq, kk, vv, lens, tabs)

        for name, (kk, vv, sc) in pools.items():
            outs = {b: flash_decode_paged(q[:b], kk, vv, lengths[:b],
                                          tables[:b], **sc) for b in ROW_BS}
            torch.cuda.synchronize()
            err, ok = first_rows_equal(outs)
            cases.append((name, f"row bits across B={list(ROW_BS)} {label} "
                          f"Hq={hq} Hkv={hkv} D={d} pages {p_max}x{ps} "
                          f"default splits", err, ok))
            err, ok = max_err(outs[b_max], plain(name, q, lengths, tables),
                              Q_ATOL if sc else ATOL)
            cases.append((name, f"B={b_max} {label} default splits vs plain",
                          err, ok))
            if name == "flash_decode_paged":
                paged_out = outs[b_max]
        # the slot engine's cache holding the same K/V as the pages
        k_c = kp[1:].reshape(b_max, s_len, hkv, d)
        v_c = vp[1:].reshape(b_max, s_len, hkv, d)
        outs = {b: flash_decode(q[:b], k_c[:b], v_c[:b], lengths[:b])
                for b in ROW_BS}
        torch.cuda.synchronize()
        err, ok = first_rows_equal(outs)
        cases.append(("flash_decode", f"row bits across B={list(ROW_BS)} "
                      f"{label} Hq={hq} Hkv={hkv} D={d} S={s_len} default "
                      f"splits", err, ok))
        info.append(dict(geometry=label, b2_equals_b3=bool(torch.equal(
            paged_out, outs[b_max])), max_abs_diff=float(
            (paged_out.float() - outs[b_max].float()).abs().max())))
        cases.append(("flash_decode", f"B={b_max} {label} B2 over pages = "
                      f"B3 over the same K/V, bits", info[-1]["max_abs_diff"],
                      info[-1]["b2_equals_b3"]))
        # a prefill chunk's or a verify step's attention, folded, against
        # its tokens one by one and against the plain version
        for t, real in ROW_FOLDS:
            b = len(real)
            lens0 = torch.clamp(lengths[:b], max=s_len - t)
            qt = randn(b, t, hq, d)
            rows = [(row, i) for row in range(b) for i in range(real[row])]
            q_all = qt.reshape(b * t, hq, d)
            lens_all = (lens0[:, None] + torch.arange(
                1, t + 1, device=dev)[None]).reshape(-1).to(torch.int32)
            tabs_all = tables[:b].repeat_interleave(t, dim=0)
            for name, (kk, vv, sc) in pools.items():
                folded = paged_attention_folded(qt, kk, vv, lens0,
                                                tables[:b], **sc)
                got = torch.stack([folded[row, i] for row, i in rows])
                one_rows = {}
                for i in range(t):
                    one = paged_attention_folded(
                        qt[:, i:i + 1], kk, vv, lens0 + i, tables[:b], **sc)
                    for row in range(b):
                        if i < real[row]:
                            one_rows[row, i] = one[row, 0]
                by_token = torch.stack([one_rows[r] for r in rows])
                ref = plain(name, q_all, lens_all, tabs_all)
                torch.cuda.synchronize()
                err, ok = max_err(folded.reshape(b * t, -1),
                                  ref.reshape(b * t, -1),
                                  Q_ATOL if sc else ATOL)
                same = bool(torch.equal(got, by_token))
                cases.append((name, f"folded B={b} T={t} (real tokens "
                              f"{list(real)}) {label}: real rows bit-equal "
                              f"to T=1 calls {same}, all {b * t} rows "
                              f"(padded ones included) vs plain", err,
                              ok and same))
        del q, kp, vp, kq, vq, pools, k_c, v_c
    return cases, info


#: phase 4e's proposals a slot a verify step
SPEC_K = 4


class Replay:
    """A draft that proposes, for each request, the next tokens the plain
    engine emitted for it (``outputs[rid]``), as many as asked and as it
    has."""

    def __init__(self, outputs):
        self.outputs = outputs

    def admit(self, slot, req):
        pass

    def release(self, slot):
        pass

    def observe(self, slot, req, new_len):
        pass

    def propose(self, plan):
        return {slot: list(self.outputs[req.rid][len(req.output):
                                                  len(req.output) + k])
                for slot, req, k in plan}


class CorruptedDraft:
    """The oracle draft of phases 4e and 7: ``inner``'s proposals (a
    :class:`Replay` of the plain engine's tokens, or a ``ModelDraft`` of
    the target model itself) with the one at depth ``d`` replaced by
    another token, ``d`` going round 0..k over each request's verify
    steps.  If every verify row's greedy token is the plain engine's, a
    step accepts exactly ``min(d, len(proposals))``: so a request of 16
    new tokens accepts every count from 0 to k, every verify row emits,
    every state-ring depth is restored and a model draft rolls back after
    partial accepts.  ``steps`` holds each step's (accepted, expected),
    the accepted count read off the tokens the step emitted (one more;
    ``verify_plan`` keeps a step's proposals under the request's
    remaining tokens), when the engine observes the step or finishes the
    request in it."""

    def __init__(self, inner, vocab: int, k: int):
        self.inner, self.vocab, self.k = inner, vocab, k
        self.pending = {}          # slot -> (request, tokens, expected)
        self.steps = []

    def _settle(self, slot):
        req, before, want = self.pending.pop(slot)
        self.steps.append((len(req.output) - before - 1, want))

    def admit(self, slot, req):
        self.inner.admit(slot, req)

    def release(self, slot):
        if slot in self.pending:
            self._settle(slot)
        self.inner.release(slot)

    def observe(self, slot, req, new_len):
        self._settle(slot)
        self.inner.observe(slot, req, new_len)

    def propose(self, plan):
        out = self.inner.propose(plan)
        for slot, req, _ in plan:
            p = list(out.get(slot, []))
            d = req.spec_steps % (self.k + 1)
            if d < len(p):
                p[d] = (p[d] + 1) % self.vocab
            out[slot] = p
            self.pending[slot] = (req, len(req.output), min(d, len(p)))
        return out

    def check(self, tag: str) -> dict:
        """Fail unless every step accepted what it was expected to and the
        steps accepted every count from 0 to k; returns the counts."""
        wrong = [s for s in self.steps if s[0] != s[1]]
        seen = sorted({a for a, _ in self.steps})
        if wrong:
            fail(f"{tag}: {len(wrong)}/{len(self.steps)} verify steps "
                 f"accepted other than the plain engine's tokens allow "
                 f"(accepted, expected) {wrong[:8]}")
        if seen != list(range(self.k + 1)):
            fail(f"{tag}: verify steps accepted only {seen} of 0..{self.k}")
        return {str(a): sum(1 for s in self.steps if s[0] == a)
                for a in seen}


# ------------------- matmul families (B1 tiles, B4m, B6, B7m, B8) and tuning
#: the M of the llama3-8b projections: a decode tick over 4 slots, a
#: prefill chunk of 16
PROJ_MS = (4, 16)
#: ragged matmul shapes held at every tile: none a multiple of the tiles
RAGGED_MKN = [(m, k, n) for m in (1, 4, 5, 16) for k in (96, 4096, 14336)
              for n in (40, 1024, 14336)]
#: ragged shapes for the split counts: K not a multiple of 128 (nor of 8),
#: K shorter than splits x 128 (empty ranges), M past one 16-row block
SPLIT_RAGGED_MKN = [(5, 300, 1000), (3, 1000, 77), (17, 520, 200),
                    (1, 130, 64), (4, 4100, 1000)]
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


def tile_config(tile, splits=None):
    from repro_torch.bench import BlockConfig
    cfg = BlockConfig.make(block_m=tile[0], block_n=tile[1], block_k=tile[2])
    return cfg if splits is None else cfg.replace(splits=splits)


def qmm_family_checks(torch, qm, x, wq, ws, bias, out, note) -> None:
    """B6 and B8 on one (x, weight, out dtype) at every tile x split
    count, through ``note(name, err, ok)``: B6 and B8 none/relu (bias and
    none) bit-equal to the plain version, silu/gelu within ACT_ULPS fp32
    ulps of max(|plain|, |pre-activation|) (bf16 out: the bf16 tolerance)
    and bit-equal across tiles and split counts; each configuration
    launched twice for equal bits."""
    from repro_torch.kernels.quant_matmul.ref import (quant_matmul_fused_ref,
                                                      quant_matmul_ref)
    f32 = torch.float32
    qref = quant_matmul_ref(x, wq, ws, out)
    qfused = {}
    for act in ACTIVATIONS:
        for bb in (None, bias):
            qfused[(act, bb is None)] = (
                quant_matmul_fused_ref(x, wq, ws, bb, act, out),
                quant_matmul_fused_ref(x, wq, ws, bb, "none", f32),
                quant_matmul_fused_ref(x, wq, ws, bb, act, f32))
    first = {}
    for tile in qm.TILES:
        for n_split in qm.SPLITS:
            cfg = tile_config(tile, n_split)
            got = qm.quant_matmul(x, wq, ws, out_dtype=out, config=cfg)
            again = qm.quant_matmul(x, wq, ws, out_dtype=out, config=cfg)
            note("quant_matmul", max_err(got, qref)[0],
                 torch.equal(got, qref) and torch.equal(got, again))
            for key, (r, pre, r32) in qfused.items():
                act, nobias = key
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
                ok = ok and torch.equal(got, first.setdefault(key, got))
                note("quant_matmul_fused", err, ok)


def qmm_tie_and_launch_checks(torch, gen, dev) -> list:
    """B6 and B8 cases beyond the shapes: rows whose codes land on .5 ties
    (tests/test_torch_qmm.py's, bf16 and fp32) through an identity weight
    at every tile x split count, bit-equal to the plain version (every
    output is code x scale); and exactly one device kernel a call (the
    profiler's device events, and one count on the wrapper's counter) at
    the llama3-8b projection shapes and a ragged one, bf16 and fp32 x."""
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.kernels.quant_matmul.ref import (quant_matmul_fused_ref,
                                                      quant_matmul_ref)
    cases = []
    rows = torch.zeros((6, 16))
    rows[0, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                126.5])
    rows[1, :8] = torch.tensor([254.0, 1.0, 3.0, 5.0, -1.0, -3.0, -5.0,
                                253.0])
    rows[2, :8] = torch.tensor([-127.0, 63.5, -63.5, 64.5, -64.5, 0.5, 0.0,
                                -0.0])
    rows[4] = torch.linspace(0.0, 1.0, 16)
    rows[5] = -torch.linspace(0.25, 3.0, 16)
    eye = torch.eye(16, dtype=torch.int8, device=dev)
    one = torch.ones((1, 16), device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = rows.to(dev).to(dtype)
        ref = quant_matmul_ref(x, eye, one, torch.float32)
        ok = True
        for tile in qm.TILES:
            for n_split in qm.SPLITS:
                got = qm.quant_matmul(x, eye, one,
                                      config=tile_config(tile, n_split))
                ok = ok and torch.equal(got, ref)
        cases.append(("quant_matmul", f"tie rows {str(dtype)[6:]} x, identity "
                      f"weight, every tile x split count", 0.0, ok))
    for m, k, n in [(4, kk, nn) for kk, nn in LLAMA_DECODE_SHAPES] + [
            (5, 300, 1000)]:
        wq, ws = qm.quantize_weights(torch.randn((k, n), generator=gen,
                                                 device=dev))
        bias = torch.randn((n,), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            for name, fn, ref in (
                    ("quant_matmul",
                     lambda: qm.quant_matmul(x, wq, ws,
                                             out_dtype=torch.bfloat16),
                     lambda: quant_matmul_ref(x, wq, ws, torch.bfloat16)),
                    ("quant_matmul_fused",
                     lambda: qm.quant_matmul_fused(
                         x, wq, ws, bias, out_dtype=torch.bfloat16),
                     lambda: quant_matmul_fused_ref(
                         x, wq, ws, bias, "relu", torch.bfloat16))):
                counter = getattr(qm, name)
                before = counter.launches
                got = fn()
                torch.cuda.synchronize()
                launched = counter.launches - before
                one, text = one_kernel_a_call(torch, fn,
                                              "quant_matmul_kernel")
                ok = one and launched == 1 and torch.equal(got, ref())
                cases.append((name, f"M={m} K={k} N={n} {str(dtype)[6:]} x: "
                              f"{text}, {launched} launch(es) counted", 0.0,
                              ok))
    return cases


def matmul_family_correctness(torch, gen, dev) -> list:
    """Phase 2 for the matmul families, at the llama3-8b projection shapes
    and the ragged ones, at every tile each kernel compiles: B1 and B7m
    (every activation, bias and none, bf16 and fp32 out) at every tile x
    split count against the split plain version at the bf16 tolerance,
    each launched twice for equal bits and equal bits across the tiles at
    one split count; B4m equal to B1 at one split and the same tile bit
    for bit, in one launch a call; B6 and B8 (:func:`qmm_family_checks`)
    on a bf16 and an fp32 x at every tile x split count, none/relu bit for
    bit, silu/gelu within ACT_ULPS fp32 ulps (bf16 out: one bf16 ulp), the
    same bits across tiles and split counts and twice launched.  One case
    per (kernel, shape), its largest error over tiles, split counts and
    variants."""
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.kernels.apr_matmul.ref import (matmul_fused_split_ref,
                                                    matmul_split_ref)
    from repro_torch.kernels.quant_matmul import ops as qm
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    shapes = [(m, k, n) for m in PROJ_MS for k, n in LLAMA_DECODE_SHAPES]
    for m, k, n in shapes + RAGGED_MKN + SPLIT_RAGGED_MKN:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
             ).to(bf16)
        bias = torch.randn((n,), generator=gen, device=dev)
        xf, wf = x.float(), w.float()     # the plain versions widen alike
        wq, ws = qm.quantize_weights(wf)
        # B6/B8 also over an fp32 x of its own (not bf16-valued)
        x32 = torch.randn((m, k), generator=gen, device=dev) * 3
        stats = {name: [0.0, True, 0] for name in (
            "apr_matmul", "apr_matmul_hbm", "apr_matmul_fused",
            "quant_matmul", "quant_matmul_fused")}

        def note(name, err, ok):
            s = stats[name]
            s[0], s[1], s[2] = max(s[0], err), s[1] and ok, s[2] + 1

        def held(name, got, again, ref, first):
            """The bf16 tolerance, twice bit-equal, and bit-equal to the
            first tile's result at this split count."""
            err, ok = max_err(got, ref)
            note(name, err, ok and torch.equal(got, again)
                 and (first is None or torch.equal(got, first)))

        for out in (bf16, f32):
            for n_split in mm.SPLITS:
                ref = matmul_split_ref(xf, wf, n_split, out)
                fused = {(act, bb is None): matmul_fused_split_ref(
                    xf, wf, n_split, bb, act, out)
                    for act in ACTIVATIONS for bb in (None, bias)}
                first, first_fused = None, {}
                for tile in mm.TILES:
                    cfg = tile_config(tile, n_split)
                    b1 = mm.apr_matmul(x, w, out_dtype=out, config=cfg)
                    held("apr_matmul", b1,
                         mm.apr_matmul(x, w, out_dtype=out, config=cfg), ref,
                         first)
                    first = b1 if first is None else first
                    if n_split == 1:
                        # the baseline keeps B1's one-chain order, in one
                        # launch
                        before = mm.apr_matmul.hbm_launches
                        b4 = mm.apr_matmul(x, w, out_dtype=out, config=cfg,
                                           residency="hbm")
                        note("apr_matmul_hbm", max_err(b4, ref)[0],
                             torch.equal(b4, b1)
                             and mm.apr_matmul.hbm_launches - before == 1)
                    for key, r in fused.items():
                        act, nobias = key
                        bb = None if nobias else bias

                        def run():
                            return mm.apr_matmul_fused(
                                x, w, bb, activation=act, out_dtype=out,
                                config=cfg)
                        got = run()
                        held("apr_matmul_fused", got, run(), r,
                             first_fused.get(key))
                        first_fused.setdefault(key, got)
            for xq in (x, x32):
                qmm_family_checks(torch, qm, xq, wq, ws, bias, out, note)
        torch.cuda.synchronize()
        for name, (err, ok, n_var) in stats.items():
            cases.append((name, f"M={m} K={k} N={n} ({n_var} tile/split/"
                          f"variant runs)", err, ok))
        del x, x32, w, xf, wf, bias, wq, ws, fused
    return cases


def matmul_family_timing(torch, gen, dev, slots: int) -> list:
    """Phase 3 for B4m, B7m, B6 and B8 at the llama3-8b projection shapes
    (M = slots and 16), weights rotated past the 50 MB L2, output bf16,
    default tiles: B4m beside B1 (the paper's comparison at matmul level),
    B7m with bias + silu (also at each split count), B6, B8 with bias +
    silu.  The int8 rows include
    the activations' quantization (inside the kernel's launch; the plain
    ``quantize_activations`` is timed alone beside them, ``quantize_ms``),
    the split count the wrapper resolves and B6's time at each
    (``split_ms``); their library yardstick is that
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
                x, ws[i % nbuf], out_dtype=bf16, residency="hbm"), 20)
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
            rows.append(dict(
                kernel="apr_matmul_fused", M=m, K=k, N=n, ms=t_f,
                plain_ms=t_fp, library_ms=t_fl, epilogue="bias + silu",
                weight_buffers=nbuf,
                splits=mm.resolve_launch("apr_matmul_fused", m, k, n,
                                         "bfloat16", "cuda")[1],
                split_ms={s: cuda_ms(torch, lambda i: mm.apr_matmul_fused(
                    x, ws[i % nbuf], bias, activation="silu",
                    out_dtype=bf16, splits=s), 60) for s in mm.SPLITS},
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

            # the plain and library rows run ~10 PyTorch ops a call: the
            # stream is held busy 0.5 ms per call, longer than the host
            # takes to enqueue one
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
                             splits=qm.resolve_launch(
                                 "quant_matmul", m, k, n, "bfloat16",
                                 "cuda")[1],
                             split_ms={s: cuda_ms(
                                 torch, lambda i: qm.quant_matmul(
                                     x, *qs[i % nbuf], out_dtype=bf16,
                                     splits=s), 60) for s in qm.SPLITS},
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
                             splits=qm.resolve_launch(
                                 "quant_matmul_fused", m, k, n, "bfloat16",
                                 "cuda")[1],
                             **bound_ms(q_bytes + 4 * n, 2 * m * k * n,
                                        INT8_OPS_PER_S)))
            del qs, qcol, x, x_lib
    return rows


def tuning_shapes(engine) -> list:
    """Phase 8's (family, shape) list at full width: the paged engine's
    ``_decode_kernel_shapes()``, the four matmul families (and B4m and the
    int8-weight kernel) at the llama3-8b projection shapes, and every other
    registered family at the
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
                       ("apr_matmul", {**mkn, "w_int8": 1}),
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
        from repro_torch.quant import QuantizedTensor
        nbytes = sum(t.nbytes if isinstance(t, QuantizedTensor)
                     else t.numel() * t.element_size() for t in (*args, y)
                     if isinstance(t, (torch.Tensor, QuantizedTensor)))
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
    splits_before = dict(apr_matmul.split_launches)
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
    serve_splits = {s: n - splits_before.get(s, 0)
                    for s, n in apr_matmul.split_launches.items()
                    if n - splits_before.get(s, 0)}
    m = engine.metrics
    # the tile and split count every projection of the served forwards
    # resolves to under the engine's cache: M = slots at a decode tick, the
    # chunk at prefill
    expect_tiles, expect_splits = {}, {}
    with scoped_cache(engine.tune_cache):
        for rows_m, calls in ((slots, m.decode_calls),
                              (engine_kw["prefill_chunk"], m.prefill_calls)):
            for (k, n), cnt in list(LLAMA_DECODE_SHAPES.items()) + [
                    (LM_HEAD, 1 / cfg.num_layers)]:
                tile, n_split = apr_ops.resolve_launch(
                    "apr_matmul", rows_m, k, n, "bfloat16", dev.type)
                launches = int(round(cnt * cfg.num_layers * calls))
                expect_tiles[tile] = expect_tiles.get(tile, 0) + launches
                expect_splits[n_split] = (expect_splits.get(n_split, 0)
                                          + launches)
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
        serve_split_launches=serve_splits,
        expected_serve_split_launches=expect_splits,
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
          f"cache {tuning['expected_serve_tile_launches']}), by split count "
          f"{serve_splits} (expected {expect_splits}); greedy tokens "
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
    if serve_splits != expect_splits:
        fail(f"phase 8: served split counts {serve_splits} != tuned "
             f"{expect_splits}")
    check_served("phase 8", reqs, 16, serve_launches, expected_counts(
        apr_matmul=per_call * (m.decode_calls + m.prefill_calls),
        flash_decode_paged=cfg.num_layers * (m.decode_calls
                                             + m.prefill_calls)))
    # the fp32 operands' kernels (and an fp32 q's) serve no bf16 path:
    # phases 2 and 5 hold them (the fp32 baseline, phase 2 alone)
    unlaunched = [k for k, v in path_launches.items() if not v and k not in (
        "flash_decode_paged_f32", "apr_matmul_f32", "apr_matmul_fused_f32",
        "apr_matmul_hbm_f32",
        "apr_matmul_f32_int8w", "flash_decode_paged_f32q",
        "flash_decode_paged_int8_f32q", "flash_decode_f32q")]
    if unlaunched:
        fail(f"phase 8: no launch of {unlaunched} on the tuning path")
    bundle.decode_paged = forward
    del engine, reqs, bundle, params, exhaustive, pruned
    torch.cuda.empty_cache()
    return tuning


#: the llama3-8b decode-attention geometry (4 slots) and the layers whose
#: caches phase 3 rotates, so that each launch finds its cache cold
DECODE_GEOMETRY = dict(b=4, hq=32, hkv=8, d=128)
DECODE_LAYERS = 32
#: phase 3's geometries of groups wider than 8 (the 4-slot tick of
#: starcoder2-15b, 40 layers, and of chatglm3-6b, 28)
WIDE_TIMING = {"starcoder2-15b": (dict(b=4, hq=48, hkv=4, d=128), 40),
               "chatglm3-6b": (dict(b=4, hq=32, hkv=2, d=128), 28)}
#: phase 3's contiguous-cache shapes (S, lengths): the slot engine's cache
#: (max_seq 256) at the phase-4 lengths, and a long cache near full
DECODE_TIMING = ((256, (40, 96, 150, 196)), (4096, (3968, 4000, 4032, 4095)))
#: ``--kernel-sweep``: B3's time against its longest length
DECODE_SWEEP = DECODE_TIMING + tuple((4096, (n,) * 4)
                                     for n in (196, 512, 1024, 2048, 4096))


def decode_timing(torch, gen, dev, cases, kv_dtype=None,
                  q_dtype=None, geometry=None, layers=None) -> list:
    """B3 (``flash_decode``) at the llama3-8b geometry (or ``geometry``,
    rotating over ``layers`` caches), per (S, lengths) of
    ``cases``: ms per launch (caches rotated over 32 layers), the plain
    version, masked SDPA on the same inputs, and the byte bound (q and the
    output once, the live tokens' K and V once, the lengths); where the
    kernel takes a split count, also its time at each (``split_ms``) and
    the count the wrapper picks (``splits``).  q is bf16, or ``q_dtype``
    (fp32 over the bf16 cache: the rows are ``flash_decode_f32q``, SDPA
    runs in fp32); the cache is bf16, or ``kv_dtype`` (fp32: the rows are
    ``flash_decode_f32``, SDPA runs in fp32 and rounds its output to
    bf16)."""
    import torch.nn.functional as F
    from repro_torch.bench import BlockConfig
    from repro_torch.kernels.flash_decode import (decode_attention_ref,
                                                  flash_decode)
    from repro_torch.kernels.flash_decode import ops as fd
    geometry = geometry or DECODE_GEOMETRY
    b, hq, hkv, d = (geometry[k] for k in ("b", "hq", "hkv", "d"))
    layers = layers or DECODE_LAYERS
    kv_dtype = kv_dtype or torch.bfloat16
    q_dtype = q_dtype or torch.bfloat16
    name = ("flash_decode_f32" if kv_dtype == torch.float32
            else "flash_decode_f32q" if q_dtype == torch.float32
            else "flash_decode")
    kv_bytes = torch.finfo(kv_dtype).bits // 8
    q_bytes = torch.finfo(q_dtype).bits // 8
    rows = []
    for s_len, lengths in cases:
        def rnd(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        q = rnd(b, hq, d, dtype=q_dtype)
        kc = rnd(layers, b, s_len, hkv, d, dtype=kv_dtype)
        vc = rnd(layers, b, s_len, hkv, d, dtype=kv_dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        live = (torch.arange(s_len, device=dev)[None] < lens[:, None].long()
                )[:, None, None]
        t_k = cuda_ms(torch, lambda i: flash_decode(
            q, kc[i % layers], vc[i % layers], lens), 200)
        t_p = cuda_ms(torch, lambda i: decode_attention_ref(
            q, kc[i % layers], vc[i % layers], lens), 30)
        # SDPA in the wider of the two types
        wide = q_dtype if q_bytes > kv_bytes else kv_dtype
        t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q[:, :, None].to(wide),
            kc[i % layers].permute(0, 2, 1, 3).to(wide),
            vc[i % layers].permute(0, 2, 1, 3).to(wide), attn_mask=live,
            enable_gqa=True).to(q.dtype), 50)
        tokens = sum(lengths)
        row = dict(kernel=name, B=b, Hq=hq, Hkv=hkv, D=d, S=s_len,
                   lengths=list(lengths), ms=t_k, plain_ms=t_p,
                   library_ms=t_l,
                   **bound_ms(2 * b * hq * d * q_bytes
                              + tokens * hkv * d * 2 * kv_bytes + b * 4,
                              4 * tokens * hq * d))
        if hasattr(fd, "SPLITS"):
            try:
                row["splits"] = fd.resolve_splits(
                    b, hq, hkv, d, s_len, str(q.dtype)[6:], "cuda",
                    kv_bytes=kv_bytes)
            except TypeError:         # an older tree: one default for all
                row["splits"] = fd.default_splits(b, hkv, s_len)
            row["split_ms"] = {n: cuda_ms(torch, lambda i: flash_decode(
                q, kc[i % layers], vc[i % layers], lens,
                config=BlockConfig.make(chunk=32, splits=n)), 200)
                for n in fd.SPLITS}
        rows.append(row)
        del q, kc, vc
    torch.cuda.empty_cache()
    return rows


#: phase 2's paged cases (B, Hq, Hkv, D, ps, P_max, lengths): lengths 0, 1,
#: ps - 1, ps, ps + 1 and full, pages shuffled across the pool
PAGED_CASES = [(4, 32, 8, 128, 16, 16, [40, 96, 150, 196]),  # serving shape
               (4, 32, 8, 128, 16, 16, [0, 1, 16, 17]),
               (6, 32, 8, 128, 16, 16, [0, 1, 15, 16, 17, 256]),
               (3, 8, 2, 64, 8, 5, [33, 0, 7]),
               (2, 14, 2, 64, 16, 4, [64, 5]),                # group of 7
               (3, 8, 2, 64, 5, 10, [50, 0, 23]),             # pages of 5
               (2, 6, 2, 34, 4, 6, [17, 0]),                  # D % 4 != 0
               # zamba2-1.2b's shared attention: a group of 1, phase 7's
               # prompt lengths, then edges and a row 16 tokens on
               (4, 32, 32, 64, 16, 16, list(RECURRENT_PROMPTS[:4])),
               (4, 32, 32, 64, 16, 16, [0, 1, 16, 112]),
               # the moe and vlm families' geometries: arctic-480b (a
               # group of 7), llama4-maverick (5), internvl2-1b (7, D 64)
               (4, 56, 8, 128, 16, 16, [40, 96, 150, 196]),
               (4, 40, 8, 128, 16, 16, [0, 1, 16, 196]),
               (4, 14, 2, 64, 16, 16, [40, 96, 150, 256]),
               # groups wider than 8, in parts of 8 query heads: starcoder2
               # (12 over 4 kv heads), chatglm3 (16 over 2), and a group of
               # 12 over one head on pages of 5 and of 16 at D % 4 != 0
               (4, 48, 4, 128, 16, 16, [40, 96, 150, 196]),
               (4, 48, 4, 128, 16, 16, [0, 1, 16, 17]),
               (4, 32, 2, 128, 16, 16, [40, 96, 150, 196]),
               (6, 32, 2, 128, 16, 16, [0, 1, 15, 16, 17, 256]),
               (3, 12, 1, 128, 5, 10, [50, 0, 23]),
               (2, 16, 1, 34, 4, 6, [17, 0])]
#: phase 2's contiguous-cache cases (B, Hq, Hkv, D, S, lengths): rows of
#: length 0 (the mean of V over all S positions, as the JAX kernel gives
#: it), S not a multiple of the 32-token step, long caches, D % 4 != 0
B3_CASES = [(4, 32, 8, 128, 256, [40, 96, 150, 196]),     # serving shape
            (4, 32, 8, 128, 256, [0, 1, 33, 256]),
            (3, 8, 2, 64, 48, [33, 0, 7]),                # S not a chunk mult.
            (2, 14, 2, 64, 64, [64, 0]),                  # group of 7
            (6, 32, 8, 128, 4096, [0, 1, 33, 1000, 4095, 4096]),
            (2, 6, 2, 36, 40, [17, 0]),                   # D % 4 != 0
            # zamba2-1.2b's slot cache (max_seq 256), a group of 1
            (4, 32, 32, 64, 256, [24, 57, 96, 40]),
            (4, 32, 32, 64, 256, [0, 1, 33, 112]),
            # arctic-480b's, llama4-maverick's and internvl2-1b's slot
            # caches (max_seq 256)
            (4, 56, 8, 128, 256, [40, 96, 150, 196]),
            (4, 40, 8, 128, 256, [0, 1, 33, 256]),
            (4, 14, 2, 64, 256, [40, 96, 150, 196]),
            # starcoder2-15b's (12 over 4) and chatglm3-6b's (16 over 2)
            # slot caches, a long one, a group of 12 at D % 4 != 0, and
            # whisper-large-v3's decoder self-attention (20 heads of 64)
            (4, 48, 4, 128, 256, [40, 96, 150, 196]),
            (4, 32, 2, 128, 256, [0, 1, 33, 256]),
            (6, 48, 4, 128, 4096, [0, 1, 33, 1000, 4095, 4096]),
            (2, 12, 1, 36, 40, [17, 0]),
            (4, 20, 20, 64, 256, [16, 17, 40, 1])]
#: the lengths of phase 3's paged rows and of the profiled decode tick
MAIN_LENGTHS = [40, 96, 150, 196]


def paged_inputs(torch, gen, dev, b, hq, hkv, d, ps, p_max, lengths,
                 layers=1):
    """bf16 q (B, Hq, D) and ``layers`` pools (P, ps, Hkv, D) with each
    row's pages shuffled across the pool, int32 lengths, the block tables
    padded with the null page 0 as the engine pads them, and the same
    tables with that padding outside the pool (-1 and P + 99 in turn)."""
    need = [-(-n // ps) for n in lengths]
    p_pool = 1 + max(sum(need), 1) + 1
    rng = np.random.default_rng(sum(lengths) + b)
    perm = rng.permutation(np.arange(1, p_pool))
    tables = np.zeros((b, p_max), np.int32)
    dead = np.zeros((b, p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = dead[i, :n] = perm[at:at + n]
        dead[i, n:] = [-1 if j % 2 else p_pool + 99
                       for j in range(p_max - n)]
        at += n

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    return (rnd(b, hq, d), rnd(layers, p_pool, ps, hkv, d),
            rnd(layers, p_pool, ps, hkv, d),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.from_numpy(tables).to(dev), torch.from_numpy(dead).to(dev))


#: |decode kernel - plain| <= F32Q_RTOL * (|plain| + max |plain|) for an
#: fp32 q (an fp32-param model) over bf16 or int8 K/V: both widen (or
#: dequantize, code * scale) the cache values to fp32 exactly and work in
#: fp32 throughout, so they differ only in the order of the softmax sums
#: and in expf's last bits (about 1e-7 relative at these lengths)
F32Q_RTOL = 1e-5


def f32q_err(got, ref) -> tuple:
    """(max |got - ref|, whether every element is within the fp32-q
    tolerance and finite)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    scale = float(r.abs().max()) if r.numel() else 0.0
    ok = bool((diff <= F32Q_RTOL * (r.abs() + scale)).all()) and \
        bool(g.isfinite().all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def digest(torch, t) -> str:
    """The sha256 of a tensor's bytes: bits, compared across runs."""
    import hashlib
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def paged_correctness(torch, gen, dev, cases=None) -> tuple:
    """Phase 2 for B2 and B2q: every case of ``cases`` (:data:`PAGED_CASES`)
    over bf16
    pools, int8 pools with per-(slot, head) fp32 scales, and fp32 pools
    under a bf16 and an fp32 q, and bf16 and int8 pools under an fp32 q,
    at the split count the wrapper picks and at each one it takes, each
    launched twice on the same inputs (equal bits); rows of length 0
    exactly zero; and the same result, bit for bit, with the tables'
    padding outside the pool.  B2 and fp32 pools are held to the plain
    version at the bf16 tolerance; B2q to the plain version (bf16-rounded
    dequantize) within BF16_RTOL*|plain| + Q_ATOL and to the plain version
    on the fp32-dequantized pools at the bf16 tolerance; an fp32 q to the
    split plain version at its split count within the fp32 tolerance
    (F32Q_RTOL).  Returns (cases, twice-bit-equal flags, {case: digest of
    its output})."""
    from repro_torch.kernels.flash_decode import (
        flash_decode_paged, paged_decode_attention_q_ref,
        paged_decode_attention_ref, paged_decode_attention_split_ref)
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.quant import quantize_channelwise
    out, det, digests = [], [], {}
    for b, hq, hkv, d, ps, p_max, lengths in cases or PAGED_CASES:
        q, kp, vp, lens, tables, dead = paged_inputs(
            torch, gen, dev, b, hq, hkv, d, ps, p_max, lengths)
        kp, vp = kp[0], vp[0]
        zero_rows = [i for i, n in enumerate(lengths) if n == 0]
        kq, vq = (quantize_channelwise(t, axis=-1) for t in (kp, vp))
        ks, vs = kq.scale[..., 0], vq.scale[..., 0]
        int8 = dict(k_scales=ks, v_scales=vs)
        kinds = [("flash_decode_paged", q, kp, vp, {}),
                 ("flash_decode_paged_int8", q, kq.q, vq.q, int8),
                 ("flash_decode_paged_f32", q, kp.float(), vp.float(), {}),
                 ("flash_decode_paged_f32", q.float(), kp.float(),
                  vp.float(), {}),
                 ("flash_decode_paged_f32q", q.float(), kp, vp, {}),
                 ("flash_decode_paged_int8_f32q", q.float(), kq.q, vq.q,
                  int8)]
        for name, qq, kk, vv, sc in kinds:
            # an fp32 q is held to the split plain version (below)
            f32q = name.endswith("_f32q")
            if sc and not f32q:
                ref = paged_decode_attention_q_ref(qq, kk, vv, ks, vs, lens,
                                                   tables)
                ref32 = paged_decode_attention_ref(
                    qq.float(), kq.dequantize(torch.float32),
                    vq.dequantize(torch.float32), lens, tables).to(qq.dtype)
            elif not f32q:
                ref = paged_decode_attention_ref(qq, kk, vv, lens, tables)
            for n in (None,) + fd.SPLITS:
                cfg = None if n is None else fd.COMPILED.replace(splits=n)
                got = flash_decode_paged(qq, kk, vv, lens, tables, config=cfg,
                                         **sc)
                again = flash_decode_paged(qq, kk, vv, lens, tables,
                                           config=cfg, **sc)
                padded = flash_decode_paged(qq, kk, vv, lens, dead,
                                            config=cfg, **sc)
                torch.cuda.synchronize()
                det.append(torch.equal(got, again))
                extra = ""
                if f32q:
                    n_split = n or fd.resolve_paged_splits(
                        b, hq, hkv, d, p_max, ps, bool(sc), "float32",
                        "cuda", kv_bytes=kk.element_size())
                    err, ok = f32q_err(got, paged_decode_attention_split_ref(
                        qq, kk, vv, lens, tables, n_split, **sc))
                    extra = f" fp32 tolerance at {n_split} splits"
                else:
                    err, ok = max_err(got, ref, Q_ATOL if sc else ATOL)
                if sc and not f32q:
                    err32, ok32 = max_err(got, ref32)
                    ok = ok and ok32
                    extra = f" fp32-dequant err={err32:.3g}"
                ok = (ok and det[-1] and got.dtype == qq.dtype
                      and torch.equal(padded, got)
                      and all(not got[i].float().any() for i in zero_rows))
                label = (f"B={b} Hq={hq} Hkv={hkv} D={d} ps={ps} P_max="
                         f"{p_max} lengths={lengths} q {str(qq.dtype)[6:]} "
                         f"splits={n or 'default'}")
                digests[f"{name} {label}"] = digest(torch, got)
                out.append((name, f"{label} twice bit-equal={det[-1]}"
                            f"{extra}", err, ok))
        del q, kp, vp, kq, vq, ks, vs
    return out, det, digests


def contig_correctness(torch, gen, dev, cases=None) -> tuple:
    """Phase 2 for B3: every case of ``cases`` (:data:`B3_CASES`) over a
    bf16 and an fp32 cache under a bf16 q, and under an fp32 q over both,
    at the split count the wrapper picks and at each one it takes (splits
    past a row's walk are empty), each launched twice on the same inputs
    (equal bits): held to the plain version (the JAX oracle: a row of
    length 0 is the mean of V over all S positions) at the bf16 tolerance,
    an fp32 q over the bf16 cache (an fp32-param model on the slot engine)
    to the split plain version within the fp32 tolerance.  Returns (cases,
    twice-bit-equal flags, {case: digest of its output})."""
    from repro_torch.kernels.flash_decode import (
        decode_attention_ref, decode_attention_split_ref, flash_decode)
    from repro_torch.kernels.flash_decode import ops as fd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    out, det, digests = [], [], {}
    for b, hq, hkv, d, s_len, lengths in cases or B3_CASES:
        q = randn(b, hq, d)
        k_c, v_c = randn(b, s_len, hkv, d), randn(b, s_len, hkv, d)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for qq, kk, vv in ((q, k_c, v_c), (q, k_c.float(), v_c.float()),
                           (q.float(), k_c.float(), v_c.float()),
                           (q.float(), k_c, v_c)):
            ref = decode_attention_ref(qq, kk, vv, lens)
            f32q = qq.dtype == torch.float32 and kk.dtype == torch.bfloat16
            name = "flash_decode_f32q" if f32q else "flash_decode"
            for n in (None,) + fd.SPLITS:
                cfg_n = None if n is None else fd.COMPILED.replace(splits=n)
                got = flash_decode(qq, kk, vv, lens, config=cfg_n)
                again = flash_decode(qq, kk, vv, lens, config=cfg_n)
                torch.cuda.synchronize()
                if f32q:
                    err, ok = f32q_err(got, decode_attention_split_ref(
                        qq, kk, vv, lens, n or fd.resolve_splits(
                            b, hq, hkv, d, s_len, "float32", "cuda",
                            kv_bytes=2)))
                else:
                    err, ok = max_err(got, ref)
                det.append(torch.equal(got, again))
                ok = ok and got.dtype == qq.dtype and det[-1]
                label = (f"B={b} Hq={hq} Hkv={hkv} D={d} S={s_len} lengths="
                         f"{lengths} q {str(qq.dtype)[6:]} cache "
                         f"{str(kk.dtype)[6:]} splits={n or 'default'}")
                digests[f"{name} {label}"] = digest(torch, got)
                out.append((name, f"{label} twice bit-equal={det[-1]}", err,
                            ok))
        del q, k_c, v_c
    return out, det, digests


#: |apr_matmul_f32 - plain| <= F32_MM_SLACK * K * 2^-24 * (|x| @ |w| +
#: |bias|) + F32_MM_ULPS * 2^-24 * |plain| (+ BF16_RTOL * |plain| for bf16
#: out): the two sum the same K fp32 products in other orders, each within
#: K * 2^-24 * sum |x * w| of the exact sum; the activations' slope is at
#: most ~1.13 and expf / tanhf round apart by a few ulps
F32_MM_SLACK, F32_MM_ULPS = 2.5, 8


def f32_err(got, ref, bound) -> tuple:
    """(max |got - ref|, whether every element is within ``bound`` and
    finite)."""
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= bound).all()) and bool(got.isfinite().all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def matmul_f32_correctness(torch, gen, dev) -> list:
    """Phase 2 for the fp32 body (B1 and B7m on fp32 operands, and fp32
    activations over an int8 weight): at the llama3-8b projection shapes
    (M = 4 and 16), the ragged ones and a K of 0, fp32 and bf16 out, plain
    and fused with every activation, bias and none, at every fp32 tile x
    split count, against the split plain versions within the F32_MM_SLACK
    bound, each launched twice for equal bits and equal bits across the
    tiles at one split count; over the int8 weight bit for bit equal to the
    fp32 body on its fp32 dequantization at every tile and split count; the
    memory-resident baseline on fp32 operands (``residency="hbm"``) at
    every fp32 tile against :func:`matmul_ref` within the same bound, in
    one launch a call.  One case per (kernel, shape)."""
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.kernels.apr_matmul.ref import (matmul_fused_split_ref,
                                                    matmul_ref,
                                                    matmul_split_ref)
    from repro_torch.quant import quantize_channelwise
    f32 = torch.float32
    shapes = [(m, k, n) for m in PROJ_MS for k, n in LLAMA_DECODE_SHAPES]
    shapes += RAGGED_MKN + SPLIT_RAGGED_MKN + [(1, 8, 8), (16, 0, 64)]
    cases = []
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * max(k, 1) ** -0.5
        bias = torch.randn((n,), generator=gen, device=dev)
        sums = torch.matmul(x.abs(), w.abs())
        qt = quantize_channelwise(w) if k else None
        deq = qt.dequantize(f32) if k else None
        names = ("apr_matmul_f32", "apr_matmul_fused_f32",
                 "apr_matmul_f32_int8w", "apr_matmul_hbm_f32")
        stats = {name: [0.0, True, 0] for name in names}

        def note(name, err, ok):
            st = stats[name]
            st[:] = [max(st[0], err), st[1] and ok, st[2] + 1]

        for out in (f32, torch.bfloat16):
            rel = F32_MM_ULPS * 2.0 ** -24 + (BF16_RTOL if out != f32 else 0)
            ref = matmul_ref(x, w, out)
            for tile in mm.F32_TILES:
                before = mm.apr_matmul.hbm_f32_launches
                got = mm.apr_matmul(x, w, out_dtype=out, residency="hbm",
                                    config=tile_config(tile, 1))
                err, ok = f32_err(got, ref, F32_MM_SLACK * k * 2.0 ** -24
                                  * sums + rel * ref.float().abs())
                note("apr_matmul_hbm_f32", err, ok and got.dtype == out
                     and mm.apr_matmul.hbm_f32_launches - before == 1)
            for n_split in mm.SPLITS:
                ref = matmul_split_ref(x, w, n_split, out)
                fused = {(act, bb is None): matmul_fused_split_ref(
                    x, w, n_split, bb, act, out)
                    for act in ACTIVATIONS for bb in (None, bias)}
                first, first_fused = None, {}
                for tile in mm.F32_TILES:
                    cfg = tile_config(tile, n_split)
                    got = mm.apr_matmul(x, w, out_dtype=out, config=cfg)
                    again = mm.apr_matmul(x, w, out_dtype=out, config=cfg)
                    err, ok = f32_err(got, ref, F32_MM_SLACK * k * 2.0 ** -24
                                      * sums + rel * ref.float().abs())
                    note("apr_matmul_f32", err, ok and got.dtype == out
                         and torch.equal(got, again)
                         and (first is None or torch.equal(got, first)))
                    first = got if first is None else first
                    if qt is not None:
                        # the int8 weight: the fp32 body's bits on the fp32
                        # dequantized weight
                        q8 = mm.apr_matmul(x, qt, out_dtype=out, config=cfg)
                        on_deq = mm.apr_matmul(x, deq, out_dtype=out,
                                               config=cfg)
                        note("apr_matmul_f32_int8w", max_err(q8, on_deq)[0],
                             torch.equal(q8, on_deq) and q8.dtype == out)
                    for key, r in fused.items():
                        act, nobias = key
                        bb = None if nobias else bias
                        slack = sums if bb is None else sums + bb.abs()
                        got = mm.apr_matmul_fused(x, w, bb, activation=act,
                                                  out_dtype=out, config=cfg)
                        again = mm.apr_matmul_fused(x, w, bb, activation=act,
                                                    out_dtype=out, config=cfg)
                        err, ok = f32_err(got, r, F32_MM_SLACK * k
                                          * 2.0 ** -24 * slack
                                          + rel * r.float().abs())
                        note("apr_matmul_fused_f32", err, ok
                             and torch.equal(got, again)
                             and (key not in first_fused
                                  or torch.equal(got, first_fused[key])))
                        first_fused.setdefault(key, got)
        torch.cuda.synchronize()
        for name, (err, ok, runs) in stats.items():
            if runs:
                cases.append((name, f"M={m} K={k} N={n} ({runs} tile/split/"
                              f"variant runs, fp32/bf16 out)", err, ok))
        del x, w, bias, sums, qt, deq
    return cases


def paged_timing(torch, gen, dev, lengths=None, geometry=None,
                 layers=None) -> list:
    """B2 (``flash_decode_paged``) over bf16 pools, fp32 pools and int8
    pools (B2q) at the llama3-8b geometry (or ``geometry``, rotating over
    ``layers`` pools), pages of 16 in a 16-page table,
    at ``lengths`` (:data:`MAIN_LENGTHS`): ms per launch (pools rotated
    over 32 layers, bf16 q), the plain version, gather + SDPA on the same
    pools (fp32 SDPA for fp32 pools, the dequantized pools in bf16 for
    int8), and the byte bound (q and the output once, the live tokens' K
    and V (and scales) once, the lengths and tables); where the wrapper
    takes a split count, its time at each (``split_ms``) and the count it
    picks (``splits``); where the tree takes an fp32 q over bf16 and int8
    pools (an fp32-param model), those two too, beside fp32 SDPA on the
    gathered (dequantized) pools.  It uses only what every version of the
    port has, so a copy of this script times an older tree's kernels."""
    import torch.nn.functional as F
    from repro_torch.bench import BlockConfig
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  gather_pages,
                                                  paged_decode_attention_q_ref,
                                                  paged_decode_attention_ref)
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.quant import quantize_channelwise
    lengths = lengths or MAIN_LENGTHS
    geometry = geometry or DECODE_GEOMETRY
    b, hq, hkv, d = (geometry[k] for k in ("b", "hq", "hkv", "d"))
    ps, p_max, layers = 16, 16, layers or DECODE_LAYERS
    q, kp, vp, lens, tables, _ = paged_inputs(torch, gen, dev, b, hq, hkv, d,
                                              ps, p_max, lengths, layers)
    live = torch.arange(p_max * ps, device=dev)[None] < lens[:, None].long()
    tokens = sum(lengths)
    base = 2 * b * hq * d * 2 + b * (p_max + 1) * 4      # q, out, tables
    splits = getattr(fd, "resolve_paged_splits", None)

    def sdpa(kk, vv, qq=q):
        return F.scaled_dot_product_attention(
            qq[:, :, None].to(kk.dtype), kk.permute(0, 2, 1, 3),
            vv.permute(0, 2, 1, 3), attn_mask=live[:, None, None],
            enable_gqa=True).to(qq.dtype)

    def row(name, kpool, vpool, ref, library, kv_bytes, sc=None, qq=q):
        def kernel(i, cfg=None):
            kw = {} if sc is None else dict(k_scales=sc[0][i % layers],
                                            v_scales=sc[1][i % layers])
            if cfg is not None:
                kw["config"] = cfg
            return flash_decode_paged(qq, kpool[i % layers],
                                      vpool[i % layers], lens, tables, **kw)
        # q and the output in q's type
        q_bytes = 2 * b * hq * d * (qq.element_size() - 2)
        r = dict(kernel=name, B=b, Hq=hq, Hkv=hkv, D=d, ps=ps, P_max=p_max,
                 lengths=list(lengths), ms=cuda_ms(torch, kernel, 200),
                 plain_ms=cuda_ms(torch, ref, 50),
                 library_ms=cuda_ms(torch, library, 50),
                 **bound_ms(base + q_bytes + kv_bytes, 4 * tokens * hq * d))
        if splits is not None:
            r["splits"] = splits(b, hq, hkv, d, p_max, ps, sc is not None,
                                 str(qq.dtype)[6:], "cuda",
                                 kv_bytes=kpool.element_size())
            r["split_ms"] = {n: cuda_ms(torch, lambda i: kernel(
                i, BlockConfig.make(chunk=32, splits=n)), 200)
                for n in fd.SPLITS}
        return r

    rows = [row("flash_decode_paged", kp, vp,
                lambda i: paged_decode_attention_ref(
                    q, kp[i % layers], vp[i % layers], lens, tables),
                lambda i: sdpa(gather_pages(kp[i % layers], tables),
                               gather_pages(vp[i % layers], tables)),
                tokens * hkv * d * 2 * 2)]
    q32 = q.float()
    f32q = (torch.float32, torch.bfloat16) in fd.KERNEL_DTYPES[
        fd.PAGED_KERNEL_NAME]
    if f32q:
        rows.append(row("flash_decode_paged_f32q", kp, vp,
                        lambda i: paged_decode_attention_ref(
                            q32, kp[i % layers], vp[i % layers], lens,
                            tables),
                        lambda i: sdpa(
                            gather_pages(kp[i % layers], tables).float(),
                            gather_pages(vp[i % layers], tables).float(),
                            q32),
                        tokens * hkv * d * 2 * 2, qq=q32))
    k32, v32 = kp.float(), vp.float()
    rows.append(row("flash_decode_paged_f32", k32, v32,
                    lambda i: paged_decode_attention_ref(
                        q, k32[i % layers], v32[i % layers], lens, tables),
                    lambda i: sdpa(gather_pages(k32[i % layers], tables),
                                   gather_pages(v32[i % layers], tables)),
                    tokens * hkv * d * 2 * 4))
    del k32, v32
    kq, vq = (quantize_channelwise(t, axis=-1) for t in (kp, vp))
    ks, vs = kq.scale[..., 0], vq.scale[..., 0]
    del kp, vp

    def library_q(i):
        lay = i % layers
        kk, vv = ((gather_pages(c.q[lay], tables).float()
                   * gather_pages(sc[lay], tables)[..., None]
                   ).to(torch.bfloat16) for c, sc in ((kq, ks), (vq, vs)))
        return sdpa(kk, vv)

    rows.append(row("flash_decode_paged_int8", kq.q, vq.q,
                    lambda i: paged_decode_attention_q_ref(
                        q, kq.q[i % layers], vq.q[i % layers], ks[i % layers],
                        vs[i % layers], lens, tables),
                    library_q, tokens * hkv * (d + 4) * 2, sc=(ks, vs)))
    if f32q:
        def library_q32(i):
            lay = i % layers
            kk, vv = (gather_pages(c.q[lay], tables).float()
                      * gather_pages(sc[lay], tables)[..., None]
                      for c, sc in ((kq, ks), (vq, vs)))
            return sdpa(kk, vv, q32)

        rows.append(row("flash_decode_paged_int8_f32q", kq.q, vq.q,
                        lambda i: paged_decode_attention_q_ref(
                            q32, kq.q[i % layers], vq.q[i % layers],
                            ks[i % layers], vs[i % layers], lens, tables),
                        library_q32, tokens * hkv * (d + 4) * 2,
                        sc=(ks, vs), qq=q32))
    del kq, vq, ks, vs, q, q32
    torch.cuda.empty_cache()
    return rows


#: ``--kernel-sweep``: B2 at each split count over these (B, P_max,
#: lengths), pages of 16 and the llama3-8b heads: one to 16 slots, short
#: rows to a 4096-token table
PAGED_SWEEP = [(1, 16, [196]), (2, 16, [96, 196]), (4, 16, MAIN_LENGTHS),
               (8, 16, MAIN_LENGTHS * 2), (16, 16, [150] * 16),
               (4, 64, [1000, 700, 300, 1024]),
               (4, 256, [4000, 3000, 2000, 4096]), (1, 256, [4096])]
#: phase 3: B2 wider than the 4-slot reference batch, at each split count
#: (the default is the 4-slot count, 8 splits at bf16): a 4-slot verify
#: step at spec_k = 4 and a 64-slot decode tick
WIDE_BATCHES = [(20, 16, MAIN_LENGTHS * 5), (64, 16, MAIN_LENGTHS * 16)]


def paged_split_sweep(torch, gen, dev, cases=PAGED_SWEEP) -> list:
    """B2 over bf16, fp32 and int8 pools at each (B, P_max, lengths) of
    ``cases``: µs per launch at each split count (pools rotated over 8
    layers), and the count the wrapper picks.  Empty for a tree whose
    paged kernel takes no split count."""
    from repro_torch.bench import BlockConfig
    from repro_torch.kernels.flash_decode import flash_decode_paged
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.quant import quantize_channelwise
    if not hasattr(fd, "resolve_paged_splits"):
        return []
    hq, hkv, d, ps, layers = 32, 8, 128, 16, 8
    rows = []
    for b, p_max, lengths in cases:
        q, kp, vp, lens, tables, _ = paged_inputs(
            torch, gen, dev, b, hq, hkv, d, ps, p_max, lengths, layers)
        kq, vq = (quantize_channelwise(t, axis=-1) for t in (kp, vp))
        kinds = [("flash_decode_paged", kp, vp, None),
                 ("flash_decode_paged_f32", kp.float(), vp.float(), None),
                 ("flash_decode_paged_int8", kq.q, vq.q,
                  (kq.scale[..., 0], vq.scale[..., 0]))]
        for name, kk, vv, sc in kinds:
            def kernel(i, cfg):
                kw = {} if sc is None else dict(k_scales=sc[0][i % layers],
                                                v_scales=sc[1][i % layers])
                return flash_decode_paged(q, kk[i % layers], vv[i % layers],
                                          lens, tables, config=cfg, **kw)
            rows.append(dict(
                kernel=name, B=b, P_max=p_max, lengths=list(lengths),
                splits=fd.resolve_paged_splits(
                    b, hq, hkv, d, p_max, ps, sc is not None, "bfloat16",
                    "cuda", kv_bytes=kk.element_size()),
                split_us={n: 1e3 * cuda_ms(torch, lambda i: kernel(
                    i, BlockConfig.make(chunk=32, splits=n)), 200)
                    for n in fd.SPLITS}))
        del q, kp, vp, kq, vq, kinds
        torch.cuda.empty_cache()
    return rows


def projection_timing(torch, gen, dev, ms) -> list:
    """B1 (``apr_matmul``), its int8-weight operand and its fp32 operands
    (the fp32 body, over fp32 weights and, where the tree has it, over int8
    weights) at the llama3-8b projection shapes and the lm_head, M in
    ``ms``: ms per call with the weights rotated past the 50 MB L2 at the
    configuration the wrapper resolves, and where the kernel takes a split
    count its time at each (``split_ms``) and the count it resolves
    (``splits``); the plain version, ``torch.matmul`` (on the dequantized
    weight for int8, in fp32 for the fp32 body; TF32 off), and the bound
    (bytes, or the operations at the bf16 or fp32 peak).  The int8 rows
    name the tile the wrapper resolves (``tile``).  It uses only what
    every version of the port has where it times the default, so a copy of
    this script times an older tree's kernels."""
    from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.quant import quantize_channelwise
    bf16, f32 = torch.bfloat16, torch.float32
    splits = getattr(mm, "SPLITS", None)
    f32_int8 = (f32, torch.int8) in mm.KERNEL_DTYPES["apr_matmul"]
    rows = []

    def by_split(row, fn, iters):
        """The row's time at each split count and the count resolved."""
        if splits is not None:
            row["split_ms"] = {n: cuda_ms(torch, lambda i: fn(i, n), iters)
                               for n in splits}
        return row

    for m in ms:
        for k, n in list(LLAMA_DECODE_SHAPES) + [LM_HEAD]:
            nbuf = min(32, max(1, math.ceil(200e6 / (k * n * 2))))
            ws = [(torch.randn((k, n), generator=gen, device=dev)
                   * k ** -0.5).to(bf16) for _ in range(nbuf)]
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            iters = 20 if n > 100_000 else 60
            t_k = cuda_ms(torch, lambda i: apr_matmul(
                x, ws[i % nbuf], out_dtype=bf16), iters)
            t_p = cuda_ms(torch, lambda i: matmul_ref(
                x, ws[i % nbuf], bf16), iters)
            t_l = cuda_ms(torch, lambda i: torch.matmul(x, ws[i % nbuf]),
                          iters)
            row = dict(kernel="apr_matmul", M=m, K=k, N=n, ms=t_k,
                       plain_ms=t_p, library_ms=t_l, weight_buffers=nbuf,
                       **bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n))
            if splits is not None:
                row["splits"] = mm.resolve_launch("apr_matmul", m, k, n,
                                                  "bfloat16", "cuda")[1]
            rows.append(by_split(row, lambda i, s: apr_matmul(
                x, ws[i % nbuf], out_dtype=bf16, splits=s), iters))
            # the same weights as int8 codes + fp32 column scales; the
            # library yardstick multiplies by the dequantized bf16 weight
            qts = [quantize_channelwise(w.float()) for w in ws]
            deqs = [qt.dequantize(bf16) for qt in qts]
            del ws
            t_k = cuda_ms(torch, lambda i: apr_matmul(
                x, qts[i % nbuf], out_dtype=bf16), iters)
            t_p = cuda_ms(torch, lambda i: matmul_ref(
                x, qts[i % nbuf].dequantize(bf16), bf16), iters)
            t_l = cuda_ms(torch, lambda i: torch.matmul(x, deqs[i % nbuf]),
                          iters)
            row = dict(kernel="apr_matmul_int8w", M=m, K=k, N=n, ms=t_k,
                       plain_ms=t_p, library_ms=t_l, weight_buffers=nbuf,
                       **bound_ms(2 * m * k + k * n + 4 * n + 2 * m * n,
                                  2 * m * k * n))
            if hasattr(mm, "INT8W_TILES"):
                row["tile"] = mm.resolve_tile("apr_matmul", m, k, n,
                                              "bfloat16", "cuda", "apr",
                                              None, True)
            rows.append(row)
            del qts, deqs
            if hasattr(mm, "F32_CONFIG") or hasattr(mm, "F32_TILES"):
                nb32 = min(32, max(1, math.ceil(200e6 / (k * n * 4))))
                w32 = [torch.randn((k, n), generator=gen, device=dev)
                       * k ** -0.5 for _ in range(nb32)]
                x32 = x.float()
                t_k = cuda_ms(torch, lambda i: apr_matmul(
                    x32, w32[i % nb32], out_dtype=f32), iters)
                t_p = cuda_ms(torch, lambda i: matmul_ref(
                    x32, w32[i % nb32], f32), iters)
                t_l = cuda_ms(torch, lambda i: torch.matmul(
                    x32, w32[i % nb32]), iters)
                row = dict(kernel="apr_matmul_f32", M=m, K=k, N=n, ms=t_k,
                           plain_ms=t_p, library_ms=t_l, weight_buffers=nb32,
                           **bound_ms(4 * (m * k + k * n + m * n),
                                      2 * m * k * n, FP32_FLOPS_PER_S))
                if splits is not None:
                    row["splits"] = mm.resolve_f32("apr_matmul", m, k,
                                                   n)["splits"]
                rows.append(by_split(row, lambda i, s: apr_matmul(
                    x32, w32[i % nb32], out_dtype=f32, splits=s), iters))
                if f32_int8:
                    # fp32 activations over int8 codes; the library
                    # multiplies by the weight dequantized to fp32 ahead
                    q32 = [quantize_channelwise(w) for w in w32]
                    deq32 = [qt.dequantize(f32) for qt in q32]
                    del w32
                    t_k = cuda_ms(torch, lambda i: apr_matmul(
                        x32, q32[i % nb32], out_dtype=f32), iters)
                    t_p = cuda_ms(torch, lambda i: matmul_ref(
                        x32, q32[i % nb32].dequantize(f32), f32), iters)
                    t_l = cuda_ms(torch, lambda i: torch.matmul(
                        x32, deq32[i % nb32]), iters)
                    row = dict(kernel="apr_matmul_f32_int8w", M=m, K=k, N=n,
                               ms=t_k, plain_ms=t_p, library_ms=t_l,
                               weight_buffers=nb32,
                               splits=mm.resolve_f32("apr_matmul", m, k, n,
                                                     w_int8=True)["splits"],
                               **bound_ms(4 * m * k + k * n + 4 * n
                                          + 4 * m * n, 2 * m * k * n,
                                          FP32_FLOPS_PER_S))
                    rows.append(by_split(row, lambda i, s: apr_matmul(
                        x32, q32[i % nb32], out_dtype=f32, splits=s), iters))
                    del q32, deq32
                else:
                    del w32
                del x32
            del x
    torch.cuda.empty_cache()
    return rows


#: the M of phase 4d's whole-sequence forward: B = 2 rows of T = 512
PREFILL_M = 1024


#: whisper-large-v3's prefill: B1 over the frames of WHISPER_B rows (M =
#: 2 x 1500) at these (K, N), launches a prefill: the encoder's q, k, v, o
#: (4 a layer) and the decoder's cross K, V of the encoder output (2 a
#: layer) at (1280, 1280), the encoder's GELU MLP at the other two
WHISPER_PREFILL_SHAPES = {(1280, 1280): 4 * 32 + 2 * 32, (1280, 5120): 32,
                          (5120, 1280): 32}


def prefill_matmul_timing(torch, gen, dev, m: int = PREFILL_M,
                          shapes=None) -> list:
    """B1 at prefill M: by default the llama3-8b projection shapes and the
    lm_head at phase 4d's B x T rows; ms per call at the configuration the
    wrapper resolves (weights rotated past the 50 MB L2 where one is
    smaller than 200 MB), the plain version, ``torch.matmul`` on the same
    bf16 operands, and the bound, which at this M is the bf16 operations
    at the tensor cores' peak, not the bytes."""
    from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
    from repro_torch.kernels.apr_matmul import ops as mm
    bf16 = torch.bfloat16
    rows = []
    for k, n in shapes or list(LLAMA_DECODE_SHAPES) + [LM_HEAD]:
        nbuf = min(4, max(1, math.ceil(200e6 / (k * n * 2))))
        ws = [(torch.randn((k, n), generator=gen, device=dev)
               * k ** -0.5).to(bf16) for _ in range(nbuf)]
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        iters = 5 if n > 100_000 else 20
        t_k = cuda_ms(torch, lambda i: apr_matmul(
            x, ws[i % nbuf], out_dtype=bf16), iters, warmup=2)
        t_p = cuda_ms(torch, lambda i: matmul_ref(x, ws[i % nbuf], bf16), 2,
                      warmup=1)
        t_l = cuda_ms(torch, lambda i: torch.matmul(x, ws[i % nbuf]), iters,
                      warmup=2)
        tile, splits = mm.resolve_launch("apr_matmul", m, k, n, "bfloat16",
                                         "cuda")
        rows.append(dict(kernel="apr_matmul", M=m, K=k, N=n, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, weight_buffers=nbuf,
                         tile=tile, splits=splits,
                         **bound_ms(2 * (m * k + k * n + m * n),
                                    2 * m * k * n)))
        del ws, x
    torch.cuda.empty_cache()
    return rows


#: the wgmma probe's operands: random, sums that cancel to a small rest
#: (a large term and its negation on either side of small ones), products
#: of exponents from 2^-40 to 2^40 side by side, and products below
#: fp32's normal range (both factors near 2^-66) among normal ones
PROBE_KINDS = ("random", "cancelling", "mixed exponents",
               "subnormal products")
PROBE_KS = (64, 1024, 4096)


def probe_operands(torch, gen, dev, kind: str, k: int) -> tuple:
    """A (64, k) and B (k, 128), bf16, of the probe kind ``kind``."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def pow2(lo, hi, *shape):
        return torch.exp2(torch.randint(lo, hi + 1, shape, generator=gen,
                                        device=dev).float())
    a, b = randn(64, k), randn(k, 128)
    if kind == "cancelling":
        # k pairs (2i, 2i + 1): a large product and nearly its negation
        a = a * 2.0 ** 12
        a[:, 1::2] = -a[:, 0::2] * (1 + randn(64, k // 2) * 2.0 ** -6)
        b[1::2] = b[0::2]
        a[:, 3::8] = randn(64, k // 8) * 2.0 ** -4
    elif kind == "mixed exponents":
        a, b = a * pow2(-20, 20, 64, k), b * pow2(-20, 20, k, 128)
    elif kind == "subnormal products":
        tiny = torch.rand((64, k), generator=gen, device=dev) < 0.75
        a = torch.where(tiny, a * 2.0 ** -66, a * 2.0 ** -60)
        b = b * 2.0 ** -66
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def mma_probe(torch, gen, dev) -> dict:
    """The instruction probe: one ``wgmma.mma_async`` m64n128k16 chain over
    K (bf16 -> fp32, B transposed from shared memory,
    ``apr_matmul_wgmma_probe``) against the WMMA 16x16x16 chain of B1's
    16 x 64 x 64 body at one split, fp32 out, on the same operands
    (:data:`PROBE_KINDS` x :data:`PROBE_KS`): elements that differ in any
    bit, and the largest difference.  ``equal`` is what lets the wide body
    run wgmma and keep the 16 x 64 x 64 body's bits."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.kernels.apr_matmul import ops as mm
    lib = _build.load(mm.LIBRARY, mm.SIGNATURES)
    fn = lib.apr_matmul_wgmma_probe
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    cases = []
    for kind in PROBE_KINDS:
        for k in PROBE_KS:
            a, b = probe_operands(torch, gen, dev, kind, k)
            got = torch.empty((64, 128), dtype=torch.float32, device=dev)
            _build.check(lib, fn(a.data_ptr(), b.data_ptr(), got.data_ptr(),
                                 k, torch.cuda.current_stream().cuda_stream),
                         "apr_matmul_wgmma_probe")
            wmma = apr_matmul(a, b, out_dtype=torch.float32, block_m=16,
                              block_n=64, block_k=64, splits=1)
            torch.cuda.synchronize()
            same = (got.view(torch.int32) == wmma.view(torch.int32))
            cases.append(dict(kind=kind, K=k, elements=got.numel(),
                              differ=int((~same).sum()),
                              max_abs_diff=float((got - wmma).abs().max()),
                              finite=bool(got.isfinite().all()),
                              nonzero=int((wmma != 0).sum())))
    return dict(cases=cases, equal=all(c["differ"] == 0 for c in cases))


#: phase 2's wide-tile checks: the M (below, at and past the 128-row tile,
#: phase 4d's, whisper's 2 x 1500 frames) and the (K, N) of llama3-8b's
#: projections (its lm_head at M = 128) and whisper-large-v3's
WIDE_CHECK_MS = (17, 128, 130, 1024, 3000)
WHISPER_SHAPES = ((1280, 1280), (1280, 5120), (5120, 1280))


def wide_bit_checks(torch, gen, dev) -> list:
    """Phase 2: B1's wide body bit for bit against its 16 x 64 x 64 body,
    at every wide tile pinned, every split count, bf16 and fp32 out, on
    :data:`WIDE_CHECK_MS` x the llama3-8b and whisper projections (and the
    lm_head at M = 128), and at the default split count, bf16 out, within
    the bf16 tolerance of the split plain version; B7m
    (``apr_matmul_fused``, bias, each activation, bf16 out) bit for bit at
    the default split count.  One case a (kernel, M, K, N), its error the
    largest against the plain version."""
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.kernels.apr_matmul.ref import matmul_split_ref
    bf16, f32 = torch.bfloat16, torch.float32
    narrow = mm.DEFAULT_TILE

    def run(x, w, tile, splits, out, bias=None, act=None):
        cfg = tile_config(tile, splits)
        if act is None:
            return mm.apr_matmul(x, w, out_dtype=out, config=cfg)
        return mm.apr_matmul_fused(x, w, bias, activation=act,
                                   out_dtype=out, config=cfg)
    geoms = [(m, k, n) for m in WIDE_CHECK_MS
             for k, n in list(LLAMA_DECODE_SHAPES) + list(WHISPER_SHAPES)]
    geoms.append((128,) + LM_HEAD)
    cases = []
    for m, k, n in geoms:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
             ).to(bf16)
        bias = torch.randn((n,), generator=gen, device=dev)
        splits = mm.SPLITS if n < 100_000 else (1,)
        s_default = mm.default_splits(k, n, narrow[1])
        plain = matmul_split_ref(x.float(), w.float(), s_default, bf16)
        runs = differ = 0
        err, ok = 0.0, True
        for out in (bf16, f32):
            for s in splits:
                ref = run(x, w, narrow, s, out)
                for tile in mm.WIDE_TILES:
                    got = run(x, w, tile, s, out)
                    runs += 1
                    differ += int((got != ref).sum())
                    if out == bf16 and s == s_default:
                        e, o = max_err(got, plain)
                        err, ok = max(err, e), ok and o
        fused_runs = fused_differ = 0
        if n < 100_000:
            for act in ACTIVATIONS:
                ref = run(x, w, narrow, s_default, bf16, bias, act)
                for tile in mm.WIDE_TILES:
                    got = run(x, w, tile, s_default, bf16, bias, act)
                    fused_runs += 1
                    fused_differ += int((got != ref).sum())
        torch.cuda.synchronize()
        cases.append(("apr_matmul_wide", f"M={m} K={k} N={n} ({runs} tile/"
                      f"split/out runs) elements differing {differ}", err,
                      ok and differ == 0))
        if fused_runs:
            cases.append(("apr_matmul_fused_wide", f"M={m} K={k} N={n} "
                          f"({fused_runs} tile/act runs) elements differing "
                          f"{fused_differ}", 0.0, fused_differ == 0))
        del x, w, bias, plain
    torch.cuda.empty_cache()
    return cases


#: phase 3's M sweep of the wide body against the 16 x 64 x 64 one and
#: torch.matmul, at three (K, N) (llama3-8b's q/o, gate/up and k/v
#: projections): where the default turns wide, and to which tile
WIDE_SWEEP_MS = (64, 128, 256, 512, 1024, 3000)
WIDE_SWEEP_SHAPES = ((4096, 4096), (4096, 14336), (4096, 1024))


def wide_sweep(torch, gen, dev) -> list:
    """Phase 3: ms a call of every wide tile, the 16 x 64 x 64 tile and
    ``torch.matmul`` at :data:`WIDE_SWEEP_MS` x :data:`WIDE_SWEEP_SHAPES`,
    bf16 out, at the default split count, weights rotated past the L2."""
    from repro_torch.kernels.apr_matmul import ops as mm
    bf16 = torch.bfloat16
    rows = []
    for k, n in WIDE_SWEEP_SHAPES:
        nbuf = min(4, max(1, math.ceil(200e6 / (k * n * 2))))
        ws = [(torch.randn((k, n), generator=gen, device=dev)
               * k ** -0.5).to(bf16) for _ in range(nbuf)]
        s = mm.default_splits(k, n, mm.DEFAULT_TILE[1])
        for m in WIDE_SWEEP_MS:
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            iters = 10 if m >= 1024 else 20
            row = dict(M=m, K=k, N=n, splits=s,
                       default="x".join(str(mm.default_config(m, k, n)[b])
                                        for b in ("block_m", "block_n",
                                                  "block_k")),
                       library_ms=cuda_ms(torch, lambda i: torch.matmul(
                           x, ws[i % nbuf]), iters),
                       **bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n))
            for tile in (mm.DEFAULT_TILE,) + mm.WIDE_TILES:
                cfg = tile_config(tile, s)

                def fn(i, cfg=cfg):
                    return mm.apr_matmul(x, ws[i % nbuf], out_dtype=bf16,
                                         config=cfg)
                row["x".join(map(str, tile))] = cuda_ms(torch, fn, iters)
            rows.append(row)
            del x
        del ws
    torch.cuda.empty_cache()
    return rows


def print_timing_row(r) -> None:
    if "M" in r:
        shape = f"M={r['M']:<3d} K={r['K']:<6d} N={r['N']:<7d}"
    else:
        shape = (f"B={r['B']} Hq={r['Hq']} Hkv={r['Hkv']} D={r['D']} "
                 + (f"ps={r['ps']}" if "ps" in r else f"S={r['S']}")
                 + f" lengths={r['lengths']}")
    print(f"    {r['kernel']:23s} {shape:40s} kernel_ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
          f"{r['bound_ms'] / r['ms']:.0%} of bound"
          + (f" tile={r['tile']}" if "tile" in r else "")
          + (f" splits={r['splits']} by split count "
             + ", ".join(f"{n}: {t:.4f}" for n, t in r["split_ms"].items())
             if "split_ms" in r else ""))


def qmm_timing(torch, gen, dev, ms) -> list:
    """B6 (``quant_matmul``) and B8 (``quant_matmul_fused``, bias + silu)
    at the llama3-8b projection shapes, M in ``ms``, bf16 x and out, int8
    weights rotated past the 50 MB L2: ms per call at the configuration
    the wrapper resolves and, where the tree's kernel takes a split count,
    at each (``split_ms``) and the count it resolves (``splits``); the
    bound (x, the weight and its scales read once, C written once, or the
    operations at the int8 peak).  It calls only ``quant_matmul(x, wq, ws,
    out_dtype=...)`` and ``quant_matmul_fused(x, wq, ws, bias,
    activation=..., out_dtype=...)``, which every version of the port has,
    so a copy of this script times an older tree's kernels."""
    from repro_torch.kernels.quant_matmul import ops as qm
    bf16 = torch.bfloat16
    splits = getattr(qm, "SPLITS", None)
    rows = []
    for m in ms:
        for k, n in LLAMA_DECODE_SHAPES:
            nbuf = min(32, max(1, math.ceil(200e6 / (k * n))))
            qs = [qm.quantize_weights(torch.randn((k, n), generator=gen,
                                                  device=dev))
                  for _ in range(nbuf)]
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            bias = torch.randn((n,), generator=gen, device=dev)
            q_bytes = 2 * m * k + k * n + 4 * n + 2 * m * n
            for name, fn, nbytes in (
                    ("quant_matmul", lambda i, **kw: qm.quant_matmul(
                        x, *qs[i % nbuf], out_dtype=bf16, **kw), q_bytes),
                    ("quant_matmul_fused",
                     lambda i, **kw: qm.quant_matmul_fused(
                         x, *qs[i % nbuf], bias, activation="silu",
                         out_dtype=bf16, **kw), q_bytes + 4 * n)):
                row = dict(kernel=name, M=m, K=k, N=n,
                           ms=cuda_ms(torch, fn, 60), weight_buffers=nbuf,
                           **bound_ms(nbytes, 2 * m * k * n, INT8_OPS_PER_S))
                if splits is not None:
                    row["splits"] = qm.resolve_launch(name, m, k, n,
                                                      "bfloat16", "cuda")[1]
                    row["split_ms"] = {s: cuda_ms(
                        torch, lambda i: fn(i, splits=s), 60)
                        for s in splits}
                rows.append(row)
            del qs, x
    torch.cuda.empty_cache()
    return rows


def sass_loop_ops(section: str, marker: str = "IMMA") -> dict:
    """Opcode counts of the innermost loop of one ``cuobjdump -sass``
    function that holds ``marker`` (an integer MMA by default): the body
    between a backward branch and its target, the shortest such body."""
    import re
    ins = []
    for line in section.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            tokens = m.group(2).split()
            if tokens and tokens[0].startswith("@"):        # a predicate
                tokens = tokens[1:]
            if tokens:
                ins.append((int(m.group(1), 16), tokens))
    best = None
    for addr, tokens in ins:
        target = re.search(r"0x([0-9a-f]+)", " ".join(tokens[1:])) \
            if tokens[0] == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            body = [t[0] for a, t in ins
                    if int(target.group(1), 16) <= a <= addr]
            if any(op.startswith(marker) for op in body) and (
                    best is None or len(body) < len(best)):
                best = body
    ops = {}
    for op in best or []:
        ops[op] = ops.get(op, 0) + 1
    return ops


def qmm_sass(lib: Path, path: Path, tile) -> dict:
    """``cuobjdump -sass`` of ``lib``'s quant_matmul kernels at ``tile``
    (aligned operands; over a bf16 x where the tree has the x type as a
    template argument) into ``path``; returns each kept function's K-loop
    opcode counts (:func:`sass_loop_ops`)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    res = subprocess.run([str(tool if tool.exists() else "cuobjdump"),
                          "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    frag = "quant_matmul_kernelILi{}ELi{}ELi{}E".format(*tile)
    kept, counts = [], {}
    for sec in res.stdout.split("Function : ")[1:]:
        name = sec.split(None, 1)[0]
        # the aligned kernel (ALIGNED true); not the fp32-x one ("f")
        if frag in name and "Lb1E" in name and "EfLb1E" not in name:
            kept.append("Function : " + sec)
            counts[name] = sass_loop_ops(sec)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(kept) + res.stderr)
    return counts


def kernel_sweep(torch, out: Path) -> None:
    """``--kernel-sweep``: build ``flash_decode.cu``, ``apr_matmul.cu``,
    ``quant_matmul.cu``, ``rwkv6.cu`` and ``mamba2.cu``, print their
    registers and spills, time B9 and B10 at the decode tick and a
    1024-token prefill (:func:`scan_timing`; every compiled configuration
    too, :func:`scan_config_sweep`), B2 over
    bf16, fp32 and int8 pools (B2q) at the serving shape (at each split
    count where the tree takes one; under an fp32 q too where it takes one)
    and at each split count over :data:`PAGED_SWEEP`, B3 against its
    longest length (:data:`DECODE_SWEEP`), over an fp32 cache and under an
    fp32 q (:data:`DECODE_TIMING`), B1 with bf16, int8 and fp32 weights
    and fp32 activations over int8 weights, and B6 / B8 (:func:`qmm_timing`)
    at the projection shapes (M = 4 and 16; at each split count where the
    tree takes one); print each kernel's time per llama3-8b decode tick
    (the 224 projections at M = 4), and the K loop of quant_matmul's
    default tile from its SASS (:func:`qmm_sass`, beside ``out``); writes
    ``out``.  It uses only entry points every version of the port has, so
    a copy of this script beside an older tree times that tree's kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.kernels.mamba2 import ops as m2
    from repro_torch.kernels.rwkv6 import ops as r6
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _build.build_all({fd.LIBRARY: fd.SIGNATURES, mm.LIBRARY: mm.SIGNATURES,
                      qm.LIBRARY: qm.SIGNATURES, r6.LIBRARY: r6.SIGNATURES,
                      m2.LIBRARY: m2.SIGNATURES})
    regs = [f"{name}: {line.strip()}"
            for name, log in sorted(_build.BUILD_LOGS.items())
            for line in log.splitlines()
            if "Used" in line or "spill" in line or "Compiling" in line]
    for line in regs:
        print(f"    {line}")
    rows = paged_timing(torch, gen, dev)
    rows += decode_timing(torch, gen, dev, DECODE_SWEEP)
    rows += decode_timing(torch, gen, dev, DECODE_TIMING, torch.float32)
    if (torch.float32, torch.bfloat16) in fd.KERNEL_DTYPES[fd.KERNEL_NAME]:
        rows += decode_timing(torch, gen, dev, DECODE_TIMING[:1],
                              q_dtype=torch.float32)
    rows += projection_timing(torch, gen, dev, PROJ_MS)
    rows += qmm_timing(torch, gen, dev, PROJ_MS)
    scan_rows = scan_timing(torch, gen, dev)
    for r in scan_rows:
        print_scan_row(r)
    scan_configs = scan_config_sweep(torch, gen, dev)
    for r in rows:
        if "plain_ms" in r:
            print_timing_row(r)
        else:
            print(f"    {r['kernel']:23s} M={r['M']:<3d} K={r['K']:<6d} "
                  f"N={r['N']:<7d} kernel_ms={r['ms']:.4f} bound_ms="
                  f"{r['bound_ms']:.4f} ({r['bound_by']})"
                  + (f" splits={r['splits']} by split count " + ", ".join(
                      f"{n}: {t:.4f}" for n, t in r["split_ms"].items())
                     if "split_ms" in r else ""))
    ticks = {}
    for r in rows:
        if r.get("M") == PROJ_MS[0] and (r["K"], r["N"]) in \
                LLAMA_DECODE_SHAPES:
            ticks[r["kernel"]] = ticks.get(r["kernel"], 0.0) + 32 * \
                LLAMA_DECODE_SHAPES[(r["K"], r["N"])] * r["ms"]
    print(f"    per llama3-8b decode tick (224 projections at M = "
          f"{PROJ_MS[0]}), ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ticks.items()))
    splits = paged_split_sweep(torch, gen, dev)
    for r in splits:
        print(f"    {r['kernel']:23s} B={r['B']:<2d} P_max={r['P_max']:<3d} "
              f"lengths={r['lengths'][:4]} default splits={r['splits']}: "
              + ", ".join(f"{n}: {t:.2f}" for n, t in r["split_us"].items())
              + " us")
    sass = qmm_sass(_build._target(qm.LIBRARY),
                    out.parent / f"{out.stem}_sass_quant_matmul.txt",
                    qm.DEFAULT_TILE)
    for name, ops in sass.items():
        print(f"    SASS K loop of {name[:80]}: {sum(ops.values())} "
              f"instructions; " + ", ".join(
                  f"{op} {n}" for op, n in sorted(ops.items())
                  if op.startswith(("BAR", "STS", "LDS", "PRMT", "IMMA",
                                    "LDGSTS", "F2F", "DMUL", "MUFU"))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, ptxas=regs, timing=rows,
                                   per_tick_ms=ticks, paged_splits=splits,
                                   qmm_sass_k_loop=sass, scans=scan_rows,
                                   scan_configs=scan_configs), indent=1))


#: ``--qmm-ablation``: variants of ``csrc/quant_matmul.cu`` made by text
#: substitution, each (bit-exact, [(text, replacement), ...]).  The exact
#: ones compute the same function another way and are held bit for bit
#: to the plain version; the others drop a piece of the kernel to time
#: what it costs, and compute something else.
QMM_CODE = """using Divisor = double;
__device__ __forceinline__ Divisor divisor(float scale) {
  return __drcp_rn((double)scale);
}
__device__ __forceinline__ int code(float x, Divisor inv) {
  const float q = __double2float_rn(__dmul_rn((double)x, inv));
  return min(max(__float2int_rn(q), -127), 127);
}"""
QMM_AMAX = """  row_absmax<T::WARPS, XT, ALIGNED>(x, m0, rv, t_begin * BK,
                                    min(K, t_end * BK), K, smax);"""
QMM_SYNC = """  if (nsplit > 1)
    cg::this_cluster().sync();                // every split's maxima are in
  else
    __syncthreads();"""
QMM_REMOTE = ("    unsigned m = nsplit > 1 ? 0u : smax[threadIdx.x];\n"
              "    for (int r = 0; r < nsplit && nsplit > 1; ++r)\n")
QMM_LOOP = "  for (int t = t_begin; t < t_end; ++t) {"
QMM_VARIANTS = {
    # a per-element IEEE division, __fdiv_rn
    "fdiv": (True, [(QMM_CODE, """using Divisor = float;
__device__ __forceinline__ Divisor divisor(float scale) { return scale; }
__device__ __forceinline__ int code(float x, Divisor scale) {
  return min(max(__float2int_rn(__fdiv_rn(x, scale)), -127), 127);
}""")]),
    # the quotient by two FMA Newton steps on fl32(1/scale) (Markstein),
    # rounded and clamped in fp32: the code is the low byte of q + 1.5 2^23
    "fma": (True, [(QMM_CODE, """using Divisor = float2;
__device__ __forceinline__ Divisor divisor(float scale) {
  return make_float2(scale, __frcp_rn(scale));
}
__device__ __forceinline__ int code(float x, Divisor d) {
  float q = __fmul_rn(x, d.y);
  float r = __fmaf_rn(-d.x, q, x);
  q = __fmaf_rn(r, d.y, q);
  r = __fmaf_rn(-d.x, q, x);
  q = __fmaf_rn(r, d.y, q);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float_as_int(__fadd_rn(q, 12582912.0f));
}""")]),
    # 8 warps a block where BK >= 128 (two a scheduler)
    "w8": (True, [("static constexpr int WARPS = 4, THREADS",
                   "static constexpr int WARPS = BK >= 128 ? 8 : 4, "
                   "THREADS")]),
    # timing only: no amax pass (every scale 1/127)
    "no_amax": (False, [(QMM_AMAX, "  if ((int)threadIdx.x < rv) "
                                   "smax[threadIdx.x] = 0x3f800000u;")]),
    # timing only: no cluster barrier or remote read before the K loop
    "no_amax_sync": (False, [(QMM_SYNC, "  __syncthreads();"), (
        QMM_REMOTE, "    unsigned m = smax[threadIdx.x];\n"
                    "    for (int r = 0; r < 0; ++r)\n")]),
    # timing only: no K loop (the ring's first stages still land)
    "no_loop": (False, [(QMM_LOOP, "  for (int t = t_begin; t < t_begin; "
                                   "++t) {")]),
}


#: ``--scan-ablation``: timing-only variants of ``csrc/rwkv6.cu`` and
#: ``csrc/mamba2.cu`` made by text substitution, each dropping one piece of
#: the staged path (they compute something else): the lanes' y reduction,
#: the staging of every round after the first, B9's per-step bonus, the
#: per-element step itself; and B10's guarded body (for N < 128) run at
#: the ablation's N = 128, which prices the guards the full-N body drops
SCAN_VARIANTS = {
    "rwkv6": {
        "no_reduce": [(
            "const int first = scan::reduce_slots<K, LI, LJ, false>(part, "
            "lane,\n                                                      "
            "         owner);", "const int first = 0;\n        owner = "
            "lane < 1;")],
        "no_restage": [("      if (c0 + ch < tlen) issue(c0 + ch, (kk + 1) "
                        "& 1);", "")],
        "no_bonus": [(
            "        bonus_steps(beta, rr + t0 * IP, IP, min(BONUS_STEPS, n - "
            "t0), su,\n                    rk + t0 * IP, d, lane);",
            "        beta[0] = 0.f;")],
        "no_step": [(
            "            wkv_step<IR, G>(st, ri, ki, wi, vj, part + 4 * s);",
            "            part[4 * s] = ri[0] + vj.x;\n            "
            "part[4 * s + 1] = ki[0] + vj.y;\n            part[4 * s + 2] = "
            "wi[0] + vj.z;\n            part[4 * s + 3] = vj.w;")],
    },
    "mamba2": {
        # the guarded body (clamped vector index, selected partial) at
        # N = 128 too, where the kernel runs the one with every vector live
        "guarded": [("  if (n == MAX_N) {", "  if (false) {")],
        "no_reduce": [(
            "const int base = scan::reduce_slots<K, LPR, 1, true>(part, "
            "lane,\n                                                       "
            "      owner);", "const int base = 0;\n        owner = lane < "
            "1;")],
        "no_restage": [("      if (c0 + ch < tlen) issue(c0 + ch, (k + 1) "
                        "& 1);", "")],
        "no_step": [(
            "            ssd_step<RT, VPL, LPR, FULL>(hs, bv, cv, xp,\n"
            "                                         rdt[tt * MAX_HEADS + "
            "hh],\n                                         sdec[tt * "
            "MAX_HEADS + hh], q, nv,\n"
            "                                         part + s * RT);",
            "            for (int r = 0; r < RT; ++r) part[s * RT + r] = "
            "xp[r] + bv[0].x + cv[0].y;")],
    },
}


#: profiled sessions of :func:`profiler_probe` at each padding, and the
#: padding (seconds of host idle at both ends of a window) it tries
PROBE_SESSIONS = 60
PROBE_PAD_S = 0.005
#: unprofiled launches :func:`profiler_probe` makes between its stages
PROBE_BACKLOG = 20000


def profiler_probe(torch, out: Path) -> None:
    """``--profiler-probe``: why a one-kernel-a-call check can count fewer
    device kernels than calls.  Builds ``quant_matmul.cu``,
    ``apr_matmul.cu``, ``rwkv6.cu`` and ``mamba2.cu`` and profiles 5 calls
    of ``quant_matmul`` at M = 5, K = 300, N = 1000 (a 3-µs kernel
    launched as a cluster) in stages: right after :func:`scan_bit_checks`
    (phase 2's profiled scan checks), :data:`PROBE_SESSIONS` sessions with
    no idle time at the window's ends and as many with
    :data:`PROBE_PAD_S` of it, in turn; then 10 sessions after each of
    :data:`PROBE_BACKLOG` unprofiled launches of a one-block elementwise
    kernel, of as many unprofiled ``quant_matmul`` calls, and of phase 2's
    :func:`matmul_family_correctness` (there also with :data:`PROBE_PAD_S`
    and 50 ms of idle ends, in turn); last :func:`one_kernel_a_call` as
    :func:`qmm_tie_and_launch_checks` makes it.  Records per session the
    device events and launch calls a call and the first device event's and
    first launch call's start in µs from the trace's start.  Writes
    ``out``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.kernels.mamba2 import ops as m2
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.kernels.rwkv6 import ops as r6
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _build.build_all({qm.LIBRARY: qm.SIGNATURES, mm.LIBRARY: mm.SIGNATURES,
                      r6.LIBRARY: r6.SIGNATURES, m2.LIBRARY: m2.SIGNATURES})
    scan_rows = scan_bit_checks(torch, gen, dev)
    for kernel, case, _, ok in scan_rows:
        print(f"    {'ok  ' if ok else 'FAIL'} {kernel} {case}", flush=True)
    wq, ws = qm.quantize_weights(torch.randn((300, 1000), generator=gen,
                                             device=dev))
    x = torch.randn((5, 300), generator=gen, device=dev).to(torch.bfloat16)

    def call():
        return qm.quant_matmul(x, wq, ws, out_dtype=torch.bfloat16)

    call()
    sessions = []

    def stage(name, count, pads):
        for i in range(count):
            for pad in pads:
                events, calls, trace = {}, {}, {}
                profile_device(torch, call, 5, counts=events,
                               launches=calls, trace=trace, pad_s=pad)
                sessions.append(dict(stage=name, session=i, pad_s=pad,
                                     kernels=sum(events.values()),
                                     launch_calls=sum(calls.values()),
                                     events=events, calls=calls, **trace))

    stage("after the scan checks", PROBE_SESSIONS, (0.0, PROBE_PAD_S))
    y = torch.zeros(256, device=dev)
    for _ in range(PROBE_BACKLOG):
        y.add_(1.0)
    torch.cuda.synchronize()
    stage("after elementwise launches", 10, (0.0,))
    for _ in range(PROBE_BACKLOG):
        call()
    torch.cuda.synchronize()
    stage("after quant_matmul launches", 10, (0.0,))
    family = matmul_family_correctness(torch, gen, dev)
    stage("after matmul_family_correctness", 10, (0.0, PROBE_PAD_S, 0.05))
    summary = {}
    for key in dict.fromkeys((r["stage"], r["pad_s"]) for r in sessions):
        rows = [r for r in sessions if (r["stage"], r["pad_s"]) == key]
        dev_us = sorted(r["first_device_us"] for r in rows
                        if r["first_device_us"] is not None)
        host_us = sorted(r["first_launch_us"] for r in rows
                         if r["first_launch_us"] is not None)
        summary[f"{key[0]}, pad {key[1]:g} s"] = dict(
            sessions=len(rows),
            short=sum(r["kernels"] < 1 for r in rows),
            fewer_events_than_launch_calls=sum(
                r["kernels"] < r["launch_calls"] for r in rows),
            kernels_a_call=sorted({r["kernels"] for r in rows}),
            launch_calls_a_call=sorted({r["launch_calls"] for r in rows}),
            first_device_us_min=dev_us[0] if dev_us else None,
            first_device_us_median=dev_us[len(dev_us) // 2]
            if dev_us else None,
            first_launch_us_median=host_us[len(host_us) // 2]
            if host_us else None)
    for key, row in summary.items():
        print(f"    {key}: {row}", flush=True)
    one = one_kernel_a_call(torch, call, "quant_matmul_kernel")
    print(f"    one_kernel_a_call: {one}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=smi, summary=summary, sessions=sessions,
        one_kernel_a_call=one,
        scan_checks=[[k, c, ok] for k, c, _, ok in scan_rows],
        family_failed=[[k, c] for k, c, _, ok in family if not ok]),
        indent=1))


def build_variants(lib: str, variants: dict, signatures: dict) -> dict:
    """Build each variant of ``csrc/<lib>.cu`` (``{name: [(old, new),
    ...]}``, text substitutions; a substitution whose text is gone fails
    the run), one nvcc each, all at once, into the build directory, and
    load them with ``signatures``; returns ``{name: library}``."""
    import ctypes
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{lib}.cu").read_text()
    vdir = _build.BUILD_DIR / f"{lib}_ablation"
    vdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                fail(f"{lib} ablation {name}: the kernel no longer has "
                     f"{old.splitlines()[0]!r}")
            text = text.replace(old, new)
        (vdir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC), "-o", str(vdir / f"lib{name}.so"),
             str(vdir / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"{lib} ablation {name} did not build:\n{log[-3000:]}")
        handle = ctypes.CDLL(str(vdir / f"lib{name}.so"))
        handle.repro_cuda_error_string.restype = ctypes.c_char_p
        handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
        for fn, (restype, argtypes) in signatures.items():
            getattr(handle, fn).restype = restype
            getattr(handle, fn).argtypes = argtypes
        libs[name] = handle
    return libs


#: variants of ``apr_conv.cu`` for ``--conv-ablation``: timing-only ones
#: (wrong results) that drop one piece of the APR kernel, then ones that
#: change its default tiles
CONV_VARIANTS = {
    # no halo staged (the resident path): no global loads of x
    "no_halo": [("  for (int rr = warp; rr < pl.ti * pl.hrows; "
                 "rr += NT / 32) {",
                 "  for (int rr = 0; rr < 0; rr += NT / 32) {")],
    # the filters of the prologue serve every step: no ring a step
    "no_filter_ring": [("      if (s + 2 < steps) {\n        stage_filter",
                        "      if (false) {\n        stage_filter")],
    # no wait and no barrier a step (the first step's only)
    "no_step_sync": [("      if (pl.resident || s == 0)\n        "
                      "cp_async_wait<1>();\n      else\n        "
                      "cp_async_wait<0>();\n      __syncthreads();",
                      "      if (s == 0) {\n        cp_async_wait<1>();\n"
                      "        __syncthreads();\n      }")],
    # the input loads of a step hoisted out of its channel loop
    "no_x_loads": [("lds4(xs + pb[i] + c)", "lds4(xs + pb[i])")],
    # the filter loads of a step hoisted out of its channel loop
    "no_f_loads": [("lds4(fs + (c + r) * BN + j4 * Tl::TXN * 4)",
                    "lds4(fs + r * BN + j4 * Tl::TXN * 4)")],
    # no shared-memory loads in the channel loop at all
    "no_loads": [("lds4(xs + pb[i] + c)", "lds4(xs + pb[i])"),
                 ("lds4(fs + (c + r) * BN + j4 * Tl::TXN * 4)",
                  "lds4(fs + r * BN + j4 * Tl::TXN * 4)")],
    # no channel loop: staging, barriers and the flush only
    "no_math": [("for (int c = 0; c < chans; c += 4) {",
                 "for (int c = 0; c < 0; c += 4) {")],
    # no stores of the flush (acc kept live by a test never true)
    "no_store": [("    if (pq[i] < 0 || b >= g.B",
                  "    if (g.B > 0 || pq[i] < 0 || b >= g.B")],
    # a block that only computes its pixels' offsets (the launch and the
    # blocks' start and end)
    "empty": [("  // Groups of cp.async: the input with step 0",
               "  if (g.B > 0) return;\n  // Groups of cp.async: the input "
               "with step 0")],
    # a block that only stages its input and filters
    "staging_only": [("  float acc[TP][TN];\n#pragma unroll\n  for (int i "
                      "= 0;", "  if (g.B > 0) {\n    cp_async_wait<0>();\n"
                      "    return;\n  }\n  float acc[TP][TN];\n#pragma "
                      "unroll\n  for (int i = 0;")],
}
# no staging, no ring, no barrier a step: the loads and the math only
CONV_VARIANTS["loads_math"] = (CONV_VARIANTS["no_halo"]
                               + CONV_VARIANTS["no_filter_ring"]
                               + CONV_VARIANTS["no_step_sync"])
# ... and no loads: the math alone
CONV_VARIANTS["math"] = CONV_VARIANTS["loads_math"] + CONV_VARIANTS["no_loads"]
# ... four times over: (math_x4 - math) / 3 is the channel loop's time
CONV_VARIANTS["math_x4"] = CONV_VARIANTS["math"] + [
    ("for (int c = 0; c < chans; c += 4) {",
     "for (int c = 0; c < 4 * chans; c += 4) {")]
# the default tiles with 256 threads (twice the pixels a block)
CONV_VARIANTS["threads256"] = [
    ("X(16, 8, 4, 128, 16)", "X(16, 8, 4, 256, 16)"),
    ("X(32, 8, 4, 128, 32)", "X(32, 8, 4, 256, 32)"),
    ("X(64, 8, 4, 128, 1073741824)", "X(64, 8, 4, 256, 1073741824)")]
# the default tiles with 8 pixels x 4 channels a thread
CONV_VARIANTS["tp8_tn4"] = [
    ("X(16, 8, 4, 128, 16)", "X(16, 4, 8, 128, 16)"),
    ("X(32, 8, 4, 128, 32)", "X(32, 4, 8, 128, 32)"),
    ("X(64, 8, 4, 128, 1073741824)", "X(64, 4, 8, 128, 1073741824)")]


def conv_ablation(torch, out: Path) -> None:
    """``--conv-ablation``: build ``apr_conv.cu`` and each of
    :data:`CONV_VARIANTS` and time each, in the order kernel, variants,
    kernel, through ``apr_conv2d`` at every distinct ResNet-20 conv at
    batch CNN_BATCH on the default tile, then the kernel on every tile it
    compiles, with per-forward totals, the blocks an SM holds and the SM
    clock under load; also the K-loop opcode counts of the fp32 APR
    kernels (``cuobjdump -sass``, beside ``out``).  A variant's time
    against the kernel's says what that piece costs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_conv import apr_conv2d
    from repro_torch.kernels.apr_conv import ops as conv_ops
    from repro_torch.models.cnn import conv_geometries
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = _build.load(conv_ops.LIBRARY, conv_ops.SIGNATURES)
    libs = build_variants(conv_ops.LIBRARY, CONV_VARIANTS,
                          conv_ops.SIGNATURES)
    order = ["kernel", *CONV_VARIANTS, "kernel again"]
    rows = {}
    for g in conv_geometries("resnet20", CNN_BATCH):
        key = (g["x_shape"], g["f_shape"], g["stride"], g["padding"])
        if key in rows:
            rows[key]["count"] += 1
            continue
        xs, fs, s, p = key
        x, f = conv_inputs(torch, gen, dev, xs, fs)
        row = rows[key] = dict(layer=g["param"], count=1, ms={},
                               blocks_per_sm=conv_ops.blocks_per_sm(
                                   x, f, stride=s, padding=p))
        for name in order:
            _build._LIBS[conv_ops.LIBRARY] = libs.get(name, kernel)
            try:
                row["ms"][name] = cuda_ms(torch, lambda i: apr_conv2d(
                    x, f, stride=s, padding=p), 30)
                if name == "kernel":         # the SM clock under load
                    for _ in range(int(200 / row["ms"][name])):
                        apr_conv2d(x, f, stride=s, padding=p)
                    row["clock"] = subprocess.run(
                        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                         "power.draw", "--format=csv,noheader"],
                        capture_output=True, text=True,
                        timeout=60).stdout.strip()
                    torch.cuda.synchronize()
            finally:
                _build._LIBS[conv_ops.LIBRARY] = kernel
        row["tile_ms"] = {
            f"{cfg['block_m']}x{cfg['block_n']}": cuda_ms(
                torch, lambda i: apr_conv2d(x, f, stride=s, padding=p,
                                            config=cfg), 30)
            for cfg in conv_ops.APR_CONFIGS}
        print(f"    {row['layer']:7s} x={xs} f={fs} s={s} ("
              f"{row['blocks_per_sm']} blocks an SM; SM clock, max, "
              f"power under load: {row['clock']}): " + ", ".join(
                  f"{k_} {v:.4f}" for k_, v in row["ms"].items())
              + "; tiles: " + ", ".join(f"{k_} {v:.4f}" for k_, v in
                                        row["tile_ms"].items()), flush=True)
        del x, f
    totals = {name: sum(r["count"] * r["ms"][name] for r in rows.values())
              for name in order}
    totals.update({f"tile {t}": sum(r["count"] * r["tile_ms"][t]
                                    for r in rows.values())
                   for t in next(iter(rows.values()))["tile_ms"]})
    print("    per ResNet-20 forward, ms: " + ", ".join(
        f"{k_} {v:.4f}" for k_, v in totals.items()))
    sass = conv_apr_sass(_build._target(conv_ops.LIBRARY),
                         out.parent / f"{out.stem}_sass.txt")
    for name, ops in sass.items():
        print(f"    SASS conv APR loop {name[19:75]}: {ops}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, totals=totals, sass=sass,
                                   timing=list(rows.values())), indent=1))


def scan_ablation(torch, out: Path) -> None:
    """``--scan-ablation``: build ``rwkv6.cu``, ``mamba2.cu`` and each of
    :data:`SCAN_VARIANTS` (one nvcc each, all at once) and time each
    through its wrapper at the 1024-token prefill of phase 3 (B = 1, bf16,
    the default configuration, inputs rotated past the L2), in the order
    kernel, variants, kernel; writes ``out``.  A variant's time against the
    kernel's says what that piece costs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2 import ops as m2
    from repro_torch.kernels.rwkv6 import ops as r6
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = {r6.LIBRARY: _build.load(r6.LIBRARY, r6.SIGNATURES),
               m2.LIBRARY: _build.load(m2.LIBRARY, m2.SIGNATURES)}
    libs = {(lib, name): handle for lib, ops in (("rwkv6", r6), ("mamba2", m2))
            for name, handle in build_variants(
                lib, SCAN_VARIANTS[lib], ops.SIGNATURES).items()}
    times = {}
    for lib, *shape in (("rwkv6", 1, 1024, 40, 64),
                        ("mamba2", 1, 1024, 80, 64, 128)):
        if lib == "rwkv6":
            fn, kw = r6.rwkv6_wkv, "s_init"
            sets = rotated(lambda: rwkv_inputs(torch, gen, dev, *shape,
                                               torch.bfloat16, False))
        else:
            fn, kw = m2.mamba2_ssd, "h_init"
            sets = rotated(lambda: mamba_inputs(torch, gen, dev, *shape,
                                                torch.bfloat16, False, True))
        for name in ["kernel", *SCAN_VARIANTS[lib], "kernel again"]:
            _build._LIBS[lib] = libs.get((lib, name), kernels[lib])
            try:
                t = cuda_ms(torch, lambda i: fn(
                    *sets[i % len(sets)][0], **{kw: sets[i % len(sets)][1]},
                    return_state=True), 10, warmup=2)
            finally:
                _build._LIBS[lib] = kernels[lib]
            times[f"{lib} {name}"] = t
            print(f"    {lib} T=1024 {name}: {t:.4f} ms", flush=True)
        del sets
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, ms=times), indent=1))


def qmm_ablation(torch, out: Path) -> None:
    """``--qmm-ablation``: build ``quant_matmul.cu`` and each of
    :data:`QMM_VARIANTS` (one nvcc each, all at once), hold every exact
    variant bit for bit to the plain version (random x, and rows whose
    codes sit at and next to .5 ties, through an identity weight; bf16 and
    fp32 x), and time each through the ``quant_matmul`` wrapper at the
    llama3-8b projection shapes (M = 4 and 16, bf16 x and out, weights
    rotated past the L2) at the default configuration, with per-tick
    totals at M = 4; writes ``out``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    libs = {"kernel": _build.load(qm.LIBRARY, qm.SIGNATURES)}
    libs.update(build_variants(qm.LIBRARY, {
        name: subs for name, (_, subs) in QMM_VARIANTS.items()},
        qm.SIGNATURES))

    def run_on(name, fn):
        _build._LIBS[qm.LIBRARY] = libs[name]
        try:
            return fn()
        finally:
            _build._LIBS[qm.LIBRARY] = libs["kernel"]

    # exactness: random rows and rows at and next to .5 ties (every tile x
    # split count for the random ones), through an identity weight
    k = 4096
    eye = torch.eye(k, dtype=torch.int8, device=dev)
    one = torch.ones((1, k), device=dev)
    checks = []
    for _ in range(6):
        amax = torch.exp(torch.empty((16, 1), device=dev).uniform_(
            -25, 25, generator=gen))
        ties = (torch.randint(-127, 127, (16, k), generator=gen,
                              device=dev) + 0.5) * (amax * (1 / 127))
        side = torch.randint(0, 3, (16, k), generator=gen, device=dev)
        ties = torch.where(side == 1, torch.nextafter(
            ties, torch.full_like(ties, float("inf"))), ties)
        ties = torch.where(side == 2, torch.nextafter(
            ties, torch.full_like(ties, -float("inf"))), ties)
        ties[:, 0] = amax[:, 0]
        rand = torch.randn((16, k), generator=gen, device=dev) * amax
        for x in (ties, ties.to(bf16), rand, rand.to(bf16)):
            checks.append((x, quant_matmul_ref(x, eye, one, f32)))
    exact = {}
    for name, lib in libs.items():
        if name != "kernel" and not QMM_VARIANTS[name][0]:
            continue
        differ = 0
        for x, ref in checks:
            for tile in (qm.DEFAULT_TILE, qm.TILES[0]):
                got = run_on(name, lambda: qm.quant_matmul(
                    x, eye, one, config=tile_config(tile)))
                differ += int((got != ref).sum())
        exact[name] = differ
        print(f"    {name:13s} elements differing from the plain version: "
              f"{differ} of {2 * sum(x.numel() for x, _ in checks)}")
    rows, ticks = [], {}
    for m in PROJ_MS:
        for kk, n in LLAMA_DECODE_SHAPES:
            nbuf = min(32, max(1, math.ceil(200e6 / (kk * n))))
            qs = [qm.quantize_weights(torch.randn((kk, n), generator=gen,
                                                  device=dev))
                  for _ in range(nbuf)]
            x = torch.randn((m, kk), generator=gen, device=dev).to(bf16)
            row = dict(M=m, K=kk, N=n, splits=qm.resolve_launch(
                "quant_matmul", m, kk, n, "bfloat16", "cuda")[1], us={})
            for name in libs:
                row["us"][name] = 1e3 * run_on(name, lambda: cuda_ms(
                    torch, lambda i: qm.quant_matmul(
                        x, *qs[i % nbuf], out_dtype=bf16), 60))
                if m == PROJ_MS[0]:
                    ticks[name] = ticks.get(name, 0.0) + 32 * \
                        LLAMA_DECODE_SHAPES[(kk, n)] * row["us"][name] / 1e3
            rows.append(row)
            print(f"    M={m:<3d} K={kk:<6d} N={n:<6d} splits={row['splits']}"
                  f" us: " + ", ".join(f"{k_}={v:.2f}"
                                       for k_, v in row["us"].items()))
            del qs, x
    print("    per llama3-8b decode tick (224 projections at M = "
          f"{PROJ_MS[0]}), ms: " + ", ".join(f"{k_} {v:.3f}"
                                            for k_, v in ticks.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, exact=exact, timing=rows,
                                   per_tick_ms=ticks), indent=1))
    if any(exact.values()):
        fail(f"an exact quant_matmul variant differs: {exact}")


# ------------------------------------- conv kernels (B5, B7 conv, B4c)
def conv_inputs(torch, gen, dev, xs, fs, dtype=None):
    """A random NHWC input and an HWIO filter scaled by K^-1/2 (fp32, or
    ``dtype``), so the outputs are O(1) and the activations meet both of
    their sides."""
    dtype = dtype or torch.float32
    x = torch.randn(xs, generator=gen, device=dev).to(dtype)
    k = fs[0] * fs[1] * fs[2]
    f = (torch.randn(fs, generator=gen, device=dev) * k ** -0.5).to(dtype)
    return x, f


def conv_label(xs, fs, s, p, bf16=False) -> str:
    return (f"x={'x'.join(map(str, xs))} f={'x'.join(map(str, fs))} "
            f"s={s} p={p}{' bf16' if bf16 else ''}")


def conv_geometries_checked(torch) -> list:
    """Phase 2's conv geometries as ``(x shape, f shape, stride, padding,
    dtype)``: every conv of LeNet-5 and ResNet-20 at batch 1 and
    CNN_BATCH, ragged ones (a 300-wide row whose halo does not fit a
    512-pixel tile, so its steps restage; C = 132 in three channel ranges a
    tap), and the JAX tests' (tests/test_kernels_conv.py) in bf16."""
    from repro_torch.models.cnn import CNNS, conv_geometries
    geoms = {}
    for net in CNNS:
        for batch in (1, CNN_BATCH):
            for g in conv_geometries(net, batch):
                geoms[(g["x_shape"], g["f_shape"], g["stride"],
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
            (4, 17, 17, 5, 5, 5, 33, 3, 2),     # K = 125, stride 3
            (1, 3, 300, 128, 3, 3, 8, 1, 1),    # restaged steps
            (2, 5, 5, 132, 3, 3, 20, 1, 1)]:    # 3 channel ranges a tap
        geoms[((b, h, w, c), (hf, wf, c, m), s, p, torch.float32)] = None
    for key in [((1, 8, 8, 4), (3, 3, 4, 8), 1, 1),          # the JAX test
                ((2, 32, 32, 3), (3, 3, 3, 16), 1, 1),
                ((2, 15, 13, 16), (3, 3, 16, 32), 2, 1)]:
        geoms[key + (torch.bfloat16,)] = None
    return list(geoms)


#: phase 2's fused-epilogue cases: (x shape, f shape, stride, padding)
CONV_FUSED_CASES = [((3, 32, 32, 1), (5, 5, 1, 6), 1, 0),
                    ((8, 32, 32, 16), (3, 3, 16, 32), 2, 1),
                    ((2, 8, 8, 64), (3, 3, 64, 64), 1, 1)]


def conv_correctness(torch, gen, dev) -> tuple:
    """Phase 2 for the conv kernels: every geometry of
    :func:`conv_geometries_checked` on ``apr_conv`` and on the
    memory-resident ``apr_conv_hbm`` (one launch a call) against the plain
    version, then the fused epilogue with every activation, bias and none.
    Returns ``(cases, digests)``: the cases as ``(kernel, case,
    max_abs_err, ok)`` and the sha256 of each case's output bytes, by
    kernel and case, so that two trees' runs show whether their kernels
    give the same bits."""
    import hashlib
    from repro_torch.kernels.apr_conv import (apr_conv2d, apr_conv2d_fused,
                                              conv2d_fused_ref, conv2d_ref)
    bf16 = torch.bfloat16
    geoms = conv_geometries_checked(torch)
    cases, digests = [], {}

    def record(name, label, got, ref, ok=True):
        err, within = conv_err(got, ref)
        cases.append((name, label, err, within and ok))
        digests[f"{name} {label}"] = hashlib.sha256(
            got.cpu().numpy().tobytes()).hexdigest()

    for xs, fs, s, p, dtype in geoms:
        x, f = conv_inputs(torch, gen, dev, xs, fs, dtype)
        ref = conv2d_ref(x, f, stride=s, padding=p)
        label = conv_label(xs, fs, s, p, dtype == bf16)
        got = apr_conv2d(x, f, stride=s, padding=p)
        before = apr_conv2d.hbm_launches
        hbm = apr_conv2d(x, f, stride=s, padding=p, residency="hbm")
        torch.cuda.synchronize()
        record("apr_conv", label, got, ref)
        record("apr_conv_hbm", label, hbm, ref,
               apr_conv2d.hbm_launches - before == 1)
        del x, f, ref, got, hbm
    for xs, fs, s, p in CONV_FUSED_CASES:
        x, f = conv_inputs(torch, gen, dev, xs, fs)
        bias = torch.randn(fs[3], generator=gen, device=dev)
        for act in ("none", "relu", "silu", "gelu"):
            for bname, bb in (("no bias", None), ("bias (M,)", bias),
                              ("bias (1,M)", bias[None])):
                got = apr_conv2d_fused(x, f, bb, activation=act, stride=s,
                                       padding=p)
                ref = conv2d_fused_ref(x, f, bb, act, stride=s, padding=p)
                torch.cuda.synchronize()
                record("apr_conv", f"{conv_label(xs, fs, s, p)} {act}, "
                       f"{bname}", got, ref)
    return cases, digests


def conv_bit_checks(torch, gen, dev) -> list:
    """Phase 2, bit for bit: on every geometry of
    :func:`conv_geometries_checked`, every tile the APR conv kernel
    compiles, pinned, gives the bytes of the default tile, one launch a
    call; so does the fused epilogue (bias + ReLU, bias + GELU) on
    :data:`CONV_FUSED_CASES`; and at batch CNN_BATCH the first and the
    last image alone give the bytes of their rows inside the batch.
    Returns ``(kernel, case, 0.0, ok)`` rows."""
    from repro_torch.kernels.apr_conv import apr_conv2d, apr_conv2d_fused
    from repro_torch.kernels.apr_conv import ops as conv_ops
    tiles = conv_ops.APR_CONFIGS
    rows = []

    def bits(t):
        return t.contiguous().view(torch.int32)

    def held(counter, base, fn):
        """(tiles giving base's bytes, launches) over every pinned tile."""
        same = launches = 0
        for cfg in tiles:
            before = counter()
            got = fn(cfg)
            launches += counter() - before
            same += int(torch.equal(bits(got), bits(base)))
        return same, launches

    for xs, fs, s, p, dtype in conv_geometries_checked(torch):
        x, f = conv_inputs(torch, gen, dev, xs, fs, dtype)
        base = apr_conv2d(x, f, stride=s, padding=p)
        same, launches = held(lambda: apr_conv2d.launches, base,
                              lambda cfg: apr_conv2d(x, f, stride=s,
                                                     padding=p, config=cfg))
        note = ""
        ok = same == len(tiles) and launches == len(tiles)
        if xs[0] == CNN_BATCH:
            alone = [torch.equal(bits(apr_conv2d(
                x[i:i + 1].contiguous(), f, stride=s, padding=p)[0]),
                bits(base[i])) for i in (0, xs[0] - 1)]
            ok = ok and all(alone)
            note = f", images 0 and {xs[0] - 1} alone = in the batch " \
                f"{alone}"
        torch.cuda.synchronize()
        label = conv_label(xs, fs, s, p, dtype != torch.float32)
        rows.append(("apr_conv", f"{label} tiles bit-equal {same}/"
                     f"{len(tiles)}, {launches} launches{note}", 0.0, ok))
        del x, f, base
    for xs, fs, s, p in CONV_FUSED_CASES:
        x, f = conv_inputs(torch, gen, dev, xs, fs)
        bias = torch.randn(fs[3], generator=gen, device=dev)
        for act in ("relu", "gelu"):
            base = apr_conv2d_fused(x, f, bias, activation=act, stride=s,
                                    padding=p)
            same, launches = held(
                lambda: apr_conv2d_fused.launches, base,
                lambda cfg: apr_conv2d_fused(x, f, bias, activation=act,
                                             stride=s, padding=p, config=cfg))
            torch.cuda.synchronize()
            rows.append(("apr_conv", f"{conv_label(xs, fs, s, p)} {act}, "
                         f"bias: tiles bit-equal {same}/{len(tiles)}, "
                         f"{launches} launches", 0.0,
                         same == len(tiles) and launches == len(tiles)))
    return rows


def cnn_conv_timing(torch, gen, dev, net: str) -> list:
    """Phase 3: ``apr_conv``, ``apr_conv_hbm``, the plain version and
    ``F.conv2d`` (and the fused bias + ReLU epilogue against its plain
    version and library chain) on every distinct conv of ``net`` at
    CNN_BATCH, with the bound, the tile and the baseline's partial bytes;
    inputs of at most 16.8 MB stay in the L2, as one layer's output does
    for the next.  Returns one row a distinct conv (``count``: how often a
    forward runs it)."""
    import torch.nn.functional as F
    from repro_torch.core.apr import reduction_hbm_traffic
    from repro_torch.kernels.apr_conv import (apr_conv2d, apr_conv2d_fused,
                                              conv2d_fused_ref, conv2d_ref)
    from repro_torch.kernels.apr_conv import ops as conv_ops
    from repro_torch.models.cnn import conv_geometries
    conv_rows = {}
    for g in conv_geometries(net, CNN_BATCH):
        key = (g["x_shape"], g["f_shape"], g["stride"], g["padding"])
        if key in conv_rows:
            conv_rows[key]["count"] += 1
            continue
        xs, fs, s, p = key
        x, f = conv_inputs(torch, gen, dev, xs, fs)
        x_cl = x.permute(0, 3, 1, 2)          # NHWC memory: channels-last
        w_cl = f.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        k = fs[0] * fs[1] * fs[2]
        steps = -(-k // conv_ops.K_STEP)
        t_k = cuda_ms(torch, lambda i: apr_conv2d(x, f, stride=s, padding=p),
                      50)
        t_h = cuda_ms(torch, lambda i: apr_conv2d(
            x, f, stride=s, padding=p, residency="hbm"), 20)
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
        resident = conv_ops.blocks_per_sm(x, f, stride=s, padding=p)
        partial_bytes = (reduction_hbm_traffic(out_elems, steps, 4, "hbm")
                         - reduction_hbm_traffic(out_elems, steps, 4, "apr"))
        fused = bound_ms(4 * (x.numel() + f.numel() + fs[3] + out_elems),
                         2 * out_elems * (k + 1), FP32_FLOPS_PER_S)
        conv_rows[key] = dict(
            layer=g["param"], count=1, x_shape=xs, f_shape=fs, stride=s,
            padding=p, K=k, hbm_steps=steps, ms=t_k, hbm_ms=t_h,
            tile=str(conv_ops.default_config(*xs, *fs[:2], fs[3], s, p)),
            blocks_per_sm=resident,
            plain_ms=t_p, library_ms=t_l, partial_bytes=partial_bytes,
            fused_ms=t_f, fused_plain_ms=t_fp, fused_library_ms=t_fl,
            fused_bound_ms=fused["bound_ms"],
            **bound_ms(4 * (x.numel() + f.numel() + out_elems),
                       2 * out_elems * k, FP32_FLOPS_PER_S))
        del x, f, x_cl, w_cl, bias
    conv_rows = list(conv_rows.values())
    print(f"    {net} convs at batch {CNN_BATCH} (CUDA events, warm L2; "
          f"bound: fp32 FMA at {FP32_FLOPS_PER_S / 1e12:g} TFLOP/s or "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s):")
    for r in conv_rows:
        print(f"    {r['layer']:7s} x{r['count']} x={r['x_shape']} "
              f"f={r['f_shape']} s={r['stride']}: apr_conv {r['ms']:.4f} "
              f"apr_conv_hbm {r['hbm_ms']:.4f} ({r['hbm_steps']} steps, "
              f"+{r['partial_bytes'] / 1e6:.1f} MB partials) plain "
              f"{r['plain_ms']:.4f} F.conv2d {r['library_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{r['bound_ms'] / r['ms']:.0%} of bound, tile {r['tile']} "
              f"{r['blocks_per_sm']} blocks an SM; fused bias+relu "
              f"{r['fused_ms']:.4f} plain {r['fused_plain_ms']:.4f} "
              f"F.conv2d+bias,relu {r['fused_library_ms']:.4f} bound "
              f"{r['fused_bound_ms']:.4f}")

    return conv_rows


def ptxas_kernels(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel in an
    ``nvcc -Xptxas -v`` log, by mangled name."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for|$)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            out[name]["smem"] = int(m.group(1))
    return out


def fd_kernel_key(name: str, wide_arg: bool = True) -> str:
    """A ``flash_decode.cu`` kernel's mangled name without its file's
    anonymous-namespace tag and, where the tree's kernels take the
    ``WIDE`` template argument (``wide_arg``), without it when it is false
    (the last argument, ``Lb0E`` before the names' closing ``EEv``), so
    that a tree before wide groups names each of its kernels as this tree
    does."""
    import re
    name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "<anon>", name)
    return name.replace("Lb0EEEv", "EEv") if wide_arg else name


def fd_ptxas(log: str, wide_arg: bool = True) -> dict:
    """The ptxas counts of ``flash_decode.cu``'s split kernels, by
    :func:`fd_kernel_key`."""
    return {fd_kernel_key(n, wide_arg): v
            for n, v in ptxas_kernels(log).items() if "split_kernel" in n}


def matmul_ptxas_ab(parent: Path, out: Path) -> None:
    """``--matmul-ptxas-ab DIR``: build ``apr_matmul.cu`` of this tree and
    of the tree unpacked at ``DIR`` with the build's flags, one nvcc each at
    once, and hold every kernel of the older tree to its registers, spill
    bytes and static shared memory here (names without the file's
    anonymous-namespace tag).  Writes ``out``; fails on any difference."""
    import re
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "apr_matmul_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {tree: subprocess.Popen(
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
         str(src.parent), "-o", str(out_dir / f"lib{tree}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree, src in (("this", _build.CSRC / "apr_matmul.cu"),
                          ("older", parent / "src" / "repro_torch" / "csrc"
                           / "apr_matmul.cu"))}
    kernels = {}
    for tree, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"matmul-ptxas-ab: {tree} tree's apr_matmul.cu did not "
                 f"build:\n{log[-3000:]}")
        kernels[tree] = {
            re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "<anon>", n): v
            for n, v in ptxas_kernels(log).items()}
    this, older = kernels["this"], kernels["older"]
    differ = {k: (v, this.get(k)) for k, v in older.items()
              if this.get(k) != v}
    new = {k: v for k, v in this.items() if k not in older}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(older=older, this=this, differ=differ,
                                   new=new), indent=1))
    print(f"[ptxas-ab] apr_matmul.cu: {len(older) - len(differ)}/"
          f"{len(older)} kernels of the older tree with the same registers, "
          f"spills and shared memory here; {len(new)} new:")
    for k, v in new.items():
        print(f"    {k[:90]}: {v}")
    if differ:
        fail(f"matmul-ptxas-ab: kernels differ from the older tree's: "
             f"{differ}")


def decode_ab(torch, parent: Path, out: Path) -> None:
    """``--decode-ab DIR``: build ``flash_decode.cu`` of this tree and of
    the tree unpacked at ``DIR`` with the same flags, and hold the kernels
    of groups up to 8 to the older tree's: every one of its split kernels
    compiled here with the same registers, spill bytes and static shared
    memory, and every phase-2 case of B2, B2q and B3 at G <= 8 (each
    dtype, every split count) giving the same output bits, from the same
    inputs (this tree, the older one, this tree again).  Then the wide
    cases (G = 12, 16) on this tree against the plain version.  Writes
    ``out``; fails on any difference."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops as fd
    dev = torch.device("cuda")
    out_dir = _build.BUILD_DIR / "flash_decode_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    # both trees' sources, one nvcc each at once, with the build's flags
    # (a library this tree built before has no ptxas log to read)
    procs = {tree: subprocess.Popen(
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
         str(src.parent), "-o", str(out_dir / f"lib{tree}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree, src in (("this", _build.CSRC / "flash_decode.cu"),
                          ("older", parent / "src" / "repro_torch" / "csrc"
                           / "flash_decode.cu"))}
    libs, logs = {}, {}
    for tree, proc in procs.items():
        logs[tree], _ = proc.communicate()
        if proc.returncode:
            fail(f"decode-ab: {tree} tree's flash_decode.cu did not build:"
                 f"\n{logs[tree][-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"lib{tree}.so"))
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        for fn, (restype, argtypes) in fd.SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[tree] = lib
    new_lib, old_lib = libs["this"], libs["older"]
    new_k = fd_ptxas(logs["this"])
    old_k = fd_ptxas(logs["older"], wide_arg=False)
    differ = {k: (v, new_k.get(k)) for k, v in old_k.items()
              if new_k.get(k) != v}
    wide_k = {k: v for k, v in new_k.items() if k not in old_k}
    narrow = lambda cases: [c for c in cases if c[1] // c[2] <= 8]
    wide = lambda cases: [c for c in cases if c[1] // c[2] > 8]

    def run(lib) -> dict:
        _build._LIBS[fd.LIBRARY] = lib
        gen = torch.Generator(device=dev).manual_seed(0)
        d2 = paged_correctness(torch, gen, dev, narrow(PAGED_CASES))[2]
        d3 = contig_correctness(torch, gen, dev, narrow(B3_CASES))[2]
        torch.cuda.synchronize()
        return {**d2, **d3}

    try:
        digests = [run(new_lib), run(old_lib), run(new_lib)]
        gen = torch.Generator(device=dev).manual_seed(1)
        wide_cases = (
            paged_correctness(torch, gen, dev, wide(PAGED_CASES))[0]
            + contig_correctness(torch, gen, dev, wide(B3_CASES))[0])
    finally:
        _build._LIBS.pop(fd.LIBRARY, None)
    bits_differ = sorted(k for k in digests[0]
                         if len({d[k] for d in digests}) != 1)
    failing = [c for c in wide_cases if not c[3]]
    res = dict(parent=str(parent), old_kernels=len(old_k),
               new_kernels=len(new_k), ptxas_differ=differ,
               ptxas_old=old_k, ptxas_wide=wide_k,
               narrow_outputs=len(digests[0]), bits_differ=bits_differ,
               wide_cases=[dict(kernel=n, case=c, max_abs_err=e, ok=o)
                           for n, c, e, o in wide_cases])
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"[decode-ab] ptxas: {len(old_k)} split kernels in {parent}, "
          f"{len(new_k)} here ({len(wide_k)} wide); counts differ in "
          f"{len(differ)}: {list(differ.items())[:4]}")
    for k, v in sorted(wide_k.items()):
        print(f"    wide: {k[:100]} {v}")
    print(f"[decode-ab] {len(digests[0])} G <= 8 outputs (B2, B2q, B3, every "
          f"dtype and split count): bits differ in {len(bits_differ)} "
          f"(this tree, the older one, this tree again): "
          f"{bits_differ[:4]}")
    for n, c, e, o in wide_cases:
        print(f"    {'ok  ' if o else 'FAIL'} {n:28s} {c} max_abs_err={e:.3g}")
    if not old_k or len(old_k) != len(new_k) - len(wide_k) or differ:
        fail("decode-ab: the G <= 8 kernels' ptxas counts differ")
    if bits_differ or failing:
        fail(f"decode-ab: {len(bits_differ)} G <= 8 outputs differ, "
             f"{len(failing)} wide cases fail")


#: the baseline kernels whose SASS ``--baseline`` keeps (mangled-name
#: fragments): B4m at the default tile and on the fp32 body (M <= 4), both
#: on aligned operands, and B4c on fp32 inputs at 16 channels (its name in
#: this tree and in older ones)
BASELINE_SASS = ("apr_matmul_kernelILi16ELi64ELi64ELb1ELb1E",
                 "f32_kernelIfLi64ELi64ELi4ELb1ELb1E",
                 "conv_kernelIfLi16ELb1E", "conv_hbm_kernelIfLi16E")
#: the APR conv kernel on fp32 inputs, whose K-loop opcodes ``--baseline``
#: counts (the tile's template arguments follow it)
CONV_APR_SASS = "conv_apr_kernelIf"


def conv_apr_sass(lib: Path, path: Path) -> dict:
    """``cuobjdump -sass`` of ``lib``'s fp32 APR conv kernels into
    ``path``; returns each one's inner-loop opcode counts (the loop that
    holds its FFMAs, :func:`sass_loop_ops`)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    res = subprocess.run([str(tool if tool.exists() else "cuobjdump"),
                          "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    kept, counts = [], {}
    for sec in res.stdout.split("Function : ")[1:]:
        name = sec.split(None, 1)[0]
        if CONV_APR_SASS in name:
            kept.append("Function : " + sec)
            counts[name] = sass_loop_ops(sec, "FFMA")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(kept) + res.stderr)
    return counts


def baseline_sass(lib: Path, path: Path) -> dict:
    """``cuobjdump -sass`` of ``lib``, cut to the functions that
    :data:`BASELINE_SASS` names, into ``path``; returns each kept
    function's count of global loads and stores by opcode."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    res = subprocess.run([str(tool if tool.exists() else "cuobjdump"),
                          "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    kept, counts = [], {}
    for section in res.stdout.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if not any(frag in name for frag in BASELINE_SASS):
            continue
        kept.append("Function : " + section)
        ops = {}
        for line in section.splitlines():
            words = line.split("*/")
            tokens = words[1].split() if len(words) > 1 else []
            if tokens and tokens[0].startswith("@"):    # a predicate
                tokens = tokens[1:]
            if tokens:
                op = tokens[0]
                if op.startswith(("LDG", "STG")):
                    ops[op] = ops.get(op, 0) + 1
        counts[name] = ops
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(kept) + res.stderr)
    return counts


def baseline_sweep(torch, out: Path) -> None:
    """``--baseline``: the paper's comparison on this tree's kernels -- the
    memory-resident baselines against their APR kernels.  B4m against B1
    (default tile; B1 at its default split count and at one split) at the
    llama3-8b projection shapes, M = 4, weights rotated past the L2, per
    call and per tick; B4c against B5 at every distinct ResNet-20 conv at
    batch CNN_BATCH, per forward; the launches a call of each baseline
    makes (the stream's pre-fill scales with them, so that a tree whose
    baseline launches once per K step is timed as fairly); the digest of
    every phase-2 conv case's output (:func:`conv_correctness`); and the
    SASS of the baseline kernels (cuobjdump, into ``out``'s directory).  It
    uses only entry points every version of the port has, so a copy of
    this script beside an older tree times and digests that tree's
    kernels.  Writes ``out``."""
    from repro_torch.core.apr import reduction_hbm_traffic
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_conv import apr_conv2d, apr_conv2d_fused
    from repro_torch.kernels.apr_conv import ops as conv_ops
    from repro_torch.kernels.apr_matmul import ops as mm
    from repro_torch.models.cnn import conv_geometries
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all({mm.LIBRARY: mm.SIGNATURES,
                      conv_ops.LIBRARY: conv_ops.SIGNATURES})
    bf16 = torch.bfloat16
    rows = []

    def launches_per_call(counter, fn):
        before = counter()
        fn(0)
        torch.cuda.synchronize()
        return counter() - before

    for k, n in LLAMA_DECODE_SHAPES:
        m = 4
        nbuf = min(32, max(1, math.ceil(200e6 / (k * n * 2))))
        ws = [(torch.randn((k, n), generator=gen, device=dev)
               * k ** -0.5).to(bf16) for _ in range(nbuf)]
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        calls = launches_per_call(lambda: mm.apr_matmul.hbm_launches,
                                  lambda i: mm.apr_matmul(
                                      x, ws[0], residency="hbm"))
        t_h = cuda_ms(torch, lambda i: mm.apr_matmul(
            x, ws[i % nbuf], out_dtype=bf16, residency="hbm"), 20,
            fill=2e5 * calls)
        t_b1 = cuda_ms(torch, lambda i: mm.apr_matmul(
            x, ws[i % nbuf], out_dtype=bf16), 60)
        t_b1s = cuda_ms(torch, lambda i: mm.apr_matmul(
            x, ws[i % nbuf], out_dtype=bf16, splits=1), 60)
        steps = -(-k // mm.DEFAULT_TILE[2])
        rows.append(dict(
            kernel="apr_matmul_hbm", M=m, K=k, N=n,
            per_tick=32 * LLAMA_DECODE_SHAPES[(k, n)],
            launches_per_call=calls, ms=t_h, apr_ms=t_b1,
            apr_one_split_ms=t_b1s, hbm_steps=steps, partial_bytes=(
                reduction_hbm_traffic(m * n, steps, 2, "hbm")
                - reduction_hbm_traffic(m * n, steps, 2, "apr"))))
        del ws, x
    for g in conv_geometries("resnet20", CNN_BATCH):
        key = (g["x_shape"], g["f_shape"], g["stride"], g["padding"])
        row = next((r for r in rows if r.get("key") == key), None)
        if row is not None:
            row["per_forward"] += 1
            continue
        xs, fs, s, p = key
        x, f = conv_inputs(torch, gen, dev, xs, fs)
        calls = launches_per_call(lambda: apr_conv2d.hbm_launches,
                                  lambda i: apr_conv2d(
                                      x, f, stride=s, padding=p,
                                      residency="hbm"))
        t_h = cuda_ms(torch, lambda i: apr_conv2d(
            x, f, stride=s, padding=p, residency="hbm"), 20,
            fill=2e5 * calls)
        t_k = cuda_ms(torch, lambda i: apr_conv2d(x, f, stride=s, padding=p),
                      50)
        bias = torch.randn(fs[3], generator=gen, device=dev)
        t_f = cuda_ms(torch, lambda i: apr_conv2d_fused(
            x, f, bias, activation="relu", stride=s, padding=p), 50)
        # every APR tile, where this tree's conv kernel has several
        t_tiles = {}
        for cfg in getattr(conv_ops, "APR_CONFIGS", ()):
            t_tiles[f"{cfg['block_m']}x{cfg['block_n']}"] = cuda_ms(
                torch, lambda i: apr_conv2d(x, f, stride=s, padding=p,
                                            config=cfg), 50)
        k = fs[0] * fs[1] * fs[2]
        steps = -(-k // conv_ops.K_STEP)
        out_elems = CNN_BATCH * fs[3] * ((xs[1] + 2 * p - fs[0]) // s + 1) \
            * ((xs[2] + 2 * p - fs[1]) // s + 1)
        rows.append(dict(
            kernel="apr_conv_hbm", key=key, layer=g["param"], per_forward=1,
            launches_per_call=calls, ms=t_h, apr_ms=t_k, fused_ms=t_f,
            tile_ms=t_tiles, hbm_steps=steps,
            partial_bytes=(reduction_hbm_traffic(out_elems, steps, 4, "hbm")
                           - reduction_hbm_traffic(out_elems, steps, 4,
                                                   "apr"))))
        del x, f, bias
    totals = {}
    for r in rows:
        weight = r.get("per_tick", r.get("per_forward"))
        t = totals.setdefault(r["kernel"], {})
        for key in ("ms", "apr_ms", "apr_one_split_ms", "fused_ms",
                    "partial_bytes", "launches_per_call"):
            if key in r:
                t[key] = t.get(key, 0) + weight * r[key]
        for tile, ms in r.get("tile_ms", {}).items():
            t.setdefault("tile_ms", {})[tile] = \
                t.get("tile_ms", {}).get(tile, 0) + weight * ms
        r.pop("key", None)
    for r in rows:
        shape = (f"M={r['M']} K={r['K']} N={r['N']}" if "M" in r
                 else f"{r['layer']} x{r['per_forward']}")
        print(f"    {r['kernel']:15s} {shape:28s} {r['ms']:.4f} ms "
              f"({r['launches_per_call']} launches a call, "
              f"{r['hbm_steps']} K steps, +{r['partial_bytes'] / 1e6:.3f} "
              f"MB of partials); APR {r['apr_ms']:.4f} ms: "
              f"x{r['ms'] / r['apr_ms']:.2f}"
              + (f"; fused bias+relu {r['fused_ms']:.4f} ms"
                 if "fused_ms" in r else "")
              + "".join(f"; tile {k_} {v:.4f}"
                        for k_, v in r.get("tile_ms", {}).items()))
    for name, t in totals.items():
        unit = "tick (224 projections)" if name == "apr_matmul_hbm" \
            else "ResNet-20 forward (21 convs)"
        print(f"    {name} per {unit}: {t['ms']:.3f} ms, APR "
              f"{t['apr_ms']:.3f} ms (x{t['ms'] / t['apr_ms']:.2f})"
              + (f", B1 at one split {t['apr_one_split_ms']:.3f} ms"
                 if "apr_one_split_ms" in t else "")
              + (f", APR fused bias+relu {t['fused_ms']:.3f} ms"
                 if "fused_ms" in t else "")
              + "".join(f", tile {k_} {v:.3f} ms"
                        for k_, v in t.get("tile_ms", {}).items())
              + f", {t['launches_per_call']:.0f} launches, "
              f"{t['partial_bytes'] / 1e9:.3f} GB of partials")
    conv_cases, digests = conv_correctness(torch, gen, dev)
    print(f"    phase-2 conv cases: {len(conv_cases)}, failing (tolerance, "
          f"or not one launch a call) {sum(not ok for *_, ok in conv_cases)}")
    sass = {lib: baseline_sass(_build._target(lib),
                               out.parent / f"{out.stem}_sass_{lib}.txt")
            for lib in (mm.LIBRARY, conv_ops.LIBRARY)}
    for lib, funcs in sass.items():
        for name, ops in funcs.items():
            print(f"    SASS {lib} {name[:70]}: {ops}")
    apr_sass = conv_apr_sass(_build._target(conv_ops.LIBRARY),
                             out.parent / f"{out.stem}_sass_conv_apr.txt")
    for name, ops in apr_sass.items():
        print(f"    SASS conv APR loop {name[:60]}: {ops}")
    regs = {k_: v for k_, v in ptxas_kernels(_build.BUILD_LOGS.get(
        conv_ops.LIBRARY, "")).items() if "conv" in k_}
    for name, r in regs.items():
        print(f"    ptxas {name[:70]}: {r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=smi, timing=rows, totals=totals, conv_digests=digests,
        conv_cases=conv_cases, sass=sass, conv_apr_sass=apr_sass,
        ptxas=regs), indent=1))


# ------------------ the graph compiler's path (B6, B7, B7m, B8 served)
#: LeNet-5's FC layers (K, N): the graph path's B7m clusters (relu, no
#: bias, fp32) at CNN_BATCH rows
LENET_FC = ((400, 120), (120, 84))
#: the head's rows on the graph path: the 4-slot decode tick and a prefill
#: chunk (B6 / B8 at LM_HEAD, bf16 x)
HEAD_MS = (4, 16)


def relu_convs(batch: int) -> list:
    """ResNet-20's convs whose output feeds a relu alone -- the first conv
    and each block's c1, the graph compiler's ten B7 clusters -- at
    ``batch`` (:func:`conv_geometries`' dicts)."""
    from repro_torch.models.cnn import conv_geometries
    return [g for g in conv_geometries("resnet20", batch)
            if g["param"] == "conv1" or g["param"].endswith("c1")]


def graph_kernel_checks(torch, gen, dev) -> list:
    """Phase 2 at the graph path's shapes: B7m (``apr_matmul_fused``, relu,
    no bias, fp32) at LeNet-5's FC layers within the fp32 bound; B7
    (``apr_conv2d_fused``, relu, no bias) at ResNet-20's ten relu convs at
    CNN_BATCH within the conv bound; B6 and B8 (activation none and relu)
    at the head's shape, bf16 x and out, bit for bit against their plain
    versions (as phase 2 holds them at the projections).  One case a
    (kernel, shape)."""
    from repro_torch.kernels.apr_conv import (apr_conv2d_fused,
                                              conv2d_fused_ref)
    from repro_torch.kernels.apr_matmul import apr_matmul_fused
    from repro_torch.kernels.apr_matmul.ref import matmul_fused_ref
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_fused,
                                                  quant_matmul_fused_ref,
                                                  quant_matmul_ref)
    from repro_torch.quant import quantize_channelwise
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for k, n in LENET_FC:
        x = torch.randn((CNN_BATCH, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        got = apr_matmul_fused(x, w, activation="relu", out_dtype=f32)
        ref = matmul_fused_ref(x, w, None, "relu", f32)
        sums = torch.matmul(x.abs(), w.abs())
        err, ok = f32_err(got, ref, F32_MM_SLACK * k * 2.0 ** -24 * sums
                          + F32_MM_ULPS * 2.0 ** -24 * ref.abs())
        cases.append(("apr_matmul_fused_f32", f"graph path: LeNet-5 FC "
                      f"M={CNN_BATCH} K={k} N={n} relu", err, ok))
    for g in relu_convs(CNN_BATCH):
        xs, fs, s, p = g["x_shape"], g["f_shape"], g["stride"], g["padding"]
        x, f = conv_inputs(torch, gen, dev, xs, fs)
        got = apr_conv2d_fused(x, f, activation="relu", stride=s, padding=p)
        ref = conv2d_fused_ref(x, f, None, "relu", stride=s, padding=p)
        err, ok = conv_err(got, ref)
        cases.append(("apr_conv_fused", f"graph path: ResNet-20 {g['param']} "
                      f"{conv_label(xs, fs, s, p)} relu", err, ok))
        del x, f, got, ref
    k, n = LM_HEAD
    w = quantize_channelwise((torch.randn((k, n), generator=gen, device=dev)
                              * k ** -0.5).to(bf16))
    for m in HEAD_MS:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        for name, got, ref in (
                ("quant_matmul", quant_matmul(x, w, out_dtype=bf16),
                 quant_matmul_ref(x, w.q, w.scale, bf16)),
                ("quant_matmul_fused", quant_matmul_fused(
                    x, w, activation="none", out_dtype=bf16),
                 quant_matmul_fused_ref(x, w.q, w.scale, None, "none", bf16)),
                ("quant_matmul_fused", quant_matmul_fused(
                    x, w, activation="relu", out_dtype=bf16),
                 quant_matmul_fused_ref(x, w.q, w.scale, None, "relu",
                                        bf16))):
            err = float((got.float() - ref.float()).abs().max())
            cases.append((name, f"graph path: head M={m} K={k} N={n}",
                          err, bool(torch.equal(got, ref))))
    return cases


def graph_fused_timing(torch, gen, dev) -> dict:
    """The graph path's fused kernels per forward, CUDA events: B7m (fp32,
    relu, no bias) over LeNet-5's two FC layers at CNN_BATCH and B7 (relu,
    no bias) over ResNet-20's ten relu convs, each beside its plain version,
    its bound (fp32 FMA or memory) and the one PyTorch call that computes a
    product and its relu: ``torch._addmm_activation`` over a zero bias
    (cuBLASLt's relu epilogue) and ``torch.cudnn_convolution_relu`` on the
    channels-last views, as phase 3 times ``F.conv2d``.  Where cuDNN
    refuses the fused call, ``F.relu(F.conv2d(...))`` is timed instead and
    ``library_call`` says so."""
    import torch.nn.functional as F
    from repro_torch.kernels.apr_conv import (apr_conv2d_fused,
                                              conv2d_fused_ref)
    from repro_torch.kernels.apr_matmul import apr_matmul_fused
    from repro_torch.kernels.apr_matmul.ref import matmul_fused_ref
    f32 = torch.float32
    out = {}
    calls = {}
    rows = []
    for k, n in LENET_FC:
        x = torch.randn((CNN_BATCH, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        zero = torch.zeros(n, device=dev)
        rows.append(dict(
            ms=cuda_ms(torch, lambda i: apr_matmul_fused(
                x, w, activation="relu", out_dtype=f32), 50),
            plain_ms=cuda_ms(torch, lambda i: matmul_fused_ref(
                x, w, None, "relu", f32), 50),
            library_ms=cuda_ms(torch, lambda i: torch._addmm_activation(
                zero, x, w), 50),
            nbytes=4 * (CNN_BATCH * k + k * n + CNN_BATCH * n),
            flops=2 * CNN_BATCH * k * n))
    out["apr_matmul_fused_f32"] = rows
    calls["apr_matmul_fused_f32"] = "torch._addmm_activation (zero bias)"

    def conv_relu(x_cl, w_cl, s, p):
        return torch.cudnn_convolution_relu(x_cl, w_cl, None, (s, s), (p, p),
                                            (1, 1), 1)
    try:
        g = relu_convs(CNN_BATCH)[0]
        x, f = conv_inputs(torch, gen, dev, g["x_shape"], g["f_shape"])
        got = conv_relu(x.permute(0, 3, 1, 2), f.permute(3, 2, 0, 1)
                        .contiguous(memory_format=torch.channels_last),
                        g["stride"], g["padding"]).permute(0, 2, 3, 1)
        ref = conv2d_fused_ref(x, f, None, "relu", stride=g["stride"],
                               padding=g["padding"])
        if not torch.allclose(got, ref, rtol=1e-4, atol=1e-4):
            raise RuntimeError("its result differs from relu(conv)")
        calls["apr_conv_fused"] = "torch.cudnn_convolution_relu"
    except RuntimeError as e:
        print(f"    cudnn_convolution_relu refused ({str(e)[:120]}); timing "
              f"F.relu(F.conv2d) instead")

        def conv_relu(x_cl, w_cl, s, p):                    # noqa: F811
            return F.relu(F.conv2d(x_cl, w_cl, stride=s, padding=p))
        calls["apr_conv_fused"] = "F.relu(F.conv2d) (two calls)"
    rows = []
    for g in relu_convs(CNN_BATCH):
        xs, fs, s, p = g["x_shape"], g["f_shape"], g["stride"], g["padding"]
        x, f = conv_inputs(torch, gen, dev, xs, fs)
        x_cl = x.permute(0, 3, 1, 2)          # NHWC memory: channels-last
        w_cl = f.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        n_out = CNN_BATCH * ((xs[1] + 2 * p - fs[0]) // s + 1) \
            * ((xs[2] + 2 * p - fs[1]) // s + 1) * fs[3]
        rows.append(dict(
            ms=cuda_ms(torch, lambda i: apr_conv2d_fused(
                x, f, activation="relu", stride=s, padding=p), 50),
            plain_ms=cuda_ms(torch, lambda i: conv2d_fused_ref(
                x, f, None, "relu", stride=s, padding=p), 50),
            library_ms=cuda_ms(torch, lambda i: conv_relu(x_cl, w_cl, s, p),
                               50),
            nbytes=4 * (x.numel() + f.numel() + n_out),
            flops=2 * n_out * fs[0] * fs[1] * fs[2]))
        del x, f, x_cl, w_cl
    out["apr_conv_fused"] = rows
    totals = {}
    for name, rs in out.items():
        nbytes = sum(r["nbytes"] for r in rs)
        flops = sum(r["flops"] for r in rs)
        totals[name] = dict(
            ms=sum(r["ms"] for r in rs),
            plain_ms=sum(r["plain_ms"] for r in rs),
            library_ms=sum(r["library_ms"] for r in rs),
            library_call=calls[name],
            launches_per_forward=len(rs), nbytes=nbytes, flops=flops,
            **bound_ms(nbytes, flops, FP32_FLOPS_PER_S))
    return totals


def graph_summary(executors) -> dict:
    """Node and cluster counts, the schedule and its bytes of each
    compiled step (``{label: GraphExecutor}``)."""
    out = {}
    for label, ex in executors.items():
        g = ex.graph
        body = [b for n in g.nodes for b in n.body_nodes()]
        d = ex.schedule
        out[label] = dict(
            nodes=len(g.nodes), clusters=sum(n.is_fused for n in g.nodes),
            primitive_ops=len(body),
            matmul=sum(b.op == "matmul" for b in body),
            quant_matmul=sum(b.op == "quant_matmul" for b in body),
            conv2d=sum(b.op == "conv2d" for b in body),
            kernel_clusters=[list(c) for c in ex.kernel_clusters()],
            dispatched=sorted(ex.dispatched.values()),
            passes=None if d is None else d.passes,
            traffic_unfused=None if d is None
            else d.unfused.intermediate_traffic,
            traffic_fused=None if d is None
            else d.fused.intermediate_traffic,
            traffic_reduction=None if d is None else d.traffic_reduction,
            const_bytes=g.const_bytes())
    return out


def print_graph_summary(summary) -> None:
    for label, s in summary.items():
        print(f"    {label} graph: {s['nodes']} nodes ({s['clusters']} "
              f"clusters, {s['primitive_ops']} ops: {s['matmul']} matmul, "
              f"{s['quant_matmul']} quant_matmul, {s['conv2d']} conv2d), "
              f"schedule {s['passes']}, intermediate traffic "
              f"{s['traffic_unfused']} -> {s['traffic_fused']} B"
              + (f" ({s['traffic_reduction']:.3f}x less)"
                 if s["traffic_reduction"] else "")
              + f", consts {s['const_bytes'] / 1e9:.2f} GB by reference; "
              f"fused kernels: {s['dispatched'] or 'none'}")


def quant_head_bound(torch, x, w, logits_a, logits_b):
    """Whether the int8 x int8 head (dynamic per-row activation codes) and
    the int8-weight one (bf16 activations over the weight dequantized to
    bf16) agree within what the activation quantization allows, row by row
    and column by column: |a - b| <= sum_k (s_row / 2 + 2^-8 |x_k|) |W_kn|
    + K 2^-23 sum_k |x_k| |W_kn| + 2^-8 (|a| + |b|), with s_row = max |x| /
    127 the row's code step (half a step is the largest rounding of a
    code), 2^-8 the bf16 rounding of the dequantized weight and of each
    output, and the last fp32 sums' order.  Returns (max |a - b|, the
    largest share of its bound used, whether every element is inside)."""
    xf = x.float().reshape(-1, x.shape[-1])
    wd = w.dequantize(torch.float32).abs()
    step = xf.abs().amax(dim=-1, keepdim=True) / 127
    sums = torch.matmul(xf.abs(), wd)
    bound = (step / 2) * wd.sum(dim=0)[None] + (2.0 ** -8 + xf.shape[-1]
                                                 * 2.0 ** -23) * sums
    a = logits_a.float().reshape(bound.shape)
    b = logits_b.float().reshape(bound.shape)
    bound = bound + 2.0 ** -8 * (a.abs() + b.abs())
    diff = (a - b).abs()
    return (float(diff.max()), float((diff / bound).max()),
            bool((diff <= bound).all()))


def graph_head_tick(torch, engine, dec, forward, qparams, tick_args) -> dict:
    """One decode tick of an int8-weight graph engine (``dec``, its decode
    executor) and of the plain step (``forward``), on copies of the
    engine's pools.  The folded head's call is captured (its wrapper, input
    and output), and so is the plain step's head input.  Returns whether
    the head's output equals its plain version on the captured input and
    the model's int8 head bit for bit (phase 2: B6 and B8 equal theirs at
    the head's shape), whether
    that input equals the plain step's head input bit for bit, whether the
    pools written are equal, and the logits' distance from the plain
    step's (B1's int8-weight head) within the bound of the head's
    activation quantization (:func:`quant_head_bound`)."""
    import repro_torch.kernels.quant_matmul as qmm_pkg
    from repro_torch.kernels.quant_matmul.ref import (quant_matmul_fused_ref,
                                                      quant_matmul_ref)
    from repro_torch.models import layers as lm_layers
    head_w = qparams.get("lm_head")
    qnode = next(n for n in dec.graph.nodes
                 if any(b.op == "quant_matmul" for b in n.body_nodes()))
    built = dec._compiled.pop(qnode.id, None)
    graph_head, plain_head = [], []
    wrappers = {"quant_matmul": qmm_pkg.quant_matmul,
                "quant_matmul_fused": qmm_pkg.quant_matmul_fused}
    apr_mm = lm_layers.apr_matmul

    def capturing(name):
        def run(*a, **kw):
            y = wrappers[name](*a, **kw)
            graph_head.append((name, a, kw, y))
            return y
        return run

    def plain_capture(x, w, **kw):
        if w is head_w:
            plain_head.append(x)
        return apr_mm(x, w, **kw)
    caches = [{k: v.clone() for k, v in engine.cache.items()}
              for _ in range(2)]
    try:
        for name in wrappers:
            setattr(qmm_pkg, name, capturing(name))
        dec._fn_for(qnode)                  # rebuilt on the capturing names
        lm_layers.apr_matmul = plain_capture
        plain_logits = forward(qparams, caches[0], *tick_args)
        lm_layers.apr_matmul = apr_mm
        graph_logits = engine._decode_step(qparams, caches[1], *tick_args)
    finally:
        lm_layers.apr_matmul = apr_mm
        for name, fn in wrappers.items():
            setattr(qmm_pkg, name, fn)
        dec._compiled.pop(qnode.id, None)
        if built is not None:
            dec._compiled[qnode.id] = built
    out = dict(head_calls=len(graph_head), plain_head_calls=len(plain_head),
               head_wrapper=None, head_equal_plain_version=False,
               head_max_abs_err=None, head_input_equal_plain_step=False,
               max_abs_diff=float("nan"), largest_bound_share=float("nan"),
               within_bound=False)
    if len(graph_head) == 1 and len(plain_head) == 1:
        name, a, kw, y = graph_head[0]
        x2d = a[0]
        # the model's own int8 head and the plain step's dtype, not the
        # operands the graph passed
        dtype = plain_head[0].dtype
        if name == "quant_matmul":
            ref = quant_matmul_ref(x2d, head_w.q, head_w.scale, dtype)
        else:
            ref = quant_matmul_fused_ref(x2d, head_w.q, head_w.scale,
                                         kw.get("bias"),
                                         kw.get("activation", "none"), dtype)
        err, share, inside = quant_head_bound(torch, x2d, head_w,
                                              graph_logits, plain_logits)
        out.update(
            head_wrapper=name, head_equal_plain_version=bool(
                y.dtype == ref.dtype and torch.equal(y, ref)),
            head_max_abs_err=float((y.float() - ref.float()).abs().max()),
            head_input_equal_plain_step=bool(torch.equal(
                x2d, plain_head[0].reshape(x2d.shape))),
            max_abs_diff=err, largest_bound_share=share, within_bound=inside)
    out.update(
        argmax_equal=int((graph_logits.argmax(-1)
                          == plain_logits.argmax(-1)).sum()),
        rows=int(plain_logits.shape[0]),
        pools_equal=all(torch.equal(caches[0][k], caches[1][k])
                        for k in engine.cache))
    return out


# ------------------------------------------------ the training path (B1)
#: llama3-8b's projections (K, N) by name, each once a layer, and its head
#: once a step: phase 9a's shapes and phase 9d's model
TRAIN_PROJ = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
              "o": (4096, 4096), "gate": (4096, 14336),
              "up": (4096, 14336), "down": (14336, 4096)}
TRAIN_HEAD = (4096, 128256)
#: phase 9a's shapes also checked on the fp32 body
TRAIN_F32 = ("k", "down")
#: phase 9d's batch (B rows of T tokens: M = 1024 rows a projection) and
#: depth (llama3-8b at full width, its 32 layers cut to 4: 1.923 B
#: parameters, 30.8 GB of bf16 params, bf16 grads and fp32 AdamW state)
TRAIN_B, TRAIN_T = 2, 512
TRAIN_LAYERS = 4
TRAIN_STEPS = 5
#: B1 launches a full-width step: the forward's 7 projections a layer and
#: the head, the remat recompute's 7 a layer, dX and dW of each
TRAIN_FWD_LAUNCHES = 7 * TRAIN_LAYERS + 1
TRAIN_RECOMPUTE_LAUNCHES = 7 * TRAIN_LAYERS
TRAIN_BWD_LAUNCHES = 2 * TRAIN_FWD_LAUNCHES
#: phase 9b: bounds on |card - CPU| / |CPU| of each step's loss and grad
#: norm.  bf16: the card's B1 (and its backward) sums in another order
#: than the CPU's plain products and lands one bf16 ulp apart now and
#: then, which the steps compound; fp32 params at step 0: sums in another
#: order only (the loss, the grad norm, each grad leaf against its max)
TRAIN_BF16_LOSS_RTOL = 1e-2
TRAIN_BF16_GNORM_RTOL = 2e-2
TRAIN_F32_RTOL = 1e-3
#: phase 9b's smoke batch (B rows of T tokens) and hyperparameters
TRAIN_SMOKE_SHAPE = (64, 4)
TRAIN_SMOKE_HYPER = dict(peak_lr=1e-2, warmup=2, total_steps=10)
#: phase 9c: the launcher, first run, resumed run, checkpoint period
TRAIN_CLI_STEPS = (20, 10, 10)


def train_matmul_checks(torch, gen, dev, m: int = TRAIN_B * TRAIN_T,
                        shapes=None) -> list:
    """Phase 9a: B1 under autograd (``AprMatmulFunction``) at llama3-8b's
    projections and head at M = ``m`` rows, bf16 (and fp32 at
    :data:`TRAIN_F32`): dX and dW of the Function against torch autograd
    through ``matmul_ref`` on the card, each within phase 2's B1 bound
    (:func:`max_err`).  Operands at the training path's scales: x of unit
    variance (a normed activation), w at its init scale (K^-0.5), dY of
    unit variance.  Then each product alone by CUDA events: the forward
    ``apr_matmul(x, w)``, dX ``apr_matmul(dY, Wᵀ)`` and dW
    ``apr_matmul(Xᵀ, dY)`` on their contiguous transposes, the two
    transposes' copies apart, the plain products (``matmul_ref`` on the
    transposed views) and ``torch.matmul`` on the same operands (the
    library, which takes the transposes as views); one bound for each
    product (the same bytes and operations)."""
    from repro_torch.kernels.apr_matmul import (AprMatmulFunction,
                                                apr_matmul, matmul_ref)
    if shapes is None:
        shapes = [(name, k, n, torch.bfloat16)
                  for name, (k, n) in TRAIN_PROJ.items()]
        shapes.append(("head", *TRAIN_HEAD, torch.bfloat16))
        shapes += [(name, *TRAIN_PROJ[name], torch.float32)
                   for name in TRAIN_F32]
    rows = []
    for name, k, n, dtype in shapes:
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(dtype)
        dy = torch.randn((m, n), generator=gen, device=dev).to(dtype)
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        AprMatmulFunction.apply(xa, wa, dtype).backward(dy)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        matmul_ref(xr, wr, dtype).backward(dy)
        dx_err, dx_ok = max_err(xa.grad, xr.grad)
        dw_err, dw_ok = max_err(wa.grad, wr.grad)
        del xa, wa, xr, wr
        wt, xt = w.t().contiguous(), x.t().contiguous()
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else FP32_FLOPS_PER_S
        row = dict(name=name, M=m, K=k, N=n, dtype=str(dtype)[6:],
                   dx_err=dx_err, dw_err=dw_err, ok=dx_ok and dw_ok,
                   **bound_ms((m * k + k * n + m * n) * x.element_size(),
                              2.0 * m * k * n, peak))
        products = {
            "fwd": (lambda i: apr_matmul(x, w, out_dtype=dtype),
                    lambda i: matmul_ref(x, w, dtype),
                    lambda i: torch.matmul(x, w)),
            "dx": (lambda i: apr_matmul(dy, wt, out_dtype=dtype),
                   lambda i: matmul_ref(dy, w.t(), dtype),
                   lambda i: torch.matmul(dy, w.t())),
            "dw": (lambda i: apr_matmul(xt, dy, out_dtype=dtype),
                   lambda i: matmul_ref(x.t(), dy, dtype),
                   lambda i: torch.matmul(x.t(), dy))}
        for p, (kernel, plain, lib) in products.items():
            row[f"{p}_ms"] = cuda_ms(torch, kernel, 5)
            row[f"plain_{p}_ms"] = cuda_ms(torch, plain, 3, warmup=1)
            row[f"library_{p}_ms"] = cuda_ms(torch, lib, 5)
        row["wt_ms"] = cuda_ms(torch, lambda i: w.t().contiguous(), 5)
        row["xt_ms"] = cuda_ms(torch, lambda i: x.t().contiguous(), 5)
        rows.append(row)
        print(f"    9a {name:>4} {row['dtype']:>8} M={m} K={k} N={n}: "
              f"|dX - plain| {dx_err:.3g}, |dW - plain| {dw_err:.3g} "
              f"({'ok' if row['ok'] else 'FAILED'}); ms fwd "
              f"{row['fwd_ms']:.3f} dX {row['dx_ms']:.3f} dW "
              f"{row['dw_ms']:.3f} (torch.matmul {row['library_fwd_ms']:.3f}"
              f" / {row['library_dx_ms']:.3f} / {row['library_dw_ms']:.3f}; "
              f"plain {row['plain_dx_ms']:.3f} / {row['plain_dw_ms']:.3f}), "
              f"transposes Wt {row['wt_ms']:.3f} Xt {row['xt_ms']:.3f}, "
              f"bound {row['bound_ms']:.3f} a product", flush=True)
        del x, w, dy, wt, xt
    return rows


def train_step_totals(rows) -> dict:
    """Phase 9a's bf16 rows summed over one full-width phase-9d step
    (:data:`TRAIN_LAYERS` layers' projections and the head): the forward
    and its remat recompute (``fwd``: each projection twice, the head
    once), the backward (``bwd``: dX + dW of each) and its parts, the
    transposes, the plain versions, ``torch.matmul`` and the bounds."""
    counts = {r["name"]: (TRAIN_LAYERS if r["name"] in TRAIN_PROJ else 1)
              for r in rows if r["dtype"] == "bfloat16"}
    bf = [r for r in rows if r["dtype"] == "bfloat16"]

    def total(key, fwd_twice=False):
        return sum(counts[r["name"]] * r[key]
                   * (2 if fwd_twice and r["name"] in TRAIN_PROJ else 1)
                   for r in bf)
    out = {}
    for part in ("fwd", "dx", "dw"):
        twice = part == "fwd"
        out[part] = dict(ms=total(f"{part}_ms", twice),
                         plain_ms=total(f"plain_{part}_ms", twice),
                         library_ms=total(f"library_{part}_ms", twice),
                         bound_ms=total("bound_ms", twice),
                         t_mem_ms=total("t_mem_ms", twice),
                         t_ops_ms=total("t_ops_ms", twice))
    out["bwd"] = {key: out["dx"][key] + out["dw"][key] for key in out["dx"]}
    out["transpose_ms"] = total("wt_ms") + total("xt_ms")
    for part in ("fwd", "bwd"):
        t = out[part]
        t["bound_by"] = "bytes" if t["t_mem_ms"] >= t["t_ops_ms"] \
            else "operations"
    out["max_abs_err"] = max(max(r["dx_err"], r["dw_err"]) for r in bf)
    return out


def _train_pair(torch, cfg, dev, params_cpu, hyper, batches):
    """The same steps on the CPU (plain versions) and on ``dev`` (the
    kernels) from the same params: per step (card, CPU) loss and grad
    norm."""
    from repro_torch.models import build_model
    from repro_torch.train import init_optimizer, make_train_step
    out = []
    runs = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        bundle = build_model(cfg, device=device)
        params = {k: v.to(device) for k, v in params_cpu.items()}
        opt = init_optimizer(cfg, params)
        step_fn = make_train_step(bundle, hyper)
        runs[where] = []
        for s, batch in enumerate(batches):
            params, opt, m = step_fn(params, opt, batch, s)
            runs[where].append({k: float(v) for k, v in m.items()})
    for card, cpu in zip(runs["card"], runs["cpu"]):
        out.append({k: (card[k], cpu[k]) for k in card})
    return out


def train_smoke_parity(torch, dev, reset_counts, llm_counts) -> dict:
    """Phase 9b: the smoke configs train on the card and on the CPU from
    the same params (seed 0) and batches (``SyntheticLMSource``): llama3-8b
    with AdamW, with Adafactor, and internvl2-1b (the vlm mask), 3 steps
    each, every step's loss and grad norm within
    :data:`TRAIN_BF16_LOSS_RTOL` / :data:`TRAIN_BF16_GNORM_RTOL`; then
    llama3-8b with fp32 params at step 0 (the fp32 body under autograd):
    the loss, the grad norm and every grad leaf (against its max) within
    :data:`TRAIN_F32_RTOL`.  The card's launches are counted."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm_sq
    from repro_torch.train import TrainHyper, loss_and_grads
    t, b = TRAIN_SMOKE_SHAPE
    hyper = TrainHyper(**TRAIN_SMOKE_HYPER)
    out = {}
    reset_counts()
    for label, arch, optimizer in (("adamw", "llama3-8b", "adamw"),
                                   ("adafactor", "llama3-8b", "adafactor"),
                                   ("vlm", "internvl2-1b", "adamw")):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  optimizer=optimizer)
        params = build_model(cfg, device="cpu").init_params()
        src = SyntheticLMSource(cfg, ShapeSpec("9b", t, b, "train"))
        steps = _train_pair(torch, cfg, dev, params, hyper,
                            [src.batch_at(s) for s in range(3)])
        errs = {k: max(abs(st[k][0] - st[k][1]) / abs(st[k][1])
                       for st in steps) for k in ("loss", "grad_norm")}
        ok = (errs["loss"] <= TRAIN_BF16_LOSS_RTOL
              and errs["grad_norm"] <= TRAIN_BF16_GNORM_RTOL
              and all(math.isfinite(c) for s in steps for c, _ in
                      s.values()))
        out[label] = dict(arch=arch, optimizer=optimizer, steps=steps,
                          rel_err=errs, ok=ok)
        print(f"    9b {label:>9} ({arch} smoke, {optimizer}): losses card "
              f"{[round(s['loss'][0], 5) for s in steps]} CPU "
              f"{[round(s['loss'][1], 5) for s in steps]}; max rel err loss "
              f"{errs['loss']:.2e}, grad norm {errs['grad_norm']:.2e} "
              f"({'ok' if ok else 'FAILED'})", flush=True)
    # fp32 params, step 0: loss and every gradient
    cfg = get_config("llama3-8b", smoke=True)
    p32 = {k: v.float() for k, v in
           build_model(cfg, device="cpu").init_params().items()}
    batch = SyntheticLMSource(cfg, ShapeSpec("9b", t, b, "train")).batch_at(0)
    res = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        loss, grads = loss_and_grads(build_model(cfg, device=device),
                                     {k: v.to(device) for k, v in p32.items()},
                                     batch)
        res[where] = (float(loss), float(torch.sqrt(global_norm_sq(
            [grads[k] for k in sorted(grads)]))),
                      {k: g.cpu() for k, g in grads.items()})
    (lc, gc, gr_c), (lp, gp, gr_p) = res["card"], res["cpu"]
    grad_err = max(float((gr_c[k] - gr_p[k]).abs().max()
                         / gr_p[k].abs().max().clamp_min(1e-30))
                   for k in gr_p)
    f32 = dict(loss=(lc, lp), grad_norm=(gc, gp),
               rel_err=dict(loss=abs(lc - lp) / abs(lp),
                            grad_norm=abs(gc - gp) / gp, grads=grad_err))
    f32["ok"] = max(f32["rel_err"].values()) <= TRAIN_F32_RTOL
    out["fp32_step0"] = f32
    out["launches"] = llm_counts()
    print(f"    9b fp32 params, step 0: loss card {lc:.6f} CPU {lp:.6f}; rel "
          f"err loss {f32['rel_err']['loss']:.2e}, grad norm "
          f"{f32['rel_err']['grad_norm']:.2e}, grads (of each leaf's max) "
          f"{grad_err:.2e} ({'ok' if f32['ok'] else 'FAILED'}); card "
          f"launches: apr_matmul {out['launches']['apr_matmul']}, "
          f"apr_matmul_f32 {out['launches']['apr_matmul_f32']}", flush=True)
    return out


def train_launcher_resume(torch, tmpdir) -> dict:
    """Phase 9c: ``repro_torch.launch.train`` on the card (llama3-8b smoke,
    its default batch 4 x 64, AdamW): :data:`TRAIN_CLI_STEPS` -- a first run
    checkpointing every 10 steps, then ``--resume`` for the rest -- against
    the same steps in one uninterrupted run (every part given the whole
    run's ``--total-steps``): the losses equal bit for bit."""
    from repro_torch.launch import train as launch_train
    first, resumed, every = TRAIN_CLI_STEPS
    total = first + resumed
    base = ["--arch", "llama3-8b", "--smoke", "--device", "cuda",
            "--total-steps", str(total), "--ckpt-every", str(every)]
    t0 = time.perf_counter()
    whole = launch_train.main(base + ["--steps", str(total), "--ckpt-dir",
                                      str(Path(tmpdir) / "whole")])
    part1 = launch_train.main(base + ["--steps", str(first), "--ckpt-dir",
                                      str(Path(tmpdir) / "split")])
    part2 = launch_train.main(base + ["--steps", str(resumed), "--resume",
                                      "--ckpt-dir",
                                      str(Path(tmpdir) / "split")])
    seconds = time.perf_counter() - t0
    split = part1.losses + part2.losses
    differ = [i for i, (a, b) in enumerate(zip(split, whole.losses))
              if a != b]
    out = dict(losses=whole.losses, resumed_losses=part2.losses,
               steps_differ=differ, equal=not differ
               and len(split) == len(whole.losses) == total,
               finite=all(math.isfinite(v) for v in split),
               max_abs_diff=max(abs(a - b) for a, b in
                                zip(split, whole.losses)), seconds=seconds)
    verdict = ("equal bit for bit" if out["equal"]
               else f"differ at steps {differ}")
    print(f"    9c launcher: {first} steps + --resume {resumed} against "
          f"{total} in one run: losses {verdict}"
          f" (loss {whole.losses[0]:.4f} -> {whole.losses[-1]:.4f}; "
          f"{seconds:.1f} s for the three runs)", flush=True)
    return out


class ForwardLaunchCounter:
    """Counts B1's launches made inside ``AprMatmulFunction.forward`` and
    ``ExpertMatmulFunction.forward`` (the forward's and the remat
    recompute's) while the ``with`` block runs: ``launches`` all of them,
    ``recompute`` those made while a backward runs (the recompute's); B1's
    other launches on a training step are the backward's products."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.apr_matmul import (AprMatmulFunction,
                                                    apr_matmul)
        from repro_torch.models.moe import ExpertMatmulFunction
        self.launches = self.recompute = 0
        self._inner = {fn: fn.forward for fn in (AprMatmulFunction,
                                                  ExpertMatmulFunction)}

        def counting(inner):
            def counted(ctx, *args):
                before = apr_matmul.launches
                y = inner(ctx, *args)
                n = apr_matmul.launches - before
                self.launches += n
                if torch._C._current_graph_task_id() != -1:
                    self.recompute += n
                return y
            return staticmethod(counted)
        for fn, inner in self._inner.items():
            fn.forward = counting(inner)
        return self

    def __exit__(self, *exc):
        for fn, inner in self._inner.items():
            fn.forward = staticmethod(inner)


def split_step(torch, bundle, params, opt, batch, step: int, hyper, dev):
    """One step of the config's optimizer (AdamW or Adafactor, each with
    ``donate=True``) split by CUDA events into forward + backward
    (``loss_and_grads``) and the update: (params, opt, split)."""
    from repro_torch.optim import (adafactor_update, adamw_update,
                                   warmup_cosine)
    from repro_torch.train import loss_and_grads
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    step_t = torch.as_tensor(step, dtype=torch.int32).to(dev)
    ev[0].record()
    loss, grads = loss_and_grads(bundle, params, batch)
    ev[1].record()
    lr = warmup_cosine(step_t, peak_lr=hyper.peak_lr, warmup=hyper.warmup,
                       total=hyper.total_steps)
    if bundle.cfg.optimizer == "adafactor":
        params, opt = adafactor_update(grads, opt, params, lr, donate=True)
    else:
        params, opt = adamw_update(grads, opt, lr, donate=True)
    ev[2].record()
    torch.cuda.synchronize()
    split = dict(forward_backward_ms=ev[0].elapsed_time(ev[1]),
                 optimizer_ms=ev[1].elapsed_time(ev[2]), loss=float(loss))
    split["optimizer_share"] = split["optimizer_ms"] / (
        split["forward_backward_ms"] + split["optimizer_ms"])
    return params, opt, split


def train_full(torch, seed: int, dev, reset_counts) -> dict:
    """Phase 9d: llama3-8b at full width, :data:`TRAIN_LAYERS` layers,
    random bf16 params from ``seed``, AdamW (``donate=True``: one copy of
    the state), B x T = :data:`TRAIN_B` x :data:`TRAIN_T` tokens from
    ``SyntheticLMSource``: :data:`TRAIN_STEPS` steps through
    ``make_train_step``, each timed by CUDA events and on the host clock,
    B1's launches counted (the Function's forward wrapped to count its
    own and the recompute's, the rest being the backward's; for the caller
    to gate); then one step profiled (device busy
    time against the steady step's, B1's share, top device ops) and one
    split by CUDA events into forward + backward and the optimizer
    update."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.models import build_model
    from repro_torch.train import TrainHyper, init_optimizer, make_train_step
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              num_layers=TRAIN_LAYERS)
    bundle = build_model(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(seed))
    opt = init_optimizer(cfg, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    state_gb = sum(t.numel() * t.element_size() for t in (
        *params.values(), *opt.m.values(), *opt.v.values(),
        *opt.master.values())) / 1e9
    src = SyntheticLMSource(cfg, ShapeSpec("9d", TRAIN_T, TRAIN_B, "train"),
                            seed=seed)
    hyper = TrainHyper(peak_lr=3e-4, warmup=2, total_steps=100)
    step_fn = make_train_step(bundle, hyper, donate=True)
    with ForwardLaunchCounter() as fwd:
        torch.cuda.synchronize()
        reset_counts()
        steps = []
        for s in range(TRAIN_STEPS):
            batch = src.batch_at(s)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            e0.record()
            params, opt, m = step_fn(params, opt, batch, s)
            e1.record()
            torch.cuda.synchronize()
            steps.append(dict(event_ms=e0.elapsed_time(e1),
                              host_ms=(time.perf_counter() - h0) * 1e3,
                              **{k: float(v) for k, v in m.items()}))
        launches = dict(apr_matmul=apr_matmul.launches,
                        forward=fwd.launches,
                        backward=apr_matmul.launches - fwd.launches,
                        wide=apr_matmul.wide_launches,
                        tiles={str(k): v for k, v in
                               apr_matmul.tile_launches.items()},
                        other=apr_matmul.int8_launches
                        + apr_matmul.f32_launches + apr_matmul.hbm_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = sorted(s["event_ms"] for s in steps[1:])
    step_ms = steady[len(steady) // 2]
    out = dict(layers=TRAIN_LAYERS, batch=TRAIN_B, seq=TRAIN_T,
               params=n_params, state_gb=state_gb, init_s=init_s,
               steps=steps, step_ms=step_ms,
               tokens_per_s=TRAIN_B * TRAIN_T / (step_ms / 1e3),
               peak_gb=peak_gb, launches=launches,
               expected=dict(forward=TRAIN_FWD_LAUNCHES,
                             recompute=TRAIN_RECOMPUTE_LAUNCHES,
                             backward=TRAIN_BWD_LAUNCHES))

    # one profiled step, and one split into forward + backward | update
    def one_step(s):
        nonlocal params, opt
        params, opt, _ = step_fn(params, opt, src.batch_at(s), s)
    s = TRAIN_STEPS
    by_kernel = profile_device(torch, lambda: one_step(s), 1)
    if by_kernel:
        busy = sum(by_kernel.values())
        out["profile"] = dict(
            device_busy_ms=busy, idle_share=max(0.0, 1 - busy / step_ms),
            b1_ms=sum(t for k, t in by_kernel.items()
                      if "apr_matmul_kernel" in k or "wide_kernel" in k),
            top_kernels_ms=dict(sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1])[:8]))
    s += 1
    params, opt, out["split"] = split_step(torch, bundle, params, opt,
                                           src.batch_at(s), s, hyper, dev)
    # the remat policies on the same params and batch, then whole steps of
    # each in turn ("nothing", "dots", "nothing", "dots"): ms and peak
    # allocated memory a step
    out["remat"] = remat = remat_policy_runs(torch, cfg, params,
                                             src.batch_at(0), dev)
    fns = {p: make_train_step(build_model(dataclasses.replace(
        cfg, remat_policy=p), device=dev), hyper, donate=True)
        for p in REMAT_POLICIES}
    remat["steps"] = {p: [] for p in REMAT_POLICIES}
    for i in range(2 * len(REMAT_POLICIES)):
        p = REMAT_POLICIES[i % len(REMAT_POLICIES)]
        s += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, _ = fns[p](params, opt, src.batch_at(s), s)
        e1.record()
        torch.cuda.synchronize()
        remat["steps"][p].append(dict(
            event_ms=e0.elapsed_time(e1),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
    del params, opt
    torch.cuda.empty_cache()
    out["roofline"] = {p: step_roofline(
        cfg, TRAIN_B, TRAIN_T, sum(x["event_ms"] for x in xs) / len(xs))
        for p, xs in remat["steps"].items()}
    prof = out.get("profile")
    print(f"    9d llama3-8b full width, {TRAIN_LAYERS} layers "
          f"({n_params / 1e9:.3f} B params, {state_gb:.1f} GB params + "
          f"AdamW state), B x T = {TRAIN_B} x {TRAIN_T}: losses "
          f"{[round(x['loss'], 4) for x in steps]}, grad norms "
          f"{[round(x['grad_norm'], 3) for x in steps]}; "
          f"{step_ms:.2f} ms a step (CUDA events, median of steps 2-"
          f"{TRAIN_STEPS}; host {[round(x['host_ms'], 1) for x in steps]}), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak {peak_gb:.2f} GB; B1 "
          f"{launches['apr_matmul']} launches ({launches['backward']} in the "
          f"backward, {launches['wide']} on wide tiles); split: forward + "
          f"backward {out['split']['forward_backward_ms']:.2f} ms, AdamW "
          f"{out['split']['optimizer_ms']:.2f} ms "
          f"({out['split']['optimizer_share']:.1%})"
          + (f"; a profiled step: device busy {prof['device_busy_ms']:.2f} "
             f"ms (B1 {prof['b1_ms']:.2f}), idle {prof['idle_share']:.1%} of "
             f"the step" if prof else ""), flush=True)
    if prof:
        for k, t in prof["top_kernels_ms"].items():
            print(f"       {t:9.3f} ms  {k[:110]}")
    card = card_name_and_limit()
    for line in policy_lines("9d", remat):
        print(line)
    for p, xs in remat["steps"].items():
        print(f"    9d whole steps under {p!r} (taken in turn): "
              f"{[round(x['event_ms'], 2) for x in xs]} ms (CUDA events), "
              f"peak {[round(x['peak_gb'], 3) for x in xs]} GB allocated; "
              f"card {card}", flush=True)
    for p, r in out["roofline"].items():
        print(roofline_line(f"9d {p!r}", r, card), flush=True)
    return out


#: the remat policies phases 9d and 9f-c hold against each other on the
#: same params and batch: "nothing" (the reference) first, then "dots"
REMAT_POLICIES = ("nothing", "dots")


def card_name_and_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line, or why
    there is none."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "not read"


def remat_policy_runs(torch, cfg, params, batch, dev,
                      host_ref: bool = False) -> dict:
    """Phases 9d and 9f-c: ``loss_and_grads`` of ``cfg`` on the same
    ``params`` and ``batch`` under each of :data:`REMAT_POLICIES`: its B1
    launches (:class:`ForwardLaunchCounter`: ``forward``, ``recompute``
    inside the backward, the rest ``backward``), the expert counts it read
    (:class:`ExpertCounts`: the forward's, then the recompute's), ms by
    CUDA events and peak allocated bytes over those allocated when it
    began; ``bit_equal``: the loss and every grad leaf of each later policy
    equal the first's bit for bit.  ``host_ref`` keeps the first policy's
    grads on the host meanwhile (two sets of arctic-480b's grads do not fit
    on one card)."""
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.models import build_model
    from repro_torch.train import loss_and_grads
    out, ref, equal = {}, None, True
    for policy in REMAT_POLICIES:
        bundle = build_model(dataclasses.replace(cfg, remat_policy=policy),
                             device=dev)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ForwardLaunchCounter() as fwd, ExpertCounts() as seen:
            before = apr_matmul.launches
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            loss, grads = loss_and_grads(bundle, params, batch)
            e1.record()
            torch.cuda.synchronize()
            total = apr_matmul.launches - before
        out[policy] = dict(
            ms=e0.elapsed_time(e1), loss=float(loss),
            peak_over_start_bytes=torch.cuda.max_memory_allocated() - base,
            launches=dict(forward=fwd.launches - fwd.recompute,
                          recompute=fwd.recompute,
                          backward=total - fwd.launches),
            reads=list(seen.reads))
        if ref is None:
            ref = (loss, {k: g.cpu() for k, g in grads.items()}
                   if host_ref else grads)
        else:
            equal = equal and torch.equal(loss, ref[0]) and all(
                torch.equal(g, ref[1][k].to(dev) if host_ref else ref[1][k])
                for k, g in grads.items())
        del loss, grads
    out["bit_equal"] = equal
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_roofline(cfg, batch: int, seq: int, step_ms: float) -> dict:
    """One training step of ``cfg`` over ``batch`` x ``seq`` tokens on one
    card by ``repro_torch.roofline``: ``model_flops`` (6 N_active D), the
    share of ``h100_sxm``'s peak that a step of ``step_ms`` reaches, and
    ``RooflineTerms``' bound (those FLOPs and ``analytic_hbm_bytes`` over
    the profile's rates) against the step."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.roofline import (RooflineTerms, analytic_hbm_bytes,
                                      get_profile, model_flops)
    prof = get_profile("h100_sxm")
    shape = ShapeSpec("step", seq, batch, "train")
    flops = model_flops(cfg, shape, True)
    terms = RooflineTerms(flops, analytic_hbm_bytes(
        cfg, shape, 1, param_count=cfg.param_count()), 0.0, 1, profile=prof)
    return dict(model_flops=flops, step_ms=step_ms,
                peak_share=flops / (step_ms / 1e3 * prof.peak_flops),
                bound_ms=terms.bound_time * 1e3, dominant=terms.dominant,
                bound_share=terms.bound_time * 1e3 / step_ms,
                terms=terms.as_dict())


def roofline_line(label: str, r: dict, card: str) -> str:
    return (f"    {label} roofline (repro_torch.roofline, h100_sxm): "
            f"model_flops {r['model_flops']:.4e} a step; at "
            f"{r['step_ms']:.2f} ms a step {r['peak_share']:.2%} of "
            f"h100_sxm's peak; RooflineTerms bound {r['bound_ms']:.3f} ms "
            f"({r['dominant']}), {r['bound_share']:.2%} of the step; card "
            f"{card}")


def policy_lines(label: str, runs: dict) -> list:
    return [f"    {label} remat_policy {p!r}: loss_and_grads "
            f"{r['ms']:.2f} ms (CUDA events), peak "
            f"{r['peak_over_start_bytes'] / 1e9:.3f} GB over the allocated "
            f"at its start; B1 launches "
            f"forward {r['launches']['forward']} + recompute "
            f"{r['launches']['recompute']} + backward "
            f"{r['launches']['backward']}" for p, r in runs.items()
            if p in REMAT_POLICIES] + [
        f"    {label} every grad leaf and the loss of "
        f"{REMAT_POLICIES[1:]} bit-equal to {REMAT_POLICIES[0]!r}'s: "
        f"{runs['bit_equal']}"]


# ------------------------- the recurrent and audio families' training path
#: phase 9e-a's training shapes of the backward kernels: rwkv6-3b's
#: (B, T, H, D) and mamba2-2.7b's and zamba2-1.2b's (B, T, H, P, N), at
#: phase 9e-c's B x T
SCAN_GRAD_SHAPES = {"rwkv6-3b": (2, 512, 40, 64),
                    "mamba2-2.7b": (2, 512, 80, 64, 128),
                    "zamba2-1.2b": (2, 512, 64, 64, 64)}
#: ... and its odd shapes (T = 1, T = 37, B = 1, T = 1024) and decay
#: extremes, few heads so that the plain version stays quick
SCAN_GRAD_ODD = {"rwkv6_wkv_backward": [
    dict(shape=(2, 1, 4, 64)), dict(shape=(2, 37, 4, 64)),
    dict(shape=(1, 96, 4, 64)), dict(shape=(1, 1024, 40, 64)),
    dict(shape=(2, 96, 4, 64), decay="tiny"),
    dict(shape=(2, 96, 4, 64), decay="one")],
    "mamba2_ssd_backward": [
    dict(shape=(2, 1, 4, 64, 128)), dict(shape=(2, 37, 4, 64, 128)),
    dict(shape=(1, 96, 4, 64, 64)), dict(shape=(1, 1024, 80, 64, 128)),
    dict(shape=(2, 96, 4, 64, 128), decay="tiny"),
    dict(shape=(2, 96, 4, 64, 128), decay="one")]}
#: |kernel - plain| / max |plain| of each gradient: both sum in fp32 from
#: the same inputs, in another order (per-step dots over up to 128 terms,
#: state recurrences over T steps, sums over heads and batch rows)
SCAN_GRAD_RTOL = 2e-5
#: fp32 operations per state element per step that the function needs (the
#: count each kernel's header gives) and the card's fp32 rate
SCAN_GRAD_OPS = {"rwkv6_wkv_backward": 17, "mamba2_ssd_backward": 15}
FP32_FLOPS = 67e12
#: phase 9e-b's bf16 steps: |card - CPU| / |CPU| of each step's loss and
#: grad norm within the larger of phase 9b's bounds and SPLIT_FACTOR x the
#: CPU's own split, |per-step path - chunked path| / |chunked| on the same
#: steps.  AdamW at lr 1e-2 moves a weight by ~lr whatever its gradient's
#: size, so a gradient element near 0 whose sign two runs round apart
#: moves it the other way: on the CPU alone, the recurrences' two exact
#: forms part zamba2-1.2b's bf16 step-2 loss by ~1e-2 and grad norm by
#: ~8e-2 (this phase's ``cpu_split``), while step 0 with fp32 params,
#: before any update, agrees far more closely.  Step 0 with fp32 params (every leaf within
#: TRAIN_F32_RTOL) is the tight check of the kernels on the model's path.
SPLIT_FACTOR = 2.0
#: phase 9e-c: each arch at its published widths, depth cut (zamba2: one
#: super-block of 6 mamba layers and the shared attention; whisper: 4
#: encoder and 4 decoder layers over its 1500 frames), B x T = TRAIN_B x
#: TRAIN_T, AdamW, 3 steps
TRAIN_RECURRENT = {"rwkv6-3b": dict(num_layers=4),
                   "mamba2-2.7b": dict(num_layers=4),
                   "zamba2-1.2b": dict(num_layers=6),
                   "whisper-large-v3": dict(num_layers=4, encoder_layers=4)}
TRAIN_RECURRENT_STEPS = 3


def scan_grad_inputs(torch, gen, dev, kernel, shape, dtype, decay="mid"):
    """Inputs of a backward call at ``shape`` and a ``dy`` of unit variance:
    r, k, v, u (x, b, c) in ``dtype``, w (dt, a, d) in fp32; the decay
    drawn ordinary, near 1e-24 (``tiny``) or near 1 (``one``)."""
    def randn(*shp, scale=1.0):
        return (torch.randn(shp, generator=gen, device=dev) * scale
                ).to(dtype)

    def uniform(shp, lo, hi):
        return torch.empty(shp, device=dev).uniform_(lo, hi, generator=gen)
    if kernel == "rwkv6_wkv_backward":
        b, t, h, d = shape
        w = uniform((b, t, h, d), *{"mid": (0.05, 0.999),
                                     "tiny": (1e-24, 1e-20),
                                     "one": (0.9999, 1.0)}[decay])
        return (randn(b, t, h, d), randn(b, t, h, d), randn(b, t, h, d), w,
                randn(h, d, scale=0.3), randn(b, t, h, d))
    b, t, h, p, n = shape
    dt = uniform((b, t, h), *{"mid": (0.01, 0.5), "tiny": (20.0, 30.0),
                              "one": (1e-5, 1e-4)}[decay])
    return (randn(b, t, h, p), randn(b, t, n), randn(b, t, n), dt,
            -uniform((h,), 0.5, 4.0),
            torch.randn((h,), generator=gen, device=dev), randn(b, t, h, p))


def scan_grad_bound(kernel, shape, itemsize) -> dict:
    """The least time of a backward call: its inputs read once and its
    gradients written once (each in its input's dtype, as the Function
    returns them) against the card's bytes rate, and
    :data:`SCAN_GRAD_OPS` per state element per step against the fp32
    rate."""
    if kernel == "rwkv6_wkv_backward":
        b, t, h, d = shape
        stream = b * t * h * d
        nbytes = (4 * stream * itemsize + stream * 4          # r k v dy, w
                  + 3 * stream * itemsize + stream * 4        # dr dk dv, dw
                  + 2 * h * d * itemsize)                      # u, du
        elems = b * t * h * d * d
    else:
        b, t, h, p, n = shape
        stream = b * t * h * p
        nbytes = ((2 * stream + 2 * b * t * n) * itemsize   # x dy b c
                  + (stream + 2 * b * t * n) * itemsize       # dx db dc
                  + 2 * b * t * h * 4 + 4 * h * 4)            # dt a d, grads
        elems = b * t * h * p * n
    return bound_ms(nbytes, SCAN_GRAD_OPS[kernel] * elems,
                    flops_per_s=FP32_FLOPS)


def scan_grad_checks(torch, gen, dev) -> list:
    """Phase 9e-a: each backward kernel against its plain version on the
    card (``rwkv6_ref_bwd``, ``mamba2_ref_bwd``) at the training shapes of
    :data:`SCAN_GRAD_SHAPES` in bf16 and fp32 and at the odd shapes and
    decay extremes of :data:`SCAN_GRAD_ODD` in bf16: every gradient within
    :data:`SCAN_GRAD_RTOL` of the plain one's largest magnitude, and two
    calls bit-equal.  At the bf16 training shapes also the kernel's ms (CUDA
    events, 5 calls), the plain version's (one call) and the bound."""
    from repro_torch.kernels.mamba2 import mamba2_ref_bwd, mamba2_ssd_backward
    from repro_torch.kernels.rwkv6 import rwkv6_ref_bwd, rwkv6_wkv_backward
    fns = {"rwkv6_wkv_backward": (rwkv6_wkv_backward, rwkv6_ref_bwd),
           "mamba2_ssd_backward": (mamba2_ssd_backward, mamba2_ref_bwd)}
    cases = []
    for arch, shape in SCAN_GRAD_SHAPES.items():
        kernel = ("rwkv6_wkv_backward" if arch == "rwkv6-3b"
                  else "mamba2_ssd_backward")
        for dtype in (torch.bfloat16, torch.float32):
            if arch == "zamba2-1.2b" and dtype == torch.float32:
                continue
            cases.append(dict(kernel=kernel, arch=arch, shape=shape,
                              dtype=dtype, timed=dtype == torch.bfloat16))
    for kernel, odd in SCAN_GRAD_ODD.items():
        cases += [dict(kernel=kernel, arch=None, dtype=torch.bfloat16,
                       timed=False, **c) for c in odd]
    rows = []
    for c in cases:
        kern, plain = fns[c["kernel"]]
        decay = c.get("decay", "mid")
        args = scan_grad_inputs(torch, gen, dev, c["kernel"], c["shape"],
                                c["dtype"], decay)
        got = kern(*args)
        again = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        rel = [float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
               for g, r in zip(got, ref)]
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        stable = all(torch.equal(a, b) for a, b in zip(got, again))
        row = dict(kernel=c["kernel"], arch=c["arch"], shape=c["shape"],
                   dtype=str(c["dtype"]).replace("torch.", ""), decay=decay,
                   rel_err=rel, max_abs_err=abs_err, bit_stable=stable,
                   ok=stable and max(rel) <= SCAN_GRAD_RTOL)
        if c["timed"]:
            row["ms"] = cuda_ms(torch, lambda i: kern(*args), 5)
            row["plain_ms"] = cuda_ms(torch, lambda i: plain(*args), 1,
                                      warmup=0)
            row.update(scan_grad_bound(c["kernel"], c["shape"],
                                       c["dtype"].itemsize))
            row.update(scan_grad_geometry(torch, c["kernel"], c["shape"],
                                          c["dtype"].itemsize,
                                          lambda: kern(*args)))
        del got, again, ref, args
        rows.append(row)
        print(f"    9e-a {row['kernel']} {row['shape']} {row['dtype']} "
              f"{decay}: rel err {max(rel):.2e} (bound {SCAN_GRAD_RTOL:g}), "
              f"abs {abs_err:.2e}, "
              f"{'bit-stable' if stable else 'NOT bit-stable'}"
              + (f"; {row['ms']:.4f} ms (plain {row['plain_ms']:.1f}, bound "
                 f"{row['bound_ms']:.4f} by {row['bound_by']})"
                 if c["timed"] else "")
              + ("" if row["ok"] else "  FAILED"), flush=True)
        if c["timed"]:
            print(f"      {scan_grad_geometry_line(row)}", flush=True)
    torch.cuda.empty_cache()
    return rows


def bwd_launch(kernel, shape, itemsize):
    """A backward call's launch, the wrapper's ``bwd_geometry`` (blocks,
    blocks an SM by shared memory and threads, waves, shared bytes a
    block, the steps a chunk stashes) with the SM count; None on a tree
    without it."""
    from repro_torch.kernels.mamba2 import ops as mops
    from repro_torch.kernels.rwkv6 import ops as rops
    mod = rops if kernel == "rwkv6_wkv_backward" else mops
    geom = getattr(mod, "bwd_geometry", None)
    return dict(geom(*shape, itemsize), sms=mod.SMS) if geom else None


def scan_grad_geometry(torch, kernel, shape, itemsize, call) -> dict:
    """A backward call's launch (:func:`bwd_launch`) and, by
    :func:`profile_device` over 3 calls, each kernel's device ms a call
    and the fixed-order reduce's (the kernels after the sweeps)."""
    geom = bwd_launch(kernel, shape, itemsize)
    for _ in range(3):      # late in a long run the profiler may drop records
        prof = profile_device(torch, call, 3)
        if prof and any("reduce" in k for k in prof):
            break
    reduce_ms = (sum(t for k, t in prof.items()
                     if "reduce" in k or "heads" in k) if prof else None)
    return dict(geometry=geom, kernels_ms=prof, reduce_ms=reduce_ms)


def scan_grad_geometry_line(row) -> str:
    g = row.get("geometry")
    red = row.get("reduce_ms")
    text = ("geometry: " + (
        f"{g['blocks']} blocks of {g['threads']} threads, {g['blocks_per_sm']}"
        f" an SM ({g['blocks_per_sm'] * g['sms']} a wave, {g['waves']} "
        f"wave{'s' if g['waves'] > 1 else ''}), {g['smem']} B of shared "
        f"memory a block, {g['chunk']} steps a chunk ({g['chunks']} chunks)"
        if g else "not reported by this tree"))
    return text + (f"; reduce {red:.4f} ms" if red is not None
                   else "; reduce not measured")


#: the arch whose phase-9e-c step ``--scan-bwd-ab`` times on both trees
SCAN_BWD_AB_STEP = "mamba2-2.7b"


def scan_bwd_one(torch, src: Path, seed: int, out: Path) -> None:
    """``--scan-bwd-one SRC``: phase 9e-a's timed cases (each backward
    kernel at its bf16 training shapes, :data:`SCAN_GRAD_SHAPES`) through
    the wrappers of the ``repro_torch`` found at ``SRC`` (already first on
    ``sys.path``), on inputs drawn from ``seed`` in one fixed order, so
    that every tree gets the same: each case's ms (CUDA events, 10 calls),
    its kernels' device ms by :func:`profile_device` (the reduce's among
    them), each gradient's |kernel - plain| / max |plain|, two calls
    bit-equal, and the tree's launch geometry where it reports one; then
    phase 9e-c's step of :data:`SCAN_BWD_AB_STEP` on the same tree
    (:func:`train_recurrent_full`); writes ``out``."""
    from repro_torch.kernels.mamba2 import mamba2_ref_bwd, mamba2_ssd_backward
    from repro_torch.kernels.rwkv6 import rwkv6_ref_bwd, rwkv6_wkv_backward
    fns = {"rwkv6_wkv_backward": (rwkv6_wkv_backward, rwkv6_ref_bwd),
           "mamba2_ssd_backward": (mamba2_ssd_backward, mamba2_ref_bwd)}
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for arch, shape in SCAN_GRAD_SHAPES.items():
        kernel = ("rwkv6_wkv_backward" if arch == "rwkv6-3b"
                  else "mamba2_ssd_backward")
        kern, plain = fns[kernel]
        args = scan_grad_inputs(torch, gen, dev, kernel, shape,
                                torch.bfloat16)
        got, again, ref = kern(*args), kern(*args), plain(*args)
        torch.cuda.synchronize()
        rel = [float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
               for g, r in zip(got, ref)]
        row = dict(kernel=kernel, arch=arch, shape=shape, rel_err=rel,
                   max_rel=max(rel),
                   bit_stable=all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
                   ms=cuda_ms(torch, lambda i: kern(*args), 10))
        row["geometry"] = bwd_launch(kernel, shape, 2)
        row["kernels_ms"] = profile_device(torch, lambda: kern(*args), 3)
        row["reduce_ms"] = (sum(t for k, t in row["kernels_ms"].items()
                                if "reduce" in k or "heads" in k)
                            if row["kernels_ms"] else None)
        cases.append(row)
        print(f"    {src}: {kernel} {shape} {row['ms']:.4f} ms, rel err "
              f"{row['max_rel']:.2e}, "
              f"{'bit-stable' if row['bit_stable'] else 'NOT bit-stable'}",
              flush=True)
        del args, got, again, ref
        torch.cuda.empty_cache()
    from repro_torch.bench import ConfigCache, set_default_cache
    tmp = tempfile.TemporaryDirectory(prefix="scan_bwd_one_")
    set_default_cache(ConfigCache(Path(tmp.name) / "untuned.json",
                                  autosave=False))
    global TRAIN_RECURRENT
    saved = TRAIN_RECURRENT
    TRAIN_RECURRENT = {SCAN_BWD_AB_STEP: saved[SCAN_BWD_AB_STEP]}
    try:
        full = train_recurrent_full(torch, seed, dev)[SCAN_BWD_AB_STEP]
    finally:
        TRAIN_RECURRENT = saved
    step = dict(arch=SCAN_BWD_AB_STEP, step_ms=full["step_ms"],
                forward_backward_ms=full["split"]["forward_backward_ms"],
                launches=full["launches"])
    print(f"    {src}: {SCAN_BWD_AB_STEP} 9e-c step {step['step_ms']:.2f} ms "
          f"(forward + backward {step['forward_backward_ms']:.2f})",
          flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(src=str(src), cases=cases, step=step),
                              indent=1))


def scan_bwd_ab(torch, older: Path, seed: int, out: Path) -> None:
    """``--scan-bwd-ab DIR``: :func:`scan_bwd_one` on the tree unpacked at
    ``DIR`` and on this one, each in its own process, in the order older,
    this, this, older; per case both trees' ms (the mean of their two
    runs), each tree's largest error against the plain version and the
    older tree's ms over this one's.  Writes ``out``; fails when either
    tree's kernels leave :data:`SCAN_GRAD_RTOL` or give other bits on a
    second call."""
    runs = []
    for i, tree in enumerate((older, ROOT, ROOT, older)):
        part = out.with_name(f"{out.stem}_run{i}.json")
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--scan-bwd-one",
             str(tree / "src"), "--seed", str(seed), "--out", str(part)],
            capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            fail(f"scan-bwd-ab: the run on {tree} failed:\n"
                 f"{proc.stderr[-3000:]}")
        runs.append(json.loads(part.read_text()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows, bad = [], []
    for k, case in enumerate(runs[0]["cases"]):
        old = [runs[i]["cases"][k] for i in (0, 3)]
        new = [runs[i]["cases"][k] for i in (1, 2)]
        row = dict(kernel=case["kernel"], arch=case["arch"],
                   shape=case["shape"],
                   older_ms=[c["ms"] for c in old],
                   this_ms=[c["ms"] for c in new],
                   older_rel=max(c["max_rel"] for c in old),
                   this_rel=max(c["max_rel"] for c in new),
                   older_reduce_ms=[c["reduce_ms"] for c in old],
                   this_reduce_ms=[c["reduce_ms"] for c in new],
                   geometry=new[0]["geometry"])
        row["ratio"] = (sum(row["older_ms"]) / sum(row["this_ms"]))
        rows.append(row)
        bad += [f"{tree} {c['kernel']} {c['shape']}" for tree, cs in
                (("older", old), ("this", new)) for c in cs
                if c["max_rel"] > SCAN_GRAD_RTOL or not c["bit_stable"]]
        print(f"[scan-bwd-ab] {row['kernel']} {row['arch']} "
              f"{tuple(row['shape'])}: older "
              f"{sum(row['older_ms']) / 2:.4f} ms (rel err "
              f"{row['older_rel']:.2e}), this "
              f"{sum(row['this_ms']) / 2:.4f} ms (rel err "
              f"{row['this_rel']:.2e}): {row['ratio']:.2f}x; reduce "
              f"{row['older_reduce_ms']} / {row['this_reduce_ms']} ms",
              flush=True)
    steps = dict(older=[runs[i]["step"] for i in (0, 3)],
                 this=[runs[i]["step"] for i in (1, 2)])
    print(f"[scan-bwd-ab] {SCAN_BWD_AB_STEP} 9e-c step (ms; forward + "
          f"backward): older "
          f"{[(s_['step_ms'], s_['forward_backward_ms']) for s_ in steps['older']]}"
          f", this "
          f"{[(s_['step_ms'], s_['forward_backward_ms']) for s_ in steps['this']]}",
          flush=True)
    print(f"[scan-bwd-ab] {smi}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, older=str(older),
                                   rtol=SCAN_GRAD_RTOL, cases=rows,
                                   steps=steps), indent=1))
    if bad:
        fail(f"scan-bwd-ab: outside {SCAN_GRAD_RTOL:g} of the plain version "
             f"or not bit-stable: {bad}")


class PlainBwdCounter:
    """Counts the plain backwards (``rwkv6_ref_bwd``, ``mamba2_ref_bwd``)
    the Functions call on CUDA tensors, by wrapping them where the
    Functions look them up (their ``ops`` modules), while the ``with``
    block runs."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        from repro_torch.kernels.mamba2 import ops as mops
        from repro_torch.kernels.rwkv6 import ops as rops
        self._saved = [(rops, "rwkv6_ref_bwd", rops.rwkv6_ref_bwd),
                       (mops, "mamba2_ref_bwd", mops.mamba2_ref_bwd)]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def run(*args):
            self.calls += args[0].is_cuda
            return fn(*args)
        return run

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def scan_counts() -> dict:
    """The recurrence kernels' launch counts, forward and backward."""
    from repro_torch.kernels.mamba2 import mamba2_ssd, mamba2_ssd_backward
    from repro_torch.kernels.rwkv6 import rwkv6_wkv, rwkv6_wkv_backward
    return {"rwkv6_wkv": rwkv6_wkv.launches,
            "rwkv6_wkv_backward": rwkv6_wkv_backward.launches,
            "mamba2_ssd": mamba2_ssd.launches,
            "mamba2_ssd_backward": mamba2_ssd_backward.launches}


def zero_scan_counts() -> None:
    from repro_torch.kernels.mamba2 import mamba2_ssd, mamba2_ssd_backward
    from repro_torch.kernels.rwkv6 import rwkv6_wkv, rwkv6_wkv_backward
    for fn in (rwkv6_wkv, rwkv6_wkv_backward, mamba2_ssd,
               mamba2_ssd_backward):
        fn.launches = 0


def cpu_split_steps(torch, cfg, params_cpu, hyper, batches) -> list:
    """The same steps on the CPU through the kernels' path (the models'
    ``use_scan_kernel`` seam forced on: the Functions over the plain
    per-step forwards and backwards), per step loss and grad norm."""
    from repro_torch.models import build_model, rwkv, ssm
    from repro_torch.train import init_optimizer, make_train_step
    seams = [(rwkv, rwkv.use_scan_kernel), (ssm, ssm.use_scan_kernel)]
    for mod, _ in seams:
        mod.use_scan_kernel = lambda x: True
    try:
        params = dict(params_cpu)
        opt = init_optimizer(cfg, params)
        step_fn = make_train_step(build_model(cfg, device="cpu"), hyper)
        out = []
        for s, batch in enumerate(batches):
            params, opt, m = step_fn(params, opt, batch, s)
            out.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    finally:
        for mod, fn in seams:
            mod.use_scan_kernel = fn
    return out


def train_recurrent_smoke_parity(torch, dev) -> dict:
    """Phase 9e-b: the rwkv6-3b, mamba2-2.7b, zamba2-1.2b and
    whisper-large-v3 smoke configs on the card and on the CPU (the chunked
    formulas' autograd, as the JAX package) from the same params (seed 0)
    and batches.  fp32 params, step 0: the loss, the grad norm and every
    grad leaf (against its max) within :data:`TRAIN_F32_RTOL`.  bf16 params,
    3 AdamW steps: each step's loss and grad norm within the larger of
    phase 9b's bounds and :data:`SPLIT_FACTOR` x the CPU's own split
    (:func:`cpu_split_steps` against the chunked run).  The card's backward
    launches are counted, and the plain backwards must not run there."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm_sq
    from repro_torch.train import TrainHyper, loss_and_grads
    t, b = TRAIN_SMOKE_SHAPE
    hyper = TrainHyper(**TRAIN_SMOKE_HYPER)
    base = {"loss": TRAIN_BF16_LOSS_RTOL, "grad_norm": TRAIN_BF16_GNORM_RTOL}
    out = {}
    zero_scan_counts()
    with PlainBwdCounter() as plain:
        for arch in TRAIN_RECURRENT:
            cfg = get_config(arch, smoke=True)
            params = build_model(cfg, device="cpu").init_params()
            src = SyntheticLMSource(cfg, ShapeSpec("9e", t, b, "train"))
            batches = [src.batch_at(s) for s in range(3)]
            before = plain.calls
            # fp32 params, step 0
            res = {}
            for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
                loss, grads = loss_and_grads(
                    build_model(cfg, device=device),
                    {k: v.float().to(device) for k, v in params.items()},
                    batches[0])
                res[where] = (float(loss), float(torch.sqrt(global_norm_sq(
                    [grads[k] for k in sorted(grads)]))),
                              {k: g.cpu() for k, g in grads.items()})
            (lc, gc, gr_c), (lp, gp, gr_p) = res["card"], res["cpu"]
            f32 = dict(loss=abs(lc - lp) / abs(lp), grad_norm=abs(gc - gp) / gp,
                       grads=max(float((gr_c[k] - gr_p[k]).abs().max()
                                       / gr_p[k].abs().max().clamp_min(1e-30))
                                 for k in gr_p))
            # bf16 params, 3 steps, against the CPU's own split
            steps = _train_pair(torch, cfg, dev, params, hyper, batches)
            split = cpu_split_steps(torch, cfg, params, hyper, batches)
            bounds = [{k: max(base[k], SPLIT_FACTOR * abs(sp[k] - st[k][1])
                              / abs(st[k][1])) for k in base}
                      for st, sp in zip(steps, split)]
            errs = [{k: abs(st[k][0] - st[k][1]) / abs(st[k][1])
                     for k in base} for st in steps]
            ok = (max(f32.values()) <= TRAIN_F32_RTOL
                  and all(e[k] <= bd[k] for e, bd in zip(errs, bounds)
                          for k in base)
                  and all(math.isfinite(c) for st in steps
                          for c, _ in st.values()))
            out[arch] = dict(steps=steps, cpu_split=split, rel_err=errs,
                             bounds=bounds, fp32_step0=dict(
                                 loss=(lc, lp), grad_norm=(gc, gp),
                                 rel_err=f32), ok=ok,
                             plain_bwd_calls=plain.calls - before)
            def by_step(rows, key):
                return "/".join(f"{r[key]:.1e}" for r in rows)
            print(f"    9e-b {arch} smoke: fp32 step 0 rel err loss "
                  f"{f32['loss']:.2e}, grad norm {f32['grad_norm']:.2e}, "
                  f"grads (of each leaf's max) {f32['grads']:.2e} (bound "
                  f"{TRAIN_F32_RTOL:g}); bf16 losses card "
                  f"{[round(x['loss'][0], 5) for x in steps]} CPU "
                  f"{[round(x['loss'][1], 5) for x in steps]}; rel err by "
                  f"step: loss {by_step(errs, 'loss')} (bounds "
                  f"{by_step(bounds, 'loss')}), grad norm "
                  f"{by_step(errs, 'grad_norm')} (bounds "
                  f"{by_step(bounds, 'grad_norm')}) "
                  f"({'ok' if ok else 'FAILED'})", flush=True)
    out["launches"] = scan_counts()
    print(f"    9e-b card launches: {out['launches']}", flush=True)
    return out


def b1_per_step(cfg) -> dict:
    """B1's launches a training step of ``cfg``: the forward's products
    (each projection, the head), the remat recompute's (every product
    inside a checkpointed block) and the backward's (dX and dW of each)."""
    fam = cfg.family
    if fam == "ssm":                 # time mix 7 (r k v g o, the decay's
        blocks = fwd = 10 * cfg.num_layers     # two), channel mix 3
    elif fam == "mamba":
        blocks = fwd = 2 * cfg.num_layers      # w_in, w_out
    elif fam == "hybrid":            # a super-block: 2 a mamba layer, the
        ae = cfg.attn_every          # shared attention's q k v o; the tail
        n_sb = cfg.num_layers // ae  # is not recomputed
        blocks = n_sb * (2 * ae + 4)
        fwd = blocks + 2 * (cfg.num_layers - n_sb * ae)
    elif fam == "audio":             # encoder 6 a layer, decoder 10
        blocks = fwd = 6 * cfg.encoder_layers + 10 * cfg.num_layers
    else:
        raise ValueError(fam)
    return dict(forward=fwd + 1, recompute=blocks if cfg.remat else 0,
                backward=2 * (fwd + 1))


def scan_per_step(cfg) -> dict:
    """The recurrence kernel's launches a training step: one a recurrent
    layer in the forward, again in the remat recompute (a hybrid's tail
    layers are not recomputed), and its backward once."""
    kernel = {"ssm": "rwkv6_wkv", "mamba": "mamba2_ssd",
              "hybrid": "mamba2_ssd"}.get(cfg.family)
    if kernel is None:
        return {}
    n = recomputed = cfg.num_layers
    if cfg.family == "hybrid":
        recomputed = n // cfg.attn_every * cfg.attn_every
    return {kernel: n + (recomputed if cfg.remat else 0),
            f"{kernel}_backward": n}


def train_recurrent_full(torch, seed: int, dev) -> dict:
    """Phase 9e-c: each arch of :data:`TRAIN_RECURRENT` at its published
    widths with its depth cut, random bf16 params from ``seed``, AdamW
    (``donate=True``), B x T = :data:`TRAIN_B` x :data:`TRAIN_T` tokens
    from ``SyntheticLMSource`` (whisper also its 1500 stub frames):
    :data:`TRAIN_RECURRENT_STEPS` steps through ``make_train_step``, each
    timed by CUDA events and on the host clock, B1's and B9/B10's launches
    counted for the caller to gate (:func:`b1_per_step`,
    :func:`scan_per_step`), the plain backwards' calls counted; then one
    step split by CUDA events into forward + backward and the AdamW
    update."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.models import build_model
    from repro_torch.train import TrainHyper, init_optimizer, make_train_step
    hyper = TrainHyper(peak_lr=3e-4, warmup=2, total_steps=100)
    out = {}
    for arch, cut in TRAIN_RECURRENT.items():
        cfg = dataclasses.replace(get_config(arch), **cut)
        bundle = build_model(cfg, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = bundle.init_params(
            torch.Generator(device=dev).manual_seed(seed))
        opt = init_optimizer(cfg, params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.values())
        src = SyntheticLMSource(cfg, ShapeSpec("9e", TRAIN_T, TRAIN_B,
                                               "train"), seed=seed)
        step_fn = make_train_step(bundle, hyper, donate=True)
        with PlainBwdCounter() as plain, ForwardLaunchCounter() as fwd:
            torch.cuda.synchronize()
            apr_matmul.launches = 0
            zero_scan_counts()
            steps = []
            for s in range(TRAIN_RECURRENT_STEPS):
                batch = src.batch_at(s)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                e0.record()
                params, opt, m = step_fn(params, opt, batch, s)
                e1.record()
                torch.cuda.synchronize()
                steps.append(dict(
                    event_ms=e0.elapsed_time(e1),
                    host_ms=(time.perf_counter() - h0) * 1e3,
                    **{k: float(v) for k, v in m.items()}))
            launches = dict(apr_matmul=apr_matmul.launches,
                            apr_matmul_forward=fwd.launches,
                            **scan_counts())
            plain_calls = plain.calls
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steady = sorted(x["event_ms"] for x in steps[1:])
        step_ms = steady[len(steady) // 2]
        b1 = b1_per_step(cfg)
        n = TRAIN_RECURRENT_STEPS
        expected = dict(apr_matmul=n * sum(b1.values()),
                        apr_matmul_forward=n * (b1["forward"]
                                                + b1["recompute"]),
                        **{k: n * v for k, v in scan_per_step(cfg).items()})
        s = TRAIN_RECURRENT_STEPS
        params, opt, split = split_step(torch, bundle, params, opt,
                                        src.batch_at(s), s, hyper, dev)
        del params, opt
        torch.cuda.empty_cache()
        r = dict(params=n_params, init_s=init_s, steps=steps,
                 step_ms=step_ms,
                 tokens_per_s=TRAIN_B * TRAIN_T / (step_ms / 1e3),
                 peak_gb=peak_gb, launches=launches, expected=expected,
                 plain_bwd_calls=plain_calls, split=split,
                 layers={k: v for k, v in cut.items()})
        r["launches_ok"] = (all(launches[k] == v for k, v in expected.items())
                            and all(launches[k] == 0 for k in scan_counts()
                                    if k not in expected))
        r["finite"] = all(math.isfinite(x[k]) for x in steps
                          for k in ("loss", "grad_norm"))
        out[arch] = r
        print(f"    9e-c {arch} full width {cut} ({n_params / 1e9:.3f} B "
              f"params), B x T = {TRAIN_B} x {TRAIN_T}: losses "
              f"{[round(x['loss'], 4) for x in steps]}, grad norms "
              f"{[round(x['grad_norm'], 3) for x in steps]}; {step_ms:.2f} "
              f"ms a step (CUDA events; host "
              f"{[round(x['host_ms'], 1) for x in steps]}), "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {peak_gb:.2f} GB; "
              f"split: forward + backward "
              f"{split['forward_backward_ms']:.2f} ms, AdamW "
              f"{split['optimizer_ms']:.2f} ms "
              f"({split['optimizer_share']:.1%}); launches {launches} "
              f"(expected {expected}; plain backwards {plain_calls})",
              flush=True)
    return out


# ------------------------------------------ the moe family's training path
#: phase 9f: the moe archs, each at its published widths with its depth
#: cut (arctic one layer; llama4 one super-block, a dense and an MoE
#: layer), B rows of T tokens, trained under Adafactor with donate
TRAIN_MOE = {"arctic-480b": (1, 2, 512),
             "llama4-maverick-400b-a17b": (2, 1, 512)}
TRAIN_MOE_STEPS = 3
#: phase 9f-c: the archs whose loss_and_grads also runs under each remat
#: policy on the same params and batch
TRAIN_MOE_REMAT = ("arctic-480b",)
#: phase 9f-a: the rows of an expert's queue (1 to 20: arctic's capacity
#: at B x T = 2 x 512) at which the expert backward's products are held to
#: the plain version and timed
MOE_GRAD_ROWS = (1, 5, 13, 20)
#: the top-1 router's gradient is zero in exact arithmetic (the gate
#: normalised over one expert is 1): both sides' rounding noise is held
#: below this share of the step's largest gradient magnitude instead of
#: against the leaf's own largest
ZERO_GRAD_RTOL = 1e-6


def moe_grad_shapes(d: int, ff: int, rows: int) -> dict:
    """The B1 products of an expert's backward for a queue of ``rows``
    rows, (M, K, N) by kind: ``w_gate`` and ``w_up`` (d, ff) give ``dX =
    dY·Wᵀ`` ("up dX") and ``dW = Xᵀ·dY`` ("up dW"), ``w_down`` (ff, d) the
    same ("down dX", "down dW")."""
    return {"up dX": (rows, ff, d), "up dW": (d, rows, ff),
            "down dX": (rows, d, ff), "down dW": (ff, rows, d)}



def moe_grad_operands(torch, gen, dev, m, k, n):
    """bf16 operands of an (M, K, N) product at the training path's
    scales: x of unit variance, y at a weight's init scale (K^-0.5)."""
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    y = (torch.randn((k, n), generator=gen, device=dev)
         * k ** -0.5).to(torch.bfloat16)
    return x, y


def moe_grad_checks(torch, gen, dev) -> list:
    """Phase 9f-a: B1 at the expert backward's shapes of arctic-480b and
    llama4-maverick (:func:`moe_grad_shapes` at every queue length of
    :data:`MOE_GRAD_ROWS`), bf16: each product written, as
    ``ExpertMatmulFunction`` writes ``dW[e]``, into a slice of a stacked
    tensor (``out=``) and held to the plain version within phase 2's bound
    (:func:`max_err`); then timed by CUDA events beside ``matmul_ref`` and
    ``torch.matmul`` on the same operands, and the transposed copy of the
    weight a dX takes (``W[e]ᵀ``, contiguous) apart."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
    rows = []
    for arch in TRAIN_MOE:
        cfg = get_config(arch)
        for r in MOE_GRAD_ROWS:
            for kind, (m, k, n) in moe_grad_shapes(cfg.d_model, cfg.d_ff,
                                                    r).items():
                x, y = moe_grad_operands(torch, gen, dev, m, k, n)
                stack = torch.zeros((2, m, n), dtype=torch.bfloat16,
                                    device=dev)
                got = apr_matmul(x, y, out_dtype=torch.bfloat16, out=stack[1])
                ref = matmul_ref(x, y, torch.bfloat16)
                torch.cuda.synchronize()
                err, ok = max_err(stack[1], ref)
                ok = ok and got.data_ptr() == stack[1].data_ptr() \
                    and not stack[0].any()
                row = dict(arch=arch, kind=kind, rows=r, M=m, K=k, N=n,
                           err=err, ok=ok,
                           **bound_ms((m * k + k * n + m * n) * 2,
                                      2.0 * m * k * n))
                row["ms"] = cuda_ms(torch, lambda i: apr_matmul(
                    x, y, out_dtype=torch.bfloat16, out=stack[1]), 5)
                row["plain_ms"] = cuda_ms(torch, lambda i: matmul_ref(
                    x, y, torch.bfloat16), 3, warmup=1)
                row["library_ms"] = cuda_ms(torch, lambda i: torch.matmul(
                    x, y), 5)
                if kind.endswith("dX"):
                    w = y.t().contiguous()
                    row["transpose_ms"] = cuda_ms(
                        torch, lambda i: w.t().contiguous(), 5)
                    del w
                rows.append(row)
                del x, y, stack, got, ref
        done = [x for x in rows if x["arch"] == arch]
        for r in MOE_GRAD_ROWS:
            line = ", ".join(
                f"{x['kind']} {x['ms']:.4f} ms (lib {x['library_ms']:.4f}, "
                f"bound {x['bound_ms']:.4f}, err {x['err']:.3g})"
                for x in done if x["rows"] == r)
            print(f"    9f-a {arch} queue of {r:2d} rows: {line}", flush=True)
    return rows


def event_ms(torch, fn) -> float:
    """Device milliseconds of one call of ``fn()``, between two CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def expert_bwd_parts(torch, x, w, queues, dy) -> dict:
    """The products of one ``ExpertMatmulFunction`` backward run again on
    that backward's own inputs (the rows ``x``, the leaf ``w``, its
    queues, ``dy``), each set timed once by CUDA events: the dX products
    with their ``W[e]ᵀ`` copies as the backward makes them, the copies
    alone, and every dX and dW product as ``matmul_ref`` (plain) and
    ``torch.matmul`` (library) compute it; with the products' bound (each
    product's bytes or bf16 operations, summed)."""
    from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    k, n = w.shape[1:]

    def dx_kernels():
        for e, s, r in queues:
            apr_matmul(dy[s:s + r], w[e].t().contiguous(), out_dtype=x.dtype,
                       out=dx[s:s + r])

    def transposes():
        for e, _, _ in queues:
            w[e].t().contiguous()

    def plain():
        for e, s, r in queues:
            matmul_ref(dy[s:s + r], w[e].t(), x.dtype)
            matmul_ref(x[s:s + r].t(), dy[s:s + r], w.dtype)

    def library():
        for e, s, r in queues:
            torch.matmul(dy[s:s + r], w[e].t())
            torch.matmul(x[s:s + r].t(), dy[s:s + r])

    out = dict(products=2 * len(queues), queues=len(queues),
               bound_ms=0.0, t_mem_ms=0.0, t_ops_ms=0.0)
    for _, _, r in queues:
        for m_, k_, n_ in ((r, n, k), (k, r, n)):     # dX, dW
            bd = bound_ms((m_ * k_ + k_ * n_ + m_ * n_) * 2,
                          2.0 * m_ * k_ * n_)
            for part in ("bound_ms", "t_mem_ms", "t_ops_ms"):
                out[part] += bd[part]
    for key, fn in (("dx_ms", dx_kernels), ("transpose_ms", transposes),
                    ("plain_ms", plain), ("library_ms", library)):
        out[key] = event_ms(torch, fn)
    return out


#: B1's launch counters that a launch of the bf16 or fp32 body moves
B1_COUNTERS = ("launches", "wide_launches", "f32_launches")
B1_COUNTS_BY = ("tile_launches", "split_launches")


class ExpertCounts:
    """Every ``moe.expert_counts`` read (forward and remat recompute) and
    the B1 launches made inside ``ExpertMatmulFunction.backward`` while
    the ``with`` block runs.  With ``timing`` set to a list, each such
    backward is also timed by CUDA events and its products run again on
    its inputs (:func:`expert_bwd_parts`, their launches not counted): one
    dict a backward appended."""

    def __enter__(self):
        from repro_torch.kernels.apr_matmul import apr_matmul
        from repro_torch.models import moe
        self.reads, self.bwd_launches, self.bwd_f32_launches = [], 0, 0
        self.timing = None
        self._moe, self._read = moe, moe.expert_counts
        self._bwd = bwd = moe.ExpertMatmulFunction.backward

        def read(r):
            counts = self._read(r)
            self.reads.append(([min(c, r.capacity) for c in counts],
                               sum(max(c - r.capacity, 0) for c in counts)))
            return counts

        def counted(ctx, dy):
            before = apr_matmul.launches, apr_matmul.f32_launches
            if self.timing is not None:
                # saved tensors unpack once under remat: the backward and
                # the timed parts share this unpacking
                import torch
                x, w = ctx.saved_tensors
                ctx = types.SimpleNamespace(
                    saved_tensors=(x, w), queues=ctx.queues,
                    needs_input_grad=ctx.needs_input_grad)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            grads = bwd(ctx, dy)
            self.bwd_launches += apr_matmul.launches - before[0]
            self.bwd_f32_launches += apr_matmul.f32_launches - before[1]
            if self.timing is not None:
                end.record()
                torch.cuda.synchronize()
                counts = {k: getattr(apr_matmul, k) for k in B1_COUNTERS}
                tiles = {k: dict(getattr(apr_matmul, k))
                         for k in B1_COUNTS_BY}
                self.timing.append(dict(
                    expert_bwd_parts(torch, x, w, ctx.queues, dy),
                    ms=start.elapsed_time(end)))
                for k, v in counts.items():
                    setattr(apr_matmul, k, v)
                for k, v in tiles.items():
                    getattr(apr_matmul, k).clear()
                    getattr(apr_matmul, k).update(v)
            return grads
        moe.expert_counts = read
        moe.ExpertMatmulFunction.backward = staticmethod(counted)
        return self

    def __exit__(self, *exc):
        self._moe.expert_counts = self._read
        self._moe.ExpertMatmulFunction.backward = staticmethod(self._bwd)


def moe_b1_per_step(cfg, reads) -> dict:
    """B1's launches a training step of ``cfg`` (remat on) whose MoE
    layers' counts were ``reads`` (the forward's, then the recompute's in
    reverse order): per forward each layer's attention 4, each dense
    layer's 3, each MoE layer's router (and arctic's dense residual 3) and
    3 a non-empty expert, and the head; the recompute the same but the
    head; the backward dX and dW of each forward product."""
    n_moe = cfg.num_layers // cfg.moe_every
    dense = (4 * cfg.num_layers + 3 * (cfg.num_layers - n_moe)
             + (1 + (3 if cfg.dense_residual_ff else 0)) * n_moe)
    nonempty = [sum(n > 0 for n in q) for q, _ in reads]
    fwd = dense + 1 + 3 * sum(nonempty[:n_moe])
    return dict(forward=fwd, recompute=dense + 3 * sum(nonempty[n_moe:]),
                backward=2 * fwd, expert_backward=6 * sum(nonempty[:n_moe]))


def train_moe_smoke_parity(torch, dev) -> dict:
    """Phase 9f-b: the arctic-480b and llama4-maverick smoke configs
    (Adafactor) on the card and on the CPU from the same params (seed 0)
    and batches.  Each step runs on the card first, its expert selections
    recorded, then on the CPU, which routes every token to the experts the
    card chose: both sides run the same queues.  The CPU's own top-k is
    computed beside, and each token it would have routed otherwise is
    recorded with the gap of the card's extra expert below the CPU's k-th
    router logit (:func:`route_flips`).  fp32 params, step 0: the loss, the
    grad norm and every grad leaf against its largest magnitude within
    :data:`TRAIN_F32_RTOL` (the top-1 router, whose gradient is zero in
    exact arithmetic, below :data:`ZERO_GRAD_RTOL` of the step's largest
    gradient on both sides), every swap a near-tie.  bf16 params, 3 steps:
    every step's loss and grad norm within phase 9b's bounds; a step that
    starts from params equal on both sides bit for bit may swap only at a
    near-tie, and a later step's swaps are counted (the params part: under
    top-1 routing the router's gradient is rounding noise, which Adafactor
    normalises into a step of its own direction on each side).  The card's
    B1 launches are counted (the expert backward's apart)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import global_norm_sq
    from repro_torch.train import (TrainHyper, init_optimizer,
                                   loss_and_grads, make_train_step)
    t, b = TRAIN_SMOKE_SHAPE
    hyper = TrainHyper(**TRAIN_SMOKE_HYPER)
    top_k_of, softmax_of = moe_mod.top_k, moe_mod.softmax
    card_sel, cpu_chosen, swaps, logits = [], {}, [], [None]
    side = ["card"]

    def softmax(x):
        logits[0] = x.detach()
        return softmax_of(x)

    def top_k(x, k):
        if side[0] == "card":
            values, idx = top_k_of(x, k)
            card_sel.append(idx.detach().cpu())
            return values, idx
        key = x.detach().numpy().tobytes()
        if key not in cpu_chosen:
            call = len(cpu_chosen)
            sel = card_sel[call]
            swaps.extend(route_flips(top_k_of(x.detach(), k)[1], logits[0],
                                     sel, call=call))
            cpu_chosen[key] = sel
        sel = cpu_chosen[key]
        return torch.gather(x, -1, sel), sel

    def on(where):
        side[0] = where
        if where == "card":
            card_sel.clear()
            cpu_chosen.clear()
            swaps.clear()
        return dev if where == "card" else torch.device("cpu")

    def routed(cfg) -> list:
        """This step's swaps, and a failing entry unless the CPU replayed
        one card selection a MoE layer."""
        n_moe = cfg.num_layers // cfg.moe_every
        out = list(swaps)
        if len(cpu_chosen) != n_moe or len(card_sel) < n_moe:
            out.append(dict(calls=(len(card_sel), len(cpu_chosen)),
                            near_tie=False))
        return out

    out = {}
    apr_matmul.launches = apr_matmul.f32_launches = 0
    moe_mod.top_k, moe_mod.softmax = top_k, softmax
    try:
        with ExpertCounts() as seen:
            for arch in TRAIN_MOE:
                cfg = get_config(arch, smoke=True)
                params = build_model(cfg, device="cpu").init_params()
                src = SyntheticLMSource(cfg, ShapeSpec("9f", t, b, "train"))
                batches = [src.batch_at(s) for s in range(3)]
                res = {}
                for where in ("card", "cpu"):
                    device = on(where)
                    loss, grads = loss_and_grads(
                        build_model(cfg, device=device),
                        {k: v.float().to(device) for k, v in params.items()},
                        batches[0])
                    res[where] = (float(loss), float(torch.sqrt(
                        global_norm_sq([grads[k] for k in sorted(grads)]))),
                        {k: g.cpu() for k, g in grads.items()})
                f32_flips = routed(cfg)
                (lc, gc, gr_c), (lp, gp, gr_p) = res["card"], res["cpu"]
                top = max(float(g.abs().max()) for g in gr_p.values())
                f32 = dict(loss=abs(lc - lp) / abs(lp),
                           grad_norm=abs(gc - gp) / gp, grads=0.0,
                           zero_grads=0.0)
                for k in gr_p:
                    if cfg.experts_per_token == 1 and k.endswith(".router"):
                        f32["zero_grads"] = max(
                            f32["zero_grads"],
                            max(float(gr_c[k].abs().max()),
                                float(gr_p[k].abs().max())) / top)
                        continue
                    f32["grads"] = max(f32["grads"], float(
                        (gr_c[k] - gr_p[k]).abs().max()
                        / gr_p[k].abs().max().clamp_min(1e-30)))
                side_params = {"cpu": dict(params), "card": {
                    k: v.to(dev) for k, v in params.items()}}
                opts = {w: init_optimizer(cfg, p)
                        for w, p in side_params.items()}
                fns = {w: make_train_step(build_model(cfg, device=on(w)),
                                          hyper) for w in side_params}
                steps = []
                for s, batch in enumerate(batches):
                    same = all(torch.equal(side_params["card"][k].cpu(), v)
                               for k, v in side_params["cpu"].items())
                    m = {}
                    for w in ("card", "cpu"):
                        on(w)
                        side_params[w], opts[w], mw = fns[w](
                            side_params[w], opts[w], batch, s)
                        m[w] = {k: float(mw[k]) for k in ("loss",
                                                          "grad_norm")}
                    steps.append(dict(
                        same_params=same, swaps=routed(cfg),
                        **{k: (m["card"][k], m["cpu"][k]) for k in m["cpu"]},
                        rel_err={k: abs(m["card"][k] - m["cpu"][k])
                                 / abs(m["cpu"][k]) for k in m["cpu"]}))
                bounds = {"loss": TRAIN_BF16_LOSS_RTOL,
                          "grad_norm": TRAIN_BF16_GNORM_RTOL}
                errs = [st["rel_err"] for st in steps]
                ok = (max(f32["loss"], f32["grad_norm"], f32["grads"])
                      <= TRAIN_F32_RTOL
                      and f32["zero_grads"] <= ZERO_GRAD_RTOL
                      and all(f["near_tie"] for f in f32_flips)
                      and all(e[k] <= bounds[k] for e in errs for k in bounds)
                      and all(f["near_tie"] for st in steps
                              if st["same_params"] for f in st["swaps"])
                      and not any("calls" in f for st in steps
                                  for f in st["swaps"])
                      and all(math.isfinite(st[k][0]) for st in steps
                              for k in bounds))
                out[arch] = dict(fp32_step0=dict(loss=(lc, lp),
                                                 grad_norm=(gc, gp),
                                                 rel_err=f32, swaps=f32_flips),
                                 steps=steps, ok=ok)

                def by_step(key):
                    return "/".join(f"{e[key]:.1e}" for e in errs)
                print(f"    9f-b {arch} smoke (Adafactor), the CPU routing as "
                      f"the card: fp32 step 0 rel err loss {f32['loss']:.2e}"
                      f", grad norm {f32['grad_norm']:.2e}, grads (of each "
                      f"leaf's max) {f32['grads']:.2e} (bound "
                      f"{TRAIN_F32_RTOL:g}), top-1 router grads "
                      f"{f32['zero_grads']:.1e} of the step's max (bound "
                      f"{ZERO_GRAD_RTOL:g}); bf16 losses card "
                      f"{[round(x['loss'][0], 5) for x in steps]} CPU "
                      f"{[round(x['loss'][1], 5) for x in steps]}; rel err "
                      f"by step: loss {by_step('loss')}, grad norm "
                      f"{by_step('grad_norm')} (bounds "
                      f"{TRAIN_BF16_LOSS_RTOL:g} / {TRAIN_BF16_GNORM_RTOL:g}"
                      f" on every step); tokens the CPU would have routed "
                      f"otherwise: fp32 {len(f32_flips)}, bf16 by step "
                      f"{[len(st['swaps']) for st in steps]} (near-ties "
                      f"{[sum(f['near_tie'] for f in st['swaps']) for st in steps]}"
                      f"; from equal params on steps "
                      f"{[s for s, st in enumerate(steps) if st['same_params']]})"
                      f" ({'ok' if ok else 'FAILED'})", flush=True)
        out["launches"] = dict(apr_matmul=apr_matmul.launches,
                               apr_matmul_f32=apr_matmul.f32_launches,
                               expert_backward=seen.bwd_launches,
                               expert_backward_f32=seen.bwd_f32_launches)
    finally:
        moe_mod.top_k, moe_mod.softmax = top_k_of, softmax_of
    print(f"    9f-b card launches: {out['launches']}", flush=True)
    return out


def train_moe_full(torch, seed: int, dev) -> dict:
    """Phase 9f-c: each arch of :data:`TRAIN_MOE` at its published widths
    with its depth cut, random bf16 params from ``seed``, Adafactor through
    ``make_train_step(..., donate=True)`` (each new param written into the
    old one's storage), ``cfg.remat`` on as the registry has it, B x T
    tokens from ``SyntheticLMSource``: :data:`TRAIN_MOE_STEPS` steps, each
    timed by CUDA events and on the host clock, with every host read of the
    expert counts (the forward's and the recompute's), the dropped
    dispatches and B1's launches recorded (for the caller to gate against
    :func:`moe_b1_per_step`); then one step split by CUDA events into
    forward + backward and the update.  Peak allocated memory is read from
    the first step on and set against the params' and grads' bytes and the
    largest expert leaf's."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.models import build_model
    from repro_torch.train import TrainHyper, init_optimizer, make_train_step
    hyper = TrainHyper(peak_lr=3e-4, warmup=2, total_steps=100)
    out = {}
    for arch, (layers, b, t) in TRAIN_MOE.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        bundle = build_model(cfg, device=dev)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = bundle.init_params(
            torch.Generator(device=dev).manual_seed(seed))
        opt = init_optimizer(cfg, params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.values())
        param_bytes = sum(p.numel() * p.element_size()
                          for p in params.values())
        leaf_bytes = max(p.numel() * p.element_size()
                         for k, p in params.items()
                         if k.rsplit(".", 1)[-1] in ("w_gate", "w_up",
                                                     "w_down")
                         and ".moe." in k)
        torch.cuda.reset_peak_memory_stats()
        src = SyntheticLMSource(cfg, ShapeSpec("9f", t, b, "train"),
                                seed=seed)
        step_fn = make_train_step(bundle, hyper, donate=True)
        steps = []
        with ExpertCounts() as seen:
            for s in range(TRAIN_MOE_STEPS):
                batch = src.batch_at(s)
                torch.cuda.synchronize()
                apr_matmul.launches = 0
                seen.reads.clear()
                seen.bwd_launches = 0
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                e0.record()
                params, opt, m = step_fn(params, opt, batch, s)
                e1.record()
                torch.cuda.synchronize()
                reads = list(seen.reads)
                n_moe = len(reads) // 2
                steps.append(dict(
                    event_ms=e0.elapsed_time(e1),
                    host_ms=(time.perf_counter() - h0) * 1e3,
                    **{k: float(v) for k, v in m.items()},
                    launches=apr_matmul.launches,
                    expert_backward=seen.bwd_launches,
                    expected=moe_b1_per_step(cfg, reads),
                    same_queues=[q for q, _ in reads[n_moe:]]
                    == [q for q, _ in reads[:n_moe]][::-1],
                    dropped=sum(d for _, d in reads[:n_moe]),
                    queues=[q for q, _ in reads[:n_moe]]))
        peak = torch.cuda.max_memory_allocated()
        s = TRAIN_MOE_STEPS
        params, opt, split = split_step(torch, bundle, params, opt,
                                        src.batch_at(s), s, hyper, dev)
        split_peak = torch.cuda.max_memory_allocated()
        with ExpertCounts() as seen:
            seen.timing = []
            params, opt, _ = step_fn(params, opt, src.batch_at(s + 1), s + 1)
        bwd = {key: sum(x[key] for x in seen.timing) for key in (
            "ms", "dx_ms", "transpose_ms", "plain_ms", "library_ms",
            "bound_ms", "t_mem_ms", "t_ops_ms", "products", "queues")}
        bwd["dw_ms"] = bwd["ms"] - bwd["dx_ms"]
        bwd["bound_by"] = ("bytes" if bwd["t_mem_ms"] >= bwd["t_ops_ms"]
                           else "operations")
        bwd["backwards"] = len(seen.timing)
        remat = (remat_policy_runs(torch, cfg, params, src.batch_at(0), dev,
                                   host_ref=True)
                 if arch in TRAIN_MOE_REMAT else None)
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        steady = sorted(x["event_ms"] for x in steps[1:])
        step_ms = steady[len(steady) // 2]
        r = dict(layers=layers, batch=b, seq=t, params=n_params,
                 param_bytes=param_bytes, grad_bytes=param_bytes,
                 largest_expert_leaf_bytes=leaf_bytes, init_s=init_s,
                 steps=steps, step_ms=step_ms,
                 tokens_per_s=b * t / (step_ms / 1e3), peak_bytes=peak,
                 split_peak_bytes=split_peak, split=split,
                 expert_backward_step=bwd)
        r["over_params_and_grads"] = max(peak, split_peak) - 2 * param_bytes
        r["finite"] = all(math.isfinite(x[k]) for x in steps
                          for k in ("loss", "grad_norm"))
        r["launches_ok"] = all(
            x["launches"] == sum(x["expected"][k] for k in (
                "forward", "recompute", "backward"))
            and x["expert_backward"] == x["expected"]["expert_backward"]
            and x["same_queues"] for x in steps)
        r["memory_ok"] = r["over_params_and_grads"] < leaf_bytes
        r["roofline"] = step_roofline(cfg, b, t, step_ms)
        if remat is not None:
            for p in REMAT_POLICIES:
                ex = moe_b1_per_step(cfg, remat[p]["reads"])
                if p == "dots":   # the products kept: the experts recompute
                    n_moe = len(remat[p]["reads"]) // 2
                    ex["recompute"] = 3 * sum(
                        sum(n > 0 for n in q)
                        for q, _ in remat[p]["reads"][n_moe:])
                remat[p]["expected"] = {k: ex[k] for k in (
                    "forward", "recompute", "backward")}
            remat["launches_ok"] = all(
                remat[p]["launches"] == remat[p]["expected"]
                for p in REMAT_POLICIES)
            r["remat"] = remat
        out[arch] = r
        ex = steps[-1]["expected"]
        print(f"    9f-c {arch} full width, {layers} layer(s) "
              f"({n_params / 1e9:.3f} B params, {param_bytes / 1e9:.2f} GB "
              f"bf16 params + as much in grads), B x T = {b} x {t}, "
              f"Adafactor, donate: losses "
              f"{[round(x['loss'], 4) for x in steps]}, grad norms "
              f"{[round(x['grad_norm'], 3) for x in steps]}; {step_ms:.2f} "
              f"ms a step (CUDA events, median of steps 2-{TRAIN_MOE_STEPS};"
              f" host {[round(x['host_ms'], 1) for x in steps]}), "
              f"{r['tokens_per_s']:.0f} tokens/s; split: forward + backward "
              f"{split['forward_backward_ms']:.2f} ms, Adafactor "
              f"{split['optimizer_ms']:.2f} ms "
              f"({split['optimizer_share']:.1%}); peak allocated "
              f"{peak / 1e9:.2f} GB (split step {split_peak / 1e9:.2f}): "
              f"{r['over_params_and_grads'] / 1e9:.2f} GB over params + "
              f"grads (bound: the largest expert leaf, {leaf_bytes / 1e9:.2f}"
              f" GB); dropped dispatches a step "
              f"{[x['dropped'] for x in steps]}; non-empty experts a step "
              f"{[sum(n > 0 for q in x['queues'] for n in q) for x in steps]}"
              f"; B1 launches a step {[x['launches'] for x in steps]} "
              f"(expected {[sum(x['expected'][k] for k in ('forward', 'recompute', 'backward')) for x in steps]}; "
              f"last step forward {ex['forward']} + recompute "
              f"{ex['recompute']} + backward {ex['backward']}, of which the "
              f"experts' {ex['expert_backward']}); recompute's queues equal "
              f"the forward's {all(x['same_queues'] for x in steps)}",
              flush=True)
        print(f"    9f-c {arch} expert backward of step {s + 1} "
              f"({bwd['backwards']} ExpertMatmulFunction backwards over "
              f"{bwd['queues']} non-empty queues in all, {bwd['products']} "
              f"B1 products): {bwd['ms']:.3f} ms by CUDA events around the "
              f"backwards (dX with its W[e]t copies {bwd['dx_ms']:.3f}, the "
              f"rest {bwd['dw_ms']:.3f}; run again on the same inputs: "
              f"torch.matmul {bwd['library_ms']:.3f}, plain "
              f"{bwd['plain_ms']:.3f}, the W[e]t copies alone "
              f"{bwd['transpose_ms']:.3f}; bound {bwd['bound_ms']:.3f} by "
              f"{bwd['bound_by']})", flush=True)
        card = card_name_and_limit()
        if remat is not None:
            for line in policy_lines(f"9f-c {arch}", remat):
                print(line)
            print(f"    9f-c {arch} B1 launches expected "
                  f"{ {p: remat[p]['expected'] for p in REMAT_POLICIES} }"
                  f" (the recompute's non-empty experts x 3 under 'dots'): "
                  f"{remat['launches_ok']}", flush=True)
        print(roofline_line(f"9f-c {arch}", r["roofline"], card), flush=True)
    return out


def identity_ablation(torch, seed: int,
                      archs=RECURRENT_ARCHS) -> dict:
    """``--ablate``: phase 7's paged-vs-slot greedy-token comparison at full
    width, with each card-side measure the path rests on turned off in
    turn (and both together):

    * ``single-mean rms_norm``: ``rms_norm``'s variance is one mean over d
      on the card, as on the CPU, not the mean over ``NORM_GROUPS`` groups;
    * ``einsum conv`` (mamba2, zamba2): ``mamba2_decode``'s conv over its
      window is ``torch.einsum("bkc,kc->bc")``, not the ``addcmul`` chain.

    The hybrid (zamba2) also runs, alone and together, the two sources of
    sum order its engines do not share: B1's split count, which the
    wrapper picks by M (a paged prefill chunk's one row against the slot
    engine's four), pinned to one split (``B1 one split``); and B2 against
    B3, both pinned to one split (``decode attention one split``) or both
    swapped for their plain versions (``plain decode attention``), which
    walk the same 256 positions in the same order.

    Each variant also runs one ``decode_step`` at B = 4 (the slot engine's
    batch) from a nonzero state and each of its rows alone at B = 1 (a
    paged prefill chunk's batch), and records whether the logits and the
    new state of every row are equal bit for bit.

    Returns, per arch and variant, the equal tokens out of all, the first
    mismatching position of each request and the B = 4 vs B = 1 check, or
    the error the variant raised."""
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels.apr_matmul import apr_matmul
    from repro_torch.kernels.flash_decode import (
        decode_attention_ref, flash_decode, flash_decode_paged,
        paged_decode_attention_q_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.models import build_model, layers, ssm
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine

    def einsum_conv(window, w):
        return torch.einsum("bkc,kc->bc", window, w)

    def plain_decode(q, k, v, lengths, **_):
        return decode_attention_ref(q, k, v, lengths)

    def plain_paged(q, kp, vp, lengths, tables, k_scales=None,
                    v_scales=None, **_):
        if k_scales is None:
            return paged_decode_attention_ref(q, kp, vp, lengths, tables)
        return paged_decode_attention_q_ref(q, kp, vp, k_scales, v_scales,
                                            lengths, tables)

    one_split = fd.COMPILED.replace(splits=1)

    def batch_invariant(bundle, params, rng) -> bool:
        dev = bundle.device
        cache = bundle.init_cache(4, 256)
        lengths = torch.zeros(4, dtype=torch.int32, device=dev)
        toks = [torch.from_numpy(rng.integers(
            1, bundle.cfg.vocab_size, (4, 1))).to(dev) for _ in range(4)]
        for j, t in enumerate(toks[:3]):     # a nonzero state (and KV)
            bundle.decode_step(params, cache, t, lengths + j)
        # each row's carry before the step: the hybrid's KV cache is
        # written in place
        rows = [{k: v[:, i:i + 1].clone() for k, v in cache.items()}
                for i in range(4)]
        whole = dict(cache)
        logits = bundle.decode_step(params, whole, toks[3], lengths + 3)
        for i, row in enumerate(rows):
            got = bundle.decode_step(params, row, toks[3][i:i + 1],
                                     lengths[i:i + 1] + 3)
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
    b1_one = [(layers, "apr_matmul",
               functools.partial(apr_matmul, splits=1))]
    fd_one = [(layers, "flash_decode",
               functools.partial(flash_decode, config=one_split)),
              (layers, "flash_decode_paged",
               functools.partial(flash_decode_paged, config=one_split))]
    fd_plain = [(layers, "flash_decode", plain_decode),
                (layers, "flash_decode_paged", plain_paged)]
    hybrid_variants = {"B1 one split": b1_one,
                       "decode attention one split": fd_one,
                       "plain decode attention": fd_plain,
                       "B1 + decode attention one split": b1_one + fd_one,
                       "B1 one split + plain decode attention":
                           b1_one + fd_plain}
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        bundle = build_model(cfg, device="cuda")
        params = bundle.init_params(
            torch.Generator(device="cuda").manual_seed(seed))
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in RECURRENT_PROMPTS]
        out[arch] = {}
        for name, patches in {**variants, **(
                hybrid_variants if cfg.family == "hybrid" else {})}.items():
            if name == "einsum conv" and cfg.family not in ("mamba",
                                                            "hybrid"):
                continue
            saved = [(m, attr, getattr(m, attr)) for m, attr, _ in patches]
            for m, attr, fn in patches:
                setattr(m, attr, fn)
            t0 = time.perf_counter()
            try:
                outs, splits = [], []
                for engine in (PagedServeEngine(bundle, params, device="cuda",
                                                slots=4, page_size=16,
                                                prefill_chunk=16),
                               ServeEngine(bundle, params, device="cuda",
                                           slots=4, max_seq=256)):
                    reqs = [Request(rid=i, prompt=p,
                                    max_new_tokens=RECURRENT_NEW)
                            for i, p in enumerate(prompts)]
                    before = dict(apr_matmul.split_launches)
                    for r in reqs:
                        engine.submit(r)
                    engine.run_until_drained()
                    outs.append([r.output for r in reqs])
                    splits.append({n: c - before.get(n, 0) for n, c in sorted(
                        apr_matmul.split_launches.items())
                        if c > before.get(n, 0)})
                    del engine
                torch.cuda.synchronize()
                first = [next((i for i, (a, b) in enumerate(zip(pa, sl))
                               if a != b), None)
                         for pa, sl in zip(*outs)]
                res = dict(tokens_equal=sum(a == b for pa, sl in zip(*outs)
                                            for a, b in zip(pa, sl)),
                           tokens_total=sum(len(o) for o in outs[0]),
                           first_mismatch=first,
                           b1_launches_by_splits=dict(paged=splits[0],
                                                      slot=splits[1]),
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
                     f"rows {res['step_b4_equals_b1']}, B1 launches by split "
                     f"count {res['b1_launches_by_splits']}")
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
                         "rwkv6-3b, mamba2-2.7b and zamba2-1.2b on both "
                         "engines with each card-side measure turned off in "
                         "turn, and zamba2's B1 and decode attention pinned "
                         "(identity_ablation); writes "
                         "chiprun_out/identity_ablation.json")
    ap.add_argument("--ablate-arch", action="append",
                    choices=RECURRENT_ARCHS,
                    help="with --ablate, only this arch (repeatable)")
    ap.add_argument("--baseline", action="store_true",
                    help="only build apr_matmul.cu and apr_conv.cu, time "
                         "the memory-resident baselines B4m and B4c beside "
                         "B1 and B5, digest the phase-2 conv cases' outputs "
                         "and dump the libraries' SASS (baseline_sweep); "
                         "writes --out")
    ap.add_argument("--qmm-ablation", action="store_true",
                    help="only build quant_matmul.cu and variants of it "
                         "(QMM_VARIANTS: other exact forms of the codes, 8 "
                         "warps, and timing-only ablations), hold the exact "
                         "ones to the plain version bit for bit and time "
                         "all at the projection shapes (qmm_ablation); "
                         "writes --out")
    ap.add_argument("--kernel-sweep", action="store_true",
                    help="only build flash_decode.cu, apr_matmul.cu, "
                         "quant_matmul.cu, rwkv6.cu and mamba2.cu, print "
                         "their registers and spills "
                         "and time B2/B2q (at each split count over "
                         "PAGED_SWEEP too; under an fp32 q), B3 against its "
                         "longest length, B1 with bf16, int8 and fp32 "
                         "weights and fp32 x int8, and B6/B8 at the "
                         "projection shapes, at each split count, count "
                         "B6's K-loop instructions from its SASS, and time "
                         "B9/B10 at the decode tick and a 1024-token "
                         "prefill (kernel_sweep); writes --out")
    ap.add_argument("--scan-ablation", action="store_true",
                    help="only build rwkv6.cu, mamba2.cu and variants of "
                         "them (SCAN_VARIANTS: the y reduction, the "
                         "restaging, B9's bonus or the step dropped, B10's "
                         "guarded body at N = 128) and "
                         "time each at a 1024-token prefill (scan_ablation); "
                         "writes --out")
    ap.add_argument("--conv-ablation", action="store_true",
                    help="only build apr_conv.cu and variants of it "
                         "(CONV_VARIANTS: the halo staging, the filter "
                         "ring, the barrier a step, the loads or the math "
                         "dropped) and time each at every ResNet-20 conv "
                         "at batch 256, with the K loop's opcode counts "
                         "(conv_ablation); writes --out")
    ap.add_argument("--decode-ab", metavar="DIR",
                    help="only build flash_decode.cu of this tree and of "
                         "the tree unpacked at DIR, hold the G <= 8 kernels "
                         "to the older tree's ptxas counts and output bits "
                         "and the G = 12 and 16 cases to the plain version "
                         "(decode_ab); writes --out")
    ap.add_argument("--scan-bwd-ab", metavar="DIR",
                    help="only run phase 9e-a's timed cases (B9's and B10's "
                         "backward kernels at the bf16 training shapes) on "
                         "the tree unpacked at DIR and on this one, each in "
                         "its own process, older, this, this, older, and "
                         "print both trees' ms, error against the plain "
                         "version and the ratio (scan_bwd_ab); writes --out")
    ap.add_argument("--scan-bwd-one", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--matmul-ptxas-ab", metavar="DIR",
                    help="only build apr_matmul.cu of this tree and of the "
                         "tree unpacked at DIR and hold every kernel of the "
                         "older tree to its ptxas counts (matmul_ptxas_ab); "
                         "writes --out")
    ap.add_argument("--profiler-probe", action="store_true",
                    help="only build quant_matmul.cu, apr_matmul.cu, "
                         "rwkv6.cu and mamba2.cu and count, over many short "
                         "profiler sessions after the scan checks (with and "
                         "without idle ends) and after streams of unprofiled "
                         "launches, the device events and launch calls of "
                         "one quant_matmul call (profiler_probe); writes "
                         "--out")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2
    if args.scan_bwd_one:       # one tree of --scan-bwd-ab, on its sources
        sys.path.insert(0, str(Path(args.scan_bwd_one).resolve()))
        scan_bwd_one(torch, Path(args.scan_bwd_one), args.seed,
                     Path(args.out))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    if args.scan_bwd_ab:
        scan_bwd_ab(torch, Path(args.scan_bwd_ab).resolve(), args.seed,
                    Path(args.out))
        return 0
    from repro_torch.bench import ConfigCache, set_default_cache
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.apr_conv import apr_conv2d, apr_conv2d_fused, \
        conv2d_ref
    from repro_torch.kernels.apr_conv import ops as conv_ops
    from repro_torch.kernels.apr_matmul import (apr_matmul, apr_matmul_fused,
                                                matmul_ref)
    from repro_torch.kernels.apr_matmul import ops as apr_ops
    from repro_torch.kernels.flash_decode import (decode_attention_ref,
                                                  decode_attention_split_ref,
                                                  flash_decode,
                                                  flash_decode_paged)
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
    if args.qmm_ablation:
        qmm_ablation(torch, Path(args.out))
        return 0
    if args.kernel_sweep:
        kernel_sweep(torch, Path(args.out))
        return 0
    if args.scan_ablation:
        scan_ablation(torch, Path(args.out))
        return 0
    if args.profiler_probe:
        profiler_probe(torch, Path(args.out))
        return 0
    if args.conv_ablation:
        conv_ablation(torch, Path(args.out))
        return 0
    if args.decode_ab:
        decode_ab(torch, Path(args.decode_ab).resolve(), Path(args.out))
        return 0
    if args.matmul_ptxas_ab:
        matmul_ptxas_ab(Path(args.matmul_ptxas_ab).resolve(), Path(args.out))
        return 0
    if args.baseline:
        baseline_sweep(torch, Path(args.out))
        return 0
    if args.ablate:
        _build.build_all({apr_ops.LIBRARY: apr_ops.SIGNATURES,
                          fd_ops.LIBRARY: fd_ops.SIGNATURES,
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
            engines=identity_ablation(torch, args.seed,
                                      args.ablate_arch or RECURRENT_ARCHS)),
            indent=1))
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
                      mamba2_ops.LIBRARY: mamba2_ops.SIGNATURES,
                      rwkv6_ops.BWD_LIBRARY: rwkv6_ops.BWD_SIGNATURES,
                      mamba2_ops.BWD_LIBRARY: mamba2_ops.BWD_SIGNATURES})
    build_s = time.perf_counter() - t0
    print(f"[1] built {sorted(_build.BUILD_SECONDS) or 'nothing (cached)'} "
          f"in {build_s:.2f} s (nvcc, sm_90a, one process per source)")
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    report["build_s"] = build_s
    report["build_seconds"] = dict(_build.BUILD_SECONDS)
    phase_done("phase 1")

    # ------------------------------------------------------------ 2 correct
    errs = {name: 0.0 for name in (
        "apr_matmul", "apr_matmul_int8w", "flash_decode_paged",
        "flash_decode_paged_int8", "flash_decode_paged_f32",
        "flash_decode_paged_f32q", "flash_decode_paged_int8_f32q",
        "flash_decode", "flash_decode_f32q", "apr_conv", "apr_conv_hbm",
        "rwkv6_wkv", "mamba2_ssd", "apr_matmul_hbm", "apr_matmul_fused",
        "quant_matmul", "quant_matmul_fused", "apr_matmul_f32",
        "apr_matmul_fused_f32", "apr_matmul_f32_int8w",
        "apr_matmul_hbm_f32", "apr_conv_fused", "apr_matmul_wide",
        "apr_matmul_fused_wide")}
    cases = []
    mm_cases = [(m, k, n, 0) for m in (4, 16)
                for (k, n) in list(LLAMA_DECODE_SHAPES) + [LM_HEAD]]
    mm_cases += [(3, 100, 1000, 0),      # K % 8 != 0: masked element loads
                 (3, 4096, 1000, 0),     # N not a multiple of the 64 tile
                 (17, 96, 77, 0),        # ragged M, N and K at once
                 (4, 256, 5000, 0),      # last tile 8 columns wide
                 (9, 130, 6000, 0),      # masked loads, ragged last tile
                 (1, 8, 8, 0),
                 (4, 512, 256, 1),       # operand 2 bytes off alignment
                 (PREFILL_M, 4096, 4096, 0),    # phase 4d's prefill M
                 (PREFILL_M, 14336, 4096, 0)]
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
        # version and, bit for bit, the bf16 kernel at one split (the K
        # order the int8-weight kernel shares) on its dequantized copy
        qt = quantize_channelwise(w.float())
        qb = torch.empty(k * n + off, dtype=torch.int8, device=dev)
        qt.q = qb[off:].view(k, n).copy_(qt.q)
        w_deq = qt.dequantize(torch.bfloat16)
        for out_dtype in (torch.bfloat16, torch.float32):
            ref = matmul_ref(x, w_deq, out_dtype)
            same = apr_matmul(x, w_deq, out_dtype=out_dtype, splits=1)
            # the default tile, then every compiled one
            for tile in (None,) + apr_ops.INT8W_TILES:
                got = apr_matmul(x, qt, out_dtype=out_dtype, config=(
                    None if tile is None else tile_config(tile)))
                torch.cuda.synchronize()
                err, ok = max_err(got, ref)
                bits = torch.equal(got, same)
                errs["apr_matmul_int8w"] = max(errs["apr_matmul_int8w"],
                                               err)
                cases.append(("apr_matmul_int8w", f"M={m} K={k} N={n} "
                              f"off={off} out={str(out_dtype)[6:]} tile="
                              f"{tile or 'default'} bit-equal={bits}", err,
                              ok and bits))
        del x, xb, w, qt, qb, w_deq

    # the paged kernels (B2, B2q, fp32 pools) at every split count, each
    # case twice for equal bits and with out-of-pool table padding
    paged_cases, b2_det, b2_digests = paged_correctness(torch, gen, dev)
    for name, case, err, ok in paged_cases:
        errs[name] = max(errs[name], err)
        cases.append((name, case, err, ok))

    # the contiguous cache of the slot engine (B3), rows of length 0
    # included, at every split count, over bf16 and fp32 caches and under
    # an fp32 q, twice on the same inputs for equal bits
    b3_cases, b3_det, b3_digests = contig_correctness(torch, gen, dev)
    for name, case, err, ok in b3_cases:
        errs[name] = max(errs[name], err)
        cases.append((name, case, err, ok))
    report["decode_digests"] = {**b2_digests, **b3_digests}

    # the wide body's instruction: one wgmma chain against the WMMA chain
    # of the 16 x 64 x 64 body on the same operands, bit for bit
    t_wide = time.perf_counter()
    probe = mma_probe(torch, gen, dev)
    # seconds of the wide body's checks and timings in phases 2 and 3
    wide_s = report["wide_s"] = dict(mma_probe=time.perf_counter() - t_wide)
    report["mma_probe"] = probe
    print(f"[2] wgmma m64n128k16 chain vs WMMA 16x16x16 chain (bf16 -> "
          f"fp32, one split), the wide body's instruction against the 16 x "
          f"64 x 64 body's: bit-equal {probe['equal']}")
    for c in probe["cases"]:
        print(f"    {c['kind']:20s} K={c['K']:<5d} elements differing "
              f"{c['differ']}/{c['elements']} (max |diff| "
              f"{c['max_abs_diff']:.3g}; nonzero {c['nonzero']})")
    if not probe["equal"]:
        fail("the wide body runs wgmma, whose chain differs from WMMA's")

    # a row's bits across M (B1) and B (B2, B2q, B3), and the folded T > 1
    # paged call against T = 1 calls
    row_cases, b2_vs_b3 = row_bits_checks(torch, gen, dev)
    report["b2_vs_b3_bits"] = b2_vs_b3
    moe_vlm_cases = moe_vlm_matmul_checks(torch, gen, dev)
    t_wide = time.perf_counter()
    wide_cases = wide_bit_checks(torch, gen, dev)
    wide_s["wide_bit_checks"] = time.perf_counter() - t_wide

    # the conv kernels: every geometry of both nets, the JAX tests' and
    # ragged ones on both residencies, and the fused epilogue
    for name, case, err, ok in (row_cases + moe_vlm_cases + wide_cases
                                + conv_correctness(torch, gen, dev)[0]
                                + conv_bit_checks(torch, gen, dev)
                                + scan_correctness(torch, gen, dev)
                                + scan_bit_checks(torch, gen, dev)
                                + matmul_family_correctness(torch, gen, dev)
                                + qmm_tie_and_launch_checks(torch, gen, dev)
                                + matmul_f32_correctness(torch, gen, dev)
                                + graph_kernel_checks(torch, gen, dev)):
        errs[name] = max(errs[name], err)
        cases.append((name, case, err, ok))
    print(f"[2] kernel vs plain version on the card (tolerance "
          f"{BF16_RTOL:.4g}*|plain| + {ATOL:g}; int8 pools "
          f"{BF16_RTOL:.4g}*|plain| + {Q_ATOL:g}; an fp32 q over bf16 or "
          f"int8 K/V {F32Q_RTOL:g}*(|plain| + max|plain|) against the split "
          f"plain version; flash_decode and "
          f"flash_decode_paged at every split count, and twice on the same "
          f"inputs bit-equal ({sum(b3_det)}/{len(b3_det)}, "
          f"{sum(b2_det)}/{len(b2_det)}); apr_matmul_f32 and its fused form "
          f"{F32_MM_SLACK:g}*K*2^-24*(|x|@|w| + |bias|) + "
          f"{F32_MM_ULPS}*2^-24*|plain| (+ {BF16_RTOL:.4g}*|plain| for bf16 "
          f"out), every fp32 tile x split count against the split plain "
          f"version, equal bits across tiles at one split count and over "
          f"int8 weights equal bits to the fp32 weight they dequantize to; "
          f"conv kernels "
          f"{CONV_RTOL:g}*|plain| + {CONV_RTOL:g}*max|plain| (apr_conv_hbm "
          f"in one launch a call); scans: y "
          f"{BF16_RTOL:.4g}*|plain| + {SCAN_ATOL_REL:g}*max|plain|, fp32 "
          f"state {STATE_RTOL:g}*(|plain| + max|plain|); matmul families "
          f"at every compiled tile (B1 and B7m at every split count, "
          f"against the split plain version, twice bit-equal and bit-equal "
          f"across tiles at one split count): B4m bit-equal to B1 at one "
          f"split and the tile in one launch a call (its fp32 form in one "
          f"launch within the fp32 bound of the unsplit plain version), the "
          f"int8-weight kernel bit-equal to B1 at one split, B6/B8 over "
          f"bf16 and fp32 x at every tile x split count: none/relu "
          f"bit-equal, silu/gelu within {ACT_ULPS} fp32 ulps of "
          f"max(|plain|, |pre-activation|) or the bf16 tolerance for bf16 "
          f"out, the same bits across tiles and split counts, twice "
          f"bit-equal, tie rows bit-equal, one device kernel a call; B7m "
          f"the bf16 tolerance; B1's and B7m's wide tiles bit-equal to the "
          f"16 x 64 x 64 tile at every split count, and at the default the "
          f"bf16 tolerance against the split plain version):")
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
    print("    B2 over pages vs B3 over a contiguous cache of the same K/V "
          "at their default splits (B = 20; gated): " + ", ".join(
              f"{r['geometry']} bit-equal {r['b2_equals_b3']} (max |diff| "
              f"{r['max_abs_diff']:.3g})" for r in b2_vs_b3))
    if not all(ok for *_, ok in cases):
        fail("a kernel disagrees with its plain version")
    if any(r["rows_differ"] for r in norms if r["mean"] == "grouped"):
        fail("rms_norm's variance depends on the batch on the card")
    phase_done("phase 2")

    # --------------------------------------------------------------- 3 time
    slots = 4
    timing = projection_timing(torch, gen, dev, (slots, 16))
    per_shape = {(r["kernel"], r["M"], r["K"], r["N"]): r for r in timing}
    # B2 over bf16, fp32 and int8 pools at the phase-4 lengths, bf16 and
    # int8 ones under an fp32 q too
    paged_rows = {r["kernel"]: r for r in paged_timing(torch, gen, dev)}
    timing += list(paged_rows.values())
    # the slot engine's contiguous cache at max_seq 256, same lengths, and a
    # 4096-token cache near full; the bound counts the live tokens' K and V;
    # at max_seq 256 an fp32 cache, and an fp32 q over the bf16 one
    decode_rows = decode_timing(torch, gen, dev, DECODE_TIMING)
    fdc_row = decode_rows[0]
    decode_rows += decode_timing(torch, gen, dev, DECODE_TIMING[:1],
                                 torch.float32)
    fdc32q_row = decode_timing(torch, gen, dev, DECODE_TIMING[:1],
                               q_dtype=torch.float32)[0]
    decode_rows.append(fdc32q_row)
    timing.extend(decode_rows)
    # the same at the groups wider than 8 (in parts of 8 on the grid):
    # starcoder2-15b's and chatglm3-6b's 4-slot ticks, pools and caches
    # rotated over their layers
    wide_rows = {}
    for arch, (geometry, n_layers) in WIDE_TIMING.items():
        rows = paged_timing(torch, gen, dev, geometry=geometry,
                            layers=n_layers)
        rows += decode_timing(torch, gen, dev, DECODE_TIMING[:1],
                              geometry=geometry, layers=n_layers)
        for r in rows:
            r["arch"] = arch
            wide_rows[(r["kernel"], arch)] = r
        timing.extend(rows)
    report["wide_timing"] = [dict(r) for r in wide_rows.values()]
    torch.cuda.empty_cache()
    scan_rows = scan_timing(torch, gen, dev)
    mm_rows = matmul_family_timing(torch, gen, dev, slots)
    for r in mm_rows:
        per_shape[(r["kernel"], r["M"], r["K"], r["N"])] = r
    timing.extend(mm_rows)
    print("[3] kernel times (CUDA events, cold weights: buffers rotated past "
          "the 50 MB L2):")
    for r in timing:
        print_timing_row(r)
    for r in scan_rows:
        print_scan_row(r)
    for r in mm_rows:
        if r["kernel"] == "apr_matmul_hbm":
            print(f"    B4m vs B1 (default tile) M={r['M']} K={r['K']} "
                  f"N={r['N']}: {r['ms']:.4f} vs {r['apr_ms']:.4f} ms, "
                  f"x{r['ms'] / r['apr_ms']:.2f} ({r['hbm_steps']} K steps, "
                  f"+{r['partial_bytes'] / 1e6:.2f} MB of fp32 partials)")
        elif r["kernel"] == "quant_matmul":
            print(f"    quant_matmul M={r['M']} K={r['K']} N={r['N']}: "
                  f"{r['ms']:.4f} ms at {r['splits']} splits, quantizing "
                  f"in the launch (the plain quantize_activations alone "
                  f"{r['quantize_ms']:.4f} ms); library at "
                  f"M={r['library_m']}")
    timing.extend(scan_rows)
    report["timing"] = timing
    # B1 at phase 4d's prefill M, per whole-sequence forward (225
    # projections at M = B x T)
    prefill_rows = prefill_matmul_timing(torch, gen, dev)
    for r in prefill_rows:
        print_timing_row(r)
    prefill_shape = {(r["K"], r["N"]): r for r in prefill_rows}

    def per_prefill_forward(key):
        return 32 * sum(cnt * prefill_shape[kn][key]
                        for kn, cnt in LLAMA_DECODE_SHAPES.items()) + \
            prefill_shape[LM_HEAD][key]

    prefill_mm = {key: per_prefill_forward(key) for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "t_mem_ms", "t_ops_ms")}
    prefill_mm["bound_by"] = ("bytes" if prefill_mm["t_mem_ms"]
                              >= prefill_mm["t_ops_ms"] else "operations")
    report["prefill_matmul"] = dict(rows=prefill_rows, per_forward=prefill_mm)
    print(f"    apr_matmul per full-width llama3-8b forward at M={PREFILL_M} "
          f"(225 projections): {prefill_mm['ms']:.3f} ms, torch.matmul "
          f"{prefill_mm['library_ms']:.3f} ms "
          f"({prefill_mm['ms'] / prefill_mm['library_ms']:.2f}x), plain "
          f"{prefill_mm['plain_ms']:.3f} ms, bound "
          f"{prefill_mm['bound_ms']:.3f} ms ({prefill_mm['bound_by']}: "
          f"bf16 tensor-core peak), {prefill_mm['bound_ms'] / prefill_mm['ms']:.0%} "
          f"of bound")
    # B1 at whisper-large-v3's prefill M (2 x 1500 frames), per prefill
    whisper_m = WHISPER_B * get_config("whisper-large-v3").encoder_frames
    t_wide = time.perf_counter()
    whisper_rows = prefill_matmul_timing(torch, gen, dev, whisper_m,
                                         list(WHISPER_PREFILL_SHAPES))
    for r in whisper_rows:
        print_timing_row(r)
    wide_s["whisper_rows"] = time.perf_counter() - t_wide
    whisper_shape = {(r["K"], r["N"]): r for r in whisper_rows}
    whisper_mm = {key: sum(cnt * whisper_shape[kn][key] for kn, cnt in
                           WHISPER_PREFILL_SHAPES.items())
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "t_mem_ms", "t_ops_ms")}
    whisper_mm["bound_by"] = ("bytes" if whisper_mm["t_mem_ms"]
                              >= whisper_mm["t_ops_ms"] else "operations")
    report["prefill_matmul_whisper"] = dict(rows=whisper_rows,
                                            per_prefill=whisper_mm)
    print(f"    apr_matmul per whisper-large-v3 prefill at M={whisper_m} "
          f"({sum(WHISPER_PREFILL_SHAPES.values())} projections over the "
          f"frames): {whisper_mm['ms']:.3f} ms, torch.matmul "
          f"{whisper_mm['library_ms']:.3f} ms "
          f"({whisper_mm['ms'] / whisper_mm['library_ms']:.2f}x), bound "
          f"{whisper_mm['bound_ms']:.3f} ms ({whisper_mm['bound_by']})")
    # the wide tiles against the 16 x 64 x 64 one and torch.matmul across M
    t_wide = time.perf_counter()
    sweep_rows = wide_sweep(torch, gen, dev)
    wide_s["wide_sweep"] = time.perf_counter() - t_wide
    report["wide_sweep"] = sweep_rows
    tiles = (apr_ops.DEFAULT_TILE,) + apr_ops.WIDE_TILES
    print("    M sweep, ms a call (bf16 out, default split count; tiles "
          + ", ".join("x".join(map(str, t)) for t in tiles)
          + ", torch.matmul):")
    for r in sweep_rows:
        print(f"      K={r['K']:<5d} N={r['N']:<5d} M={r['M']:<4d} "
              + " ".join(f"{r['x'.join(map(str, t))]:.4f}" for t in tiles)
              + f" {r['library_ms']:.4f} (default {r['default']}) "
              f"bound {r['bound_ms']:.4f}")
    print("    the wide body's checks and timings took "
          + ", ".join(f"{k_} {t:.1f} s" for k_, t in wide_s.items()))

    # every distinct conv of ResNet-20 and of MobileNet-V1 at CNN_BATCH
    conv_rows = cnn_conv_timing(torch, gen, dev, "resnet20")
    mb_conv_rows = cnn_conv_timing(torch, gen, dev, "mobilenet_v1")
    conv_regs = {k_: v for k_, v in ptxas_kernels(_build.BUILD_LOGS.get(
        conv_ops.LIBRARY, "")).items() if "conv" in k_}
    report["conv_ptxas"] = conv_regs
    for name, r in conv_regs.items():
        print(f"    ptxas {name[19:80]}: {r}")
    # the decode kernels' registers, spills and static shared memory, the
    # wide ones (a group in parts of 8) beside the G = 8 ones they reuse
    fd_regs = fd_ptxas(_build.BUILD_LOGS.get(fd_ops.LIBRARY, ""))
    report["decode_ptxas"] = fd_regs
    for name, r in sorted(fd_regs.items()):
        print(f"    ptxas {name[name.find('split_kernel'):][:70]}: {r}")

    def per_forward(rows):
        """Sums over the convs of one forward at CNN_BATCH."""
        return {key: sum(r["count"] * r[key] for r in rows) for key in (
            "ms", "hbm_ms", "plain_ms", "library_ms", "bound_ms", "t_mem_ms",
            "t_ops_ms", "partial_bytes", "fused_ms", "fused_plain_ms",
            "fused_library_ms", "fused_bound_ms")}

    report["conv_timing"] = conv_rows
    report["mobilenet_conv_timing"] = mb_conv_rows
    conv_total = per_forward(conv_rows)
    mb_total = per_forward(mb_conv_rows)
    report["conv_per_forward"] = conv_total
    report["mobilenet_conv_per_forward"] = mb_total
    print(f"    per MobileNet-V1 forward (14 convs: conv1 + 13 pointwise): "
          f"apr_conv {mb_total['ms']:.4f} ms, apr_conv_hbm "
          f"{mb_total['hbm_ms']:.4f} ms (+{mb_total['partial_bytes'] / 1e9:.3f}"
          f" GB of partial sums), plain {mb_total['plain_ms']:.4f} ms, "
          f"F.conv2d {mb_total['library_ms']:.4f} ms, bound "
          f"{mb_total['bound_ms']:.4f} ms "
          f"({mb_total['bound_ms'] / mb_total['ms']:.0%} of bound)")
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

    def per_tick(key, kernel="apr_matmul", lm_head=True, m=slots):
        """Sum over one full-width decode tick (M = slots): 7 projections
        in each of 32 layers plus (``lm_head``) the lm_head; ``key`` names
        a row's field, or is a function of the row."""
        value = key if callable(key) else (lambda r: r[key])
        layer = sum(cnt * value(per_shape[(kernel, m, k, n)])
                    for (k, n), cnt in LLAMA_DECODE_SHAPES.items())
        return 32 * layer + (value(per_shape[(kernel, m) + LM_HEAD])
                             if lm_head else 0.0)

    def verdict(t, lib):
        return "at or below" if t <= lib else f"{t / lib:.2f}x"

    for name in ("apr_matmul", "apr_matmul_int8w", "apr_matmul_f32",
                 "apr_matmul_f32_int8w"):
        for m_ in (slots, 16):
            t = {key: per_tick(key, name, m=m_) for key in (
                "ms", "library_ms", "bound_ms")}
            split = ""
            if "split_ms" in per_shape[(name, m_) + LM_HEAD]:
                by_n = {n: per_tick(lambda r: r["split_ms"][n], name, m=m_)
                        for n in per_shape[(name, m_) + LM_HEAD]["split_ms"]}
                best = per_tick(lambda r: min(r["split_ms"].values()), name,
                                m=m_)
                split = ("; every projection at one split count " + ", ".join(
                    f"{n}: {v:.3f}" for n, v in by_n.items())
                    + f" ms, each at its best {best:.3f} ms")
            print(f"    {name} per full-width decode tick (225 projections "
                  f"at M={m_}): {t['ms']:.3f} ms, torch.matmul "
                  f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms: "
                  f"{verdict(t['ms'], t['library_ms'])} its library call"
                  + split)
    for r in list(paged_rows.values()) + decode_rows:
        s_len = r["S"] if "S" in r else r["P_max"] * r["ps"]
        print(f"    {r['kernel']} S={s_len} "
              f"lengths={r['lengths']}: "
              f"{r['ms'] * 1e3:.2f} us a launch, {32 * r['ms']:.3f} ms per "
              f"32-layer tick; masked SDPA {r['library_ms'] * 1e3:.2f} us, "
              f"bound {r['bound_ms'] * 1e3:.2f} us: "
              f"{verdict(r['ms'], r['library_ms'])} its library call"
              + (f"; at its best split count "
                 f"{min(r['split_ms'].values()) * 1e3:.2f} us"
                 if "split_ms" in r else ""))

    # what the split count fixed at the 4-slot one costs a wider batch
    wide = paged_split_sweep(torch, gen, dev, WIDE_BATCHES)
    report["wide_batch_splits"] = wide
    for r in wide:
        print(f"    {r['kernel']} B={r['B']} lengths={r['lengths'][:4]}...: "
              f"default {r['splits']} splits; us a launch by split count "
              + ", ".join(f"{n}: {t:.2f}" for n, t in r["split_us"].items()))

    phase_done("phase 3")

    # -------------------------------------------------------------- 4 serve
    def reset_counts():
        apr_matmul.launches = 0
        apr_matmul.int8_launches = 0
        flash_decode_paged.launches = 0
        flash_decode_paged.int8_launches = 0
        flash_decode_paged.f32_launches = 0
        flash_decode_paged.f32q_launches = 0
        flash_decode_paged.int8_f32q_launches = 0
        flash_decode.launches = 0
        flash_decode.f32q_launches = 0
        apr_conv2d.launches = 0
        apr_conv2d.hbm_launches = 0
        apr_conv2d_fused.launches = 0
        rwkv6_wkv.launches = 0
        mamba2_ssd.launches = 0
        apr_matmul.hbm_launches = 0
        apr_matmul.hbm_f32_launches = 0
        apr_matmul.wide_launches = 0
        apr_matmul.tile_launches.clear()
        apr_matmul.split_launches.clear()
        apr_matmul.int8_tile_launches.clear()
        apr_matmul_fused.launches = 0
        apr_matmul.f32_launches = 0
        apr_matmul.f32_int8_launches = 0
        apr_matmul_fused.f32_launches = 0
        quant_matmul.launches = 0
        quant_matmul_fused.launches = 0

    def llm_counts() -> dict:
        return {"apr_matmul": apr_matmul.launches,
                "apr_matmul_int8w": apr_matmul.int8_launches,
                "flash_decode_paged": flash_decode_paged.launches,
                "flash_decode_paged_int8": flash_decode_paged.int8_launches,
                "flash_decode_paged_f32": flash_decode_paged.f32_launches,
                "flash_decode_paged_f32q": flash_decode_paged.f32q_launches,
                "flash_decode_paged_int8_f32q":
                    flash_decode_paged.int8_f32q_launches,
                "flash_decode": flash_decode.launches,
                "flash_decode_f32q": flash_decode.f32q_launches,
                "rwkv6_wkv": rwkv6_wkv.launches,
                "mamba2_ssd": mamba2_ssd.launches,
                "apr_matmul_hbm": apr_matmul.hbm_launches,
                "apr_matmul_hbm_f32": apr_matmul.hbm_f32_launches,
                "apr_matmul_fused": apr_matmul_fused.launches,
                "apr_matmul_f32": apr_matmul.f32_launches,
                "apr_matmul_f32_int8w": apr_matmul.f32_int8_launches,
                "apr_matmul_fused_f32": apr_matmul_fused.f32_launches,
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
    main_lengths = MAIN_LENGTHS
    need = [-(-(n + 1) // 16) for n in main_lengths]
    tick_tables = np.zeros((slots, 16), np.int32)
    at = 1
    for i, n in enumerate(need):
        tick_tables[i, :n] = np.arange(at, at + n)
        at += n
    tick_args = [torch.from_numpy(a).to(dev) for a in (
        np.ones((slots, 1), np.int32), np.asarray(main_lengths, np.int32),
        np.ones(slots, np.int32), tick_tables)]

    def profile_tick(prm, engine, step=None) -> dict:
        """Where a decode tick's time goes at the phase-3 lengths: device
        busy time (sum of kernel times on the one stream) against the
        tick's wall time; {} where the profiler cannot trace.  ``step``:
        the tick's forward (the plain step by default)."""
        step = forward if step is None else step
        step(prm, engine.cache, *tick_args)             # warm
        torch.cuda.synchronize()
        ticks = 5
        t0 = time.perf_counter()                        # wall, profiler off
        for _ in range(ticks):
            step(prm, engine.cache, *tick_args)
        torch.cuda.synchronize()
        tick_wall = (time.perf_counter() - t0) / ticks * 1e3
        host = {}
        by_kernel = profile_device(
            torch, lambda: step(prm, engine.cache, *tick_args), ticks,
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
        flash_decode_paged=cfg.num_layers * (m.decode_calls
                                             + m.prefill_calls))
    serve = dict(weight_gb=weight_gb, init_s=init_s,
                 **paged_summary(engine, wall_s, launches, expect))
    report["serve"] = serve
    print(f"[4] served {m.requests_done}/{len(reqs)} requests of full-width "
          f"{cfg.name} ({cfg.num_layers} layers, {weight_gb:.2f} GB bf16 "
          f"weights, init {init_s:.2f} s) in {wall_s:.2f} s wall:")
    print_paged(serve, m)
    check_served("phase 4", reqs, 16, launches, expect)
    serve["tile_launches"] = {str(t): n for t, n in
                              apr_matmul.tile_launches.items()}
    print(f"    B1 launches by tile: {serve['tile_launches']}")
    if set(apr_matmul.tile_launches) & set(apr_ops.WIDE_TILES):
        fail(f"phase 4: a wide tile served a tick or a chunk "
             f"{serve['tile_launches']}")
    bf16_outputs = [r.output for r in reqs]
    serve["profiled_tick"] = profile_tick(params, engine)
    del engine, reqs
    torch.cuda.empty_cache()

    phase_done("phase 4")

    # ------------------------- 4g the graph-compiled engine, full width
    def serve_graph(prm, kv_dtype, prompts, max_new):
        """Phase 4's requests on ``PagedServeEngine(use_graph=True)``: its
        prefill step and decode tick traced on the card at full width from
        the plain step (the finite check wraps the compiled steps), warmed
        on one request, then served with every count set to 0 just before.
        Returns the engine, its requests, the wall seconds, the counts read
        just after, the compile seconds and the two executors."""
        bundle.decode_paged = forward
        t0 = time.perf_counter()
        engine = PagedServeEngine(
            bundle, prm, kv_dtype=kv_dtype, use_graph=True,
            tune_cache=str(Path(tmp.name) / f"graph_{kv_dtype}.json"),
            **engine_kw)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        bundle.decode_paged = checked(forward)
        exs = {"prefill": engine._prefill.executor,
               "decode": engine._decode_step.executor}
        engine._prefill = checked(engine._prefill)
        engine._decode_step = checked(engine._decode_step)
        engine.submit(Request(rid=-1, prompt=[1] * 20, max_new_tokens=2))
        engine.run_until_drained()                      # warm
        engine.metrics = type(engine.metrics)()
        reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
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
        return engine, reqs, wall, llm_counts(), compile_s, exs

    engine, reqs, wall_s, launches, compile_s, exs = serve_graph(
        params, "bfloat16", prompts, 16)
    m = engine.metrics
    expect = expected_counts(
        apr_matmul=per_call * (m.decode_calls + m.prefill_calls),
        flash_decode_paged=cfg.num_layers * (m.decode_calls
                                             + m.prefill_calls))
    serve_g = dict(compile_s=compile_s, graphs=graph_summary(exs),
                   **paged_summary(engine, wall_s, launches, expect))
    same = sum(a == b for r, o in zip(reqs, bf16_outputs)
               for a, b in zip(r.output, o))
    n_tok = sum(len(o) for o in bf16_outputs)
    serve_g["tokens_equal_phase4"] = same
    report["serve_graph"] = serve_g
    print(f"[4g] served {m.requests_done}/{len(reqs)} requests of full-width "
          f"{cfg.name} bf16 on PagedServeEngine(use_graph=True) in "
          f"{wall_s:.2f} s wall (both steps traced on the card and compiled "
          f"in {compile_s:.2f} s; phase 4: {serve['decode_ms_per_tick']:.3f} "
          f"ms per tick, {serve['prefill_ms_per_chunk']:.3f} ms per chunk):")
    print_graph_summary(serve_g["graphs"])
    print_paged(serve_g, m)
    print(f"    greedy tokens equal to phase 4's: {same}/{n_tok}")
    check_served("phase 4g", reqs, 16, launches, expect)
    if same != n_tok:
        fail(f"phase 4g: the graph engine's greedy tokens differ from phase "
             f"4's ({same}/{n_tok})")
    serve_g["profiled_tick"] = profile_tick(params, engine,
                                            engine._decode_step)
    del engine, reqs, exs
    torch.cuda.empty_cache()

    phase_done("phase 4g")

    # ------------------------------ 4f bf16 weights over fp32 KV pages
    engine, reqs, wall_s, launches = serve_paged(params, "float32", prompts,
                                                 16)
    m = engine.metrics
    expect = expected_counts(
        apr_matmul=per_call * (m.decode_calls + m.prefill_calls),
        flash_decode_paged_f32=cfg.num_layers * (m.decode_calls
                                                 + m.prefill_calls))
    serve_f = paged_summary(engine, wall_s, launches, expect)
    same = sum(a == b for r, o in zip(reqs, bf16_outputs)
               for a, b in zip(r.output, o))
    serve_f["tokens_equal_bf16"] = same
    report["serve_fp32_pools"] = serve_f
    print(f"[4f] served {m.requests_done}/{len(reqs)} requests of full-width "
          f"{cfg.name} (bf16 weights) over fp32 KV pages "
          f"(kv_dtype='float32') in {wall_s:.2f} s wall (phase 4, bf16 "
          f"pages: {serve['decode_ms_per_tick']:.3f} ms per tick, KV pools "
          f"{serve['kv_pool_bytes']} bytes):")
    print_paged(serve_f, m)
    print(f"    greedy tokens equal to phase 4's (bf16 pages): {same}/"
          f"{sum(len(o) for o in bf16_outputs)} (information: the same "
          f"K/V values, attention summed in fp32)")
    check_served("phase 4f", reqs, 16, launches, expect)
    del engine, reqs
    torch.cuda.empty_cache()

    phase_done("phase 4f")

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
    # a row's bits do not depend on the batch, so the slot engine (B3, the
    # prompt one token at a time) and the paged one (B2, chunks of 16)
    # agree token for token
    if same != n_tok:
        fail(f"phase 4c: the slot engine's greedy tokens differ from the "
             f"paged engine's ({same}/{n_tok})")

    phase_done("phase 4c")

    # --------------------------- 4d the dense whole-sequence entry points
    dense = dense_whole_sequence(torch, bundle, params, rng, finite,
                                 reset_counts, llm_counts, expected_counts)
    report["dense_whole_sequence"] = dense
    phase_done("phase 4d")

    # ------------------------- 4e speculative decoding at full width
    from repro_torch.configs import get_draft_config
    from repro_torch.models import build_draft_model
    from repro_torch.spec import ModelDraft, SpeculativeServeEngine

    def serve_spec(prm, kv_dtype, draft=None, proposer=None):
        """Warm a throwaway engine, then serve phase 4's requests on a
        ``SpeculativeServeEngine(spec_k=SPEC_K)`` (the n-gram draft, a
        ``ModelDraft`` of ``draft`` = (bundle, params), or ``proposer()``)
        with every launch count set to 0 just before; returns the engine,
        its requests, the wall seconds, the counts read just after, and the
        model draft's forwards (counted at its ``_step``) and layers."""
        kw = dict(engine_kw, kv_dtype=kv_dtype, spec_k=SPEC_K)
        if draft is not None:
            kw.update(draft_bundle=draft[0], draft_params=draft[1])

        def make():
            return SpeculativeServeEngine(bundle, prm, **kw, **(
                {} if proposer is None else {"draft": proposer()}))
        warm = make()
        warm.submit(Request(rid=-1, prompt=[1] * 20, max_new_tokens=6))
        warm.run_until_drained()
        del warm
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        engine = make()
        draft_calls, draft_layers = [0], 0
        model = getattr(engine.draft, "inner", engine.draft)
        if isinstance(model, ModelDraft):
            draft_layers = model.bundle.cfg.num_layers
            step = model._step

            def counted(*a):
                draft_calls[0] += 1
                return step(*a)
            model._step = counted
        torch.cuda.synchronize()
        finite.clear()
        reset_counts()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (engine, reqs, wall, llm_counts(), draft_calls[0],
                draft_layers)

    def spec_run(tag, prm, kv_dtype, plain_outputs, plain_tick_ms, weights,
                 attention, draft=None, proposer=None,
                 name="ngram") -> dict:
        """Phase 4e: one speculative run (``serve_spec``'s drafts; ``name``
        for a ``proposer``), its tokens gated equal to the plain paged
        engine's (``plain_outputs``), an oracle's accepted counts to
        :meth:`CorruptedDraft.check`, and its launches to the code's
        counts: ``per_call`` B1 (``weights``) and 32 decode attentions
        (``attention``) a target forward (a prefill chunk or a verify
        step), and the draft model's own per forward."""
        engine, reqs, wall_s, launches, draft_calls, d_layers = serve_spec(
            prm, kv_dtype, draft, proposer)
        m = engine.metrics
        forwards = m.decode_calls + m.prefill_calls
        d_per_call = 7 * d_layers + 1 if d_layers else 0
        expect = expected_counts(**{
            weights: per_call * forwards + d_per_call * draft_calls,
            attention: cfg.num_layers * forwards + d_layers * draft_calls})
        same = sum(a == b for r, o in zip(reqs, plain_outputs)
                   for a, b in zip(r.output, o))
        total = sum(len(o) for o in plain_outputs)
        run = dict(**m.summary(), wall_s=wall_s, spec_k=SPEC_K,
                   kv_dtype=kv_dtype,
                   draft=(name if draft is None else draft[0].cfg.name),
                   ms_per_verify_step=1e3 * m.decode_time_s / m.decode_calls,
                   plain_ms_per_tick=plain_tick_ms,
                   draft_ms_per_step=1e3 * m.draft_time_s / m.decode_calls,
                   draft_forwards=draft_calls,
                   tokens_equal_plain=same, tokens_total=total,
                   launches=launches, expected_launches=expect)
        print(f"[4e] {tag}: SpeculativeServeEngine(spec_k={SPEC_K}, draft="
              f"{run['draft']}, kv {kv_dtype}), phase 4's {len(reqs)} "
              f"requests in {wall_s:.2f} s wall: {m.spec_steps} request "
              f"verify steps in {m.decode_calls} verify forwards, acceptance "
              f"{m.acceptance_rate:.3f} ({m.draft_accepted}/"
              f"{m.draft_proposed}), {m.tokens_per_step:.3f} tokens a step; "
              f"{run['ms_per_verify_step']:.3f} ms a verify forward (plain "
              f"tick {plain_tick_ms:.3f} ms), draft "
              f"{run['draft_ms_per_step']:.3f} ms a step ({draft_calls} draft "
              f"forwards); decode {m.decode_tokens} tok, {m.decode_tps:.2f} "
              f"tok/s, incl. draft {m.spec_decode_tps:.2f} tok/s; greedy "
              f"tokens equal to the plain engine's {same}/{total}; launches "
              f"{launches[weights]} {weights} + {launches[attention]} "
              f"{attention} (expected {expect[weights]} + "
              f"{expect[attention]})")
        check_served(f"phase 4e {tag}", reqs, 16, launches, expect)
        if same != total:
            fail(f"phase 4e {tag}: speculative tokens differ from the plain "
                 f"paged engine's ({same}/{total})")
        if isinstance(engine.draft, CorruptedDraft):
            run["steps_by_accepted"] = engine.draft.check(f"phase 4e {tag}")
            print(f"    verify steps by tokens accepted (each as the plain "
                  f"engine's tokens allow): {run['steps_by_accepted']}")
        del engine, reqs
        torch.cuda.empty_cache()
        return run

    spec_runs = {}
    spec_runs["ngram"] = spec_run(
        "n-gram draft, bf16", params, "bfloat16", bf16_outputs,
        serve["decode_ms_per_tick"], "apr_matmul", "flash_decode_paged")
    dcfg = get_draft_config("llama3-8b")
    dbundle = build_draft_model(cfg, dcfg, device="cuda")
    dparams = dbundle.init_params(torch.Generator(device=dev).manual_seed(
        args.seed + 1))
    spec_runs["model"] = spec_run(
        f"{dcfg.name} draft ({dcfg.num_layers} layers, d={dcfg.d_model}), "
        f"bf16", params, "bfloat16", bf16_outputs,
        serve["decode_ms_per_tick"], "apr_matmul", "flash_decode_paged",
        draft=(dbundle, dparams))
    del dbundle, dparams
    # the oracle: llama3-8b as its own ModelDraft (its own paged cache; its
    # proposals are the plain engine's tokens where a row's bits do not
    # depend on the batch), one proposal a list corrupted at a depth going
    # round 0..SPEC_K: partial accepts, every verify row, draft rollback
    spec_runs["oracle"] = spec_run(
        "oracle: llama3-8b as its own draft, corrupted at depth 0..4, bf16",
        params, "bfloat16", bf16_outputs, serve["decode_ms_per_tick"],
        "apr_matmul", "flash_decode_paged", name="llama3-8b self, corrupted",
        proposer=lambda: CorruptedDraft(
            ModelDraft(bundle, params, slots=slots, page_size=16, chunk=16,
                       kv_dtype="bfloat16"), cfg.vocab_size, SPEC_K))
    report["serve_spec"] = spec_runs
    phase_done("phase 4e")

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
        flash_decode_paged_int8=cfg.num_layers * (m.decode_calls
                                                  + m.prefill_calls))
    serve_q = dict(weight_gb=int8_gb, quantize_s=quant_s,
                   **paged_summary(engine, wall_s, launches, expect))
    same = sum(a == b for r, o in zip(reqs, bf16_outputs)
               for a, b in zip(r.output, o))
    serve_q["tokens_equal_bf16"] = same
    serve_q["int8_tile_launches"] = {
        str(t): n for t, n in apr_matmul.int8_tile_launches.items()}
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
          f"weights, int8 may flip near-ties); int8-weight launches by tile "
          f"{serve_q['int8_tile_launches']}")
    check_served("phase 4b", reqs, 16, launches, expect)
    serve_q["profiled_tick"] = profile_tick(qparams, engine)
    int8_outputs = [r.output for r in reqs]
    del engine, reqs
    torch.cuda.empty_cache()
    phase_done("phase 4b")

    # 4g's int8 run: int8 weights and KV pages on the graph engine, whose
    # head folds into quant_matmul (B6, or B8 under a fused epilogue)
    engine, reqs, wall_s, launches, compile_s, exs = serve_graph(
        qparams, "int8", prompts[:GRAPH_INT8_REQUESTS], GRAPH_INT8_NEW)
    m = engine.metrics
    calls = {"prefill": m.prefill_calls, "decode": m.decode_calls}
    folded = {k: sum(b.op == "quant_matmul" for n in ex.graph.nodes
                     for b in n.body_nodes()) for k, ex in exs.items()}
    b8 = {k: sum(v == "quant_matmul_fused" for v in ex.dispatched.values())
          for k, ex in exs.items()}
    expect = expected_counts(
        apr_matmul_int8w=sum((per_call - folded[k]) * calls[k]
                             for k in calls),
        quant_matmul=sum((folded[k] - b8[k]) * calls[k] for k in calls),
        quant_matmul_fused=sum(b8[k] * calls[k] for k in calls),
        flash_decode_paged_int8=cfg.num_layers * sum(calls.values()))
    serve_gq = dict(compile_s=compile_s, graphs=graph_summary(exs),
                    folded_per_step=folded,
                    **paged_summary(engine, wall_s, launches, expect))
    same = sum(a == b for r, o in zip(reqs, int8_outputs)
               for a, b in zip(r.output, o))
    n_tok = sum(len(r.output) for r in reqs)
    serve_gq["tokens_equal_phase4b"] = same
    # one decode tick at the phase-3 lengths on copies of the served pools
    tick = graph_head_tick(torch, engine, exs["decode"], forward, qparams,
                           tick_args)
    serve_gq["tick_vs_plain"] = tick
    report["serve_graph_int8"] = serve_gq
    print(f"[4g] served {m.requests_done}/{len(reqs)} requests of full-width "
          f"{cfg.name} with int8 weights and int8 KV pages on "
          f"PagedServeEngine(use_graph=True) in {wall_s:.2f} s wall "
          f"(compiled in {compile_s:.2f} s; phase 4b: "
          f"{serve_q['decode_ms_per_tick']:.3f} ms per tick); folded "
          f"quant_matmul nodes a step {folded}, of them on B8 {b8}:")
    print_graph_summary(serve_gq["graphs"])
    print_paged(serve_gq, m)
    print(f"    greedy tokens equal to phase 4b's (int8-weight head on B1's "
          f"int8-weight kernel): {same}/{n_tok} of the first "
          f"{GRAPH_INT8_REQUESTS} requests' first {GRAPH_INT8_NEW} "
          f"(information: the folded head quantizes its activations per "
          f"row); one tick at lengths {main_lengths}: the folded head "
          f"({tick['head_wrapper']}, {tick['head_calls']} call) equal to its"
          f" plain version on its input {tick['head_equal_plain_version']} "
          f"(max |diff| {tick['head_max_abs_err']}), its input equal to the "
          f"plain step's head input {tick['head_input_equal_plain_step']}, "
          f"pools written equal {tick['pools_equal']} (all three gated); "
          f"against the plain step (B1's int8-weight head): max |logits "
          f"diff| {tick['max_abs_diff']:.4g}, at most "
          f"{tick['largest_bound_share']:.3f} of the activation-quantization"
          f" bound (gated), argmax equal {tick['argmax_equal']}/"
          f"{tick['rows']}")
    check_served("phase 4g int8", reqs, GRAPH_INT8_NEW, launches, expect)
    if not (tick["head_equal_plain_version"]
            and tick["head_input_equal_plain_step"]):
        fail(f"phase 4g int8: the folded head ({tick['head_calls']} calls "
             f"captured, {tick['plain_head_calls']} plain) is not its plain "
             f"version on the plain step's head input bit for bit")
    if not (tick["within_bound"] and tick["pools_equal"]):
        fail("phase 4g int8: the graph step's logits leave the activation-"
             "quantization bound of the plain step's, or its pools differ")
    if not sum(folded.values()):
        fail("phase 4g int8: no quant_matmul node was folded")
    del engine, reqs, exs
    torch.cuda.empty_cache()
    phase_done("phase 4g int8")

    # 4e's int8 run: int8 weights and KV pages, the n-gram draft, against
    # phase 4b's tokens
    spec_runs["int8"] = spec_run(
        "n-gram draft, int8 weights + int8 KV", qparams, "int8",
        int8_outputs, serve_q["decode_ms_per_tick"], "apr_matmul_int8w",
        "flash_decode_paged_int8")
    del qparams, bundle
    torch.cuda.empty_cache()
    phase_done("phase 4e int8")

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
        kv = {"paged_int8": "int8", "paged_f32": "float32"}.get(
            kind, "bfloat16")
        prm = {"cpu": smoke_params[prm_key],
               "cuda": {k: v.to(dev) for k, v in
                        smoke_params[prm_key].items()}}
        if kind == "slot":
            caches = {w: b_.init_cache(2, 16) for w, b_ in bundles.items()}
            tokens, lengths = smoke_tokens[:, :1], np.array([0, 3], np.int32)
        else:
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
              for kind in ("paged_bf16", "paged_int8", "paged_f32", "slot")}
    # the whole-sequence entry points on the 8 smoke tokens: every position
    # of forward's logits and prefill's (max_seq 12) last ones, bf16 and
    # fp32 parameters (the fp32 body under every projection on the card)
    for label, prm, bound in (
            ("bf16", smoke_params["bf16"], SMOKE_LOGITS_BOUND),
            ("fp32", {k: v.float() for k, v in smoke_params["bf16"].items()},
             F32_SMOKE_LOGITS_BOUND)):
        dprm = {"cpu": prm, "cuda": {k: v.to(dev) for k, v in prm.items()}}
        for entry in ("forward", "prefill"):
            out = {}
            for where, b_ in bundles.items():
                toks = on(where, (smoke_tokens,))[0]
                lg = (b_.forward(dprm[where], toks) if entry == "forward"
                      else b_.prefill(dprm[where], toks, max_seq=12)[0])
                out[where] = lg.float().cpu().reshape(-1, lg.shape[-1])
            nxt, got = out["cpu"].argmax(-1), out["cuda"].argmax(-1)
            err = float((out["cpu"] - out["cuda"]).abs().max())
            parity[f"{entry}_{label}"] = dict(
                max_abs_logits_diff=err, per_step=[err],
                greedy_agree=int((nxt == got).sum()),
                greedy_total=int(nxt.numel()), flips=[dict(
                    step=0, row=row, cpu_gap=float(
                        out["cpu"][row, nxt[row]] - out["cpu"][row, got[row]]))
                    for row in torch.nonzero(nxt != got).flatten().tolist()],
                bound=bound)
    for arch in RECURRENT_ARCHS:
        for kind, r in recurrent_smoke_parity(torch, arch, args.seed,
                                              dev).items():
            parity[f"{arch.split('-')[0]}_{kind}"] = r
    for arch in (*MOE_LAYERS, "internvl2-1b"):
        for kind, r in family_smoke_parity(torch, arch, args.seed,
                                           dev).items():
            parity[f"{arch.split('-')[0]}_{kind}"] = r
    # the G-wide smoke variants: the wide decode kernels (a group in parts
    # of 8) under the model, held to the llama3-8b smoke bounds
    for arch, groups in WIDE_SMOKE:
        for kind, r in family_smoke_parity(
                torch, arch, args.seed, dev,
                scfg=wide_variant(get_config(arch), groups)).items():
            parity[f"{arch.split('-')[0]}_g{groups}_{kind}"] = r
    report["smoke_parity"] = parity
    print("[5] smoke llama3-8b, rwkv6-3b, mamba2-2.7b, zamba2-1.2b, "
          "arctic-480b, llama4-maverick-400b-a17b, internvl2-1b and the "
          "G-wide variants of starcoder2-15b (G = 12) and chatglm3-6b (G = "
          f"16), card (kernels) vs CPU (plain), same weights (bound "
          f"{SMOKE_LOGITS_BOUND} on max |logits diff|, "
          f"{F32_SMOKE_LOGITS_BOUND:g} for the fp32 entries; every row's "
          "routing compared, padded positions' included):")
    for kind, r in parity.items():
        print(f"    {kind:14s} max |logits diff| "
              f"{r['max_abs_logits_diff']:.4g}, per step "
              f"{[round(x, 4) for x in r['per_step']]}, greedy tokens agree "
              f"{r['greedy_agree']}/{r['greedy_total']}"
              + "".join(f"; step {f['step']} row {f['row']}: the card's token"
                        f" is {f['cpu_gap']:.4g} below the CPU's best on the "
                        f"CPU's logits" for f in r["flips"])
              + "".join(f"; routing differs at step {f['step']} (MoE call "
                        f"{f.get('call')}, row {f.get('row')}: the card's "
                        f"expert {f.get('gap', 0):.3g} below the CPU's k-th "
                        f"router logit, a bf16 ulp {f.get('ulp', 0):.3g}), "
                        f"held: the {r['steps_held']} steps before"
                        for f in r.get("routing_flips", ())))
    for kind, r in parity.items():
        err = r["max_abs_logits_diff"]
        if not math.isfinite(err) or err > r["bound"]:
            fail(f"{kind}: card and CPU logits differ beyond the bound")
    # the MoE smoke configs at the published capacity factor: the card's
    # dropped dispatches, request by request, against the CPU's
    report["capacity_drops"] = {arch: capacity_drops(torch, arch, args.seed,
                                                     dev)
                                for arch in MOE_LAYERS}
    # a bf16 model serving on fp32 KV pools (kv_dtype="float32"): every
    # decode tick's attention on the fp32-pool kernel
    fp32_eng = PagedServeEngine(bundles["cuda"], {
        k: v.to(dev) for k, v in smoke_params["bf16"].items()},
        device="cuda", slots=2, page_size=8, prefill_chunk=8,
        kv_dtype="float32")
    fp32_reqs = [Request(rid=i, prompt=smoke_tokens[i].tolist(),
                         max_new_tokens=6) for i in range(2)]
    finite.clear()
    reset_counts()
    bundles["cuda"].decode_paged = checked(bundles["cuda"].decode_paged)
    for r in fp32_reqs:
        fp32_eng.submit(r)
    fp32_eng.run_until_drained()
    torch.cuda.synchronize()
    fm = fp32_eng.metrics
    fp32_launches = llm_counts()
    fp32_expect = expected_counts(
        apr_matmul=(7 * scfg.num_layers + 1) * (fm.decode_calls
                                                + fm.prefill_calls),
        flash_decode_paged_f32=scfg.num_layers * (fm.decode_calls
                                                  + fm.prefill_calls))
    report["serve_fp32_pools_smoke"] = dict(
        kv_pool_bytes=fp32_eng.kv_pool_bytes(), launches=fp32_launches,
        expected_launches=fp32_expect, decode_calls=fm.decode_calls,
        outputs=[r.output for r in fp32_reqs])
    print(f"    PagedServeEngine(kv_dtype='float32') on the bf16 smoke "
          f"model: {fm.requests_done}/2 requests, {fm.decode_calls} decode "
          f"ticks, KV pools {fp32_eng.kv_pool_bytes()} bytes; launches "
          f"{fp32_launches} (expected {fp32_expect})")
    check_served("phase 5 fp32 pools", fp32_reqs, 6, fp32_launches,
                 fp32_expect)
    del fp32_eng
    # a model with fp32 parameters (the smoke weights in fp32) served on
    # the card (the fp32 body under every projection, the decode kernels
    # with an fp32 q) and on the CPU (plain versions): on fp32, bf16 and
    # int8 KV pools by the PagedServeEngine, with int8 weights
    # (quantize_params) on fp32 pools, and on the slot ServeEngine (bf16
    # cache); every forward's live logits within F32_SMOKE_LOGITS_BOUND,
    # greedy tokens equal, the launches exactly those of the path
    f32_prm = {k: v.float() for k, v in smoke_params["bf16"].items()}
    f32_int8_prm = bundles["cpu"].quantize_params(f32_prm)
    per_call_s = 7 * scfg.num_layers + 1

    def serve_f32_smoke(prm, kv_dtype):
        """Serve the two smoke prompts on the CPU and on the card: the
        PagedServeEngine over ``kv_dtype`` pools, or (``kv_dtype`` None)
        the slot ServeEngine; returns each side's live logits by forward
        and requests, the card's engine metrics and launches, and (int8
        pools) the number of K/V codes in which the two sides' pools
        differ outside the null page."""
        logits, reqs, card, pools = {}, {}, {}, {}
        for side, where in (("cpu", "cpu"), ("card", "cuda")):
            b_, store = bundles[where], []
            logits[side] = store
            dprm = {k: v.to(where) for k, v in prm.items()}
            if kv_dtype is None:
                eng = ServeEngine(b_, dprm, device=where, slots=2,
                                  max_seq=32)
                inner = eng._decode

                def slot_recorded(*a, inner=inner, eng=eng, store=store):
                    out = inner(*a)
                    finite.append(bool(torch.isfinite(out).all()))
                    active = torch.tensor([r is not None for r in eng.active])
                    store.append(out.float().cpu()[active, 0])
                    return out

                eng._decode = slot_recorded
                restore = None
            else:
                inner = b_.decode_paged

                def recorded(*a, inner=inner, store=store):
                    out = inner(*a)
                    counts = a[4].long().cpu()
                    live = torch.arange(out.shape[1])[None] < counts[:, None]
                    store.append(out.float().cpu()[live])
                    return out

                b_.decode_paged = recorded
                restore = (b_, inner)
                eng = PagedServeEngine(b_, dprm, device=where, slots=2,
                                       page_size=8, prefill_chunk=8,
                                       kv_dtype=kv_dtype)
            reqs[side] = [Request(rid=i, prompt=smoke_tokens[i].tolist(),
                                  max_new_tokens=6) for i in range(2)]
            finite.clear()
            reset_counts()
            for r in reqs[side]:
                eng.submit(r)
            eng.run_until_drained()
            torch.cuda.synchronize()
            if restore is not None:
                restore[0].decode_paged = restore[1]
            if kv_dtype == "int8":        # past the null page 0, whose
                # padded writes collide in index_put_ in no fixed order
                pools[side] = [eng.cache[k][:, :, 1:].cpu()
                               for k in ("k", "v")]
            if side == "card":
                card = dict(metrics=getattr(eng, "metrics", None),
                            launches=llm_counts(), forwards=len(store))
            del eng
        if pools:
            card["codes_differ"] = sum(int((a != b).sum()) for a, b in zip(
                pools["cpu"], pools["card"]))
        return logits, reqs, card

    f32_runs = {}
    for label, prm, kv_dtype in (
            ("fp32 pools", f32_prm, "float32"),
            ("bf16 pools", f32_prm, "bfloat16"),
            ("int8 pools", f32_prm, "int8"),
            ("int8 weights, fp32 pools", f32_int8_prm, "float32"),
            ("slot engine", f32_prm, None)):
        logits, reqs, card = serve_f32_smoke(prm, kv_dtype)
        fm = card["metrics"]
        if kv_dtype is None:
            forwards = card["forwards"]
            expect = expected_counts(apr_matmul_f32=per_call_s * forwards,
                                     flash_decode_f32q=scfg.num_layers
                                     * forwards)
        else:
            forwards = fm.decode_calls + fm.prefill_calls
            weights = ("apr_matmul_f32_int8w" if prm is f32_int8_prm
                       else "apr_matmul_f32")
            attention = {"float32": "flash_decode_paged_f32",
                         "bfloat16": "flash_decode_paged_f32q",
                         "int8": "flash_decode_paged_int8_f32q"}[kv_dtype]
            expect = expected_counts(**{
                weights: per_call_s * forwards,
                attention: scfg.num_layers * forwards})
        diffs = [float((c - g).abs().max()) for c, g in
                 zip(logits["cpu"], logits["card"]) if c.numel()]
        tokens = {w: [r.output for r in rs] for w, rs in reqs.items()}
        bound = (F32_INT8_CODE_LOGITS_BOUND if card.get("codes_differ")
                 else F32_SMOKE_LOGITS_BOUND)
        run = dict(forwards=len(logits["card"]),
                   cpu_forwards=len(logits["cpu"]),
                   max_abs_logits_diff=max(diffs), per_forward=diffs,
                   bound=bound, tokens=tokens, launches=card["launches"],
                   expected_launches=expect)
        if "codes_differ" in card:
            run["kv_codes_differ"] = card["codes_differ"]
        f32_runs[label] = run
        print(f"    fp32 parameters, {label} ("
              + ("ServeEngine" if kv_dtype is None else "PagedServeEngine")
              + f"): {len(diffs)} forwards, max |logits diff| card vs CPU "
              f"{max(diffs):.3g} (bound {bound:g}"
              + (f"; K/V codes apart in the two sides' pools: "
                 f"{card['codes_differ']}" if "codes_differ" in card else "")
              + f"), greedy tokens card {tokens['card']} CPU "
              f"{tokens['cpu']}; launches {card['launches']} (expected "
              f"{expect})")
        check_served(f"phase 5 fp32 params, {label}", reqs["card"], 6,
                     card["launches"], expect)
        if run["forwards"] != run["cpu_forwards"] or not all(
                math.isfinite(x) and x <= bound for x in diffs):
            fail(f"phase 5 fp32 params, {label}: card and CPU logits differ "
                 f"beyond the bound")
        if tokens["card"] != tokens["cpu"]:
            fail(f"phase 5 fp32 params, {label}: greedy tokens differ "
                 f"between card and CPU")
    report["serve_fp32_params_smoke"] = f32_runs["fp32 pools"]
    report["serve_fp32_params_smoke_more"] = {
        k: v for k, v in f32_runs.items() if k != "fp32 pools"}

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
    expect_hbm = len(conv_geometries("resnet20"))     # one a conv
    hbm_rel = rel_logits_err(logits_hbm, logits["resnet20"])
    logits_plain = fwd(params, x, conv=conv2d_ref)
    plain_rel = rel_logits_err(logits["resnet20"], logits_plain)
    # MobileNet-V1 on the baseline (its 14 convs memory-resident, the
    # depthwise ones plain on both) and on the plain path
    mfwd, mparams, mx = nets["mobilenet_v1"]
    reset_counts()
    mb_hbm = mfwd(mparams, mx, conv=hbm_conv)
    torch.cuda.synchronize()
    mb_hbm_launches = apr_conv2d.hbm_launches
    mb_hbm_rel = rel_logits_err(mb_hbm, logits["mobilenet_v1"])
    mb_plain_rel = rel_logits_err(logits["mobilenet_v1"],
                                  mfwd(mparams, mx, conv=conv2d_ref))
    cnn = dict(batch=CNN_BATCH, launches_per_forward=per_net,
               expected_per_forward=expect_per_net, main_path_launches=
               cnn_launches, hbm_launches=hbm_launches,
               expected_hbm_launches=expect_hbm,
               mobilenet_hbm_launches=mb_hbm_launches,
               resnet20_hbm_vs_apr_rel=hbm_rel,
               resnet20_apr_vs_plain_rel=plain_rel,
               mobilenet_hbm_vs_apr_rel=mb_hbm_rel,
               mobilenet_apr_vs_plain_rel=mb_plain_rel,
               max_abs_logit={n: float(v.abs().max())
                              for n, v in logits.items()})
    print(f"[6] CNN inference at batch {CNN_BATCH}: apr_conv launches per "
          f"forward {per_net} (expected {expect_per_net}); on "
          f"apr_conv_hbm: ResNet-20 {hbm_launches} launches (expected "
          f"{expect_hbm}), MobileNet-V1 {mb_hbm_launches} (expected "
          f"{expect_per_net['mobilenet_v1']}); max |diff| / max |logit|: "
          f"ResNet-20 hbm vs apr {hbm_rel:.3g}, apr vs plain "
          f"{plain_rel:.3g}; MobileNet-V1 hbm vs apr {mb_hbm_rel:.3g}, apr "
          f"vs plain {mb_plain_rel:.3g} (bound {CNN_LOGITS_RTOL:g})")
    if per_net != expect_per_net:
        fail(f"apr_conv launches {per_net} != {expect_per_net}")
    if hbm_launches != expect_hbm:
        fail(f"apr_conv_hbm launches {hbm_launches} != {expect_hbm}")
    if mb_hbm_launches != expect_per_net["mobilenet_v1"]:
        fail(f"MobileNet-V1 apr_conv_hbm launches {mb_hbm_launches} != "
             f"{expect_per_net['mobilenet_v1']}")
    for name, v in list(logits.items()) + [("resnet20 hbm", logits_hbm),
                                           ("mobilenet_v1 hbm", mb_hbm)]:
        if v.shape != (CNN_BATCH, 10) or not bool(torch.isfinite(v).all()):
            fail(f"{name}: logits {tuple(v.shape)} not finite of shape "
                 f"({CNN_BATCH}, 10)")
    if not max(hbm_rel, plain_rel, mb_hbm_rel,
               mb_plain_rel) <= CNN_LOGITS_RTOL:
        fail("CNN forwards disagree beyond the bound")
    del logits, logits_hbm, logits_plain, mb_hbm

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
    mx1 = mx[:1].contiguous()
    runs += [(f"mobilenet_v1 b{CNN_BATCH}", CNN_BATCH, 20, mfwd, mparams, mx,
              apr_conv2d),
             (f"mobilenet_v1 b{CNN_BATCH} hbm", CNN_BATCH, 10, mfwd, mparams,
              mx, hbm_conv),
             (f"mobilenet_v1 b{CNN_BATCH} plain", CNN_BATCH, 20, mfwd,
              mparams, mx, conv2d_ref),
             ("mobilenet_v1 b1", 1, 50, mfwd, mparams, mx1, apr_conv2d),
             ("mobilenet_v1 b1 plain", 1, 50, mfwd, mparams, mx1,
              conv2d_ref)]
    times, rates = {}, {}
    for label, batch, iters, f_, p_, x_, conv in runs:
        times[label] = forward_ms(lambda: f_(p_, x_, conv=conv), iters)
        rates[label] = batch / times[label] * 1e3
        print(f"    {label:26s} {times[label]:9.4f} ms per forward, "
              f"{rates[label]:10.1f} images/s")
    cnn["ms_per_forward"], cnn["images_per_s"] = times, rates
    # MobileNet-V1's depthwise convs (plain F.conv2d, groups = C) against
    # its whole forward, by CUDA events around each and around the forward
    from repro_torch.models.cnn import depthwise
    dw_share = {}
    for batch, x_ in ((CNN_BATCH, mx), (1, mx1)):
        pairs, whole = [], []

        def dw_timed(x, f, stride):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            a.record()
            y = depthwise(x, f, stride)
            b.record()
            pairs.append((a, b))
            return y

        for _ in range(6):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            a.record()
            mfwd(mparams, x_, dw=dw_timed)
            b.record()
            whole.append((a, b))
        torch.cuda.synchronize()
        pairs, whole = pairs[13:], whole[1:]       # the first forward warms
        dw_ms = sum(a.elapsed_time(b) for a, b in pairs) / len(whole)
        fwd_ms = sum(a.elapsed_time(b) for a, b in whole) / len(whole)
        dw_share[batch] = dict(depthwise_ms=dw_ms, forward_event_ms=fwd_ms,
                               share=dw_ms / fwd_ms)
        print(f"    MobileNet-V1 at batch {batch}: the 13 depthwise convs "
              f"(F.conv2d, groups = C) {dw_ms:.4f} ms of a {fwd_ms:.4f} ms "
              f"forward (CUDA events), {dw_ms / fwd_ms:.1%}")
    cnn["mobilenet_depthwise"] = dw_share
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
    phase_done("phase 6")

    # ----------------------------- 6g the CNNs through the graph compiler
    from repro_torch.bench.config import scoped_cache
    from repro_torch.graph import compile_fn
    #: the graph path's launches a forward: B7m, B7 and the kernels that run
    #: the rest (B5, the fp32 B1)
    graph_counts = lambda: {                              # noqa: E731
        "apr_matmul_fused_f32": apr_matmul_fused.f32_launches,
        "apr_conv_fused": apr_conv2d_fused.launches,
        "apr_conv": apr_conv2d.launches,
        "apr_matmul_f32": apr_matmul.f32_launches}
    n_convs = {name: len(conv_geometries(name)) for name in ("lenet",
                                                            "resnet20")}
    expect_g = {
        ("lenet", "fused"): dict(apr_matmul_fused_f32=2, apr_conv_fused=0,
                                 apr_conv=n_convs["lenet"], apr_matmul_f32=1),
        ("lenet", "unfused"): dict(apr_matmul_fused_f32=0, apr_conv_fused=0,
                                   apr_conv=n_convs["lenet"],
                                   apr_matmul_f32=3),
        ("resnet20", "fused"): dict(
            apr_matmul_fused_f32=0, apr_conv_fused=10,
            apr_conv=n_convs["resnet20"] - 10, apr_matmul_f32=1),
        ("resnet20", "unfused"): dict(
            apr_matmul_fused_f32=0, apr_conv_fused=0,
            apr_conv=n_convs["resnet20"], apr_matmul_f32=1)}
    graph_cnn = {}
    with scoped_cache(ConfigCache(Path(tmp.name) / "graph_cnn.json")):
        for name in ("lenet", "resnet20"):
            fwd, params, x = nets[name]
            fn = (lambda f, p: lambda xx: f(p, xx))(fwd, params)
            eager = fn(x)
            t0 = time.perf_counter()
            exs = {"fused": compile_fn(fn, x, name=f"{name}-b{CNN_BATCH}"),
                   "unfused": compile_fn(fn, x, fused=False)}
            torch.cuda.synchronize()
            res = dict(compile_s=time.perf_counter() - t0,
                       graphs=graph_summary(exs), runs={})
            for label, ex in exs.items():
                ex(x)                                   # warm: builds nodes
                torch.cuda.synchronize()
                reset_counts()
                out = ex(x)
                torch.cuda.synchronize()
                launches = graph_counts()
                res["runs"][label] = dict(
                    launches=launches, expected=expect_g[(name, label)],
                    rel_vs_eager=rel_logits_err(out, eager),
                    finite=bool(torch.isfinite(out).all()),
                    shape=list(out.shape),
                    ms=cuda_ms(torch, lambda i: ex(x), 10),
                    host_ms=forward_ms(lambda: ex(x), 10))
            res["eager_ms"] = cuda_ms(torch, lambda i: fn(x), 10)
            res["eager_host_ms"] = forward_ms(lambda: fn(x), 10)
            graph_cnn[name] = res
    graph_fused = graph_fused_timing(torch, gen, dev)
    report["graph_cnn"] = dict(nets=graph_cnn, fused_kernels=graph_fused)
    print(f"[6g] LeNet-5 and ResNet-20 at batch {CNN_BATCH} through "
          f"compile_fn (traced on the card; the cost model's schedule):")
    for name, res in graph_cnn.items():
        print_graph_summary({f"{name} {k}": v
                             for k, v in res["graphs"].items()})
        for label, r in res["runs"].items():
            print(f"    {name} {label}: {r['ms']:.3f} ms a forward (CUDA "
                  f"events; host {r['host_ms']:.3f} ms), eager "
                  f"{res['eager_ms']:.3f} ms (host {res['eager_host_ms']:.3f}"
                  f" ms); max|diff|/max|logit| vs eager {r['rel_vs_eager']:.3g}"
                  f" (bound {CNN_LOGITS_RTOL:g}); launches {r['launches']} "
                  f"(expected {r['expected']})")
    for name, t in graph_fused.items():
        print(f"    {name} per forward ({t['launches_per_forward']} launches):"
              f" {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"{t['library_call']} {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.0%} of bound")
    for name, res in graph_cnn.items():
        for label, r in res["runs"].items():
            if r["launches"] != r["expected"]:
                fail(f"phase 6g {name} {label}: launches {r['launches']} != "
                     f"{r['expected']}")
            if not (r["finite"] and r["shape"] == [CNN_BATCH, 10]
                    and r["rel_vs_eager"] <= CNN_LOGITS_RTOL):
                fail(f"phase 6g {name} {label}: logits {r['shape']} finite "
                     f"{r['finite']}, {r['rel_vs_eager']:.3g} from the eager "
                     f"forward's")
    del nets
    phase_done("phase 6g")

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
              f"{pg['peak_mem_gb']:.2f} GB; state (and KV) pools "
              f"{pg['state_pool_bytes']} bytes ({pg['state_pool_slots']} "
              f"state slots)")
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
        print(f"    {pf['entry']} of 1024 tokens: kernels {pf['kernel_ms']:.3f} ms "
              f"(host clock), of it the {pf['scan_launches']} scans "
              f"{pf['scan_ms']:.3f} ms (CUDA events, "
              f"{pf['scan_share']:.1%}), "
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
        for sp in (rec["spec"], rec["spec_oracle"]):
            if sp is None:
                continue
            print(f"    SpeculativeServeEngine ({sp['draft']}, spec_k="
                  f"{sp['spec_k']}): {sp['requests_done']} requests "
                  f"({sp['max_new']} new tokens) in "
                  f"{sp['wall_s']:.2f} s wall; {sp['spec_steps']} request "
                  f"verify steps in {sp['decode_calls']} verify forwards "
                  f"({sp['ms_per_verify_step']:.3f} ms each, spec_k + 1 "
                  f"token-forwards), acceptance "
                  f"{sp['acceptance_rate']:.3f}, "
                  f"{sp['tokens_per_step']:.3f} tokens a step, "
                  f"{sp['spec_decode_tps']:.2f} tok/s incl. draft; "
                  f"{sp['state_restores']} state-ring restores; greedy "
                  f"tokens equal to the paged engine's "
                  f"{sp['tokens_equal_paged']}/{sp['tokens_total']}; "
                  f"launches {sp['launches']} over {sp['token_forwards']} "
                  f"token-forwards" + (
                      f"; verify steps by tokens accepted (each as the "
                      f"paged engine's tokens allow) "
                      f"{sp['steps_by_accepted']}"
                      if "steps_by_accepted" in sp else ""))
        # a row's bits do not depend on the batch (B1's and the decode
        # attention's split counts follow the shape alone), so the engines
        # agree token for token on every family, the hybrid included
        if sl["tokens_equal_paged"] != sl["tokens_total"]:
            fail(f"{arch}: the slot engine's greedy tokens differ from the "
                 f"paged engine's ({sl['tokens_equal_paged']}/"
                 f"{sl['tokens_total']})")
    report["recurrent"] = recurrent
    phase_done("phase 7")

    # ------------------------ 7b the moe and vlm families, full width
    torch.cuda.empty_cache()
    families = {}
    for arch in MOE_LAYERS:
        families[arch] = moe_serving(torch, arch, args.seed, dev, finite,
                                     reset_counts, llm_counts, check_served)
        torch.cuda.empty_cache()
    families["internvl2-1b"] = vlm_full(torch, args.seed, dev, finite,
                                        reset_counts, llm_counts,
                                        check_served)
    report["families"] = families
    phase_done("phase 7b")

    # ---- 7c groups wider than 8 and the audio family, full width
    torch.cuda.empty_cache()
    wide = {}
    for arch in WIDE_ARCHS:
        wide[arch] = wide_serving(torch, arch, args.seed, dev, finite,
                                  reset_counts, llm_counts, check_served)
        torch.cuda.empty_cache()
    wide["whisper-large-v3"] = whisper_full(torch, args.seed, dev, finite,
                                            reset_counts, llm_counts,
                                            check_served)
    report["wide"] = wide
    phase_done("phase 7c")

    # ------------------------- 8 the tuning path at llama3-8b full width
    tuning = tuning_path(torch, args.seed, dev, tmp.name, engine_kw, prompts,
                         bf16_outputs, checked, finite, reset_counts,
                         llm_counts, expected_counts, check_served)
    report["tuning"] = tuning
    phase_done("phase 8")

    # ----------------------------------------------- 9 the training path
    print("[9] training: B1 under autograd, the smoke configs card against "
          "CPU, the launcher resumed, llama3-8b at full width", flush=True)
    train_rows = train_matmul_checks(torch, gen, dev)
    bad = [f"{r['name']} {r['dtype']}" for r in train_rows if not r["ok"]]
    if bad:
        fail(f"phase 9a: B1's dX / dW outside phase 2's bound at {bad}")
    totals = train_step_totals(train_rows)
    print(f"    9a per full-width step ({TRAIN_LAYERS} layers + head, M = "
          f"{TRAIN_B * TRAIN_T}): B1 forward + recompute "
          f"{totals['fwd']['ms']:.3f} ms (torch.matmul "
          f"{totals['fwd']['library_ms']:.3f}, bound "
          f"{totals['fwd']['bound_ms']:.3f}), backward dX "
          f"{totals['dx']['ms']:.3f} + dW {totals['dw']['ms']:.3f} ms "
          f"(torch.matmul {totals['dx']['library_ms']:.3f} + "
          f"{totals['dw']['library_ms']:.3f}, bound "
          f"{totals['bwd']['bound_ms']:.3f}; plain "
          f"{totals['bwd']['plain_ms']:.3f}), transposes "
          f"{totals['transpose_ms']:.3f} ms", flush=True)
    train_smoke = train_smoke_parity(torch, dev, reset_counts, llm_counts)
    bad = [k for k, v in train_smoke.items()
           if isinstance(v, dict) and not v.get("ok", True)]
    if bad:
        fail(f"phase 9b: card and CPU training part beyond the bounds in "
             f"{bad}")
    train_cli = train_launcher_resume(torch, tmp.name)
    if not (train_cli["equal"] and train_cli["finite"]):
        fail(f"phase 9c: the resumed launcher run's losses differ from the "
             f"uninterrupted run's at steps {train_cli['steps_differ']}")
    torch.cuda.empty_cache()
    train = train_full(torch, args.seed, dev, reset_counts)
    want = TRAIN_STEPS * (TRAIN_FWD_LAUNCHES + TRAIN_RECOMPUTE_LAUNCHES
                          + TRAIN_BWD_LAUNCHES)
    train_launches = train["launches"]
    if not all(math.isfinite(st[k]) for st in train["steps"]
               for k in ("loss", "grad_norm")):
        fail(f"phase 9d: a loss or grad norm is not finite: "
             f"{train['steps']}")
    if (train_launches["apr_matmul"] != want
            or train_launches["backward"]
            != TRAIN_STEPS * TRAIN_BWD_LAUNCHES
            or train_launches["forward"] != TRAIN_STEPS * (
                TRAIN_FWD_LAUNCHES + TRAIN_RECOMPUTE_LAUNCHES)
            or train_launches["other"]):
        fail(f"phase 9d: B1 launches {train_launches} over {TRAIN_STEPS} "
             f"steps; "
             f"expected {want} ({TRAIN_FWD_LAUNCHES} forward + "
             f"{TRAIN_RECOMPUTE_LAUNCHES} recompute + {TRAIN_BWD_LAUNCHES} "
             f"backward a step), no other matmul kernel")
    remat = train["remat"]
    want = {"nothing": dict(forward=TRAIN_FWD_LAUNCHES,
                            recompute=TRAIN_RECOMPUTE_LAUNCHES,
                            backward=TRAIN_BWD_LAUNCHES),
            "dots": dict(forward=TRAIN_FWD_LAUNCHES, recompute=0,
                         backward=TRAIN_BWD_LAUNCHES)}
    if not remat["bit_equal"] or any(remat[p]["launches"] != want[p]
                                     for p in REMAT_POLICIES):
        fail(f"phase 9d: under remat_policy 'dots' a grad leaf differs from "
             f"'nothing' (bit-equal: {remat['bit_equal']}) or B1's launches "
             f"{ {p: remat[p]['launches'] for p in REMAT_POLICIES} } are "
             f"not {want}")
    report["train"] = dict(matmul=train_rows, totals=totals,
                           smoke=train_smoke, launcher=train_cli, full=train)
    phase_done("phase 9")

    # ------------- 9e the recurrent and audio families' training path
    print("[9e] training rwkv6-3b, mamba2-2.7b, zamba2-1.2b and "
          "whisper-large-v3: B9/B10's backward kernels, the smoke configs "
          "card against CPU, full width with the depth cut", flush=True)
    torch.cuda.empty_cache()
    scan_grad_rows = scan_grad_checks(torch, gen, dev)
    bad = [f"{r['kernel']} {r['shape']} {r['dtype']} {r['decay']}"
           for r in scan_grad_rows if not r["ok"]]
    if bad:
        fail(f"phase 9e-a: backward kernels outside {SCAN_GRAD_RTOL:g} of "
             f"their plain versions, or not bit-stable, at {bad}")
    rec_smoke = train_recurrent_smoke_parity(torch, dev)
    bad = [a for a in TRAIN_RECURRENT if not rec_smoke[a]["ok"]
           or rec_smoke[a]["plain_bwd_calls"]]
    want = {}       # the fp32 step 0 and 3 bf16 steps of each arch
    for arch in TRAIN_RECURRENT:
        for k, v in scan_per_step(get_config(arch, smoke=True)).items():
            want[k] = want.get(k, 0) + 4 * v
    if bad or any(rec_smoke["launches"][k] != want.get(k, 0)
                  for k in rec_smoke["launches"]):
        fail(f"phase 9e-b: card and CPU training part beyond the bounds, or "
             f"a plain backward ran on the card, in {bad}; launches "
             f"{rec_smoke['launches']} (expected {want})")
    torch.cuda.empty_cache()
    rec_full = train_recurrent_full(torch, args.seed, dev)
    bad = [a for a, r in rec_full.items() if not (
        r["finite"] and r["launches_ok"] and r["plain_bwd_calls"] == 0)]
    if bad:
        fail(f"phase 9e-c: non-finite losses, launches other than "
             f"expected, or a plain backward on the card in {bad}: "
             f"{ {a: (rec_full[a]['launches'], rec_full[a]['expected'], rec_full[a]['plain_bwd_calls']) for a in bad} }")
    report["train_recurrent"] = dict(kernels=scan_grad_rows,
                                     smoke=rec_smoke, full=rec_full)
    phase_done("phase 9e")

    # ------------------------ 9f the moe family's training path
    print("[9f] training arctic-480b and llama4-maverick: B1 at the expert "
          "backward's shapes, the smoke configs card against CPU, full "
          "width with the depth cut (Adafactor, donate)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    allocated before 9f (phase 7b's weights freed): "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    moe_grad_rows = moe_grad_checks(torch, gen, dev)
    bad = [f"{r['arch']} {r['kind']} rows={r['rows']}" for r in moe_grad_rows
           if not r["ok"]]
    if bad:
        fail(f"phase 9f-a: B1 at the expert backward's shapes outside phase "
             f"2's bound, or not written into its slice, at {bad}")
    moe_smoke = train_moe_smoke_parity(torch, dev)
    bad = [a for a in TRAIN_MOE if not moe_smoke[a]["ok"]]
    if bad or not (moe_smoke["launches"]["expert_backward"]
                   and moe_smoke["launches"]["expert_backward_f32"]):
        fail(f"phase 9f-b: card and CPU training part beyond the bounds, a "
             f"routing swap not a near-tie, or no expert backward launched, "
             f"in {bad}; launches {moe_smoke['launches']}")
    torch.cuda.empty_cache()
    moe_full = train_moe_full(torch, args.seed, dev)
    bad = {a: dict(finite=r["finite"], launches_ok=r["launches_ok"],
                   memory_ok=r["memory_ok"])
           for a, r in moe_full.items()
           if not (r["finite"] and r["launches_ok"] and r["memory_ok"])}
    if bad:
        fail(f"phase 9f-c: non-finite losses, B1 launches other than the "
             f"expert counts imply (or a recompute that routed otherwise), or "
             f"peak memory over params + grads not below the largest expert "
             f"leaf, in {bad}")
    bad = {a: dict(bit_equal=moe_full[a]["remat"]["bit_equal"],
                   launches_ok=moe_full[a]["remat"]["launches_ok"])
           for a in TRAIN_MOE_REMAT
           if not (moe_full[a]["remat"]["bit_equal"]
                   and moe_full[a]["remat"]["launches_ok"])}
    if bad:
        fail(f"phase 9f-c: under remat_policy 'dots' a grad leaf differs from "
             f"'nothing', or B1's recompute launches are not 3 a non-empty "
             f"expert of the recompute's counts, in {bad}")
    moe_step = moe_full["arctic-480b"]["expert_backward_step"]
    report["train_moe"] = dict(kernels=moe_grad_rows, smoke=moe_smoke,
                               full=moe_full)
    phase_done("phase 9f")

    # ------------------------------------------------------------ 10 report
    def by_path(**paths) -> dict:
        """``launches`` (their sum) and ``launches_by_path``: each path's
        count, read just after the run that zeroed it."""
        return dict(launches=sum(paths.values()), launches_by_path=paths)

    def tick_entry(name, source, replaces, paths, kernel=None, row=None):
        """A kernels-line entry timed per full-width decode tick: the 225
        projections of phase 3's ``kernel`` rows, or 32 launches of
        ``row``; ``paths`` as :func:`by_path` takes them."""
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
                    **by_path(**paths), max_abs_err=errs[name], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=bound_by, library_ms=t["library_ms"])

    def hybrid_launches(engine, name):
        """``name``'s launches on phase 7's zamba2 ``engine`` run."""
        return recurrent["zamba2-1.2b"][engine]["launches"][name]

    def family_paths(name) -> dict:
        """``name``'s launches on each of phase 7b's runs that launched
        it (each run zeroed before and gated after)."""
        paths = {}
        for arch, fam in families.items():
            runs = dict(fam.get("runs", {}))
            runs.update({k: fam[k] for k in ("forward", "prefill",
                                             "decode_from_prefill", "paged",
                                             "slot") if k in fam})
            for run_name, r in runs.items():
                if r["launches"].get(name):
                    paths[f"phase 7b {arch} {run_name}"] = \
                        r["launches"][name]
        return paths

    def wide_paths(name, archs=None) -> dict:
        """``name``'s launches on each of phase 7c's runs (of ``archs``,
        every arch by default) that launched it."""
        return {f"phase 7c {arch} {run_name}": r["launches"][name]
                for arch, res in wide.items() if archs is None
                or arch in archs for run_name, r in res.items()
                if isinstance(r, dict) and r.get("launches", {}).get(name)}

    def graph_cnn_paths(name) -> dict:
        """``name``'s launches on each of phase 6g's forwards that launched
        it (each zeroed before and gated after)."""
        return {f"phase 6g {net} {label}": r["launches"][name]
                for net, res in graph_cnn.items()
                for label, r in res["runs"].items() if r["launches"][name]}

    def train_scan_paths(name) -> dict:
        """``name``'s launches on phase 9e-b's smoke training and on each
        of phase 9e-c's full-width runs that launched it."""
        paths = ({"phase 9e-b": rec_smoke["launches"][name]}
                 if rec_smoke["launches"][name] else {})
        paths.update({f"phase 9e-c {a}": r["launches"][name]
                      for a, r in rec_full.items() if r["launches"][name]})
        return paths

    mm_src = "src/repro_torch/csrc/apr_matmul.cu"
    fd_src = "src/repro_torch/csrc/flash_decode.cu"
    kernels = [
        tick_entry("apr_matmul", mm_src,
                   "src/repro/kernels/apr_matmul/kernel.py:139",
                   {"phase 4": serve["launches"]["apr_matmul"],
                    "phase 4g": serve_g["launches"]["apr_matmul"],
                    "phase 4e n-gram": spec_runs["ngram"][
                        "launches"]["apr_matmul"],
                    "phase 4e model draft": spec_runs["model"][
                        "launches"]["apr_matmul"],
                    "phase 4e oracle": spec_runs["oracle"][
                        "launches"]["apr_matmul"],
                    **family_paths("apr_matmul"),
                    **wide_paths("apr_matmul"),
                    "phase 9b": train_smoke["launches"]["apr_matmul"],
                    "phase 9f-b": moe_smoke["launches"]["apr_matmul"]
                    - moe_smoke["launches"]["expert_backward"],
                    **{f"phase 9f-c {a}": sum(
                        x["launches"] - x["expert_backward"]
                        for x in r["steps"]) for a, r in moe_full.items()}},
                   kernel="apr_matmul"),
        tick_entry("apr_matmul_int8w", mm_src,
                   "src/repro/kernels/apr_matmul/kernel.py:139",
                   {"phase 4b": serve_q["launches"]["apr_matmul_int8w"],
                    "phase 4g int8": serve_gq["launches"][
                        "apr_matmul_int8w"],
                    "phase 4e int8": spec_runs["int8"][
                        "launches"]["apr_matmul_int8w"],
                    **family_paths("apr_matmul_int8w"),
                    **wide_paths("apr_matmul_int8w")},
                   kernel="apr_matmul_int8w"),
        tick_entry("apr_matmul_f32", mm_src,
                   "src/repro/kernels/apr_matmul/kernel.py:139",
                   {"phase 5 fp32 pools": f32_runs["fp32 pools"][
                       "launches"]["apr_matmul_f32"],
                    **graph_cnn_paths("apr_matmul_f32"),
                    "phase 9b fp32": train_smoke["launches"][
                        "apr_matmul_f32"],
                    "phase 9f-b fp32": moe_smoke["launches"][
                        "apr_matmul_f32"]},
                   kernel="apr_matmul_f32"),
        tick_entry("apr_matmul_f32_int8w", mm_src,
                   "src/repro/kernels/apr_matmul/kernel.py:139",
                   {"phase 5 int8 weights, fp32 pools": f32_runs[
                       "int8 weights, fp32 pools"]["launches"][
                       "apr_matmul_f32_int8w"]},
                   kernel="apr_matmul_f32_int8w"),
        tick_entry("flash_decode_paged", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:153",
                   {"phase 4": serve["launches"]["flash_decode_paged"],
                    "phase 4g": serve_g["launches"]["flash_decode_paged"],
                    "phase 4e n-gram": spec_runs["ngram"][
                        "launches"]["flash_decode_paged"],
                    "phase 4e model draft": spec_runs["model"][
                        "launches"]["flash_decode_paged"],
                    "phase 4e oracle": spec_runs["oracle"][
                        "launches"]["flash_decode_paged"],
                    "phase 7 zamba2-1.2b paged": hybrid_launches(
                        "paged", "flash_decode_paged"),
                    "phase 7 zamba2-1.2b spec": hybrid_launches(
                        "spec", "flash_decode_paged"),
                    "phase 7 zamba2-1.2b spec oracle": hybrid_launches(
                        "spec_oracle", "flash_decode_paged"),
                    **family_paths("flash_decode_paged")},
                   row=paged_rows["flash_decode_paged"]),
        tick_entry("flash_decode_paged_f32", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:153",
                   {"phase 4f": serve_f["launches"]["flash_decode_paged_f32"]},
                   row=paged_rows["flash_decode_paged_f32"]),
        tick_entry("flash_decode_paged_f32q", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:153",
                   {"phase 5 bf16 pools": f32_runs["bf16 pools"][
                       "launches"]["flash_decode_paged_f32q"]},
                   row=paged_rows["flash_decode_paged_f32q"]),
        tick_entry("flash_decode_paged_int8", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:81",
                   {"phase 4b": serve_q["launches"][
                       "flash_decode_paged_int8"],
                    "phase 4g int8": serve_gq["launches"][
                        "flash_decode_paged_int8"],
                    "phase 4e int8": spec_runs["int8"][
                        "launches"]["flash_decode_paged_int8"],
                    **family_paths("flash_decode_paged_int8")},
                   row=paged_rows["flash_decode_paged_int8"]),
        tick_entry("flash_decode_paged_int8_f32q", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:81",
                   {"phase 5 int8 pools": f32_runs["int8 pools"][
                       "launches"]["flash_decode_paged_int8_f32q"]},
                   row=paged_rows["flash_decode_paged_int8_f32q"]),
        tick_entry("flash_decode", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:240",
                   {"phase 4c": slot["launches"]["flash_decode"],
                    "phase 4d decode from the prefilled cache": dense[
                        "decode_from_prefill"]["launches"]["flash_decode"],
                    "phase 7 zamba2-1.2b slot": hybrid_launches(
                        "slot", "flash_decode"),
                    **family_paths("flash_decode"),
                    **wide_paths("flash_decode", ("whisper-large-v3",))},
                   row=fdc_row),
        tick_entry("flash_decode_f32q", fd_src,
                   "src/repro/kernels/flash_decode/kernel.py:240",
                   {"phase 5 slot engine": f32_runs["slot engine"][
                       "launches"]["flash_decode_f32q"]}, row=fdc32q_row),
    ]
    # B2, B2q and B3 at the groups wider than 8, per full-width decode
    # tick of their arch (phase 3's rows times its layers); launches are
    # those of phase 7c's runs of that arch
    for (name, arch), row in wide_rows.items():
        n_layers = WIDE_TIMING[arch][1]
        paths = wide_paths(name, (arch,))
        if not paths:
            continue
        kernels.append(dict(
            name=f"{name}_g{row['Hq'] // row['Hkv']}", route="cuda",
            source=fd_src, replaces=(
                "src/repro/kernels/flash_decode/kernel.py:240"
                if name == "flash_decode" else
                "src/repro/kernels/flash_decode/kernel.py:153"),
            **by_path(**paths), max_abs_err=errs[name],
            **{key: n_layers * row[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")},
            bound_by=row["bound_by"]))
    # B1's wide body, per whole-sequence forward (phase 3's rows at M =
    # B x T) and per whisper prefill (its rows at M = 2 x 1500); launches
    # are the wide-tile ones of phase 4d's forward and prefill and of phase
    # 7c's whisper prefill
    whisper_wide = wide["whisper-large-v3"]["prefill"]["wide_launches"]
    for name, t, paths in (
            ("apr_matmul_wide", prefill_mm,
             {f"phase 4d {e}": dense[e]["wide_launches"]
              for e in ("forward", "prefill")}),
            ("apr_matmul_wide_whisper", whisper_mm,
             {"phase 7c whisper-large-v3 prefill": whisper_wide})):
        kernels.append(dict(
            name=name, route="cuda", source=mm_src,
            replaces="src/repro/kernels/apr_matmul/kernel.py:139",
            **by_path(**paths), max_abs_err=errs["apr_matmul_wide"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    # B1 on the training path, per full-width phase-9d step (phase 9a's
    # rows): the forward and its remat recompute, and the backward (dX +
    # dW; the transposes' copies apart); launches are phase 9d's
    dots = remat["dots"]["launches"]
    for name, part, launches, dots_launches in (
            ("apr_matmul_train", "fwd",
             train_launches["apr_matmul"] - train_launches["backward"],
             dots["forward"] + dots["recompute"]),
            ("apr_matmul_train_backward", "bwd",
             train_launches["backward"], dots["backward"])):
        t = totals[part]
        entry = dict(
            name=name, route="cuda", source=mm_src,
            replaces="src/repro/kernels/apr_matmul/kernel.py:139",
            **by_path(**{"phase 9d": launches,
                         "phase 9d remat_policy 'dots'": dots_launches}),
            max_abs_err=(errs["apr_matmul_wide"] if part == "fwd"
                         else totals["max_abs_err"]), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"])
        if part == "bwd":
            entry.update(dx_ms=totals["dx"]["ms"], dw_ms=totals["dw"]["ms"],
                         transpose_ms=totals["transpose_ms"])
        kernels.append(entry)
    # B1 on the moe training path's expert backward (ExpertMatmulFunction:
    # dX and dW of each non-empty expert's three stacked leaves), per
    # full-width arctic-480b step (phase 9f-c's last step's queues);
    # launches are phase 9f-b's (bf16) and 9f-c's
    kernels.append(dict(
        name="apr_matmul_moe_backward", route="cuda", source=mm_src,
        replaces="src/repro/kernels/apr_matmul/kernel.py:139",
        **by_path(**{"phase 9f-b": moe_smoke["launches"]["expert_backward"]},
                  **{f"phase 9f-c {a}": sum(x["expert_backward"]
                                            for x in r["steps"])
                     for a, r in moe_full.items()}),
        max_abs_err=max(r["err"] for r in moe_grad_rows), ms=moe_step["ms"],
        plain_ms=moe_step["plain_ms"], bound_ms=moe_step["bound_ms"],
        bound_by=moe_step["bound_by"], library_ms=moe_step["library_ms"],
        dx_ms=moe_step["dx_ms"], dw_ms=moe_step["dw_ms"],
        transpose_ms=moe_step["transpose_ms"]))
    # the conv kernels per ResNet-20 forward (LeNet-5's and ResNet-20's
    # launches) and per MobileNet-V1 forward (its launches), at CNN_BATCH
    for suffix, total, apr_paths, hbm_paths in (
            ("", conv_total,
             {**{f"phase 6 {net}": per_net[net] for net in ("lenet",
                                                            "resnet20")},
              **graph_cnn_paths("apr_conv")},
             {"phase 6 resnet20": hbm_launches}),
            ("_mobilenet", mb_total,
             {"phase 6 mobilenet_v1": per_net["mobilenet_v1"]},
             {"phase 6 mobilenet_v1": mb_hbm_launches})):
        bound_by = ("bytes" if total["t_mem_ms"] >= total["t_ops_ms"]
                    else "operations")
        for name, key, paths in (("apr_conv", "ms", apr_paths),
                                 ("apr_conv_hbm", "hbm_ms", hbm_paths)):
            kernels.append(dict(
                name=name + suffix, route="cuda",
                source="src/repro_torch/csrc/apr_conv.cu",
                replaces=("src/repro/kernels/apr_conv/kernel.py:44"
                          if name == "apr_conv" else
                          "src/repro/kernels/apr_matmul/kernel.py:124"),
                **by_path(**paths), max_abs_err=errs[name], ms=total[key],
                plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                bound_by=bound_by, library_ms=total["library_ms"]))
    # B9 and B10 per full-width decode tick at 4 slots: one launch per
    # layer at the phase-3 decode shape (32 rwkv6 layers, 64 mamba2 ones)
    for name, arch, source, replaces in (
            ("rwkv6_wkv", "rwkv6-3b", "src/repro_torch/csrc/rwkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:61"),
            ("mamba2_ssd", "mamba2-2.7b", "src/repro_torch/csrc/mamba2.cu",
             "src/repro/kernels/mamba2/kernel.py:59")):
        row = next(r for r in scan_rows
                   if r["kernel"] == name and r["shape"] == "decode")
        n_layers = get_config(arch).num_layers   # per full-depth tick
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            **by_path(**{f"phase 7 {a} {e}": r[e]["launches"][name]
                         for a, r in recurrent.items()
                         for e in ("paged", "slot", "spec", "spec_oracle")
                         if r.get(e) and r[e]["launches"][name]},
                      **train_scan_paths(name)),
            max_abs_err=errs[name], ms=n_layers * row["ms"],
            plain_ms=n_layers * row["plain_ms"],
            bound_ms=n_layers * row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None))
    # B9's and B10's backward kernels per full-width phase-9e-c step of
    # rwkv6-3b / mamba2-2.7b (a launch a layer at phase 9e-a's bf16
    # training shape); launches are phase 9e-b's and 9e-c's
    for name, arch, source, replaces in (
            ("rwkv6_wkv_backward", "rwkv6-3b",
             "src/repro_torch/csrc/rwkv6_bwd.cu",
             "src/repro/kernels/rwkv6/kernel.py:61"),
            ("mamba2_ssd_backward", "mamba2-2.7b",
             "src/repro_torch/csrc/mamba2_bwd.cu",
             "src/repro/kernels/mamba2/kernel.py:59")):
        row = next(r for r in scan_grad_rows if r["kernel"] == name
                   and r["arch"] == arch and r["dtype"] == "bfloat16")
        n_layers = TRAIN_RECURRENT[arch]["num_layers"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            **by_path(**train_scan_paths(name)),
            max_abs_err=max(r["max_abs_err"] for r in scan_grad_rows
                            if r["kernel"] == name),
            ms=n_layers * row["ms"], plain_ms=n_layers * row["plain_ms"],
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
        graph_path = ({"phase 4g int8": serve_gq["launches"][name]}
                      if serve_gq["launches"].get(name) else {})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            **by_path(**{"phase 8": tuning["launches"][name]},
                      **graph_path),
            max_abs_err=errs[name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes" if t["t_mem_ms"] >= t["t_ops_ms"]
            else "operations", library_ms=t["library_ms"]))
    # B7m on fp32 operands over LeNet-5's two FC layers and B7 over
    # ResNet-20's ten relu convs, per forward at CNN_BATCH (phase 6g's
    # timing); launches are those of phase 6g's fused forwards, the
    # graph compiler's dispatch
    for name, source, replaces in (
            ("apr_matmul_fused_f32", mm_src,
             "src/repro/kernels/apr_matmul/kernel.py:86"),
            ("apr_conv_fused", "src/repro_torch/csrc/apr_conv.cu",
             "src/repro/kernels/apr_matmul/kernel.py:86")):
        t = graph_fused[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            **by_path(**graph_cnn_paths(name)), max_abs_err=errs[name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    report["kernels"] = kernels
    report["kernels_note"] = (
        "launches: the sum of launches_by_path, whose each entry is one "
        "path's count, read just after the run that zeroed the counts and "
        "gated there against what that path demands. "
        "apr_matmul, apr_matmul_int8w, apr_matmul_f32, "
        "apr_matmul_f32_int8w, flash_decode_paged, flash_decode_paged_f32, "
        "flash_decode_paged_f32q, flash_decode_paged_int8, "
        "flash_decode_paged_int8_f32q, flash_decode and flash_decode_f32q: "
        "ms, plain_ms, bound_ms and library_ms are per full-width decode "
        "tick (4 slots): 225 projection shapes at the resolved split count "
        "(apr_matmul_f32 on fp32 weights, apr_matmul_f32_int8w fp32 "
        "activations over int8 weights, library torch.matmul in fp32 "
        "without TF32, on the fp32 dequantized weight for int8), 32 "
        "decode-attention launches at the phase-3 lengths (flash_decode "
        "over a max_seq-256 contiguous cache; the _f32q entries an fp32 q "
        "over bf16 or int8 K/V, library SDPA in fp32); launches are those "
        "of phase 4 (bf16 paged: decode ticks and, folded over the chunk's "
        "rows, prefill chunks; flash_decode_paged also phase 7's zamba2 "
        "paged and speculative runs), 4e (the speculative engine: verify "
        "steps, prefill chunks and the model draft's own forwards; "
        "apr_matmul and flash_decode_paged its n-gram and model-draft runs, "
        "apr_matmul_int8w and flash_decode_paged_int8 its int8 run), 4f "
        "(fp32 KV pages), 4b (int8 paged), 4c (slot; "
        "flash_decode also phase 4d's decode ticks from the prefilled cache "
        "and phase 7's zamba2 slot run) and 5 (the fp32-param smoke model: "
        "apr_matmul_f32 on fp32 "
        "pools, apr_matmul_f32_int8w with int8 weights, "
        "flash_decode_paged_f32q / _int8_f32q on bf16 / int8 pools, "
        "flash_decode_f32q on the slot engine). flash_decode_f32 (B3 over "
        "an fp32 cache) has phase-2 cases and a phase-3 row but no entry: "
        "no serving path launches it (the slot engine's cache is bf16); "
        "nor has the memory-resident baseline on fp32 operands "
        "(apr_matmul_hbm_f32), which phase 2 alone holds. "
        "apr_conv and apr_conv_hbm: per ResNet-20 forward at batch "
        f"{CNN_BATCH} (21 convs; library F.conv2d, channels-last fp32 without "
        "TF32); launches are those of phase 6's main path (one LeNet-5 and "
        "one ResNet-20 forward) and of its memory-resident ResNet-20 forward "
        "(one apr_conv_hbm launch a conv). apr_conv_mobilenet and "
        "apr_conv_hbm_mobilenet: the same kernels per MobileNet-V1 forward "
        f"at batch {CNN_BATCH} (its 14 convs: conv1 and the 13 pointwise; "
        "the depthwise convs are plain F.conv2d, as the JAX model computes "
        "them outside any kernel); launches are those of its phase-6 "
        "forward on each. "
        "Phase 7b (the moe and vlm families at published widths) adds its "
        "runs to apr_matmul, apr_matmul_int8w, flash_decode_paged, "
        "flash_decode_paged_int8 and flash_decode; the MoE runs' apr_matmul "
        "counts are gated against their routing (3 launches a non-empty "
        "expert). Phase 7c adds its runs to apr_matmul and "
        "apr_matmul_int8w, and whisper-large-v3's to flash_decode. "
        "flash_decode_paged_g12, flash_decode_paged_int8_g12 and "
        "flash_decode_g12 (starcoder2-15b, 48 query heads over 4 kv heads), "
        "flash_decode_paged_g16 and flash_decode_g16 (chatglm3-6b, 32 over "
        "2): the same kernels at a group wider than 8 (in parts of 8 query "
        "heads on the grid), per full-width decode tick of that arch (40 / "
        "28 launches at the phase-3 lengths, library gather + SDPA or "
        "masked SDPA); launches are those of phase 7c's runs of that "
        "arch. "
        "apr_matmul_wide: B1's wide body (TMA ring, wgmma) per full-width "
        f"llama3-8b whole-sequence forward at M = {PREFILL_M} (225 "
        "projections; phase 3's prefill rows, library torch.matmul on the "
        "same bf16 operands, bound the bf16 tensor-core peak); launches are "
        "the wide-tile ones of phase 4d's forward and prefill (the "
        "prefill's last-row head runs the 16 x 64 x 64 tile). "
        "apr_matmul_wide_whisper: the same per whisper-large-v3 prefill, "
        "its 256 projections over 2 x 1500 frames (phase 3's whisper rows); "
        "launches are the wide-tile ones of phase 7c's whisper prefill. "
        "max_abs_err of both: against the split plain version in phase 2's "
        "wide cases, where every wide tile is also bit-equal to the 16 x 64 "
        "x 64 tile. "
        "rwkv6_wkv and mamba2_ssd: per full-width decode tick (4 slots, "
        "state in and out): 32 and 64 launches at the phase-3 decode shape; "
        "no PyTorch call computes either recurrence (library_ms null); "
        "launches are those of phase 7's PagedServeEngine and ServeEngine "
        "runs (mamba2_ssd: mamba2-2.7b's and zamba2-1.2b's, and zamba2's "
        "SpeculativeServeEngine run). "
        "apr_matmul_hbm (B4m), apr_matmul_fused (B7m, bias + silu), "
        "quant_matmul (B6) and quant_matmul_fused (B8, bias + silu): per "
        "full-width decode tick's 224 projections (no lm_head) at the "
        "default configuration, bf16 out (apr_matmul_hbm one launch a "
        "call); the int8 kernels quantize the activations inside their one "
        "launch, their library (quantization, torch._int_mm, the two "
        "scale multiplies, + bias and silu) is timed at M = 32 where "
        "_int_mm refuses M <= 16; launches are those of phase 8's counted "
        "window (warm_cache sweep and the tuned engine's serving). "
        "apr_matmul_train and apr_matmul_train_backward: B1 on the training "
        f"path, per full-width llama3-8b step ({TRAIN_LAYERS} layers, M = "
        f"{TRAIN_B * TRAIN_T} rows; phase 9a's rows): the forward and its "
        "remat recompute (each projection twice, the head once), and the "
        "backward's dX = dY Wt and dW = Xt dY of every projection "
        "(dx_ms, dw_ms apart; transpose_ms the copies of Wt and Xt, not in "
        "ms); max_abs_err: phase 2's wide cases for the forward, phase "
        "9a's dX and dW against autograd through matmul_ref (values up to "
        "~200) for the backward; plain: autograd's products through matmul_ref, library: "
        "torch.matmul on the same operands (transposes as views), bound: "
        "the products' bytes or bf16 operations; launches are phase 9d's "
        f"{TRAIN_STEPS} steps (split by a wrapper of "
        "AprMatmulFunction.forward that counts the forward's and the "
        "recompute's launches); apr_matmul and apr_matmul_f32 also count "
        "phase 9b's smoke training on the card. "
        "rwkv6_wkv_backward and mamba2_ssd_backward: the gradients of B9 "
        "and B10 (Rwkv6Function, Mamba2Function; no TPU kernel has one, so "
        "replaces names the forward's TPU kernel), per full-width phase-9e-c "
        "step of rwkv6-3b / mamba2-2.7b (4 launches at B = 2, T = 512; "
        "phase 9e-a's bf16 rows), plain: rwkv6_ref_bwd / mamba2_ref_bwd, no "
        "PyTorch call computes either (library_ms null), bound: the "
        "function's bytes or fp32 operations; max_abs_err over phase 9e-a's "
        "cases; a launch is one call (its checkpointing and reverse sweep, "
        "then one fixed-order reduce); launches are those of phase 9e-b "
        "(the smoke configs on the card) and 9e-c (full width), whose "
        "forward and remat-recompute launches rwkv6_wkv and mamba2_ssd "
        "also count. "
        "apr_matmul_moe_backward: B1 in the moe training path's expert "
        "backward (ExpertMatmulFunction: dX = dY W[e]t and dW[e] = Xt dY of "
        "each non-empty queue's w_gate, w_up and w_down, dW written into "
        "the leaf's one gradient tensor), per full-width arctic-480b step "
        "(one layer, B x T = 2 x 512; phase 9f-c's fifth step): ms by CUDA "
        "events around the real backwards (products, the W[e]t and Xt "
        "copies, the empty experts' zero fill); dx_ms the dX products with "
        "their W[e]t copies, dw_ms the rest, transpose_ms the W[e]t copies "
        "alone, plain matmul_ref and library torch.matmul of every product, "
        "each run again on the backwards' own inputs; bound the products' "
        "bytes or bf16 operations summed; max_abs_err "
        "over phase 9f-a's products at queues of 1, 5, 13 and 20 rows; "
        "launches are phase 9f-b's bf16 smoke steps on the card and phase "
        "9f-c's full-width steps, whose other B1 launches (forward, remat "
        "recompute, the dense projections' backward) apr_matmul counts, "
        "with phase 9f-b's, and apr_matmul_f32 9f-b's fp32 step")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi could not read the card: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    report["nvidia_smi"] = card
    report["total_s"] = time.perf_counter() - t_start
    report["phase_s"] = phase_s
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"[10] wrote {out}; total {report['total_s']:.1f} s (per phase "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} })")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
