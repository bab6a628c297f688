"""A row's bits do not depend on the batch (the port's repair of ROADMAP
C.2): the default split counts of ``apr_matmul`` follow (K, N, the
weight's bytes) and never M, and those of the decode-attention kernels
follow (Hkv, the walk width, the K/V bytes) and never B, at every shape the
served models run; and T > 1 paged attention folded into the batch of one
``flash_decode_paged`` call (``layers.paged_attention_folded``, the CUDA
path of ``attention_decode_paged``) equals the gather path the CPU and the
JAX layer take, through the kernel's plain version, padded rows
included."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_draft_config
from repro_torch.kernels.apr_matmul import ops as apr_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models.layers import (paged_attention_folded,
                                       paged_attention_gather)
from repro_torch.quant import quantize_channelwise

#: the M a served row meets: a lone paged prefill row or B = 1 tick, the
#: 4-slot decode tick, a 16-token prefill chunk, a 4-slot verify step at
#: spec_k = 4, the tick at 64 slots, the first M of the wide tiles, the
#: whole-sequence forward, and whisper's prefill over 2 x 1500 frames
MS = (1, 4, 16, 20, 64, 128, 1024, 3000)
#: the batches of the decode attention: B = 1 (a paged prefill chunk's
#: token on the hybrid), 4 slots, a 4-slot verify step at spec_k = 4, 64
BS = (1, 4, 16, 20, 64)
SERVED = [("llama3-8b", False), ("llama3-8b", True), ("zamba2-1.2b", False),
          ("rwkv6-3b", False), ("mamba2-2.7b", False)]


def _cfg(arch, draft):
    return get_draft_config(arch) if draft else get_config(arch)


def _projections(cfg):
    """(K, N) of the model's projections and its head."""
    d = cfg.d_model
    shapes = {(d, cfg.vocab_size)}
    if cfg.family in ("dense", "hybrid"):
        hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        shapes |= {(d, hq * hd), (d, hkv * hd), (hq * hd, d)}
    if cfg.d_ff:
        shapes |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    if getattr(cfg, "d_inner", 0):
        shapes |= {(d, cfg.d_inner), (cfg.d_inner, d)}
    return sorted(shapes)


@pytest.mark.parametrize("arch,draft", SERVED,
                         ids=[f"{a}{'-draft' if d else ''}"
                              for a, d in SERVED])
def test_matmul_split_count_is_one_across_m(arch, draft):
    """bf16 and fp32 bodies (and int8 codes under an fp32 x): one split
    count a projection whatever M; the 4-slot tick's count, which the
    decode tick has always run, is the one every M takes."""
    for k, n in _projections(_cfg(arch, draft)):
        bf16 = {apr_ops.resolve_launch("apr_matmul", m, k, n, "bfloat16",
                                       "cuda")[1] for m in MS}
        f32 = {apr_ops.resolve_f32("apr_matmul", m, k, n)["splits"]
               for m in MS}
        f32q = {apr_ops.resolve_f32("apr_matmul", m, k, n,
                                    w_int8=True)["splits"] for m in MS}
        assert bf16 == f32 == {apr_ops.default_splits(k, n, 64)}, (k, n)
        assert f32q == {apr_ops.default_splits(k, n, 64, 1)}, (k, n)
        assert {apr_ops.resolve_launch("apr_matmul", m, k, n, "bfloat16",
                                       "cuda", w_int8=True)[1]
                for m in MS} == {1}


@pytest.mark.parametrize("arch,draft", [s for s in SERVED
                                        if s[0] in ("llama3-8b",
                                                    "zamba2-1.2b")],
                         ids=["llama3-8b", "llama3-8b-draft", "zamba2-1.2b"])
def test_decode_split_count_is_one_across_b(arch, draft):
    """B2 over bf16, fp32 and int8 pools and B3 over bf16 and fp32 caches:
    one split count whatever B, and the slot engine's (S = 256) equal to
    the paged engine's (16 pages of 16) at the serving geometry."""
    cfg = _cfg(arch, draft)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for kv_bytes, int8 in ((2, False), (4, False), (1, True)):
        paged = {fd_ops.resolve_paged_splits(b, hq, hkv, d, 16, 16, int8,
                                             "bfloat16", "cuda",
                                             kv_bytes=kv_bytes)
                 for b in BS}
        assert paged == {fd_ops.default_splits(hkv, 256, kv_bytes)}
        if not int8:
            slot = {fd_ops.resolve_splits(b, hq, hkv, d, 256, "bfloat16",
                                          "cuda", kv_bytes=kv_bytes)
                    for b in BS}
            assert slot == paged, (kv_bytes, slot, paged)


def test_decode_split_counts_keep_the_four_slot_tick():
    """The 4-slot tick keeps the counts it ran before the repair:
    llama3-8b (Hkv = 8) 8 splits over bf16 and int8 pools, 2 over fp32
    ones; zamba2 (Hkv = 32) 2, and 1 over fp32."""
    assert fd_ops.REFERENCE_BATCH == 4
    assert [fd_ops.default_splits(8, 256, kb) for kb in (2, 1, 4)] == \
        [8, 8, 2]
    assert [fd_ops.default_splits(32, 256, kb) for kb in (2, 1, 4)] == \
        [2, 2, 1]


# ------------------------------------------- folded T > 1 paged attention
def _pools(rng, pool_pages, ps, hkv, d, kind):
    k = rng.standard_normal((pool_pages, ps, hkv, d)).astype(np.float32)
    v = rng.standard_normal((pool_pages, ps, hkv, d)).astype(np.float32)
    if kind == "int8":
        kq, vq = (quantize_channelwise(torch.from_numpy(a), axis=-1)
                  for a in (k, v))
        return (kq.q, vq.q, dict(k_scales=kq.scale[..., 0],
                                 v_scales=vq.scale[..., 0]))
    dt = torch.float32 if kind == "float32" else torch.bfloat16
    return torch.from_numpy(k).to(dt), torch.from_numpy(v).to(dt), {}


#: (B, T, Hq, Hkv, D, page size, table width, lengths, new counts)
FOLD_CASES = [
    (4, 5, 8, 2, 16, 4, 8, [0, 3, 9, 20], [5, 2, 5, 0]),    # verify step
    (1, 16, 4, 4, 8, 8, 4, [5], [11]),                        # prefill chunk
    (2, 1, 8, 2, 16, 4, 8, [7, 0], [1, 0]),                   # decode tick
    (3, 3, 6, 2, 12, 4, 6, [0, 0, 13], [3, 1, 2]),            # group of 3
]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", range(len(FOLD_CASES)))
def test_folded_call_equals_gather_path(case, kind):
    """Row ``b·T + i`` of the folded call (q of token i at length
    ``lengths[b] + i + 1``) against the gather path's token i, at every
    position, padded ones (``i >= new counts``) included, since an MoE
    layer routes them: within 1e-5 for an fp32 q (int8 pools dequantized
    in fp32 on both), one bf16 ulp of the output's scale for a bf16 q."""
    b, t, hq, hkv, d, ps, width, lengths, counts = FOLD_CASES[case]
    rng = np.random.default_rng(case)
    pool_pages = 1 + b * width
    k_pages, v_pages, scales = _pools(rng, pool_pages, ps, hkv, d, kind)
    tables = torch.from_numpy(
        1 + rng.permutation(b * width).reshape(b, width).astype(np.int32))
    qdt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d)).astype(
        np.float32)).to(qdt)
    lens = torch.tensor(lengths, dtype=torch.int32)
    positions = lens.long()[:, None] + torch.arange(t)[None]
    got = paged_attention_folded(q, k_pages, v_pages, lens, tables,
                                 **scales)
    ref = paged_attention_gather(q, k_pages, v_pages, positions, tables,
                                 **scales)
    assert got.shape == ref.shape == (b, t, hq * d)
    assert got.dtype == ref.dtype == qdt
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - ref.float()).abs()
    if kind == "bfloat16":
        assert float(diff.max()) <= 2 ** -7 * float(ref.float().abs().max())
    else:
        assert float(diff.max()) <= 1e-5


def test_folded_rows_are_single_token_calls():
    """The folded call's row b·T + i is, bit for bit, a T = 1 call of token
    i at length ``lengths[b] + i`` (the decode tick that would produce
    it), for every real row."""
    rng = np.random.default_rng(7)
    b, t, hq, hkv, d, ps, width = 3, 4, 8, 2, 16, 4, 6
    k_pages, v_pages, _ = _pools(rng, 1 + b * width, ps, hkv, d, "bfloat16")
    tables = torch.from_numpy(
        1 + rng.permutation(b * width).reshape(b, width).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d)).astype(
        np.float32)).to(torch.bfloat16)
    lens = torch.tensor([2, 9, 0], dtype=torch.int32)
    cnts = torch.tensor([4, 3, 1], dtype=torch.int32)
    got = paged_attention_folded(q, k_pages, v_pages, lens, tables)
    for i in range(t):
        one = paged_attention_folded(q[:, i:i + 1], k_pages, v_pages,
                                     lens + i, tables)
        for row in range(b):
            if i < int(cnts[row]):
                assert torch.equal(got[row, i], one[row, 0]), (row, i)
