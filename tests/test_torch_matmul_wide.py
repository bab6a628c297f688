"""B1's wide tiles (``csrc/apr_matmul.cu``, ``APR_MATMUL_WIDE_TILES``), on
the CPU: the tile list against the source, where the untuned configuration
turns wide (prefill M, TMA-friendly K and N) and where it stays on the
16 x 64 x 64 tile, the tune spaces, the shared memory of each wide tile,
the refusals (the memory-resident baseline, the int8 weight, a pinned wide
tile on operands TMA cannot take) and a pinned wide tile on CPU tensors.
The wide body is held to the 16 x 64 x 64 body bit for bit on the card by
``chip_smoke.py``'s phase 2."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench import BlockConfig, TileError, get_spec
from repro_torch.configs import get_config
from repro_torch.kernels.apr_matmul import (apr_matmul, apr_matmul_fused,
                                            matmul_fused_ref, matmul_ref)
from repro_torch.kernels.apr_matmul import ops as apr_ops

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "apr_matmul.cu").read_text()
#: a block's shared memory on an H100 (227 KB)
SMEM_MAX = 232448


def _projections(arch):
    """(K, N) of a dense or audio model's projections."""
    cfg = get_config(arch)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    return sorted({(d, hq * hd), (d, hkv * hd), (hq * hd, d),
                   (d, cfg.d_ff), (cfg.d_ff, d)})


LLAMA = _projections("llama3-8b")
WHISPER = _projections("whisper-large-v3")


def _wide(cfg):
    return (cfg["block_m"], cfg["block_n"], cfg["block_k"]) in \
        apr_ops.WIDE_TILES


def test_wide_tiles_match_the_source():
    body = re.search(r"#define APR_MATMUL_WIDE_TILES\(X\)(.*?)\n", SRC,
                     re.S).group(1)
    tiles = tuple(tuple(int(v) for v in m.groups()) for m in re.finditer(
        r"X\((\d+), (\d+), (\d+)\)", body))
    assert tiles == apr_ops.WIDE_TILES
    assert not set(tiles) & set(apr_ops.TILES)
    # the narrow family's macro is untouched
    body = re.search(r"#define APR_MATMUL_TILES\(X\)(.*?)\n//", SRC,
                     re.S).group(1)
    assert tuple(tuple(int(v) for v in m.groups()) for m in re.finditer(
        r"X\((\d+), (\d+), (\d+)\)", body)) == apr_ops.TILES


def test_projection_shapes():
    assert LLAMA == [(4096, 1024), (4096, 4096), (4096, 14336),
                     (14336, 4096)]
    assert WHISPER == [(1280, 1280), (1280, 5120), (5120, 1280)]


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (4, 4096, 1024),
                                   (16, 4096, 14336), (20, 14336, 4096),
                                   (64, 4096, 4096), (127, 1280, 5120),
                                   (128, 100, 1000), (1024, 4096, 1001),
                                   (3000, 130, 6000)])
def test_default_is_narrow_below_128_rows_or_off_8(m, k, n):
    cfg = apr_ops.default_config(m, k, n)
    assert (cfg["block_m"], cfg["block_n"], cfg["block_k"]) == \
        apr_ops.DEFAULT_TILE
    assert cfg["splits"] == apr_ops.default_splits(k, n, 64)


@pytest.mark.parametrize("m", [128, 1024, 3000])
def test_default_is_wide_at_prefill_m(m):
    for k, n in LLAMA + WHISPER + [(4096, 128256)]:
        cfg = apr_ops.default_config(m, k, n)
        assert _wide(cfg), (m, k, n)
        # the split count of the 64-column tiles: M never enters
        assert cfg["splits"] == apr_ops.default_config(4, k, n)["splits"] \
            == apr_ops.default_splits(k, n, 64)
        tile, splits = apr_ops.resolve_launch("apr_matmul", m, k, n,
                                              "bfloat16", "cuda")
        assert tile in apr_ops.WIDE_TILES and splits == cfg["splits"]
        # the fused family resolves alike
        assert apr_ops.resolve_launch("apr_matmul_fused", m, k, n,
                                      "bfloat16", "cuda") == (tile, splits)


@pytest.mark.parametrize("name", ["apr_matmul", "apr_matmul_fused"])
def test_tune_spaces_hold_wide_tiles_only_at_prefill_m(name):
    spec = get_spec(name)
    for m in (1, 4, 16, 64, 127):
        cands = spec.candidates({"m": m, "k": 4096, "n": 4096})
        assert not any(_wide(c) for c in cands), m
    assert len(spec.candidates({"m": 4, "k": 4096, "n": 1024})) == 24
    for m in (128, 1024):
        cands = spec.candidates({"m": m, "k": 4096, "n": 4096})
        assert {(c["block_m"], c["block_n"], c["block_k"]) for c in cands} \
            == set(apr_ops.TILES) | set(apr_ops.WIDE_TILES)
        assert len(cands) == len(apr_ops.TILES + apr_ops.WIDE_TILES) * 4
        assert spec.default_config({"m": m, "k": 4096, "n": 4096}) in cands
    # K off 8: TMA cannot take it, so no wide candidate
    assert not any(_wide(c) for c in spec.candidates(
        {"m": 1024, "k": 100, "n": 4096}))
    # fp32 operands keep the fp32 body's space
    assert not any(_wide(c) for c in spec.candidates(
        {"m": 1024, "k": 4096, "n": 4096}, "float32"))


def test_baseline_and_int8_spaces_have_no_wide_tiles():
    spec = get_spec("apr_matmul")
    mkn = {"m": 1024, "k": 4096, "n": 4096}
    assert not any(_wide(c) for c in spec.candidates({**mkn, "hbm": 1}))
    assert not any(_wide(c) for c in spec.candidates({**mkn, "w_int8": 1}))
    assert not _wide(spec.default_config({**mkn, "hbm": 1}))
    assert spec.default_config({**mkn, "hbm": 1})["splits"] == 1


@pytest.mark.parametrize("tile", apr_ops.WIDE_TILES)
def test_wide_tile_shared_memory_fits(tile):
    bm, bn, bk = tile
    body = re.search(r"struct WideTile \{(.*?)\n\};", SRC, re.S).group(1)
    stages = int(re.search(r"STAGES = (\d+);", body).group(1))
    pad = int(re.search(r"LDC = BN \+ (\d+);", body).group(1))
    ring = stages * (bm * bk + bk * bn) * 2
    partial = bm * (bn + pad) * 4         # the flush's C tile, the split
    assert apr_ops.wide_smem_bytes(bm, bn, bk) == \
        1024 + max(ring, partial) + 2 * stages * 8 <= SMEM_MAX
    spec = get_spec("apr_matmul")
    cfg = BlockConfig.make(block_m=bm, block_n=bn, block_k=bk, splits=1)
    assert spec.vmem_bytes({"m": 1024, "k": 4096, "n": 4096}, cfg,
                           "bfloat16") == apr_ops.wide_smem_bytes(bm, bn, bk)


@pytest.mark.parametrize("tile", apr_ops.WIDE_TILES)
def test_wide_tile_refused_by_baseline_and_int8_weight(tile):
    cfg = BlockConfig.make(block_m=tile[0], block_n=tile[1],
                           block_k=tile[2], splits=1)
    with pytest.raises(TileError):
        apr_ops.resolve_launch("apr_matmul", 1024, 4096, 4096, "bfloat16",
                               "cuda", "hbm", cfg)
    with pytest.raises(TileError):
        apr_ops.resolve_launch("apr_matmul", 1024, 4096, 4096, "bfloat16",
                               "cuda", config=cfg, w_int8=True)
    # the untuned baseline at prefill M stays on the 16-row tile
    assert apr_ops.resolve_launch("apr_matmul", 1024, 4096, 4096,
                                  "bfloat16", "cuda", "hbm") == \
        (apr_ops.DEFAULT_TILE, 1)


def test_wide_tile_gives_way_or_raises_off_tma():
    wide = BlockConfig.make(block_m=128, block_n=128, block_k=64, splits=2)
    # the default gives way to the 16 x 64 x 64 tile on unaligned bases
    assert apr_ops.resolve_launch("apr_matmul", 1024, 4096, 4096,
                                  "bfloat16", "cuda", aligned=False) == \
        (apr_ops.DEFAULT_TILE, 2)
    # a pinned wide tile raises there, and at K or N off 8
    with pytest.raises(TileError):
        apr_ops.resolve_launch("apr_matmul", 1024, 4096, 4096, "bfloat16",
                               "cuda", config=wide, aligned=False)
    for k, n in ((100, 4096), (4096, 1001)):
        with pytest.raises(TileError):
            apr_ops.resolve_launch("apr_matmul_fused", 1024, k, n,
                                   "bfloat16", "cuda", config=wide)
    assert apr_ops.resolve_launch("apr_matmul", 1024, 4096, 4096,
                                  "bfloat16", "cuda", config=wide) == \
        ((128, 128, 64), 2)


def test_pinned_wide_tile_on_cpu_tensors_is_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((130, 96), np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((96, 72), np.float32)
                         ).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(72, np.float32))
    for tile in apr_ops.WIDE_TILES:
        pins = dict(block_m=tile[0], block_n=tile[1], block_k=tile[2])
        for out in (torch.bfloat16, torch.float32):
            assert torch.equal(apr_matmul(x, w, out_dtype=out, **pins),
                               matmul_ref(x, w, out))
            assert torch.equal(
                apr_matmul_fused(x, w, bias, activation="silu",
                                 out_dtype=out, splits=2, **pins),
                matmul_fused_ref(x, w, bias, "silu", out))
