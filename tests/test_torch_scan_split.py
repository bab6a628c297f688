"""Port parity, the recurrences' launch configurations (B9 ``rwkv6_wkv``,
B10 ``mamba2_ssd``): the ``chunk=`` kwarg as the JAX wrappers take it
(explicit > config > tuned cache > default, against the JAX package's
``resolve_config``), refused when it is not compiled; the wrappers with
``chunk=16`` and ``chunk=32`` on CPU tensors against the JAX Pallas
kernels with that chunk in interpret mode; the kernels' index maps
(every state value of every (b, h) owned by exactly one thread, at full
width and at the ragged shapes ``chip_smoke.py`` phase 2 runs) and their
shared memory; and the tune spaces, which list exactly the compiled
configurations.  The CUDA kernels are held to their plain versions, and
to each other across configurations bit for bit, on the card by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro.bench import ConfigCache as JaxConfigCache
from repro.bench.config import BlockConfig as JaxBlockConfig
from repro.bench.config import resolve_config as jax_resolve_config
from repro.bench.config import scoped_cache as jax_scoped_cache
from repro.kernels.mamba2 import mamba2_ssd as jax_mamba2_ssd
from repro.kernels.mamba2 import ops as jax_mamba_ops
from repro.kernels.rwkv6 import ops as jax_rwkv_ops
from repro.kernels.rwkv6 import rwkv6_wkv as jax_rwkv6_wkv
from repro_torch.bench import BlockConfig, ConfigCache, TileError
from repro_torch.bench.config import pin_config, scoped_cache
from repro_torch.bench.registry import get_spec
from repro_torch.kernels.mamba2 import mamba2_ref, mamba2_ssd
from repro_torch.kernels.mamba2 import ops as mamba_ops
from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv6_wkv
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from test_torch_scan import (MAMBA_CASES, RWKV_CASES, _both, _np, _tol,
                             mamba_arrays, rwkv_arrays)

#: (kernel name, ops module, JAX ops module, dims of a decode tick)
FAMILIES = {"rwkv6": (rwkv_ops, jax_rwkv_ops, (4, 1, 40, 64)),
            "mamba2": (mamba_ops, jax_mamba_ops, (4, 1, 80, 64, 128))}
#: the shapes phase 2 gives the kernels: full width, the smoke heads and
#: ragged head sizes (rwkv6 (B, H, D); mamba2 (B, H, P, N))
RWKV_GEOMETRIES = [(2, 40, 64), (2, 4, 16), (2, 3, 48), (1, 2, 128),
                   (3, 2, 80)]
MAMBA_GEOMETRIES = [(2, 80, 64, 128), (2, 8, 16, 16), (2, 3, 48, 80),
                    (3, 2, 32, 112)]


@pytest.fixture(autouse=True)
def _tune_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))


def _jax_chunk(name, dims, dtype, config=None, chunk=None):
    ops = FAMILIES[name][1]
    cfg = jax_resolve_config(
        name, ops.shape_key(*dims), dtype, "cuda",
        default=ops.default_config(*dims),
        override=None if config is None else JaxBlockConfig.make(**config),
        explicit={"chunk": chunk})
    return cfg["chunk"]


# ------------------------------------------------------------- resolution
@pytest.mark.parametrize("name", ["rwkv6", "mamba2"])
def test_chunk_resolves_as_the_jax_wrappers(name, tmp_path):
    """``chunk`` > ``config`` > the tuned entry (here one the JAX package
    wrote) > the default, the JAX wrappers' order; the other keys keep the
    port's default under a chunk-only entry."""
    ops, jax_ops, dims = FAMILIES[name]
    default = ops.default_config(*dims)
    assert ops.resolve_launch(*dims, "bfloat16") == default
    for chunk in ops.CHUNKS:
        got = ops.resolve_launch(*dims, "bfloat16",
                                 config=pin_config(None, chunk=chunk))
        assert got == default.replace(chunk=chunk)
        assert got["chunk"] == _jax_chunk(name, dims, "bfloat16",
                                          chunk=chunk)
    path = tmp_path / "shared.json"
    JaxConfigCache(path).store(name, jax_ops.shape_key(*dims), "bfloat16",
                               "cuda", JaxBlockConfig.make(chunk=64),
                               metrics={"us": 1.0})
    with jax_scoped_cache(JaxConfigCache(path)):
        want = [_jax_chunk(name, dims, "bfloat16"),
                _jax_chunk(name, dims, "bfloat16", config={"chunk": 16}),
                _jax_chunk(name, dims, "bfloat16", config={"chunk": 16},
                           chunk=8)]
    with scoped_cache(ConfigCache(path)):
        got = [ops.resolve_launch(*dims, "bfloat16"),
               ops.resolve_launch(*dims, "bfloat16",
                                  config=BlockConfig.make(chunk=16)),
               ops.resolve_launch(*dims, "bfloat16", config=pin_config(
                   BlockConfig.make(chunk=16), chunk=8))]
    assert [c["chunk"] for c in got] == want == [64, 16, 8]
    assert all(c == default.replace(chunk=c["chunk"]) for c in got)


@pytest.mark.parametrize("name", ["rwkv6", "mamba2"])
@pytest.mark.parametrize("bad", [dict(chunk=128), dict(chunk=12),
                                 dict(chunk=1), dict(lanes=3),
                                 dict(lanes=32)])
def test_uncompiled_configs_raise_tile_error(name, bad):
    """A chunk (or lanes) that no compiled body takes raises TileError
    before any launch, pinned or from a config."""
    ops, _, dims = FAMILIES[name]
    with pytest.raises(TileError):
        ops.resolve_launch(*dims, "bfloat16",
                           config=pin_config(None, **bad))
    with pytest.raises(TileError):
        ops.resolve_launch(*dims, "float32", config=BlockConfig.make(
            **{**ops.default_config(*dims).to_dict(), **bad}))


def test_uncompiled_tiles_raise_tile_error():
    with pytest.raises(TileError):
        mamba_ops.resolve_launch(4, 1, 80, 64, 128, "bfloat16",
                                 config=pin_config(None, rows=12))
    with pytest.raises(TileError):       # 4 columns, 4 lanes of 4 columns
        rwkv_ops.resolve_launch(4, 1, 40, 64, "bfloat16",
                                config=BlockConfig.make(chunk=32, cols=8,
                                                        lanes=4))


@pytest.mark.parametrize("name", ["rwkv6", "mamba2"])
def test_tune_spaces_list_the_compiled_configurations(name):
    ops, _, dims = FAMILIES[name]
    keys = ("b", "t", "h", "d") if name == "rwkv6" else \
        ("b", "t", "h", "p", "n")
    shape = dict(zip(keys, dims))
    cands = get_spec(name).candidates(shape)
    assert len(cands) == len(set(cands))
    assert set(cands) == ops.compiled_configs()
    assert get_spec(name).default_config(shape) in cands
    assert 64 in ops.CHUNKS            # the JAX wrappers' default chunk
    for cfg in cands:                   # each one resolves as it is
        assert ops.resolve_launch(*dims, "bfloat16", config=cfg) == cfg


# ---------------------------------------------------- CPU against the JAX
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("b,t,h,d,dtype", RWKV_CASES)
def test_rwkv6_chunk_kwarg_matches_jax_interpret(b, t, h, d, dtype, chunk):
    """``rwkv6_wkv(..., chunk=c)`` on CPU tensors (the plain version,
    whatever the chunk) against the JAX wrapper with the same chunk, its
    Pallas kernel in interpret mode."""
    r, k, v, logw, u, _ = rwkv_arrays(b, t, h, d, seed=t + chunk)
    pairs = [_both(a, dtype) for a in (r, k, v)] + [
        _both(np.exp(logw)), _both(u, dtype)]
    ref = jax_rwkv6_wkv(*(p[0] for p in pairs), chunk=chunk, interpret=True)
    got = rwkv6_wkv(*(p[1] for p in pairs), chunk=chunk)
    assert torch.equal(got, rwkv6_ref(*(p[1] for p in pairs)))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("b,t,h,p,n,dtype", MAMBA_CASES)
def test_mamba2_chunk_kwarg_matches_jax_interpret(b, t, h, p, n, dtype,
                                                  chunk):
    x, bb, c, dt, a, d, _ = mamba_arrays(b, t, h, p, n, seed=t + chunk)
    pairs = [_both(v, dtype) for v in (x, bb, c)] + [
        _both(v) for v in (dt, a, d)]
    ref = jax_mamba2_ssd(*(q[0] for q in pairs), chunk=chunk,
                         interpret=True)
    got = mamba2_ssd(*(q[1] for q in pairs), chunk=chunk)
    assert torch.equal(got, mamba2_ref(*(q[1] for q in pairs)))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


def test_config_kwarg_on_the_cpu_is_the_plain_version():
    """On CPU tensors a config, compiled or not, changes nothing: the
    wrappers are the plain versions."""
    r, k, v, logw, u, s0 = (torch.tensor(a, dtype=torch.float32)
                            for a in rwkv_arrays(2, 9, 2, 16, seed=1))
    w = torch.exp(logw)
    want = rwkv6_ref(r, k, v, w, u, s_init=s0, return_state=True)
    for cfg in (BlockConfig.make(chunk=64, cols=8, lanes=2), None):
        got = rwkv6_wkv(r, k, v, w, u, s_init=s0, return_state=True,
                        chunk=8, config=cfg)
        assert all(torch.equal(g, e) for g, e in zip(got, want))
    args = [torch.tensor(a, dtype=torch.float32)
            for a in mamba_arrays(2, 9, 2, 16, 32, seed=1)]
    want = mamba2_ref(*args[:6], h_init=args[6], return_state=True)
    got = mamba2_ssd(*args[:6], h_init=args[6], return_state=True,
                     chunk=128)
    assert all(torch.equal(g, e) for g, e in zip(got, want))


# ------------------------------------------------------------ index maps
def mamba_state_owners(b, h, p, n, geom: dict) -> np.ndarray:
    """How many threads of a launch of ``geom`` own each state value
    (B, H, P, N), by the kernel's index map: block b·(H·P / rows) + tile,
    warp w, lane: flattened rows g = tile·rows + w·rows_per_warp + (lane /
    lanes)·rows_per_lane + r (head g / P, row g % P), columns 4v .. 4v + 3
    of the vectors v = j·lanes + lane % lanes below N / 4."""
    rows, lanes = geom["rows"], geom["lanes"]
    rt, tiles = mamba_ops.rows_per_lane(lanes), h * p // rows
    blk, tid, r, j = np.ix_(np.arange(geom["blocks"]),
                            np.arange(geom["threads"]),
                            np.arange(rt), np.arange(32 // lanes))
    lane = tid % 32
    g = (blk % tiles * rows + tid // 32 * mamba_ops.rows_per_warp(lanes)
         + lane // lanes * rt + r)
    v = j * lanes + lane % lanes
    idx = np.broadcast_arrays(blk // tiles, g // p, g % p, v)
    live = idx[3] < n // 4
    count = np.zeros((b, h, p, n), np.int64)
    for e in range(4):
        np.add.at(count, (idx[0][live], idx[1][live], idx[2][live],
                          4 * idx[3][live] + e), 1)
    return count


def rwkv_state_owners(b, h, d, geom: dict) -> np.ndarray:
    """How many threads of a launch of ``geom`` own each state value
    (B, H, D, D), by the kernel's index map: block (b·H + h)·parts + part
    owns the head's warps [part·W / parts, (part + 1)·W / parts) of 4·lanes
    columns (W = D / (4·lanes)); its warp w, lane: columns 4·lanes·(first
    warp + w) + 4·(lane % lanes) .. + 3, rows (lane / lanes)·rows_per_lane
    + m below D."""
    lanes, ir, parts = geom["lanes"], geom["rows_per_lane"], geom["parts"]
    head_warps = d // (4 * lanes)
    blk, tid, m = np.ix_(np.arange(geom["blocks"]),
                         np.arange(geom["threads"]), np.arange(ir))
    part, bh, lane, warp = blk % parts, blk // parts, tid % 32, tid // 32
    wlo = part * head_warps // parts
    active = warp < (part + 1) * head_warps // parts - wlo
    j0 = (wlo + warp) * 4 * lanes + 4 * (lane % lanes)
    i = lane // lanes * ir + m
    idx = np.broadcast_arrays(bh // h, bh % h, i, j0, active)
    live = (idx[2] < d) & idx[4]
    count = np.zeros((b, h, d, d), np.int64)
    for e in range(4):
        np.add.at(count, (idx[0][live], idx[1][live], idx[2][live],
                          idx[3][live] + e), 1)
    return count


@pytest.mark.parametrize("geom", MAMBA_GEOMETRIES)
def test_mamba2_every_state_value_has_one_owner(geom):
    """Every (row, column) of every (b, h) is owned by exactly one thread
    under every compiled configuration (rows a block, tiles that may span
    heads, lanes a row)."""
    b, h, p, n = geom
    seen = set()
    for cfg in sorted(mamba_ops.compiled_configs()):
        g = mamba_ops.geometry(b, 2, h, p, n, cfg)
        key = (g["rows"], g["lanes"])
        if key in seen:
            continue
        seen.add(key)
        assert h * p % g["rows"] == 0 and g["rows"] % 8 == 0
        assert g["rows"] <= cfg["rows"] and g["threads"] <= 512
        owners = mamba_state_owners(b, h, p, n, g)
        assert owners.shape == (b, h, p, n)
        assert (owners == 1).all(), (geom, cfg)
    assert len(seen) == len({(r, l) for r in mamba_ops.ROWS
                             for l in mamba_ops.LANES if h * p % r == 0})


@pytest.mark.parametrize("geom", RWKV_GEOMETRIES)
def test_rwkv6_every_state_value_has_one_owner(geom):
    b, h, d = geom
    seen = set()
    for cfg in sorted(rwkv_ops.compiled_configs()):
        g = rwkv_ops.geometry(b, 2, h, d, cfg)
        key = (g["parts"], g["lanes"])
        if key in seen:
            continue
        seen.add(key)
        assert 1 <= g["parts"] <= d // (4 * g["lanes"])
        assert 32 // g["lanes"] * g["rows_per_lane"] == \
            rwkv_ops.head_rows(d) >= d
        assert g["parts"] == min(d // (4 * g["lanes"]), max(
            -(-d // cfg["cols"]), -(-d // (4 * g["lanes"] * 8))))
        assert g["threads"] <= 32 * rwkv_ops.MAX_WARPS
        owners = rwkv_state_owners(b, h, d, g)
        assert owners.shape == (b, h, d, d)
        assert (owners == 1).all(), (geom, cfg)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_compiled_staging_fits_shared_memory(itemsize):
    """The largest heads the kernels take, at every compiled
    configuration, stage within an H100 block's shared memory."""
    for cfg in mamba_ops.compiled_configs():
        g = mamba_ops.geometry(1, 2, 1, 64, 128, cfg, itemsize)
        assert g["smem"] <= mamba_ops.MAX_SMEM, cfg
    for cfg in rwkv_ops.compiled_configs():
        g = rwkv_ops.geometry(1, 2, 1, 128, cfg, itemsize)
        assert g["smem"] <= rwkv_ops.MAX_SMEM, cfg
    # a decode tick (T = 1) stages nothing
    assert mamba_ops.geometry(4, 1, 80, 64, 128, mamba_ops.default_config(
        4, 1, 80, 64, 128))["smem"] == 0
    assert rwkv_ops.geometry(4, 1, 40, 64, rwkv_ops.default_config(
        4, 1, 40, 64))["smem"] == 0


def test_default_geometries_spread_over_the_card():
    """At a 1024-token prefill (B = 1) the default launches put more
    blocks on the card than there are heads (80 and 40), and no more than
    one a streaming multiprocessor."""
    g = mamba_ops.geometry(1, 1024, 80, 64, 128, mamba_ops.default_config(
        1, 1024, 80, 64, 128))
    assert 80 < g["blocks"] <= mamba_ops.SMS
    g = rwkv_ops.geometry(1, 1024, 40, 64, rwkv_ops.default_config(
        1, 1024, 40, 64))
    assert 40 < g["blocks"] <= rwkv_ops.SMS
