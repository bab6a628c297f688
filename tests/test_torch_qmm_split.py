"""Port parity, the split-K int8 matmul (B6 ``quant_matmul``, B8
``quant_matmul_fused``): the wrappers at every split count and pinned tile
against the JAX package's Pallas kernels run in interpret mode, at the
llama3-8b projection shapes scaled down and at ragged ones; the plain
mirror of the kernel's split-K (exact partials over the 256-row K ranges
of ``split_range``, then added) against the unsplit plain version bit for
bit; the tie rows' codes; the tune spaces of tiles x splits and the
traffic model of the in-launch quantization; and the ``block_*`` /
``splits`` kwargs of the quant and conv wrappers against the JAX
resolution.  The CUDA kernel itself is held to these plain versions on the
card by ``chip_smoke.py``."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import ConfigCache as JaxConfigCache
from repro.bench.config import BlockConfig as JaxBlockConfig
from repro.bench.config import resolve_config as jax_resolve_config
from repro.bench.config import scoped_cache as jax_scoped_cache
from repro.bench.config import shape_key_from_dims
from repro.kernels.apr_conv import ops as jax_conv_ops
from repro.kernels.quant_matmul import ops as jax_qmm_ops
from repro_torch.bench import ConfigCache, TileError
from repro_torch.bench.config import pin_config, scoped_cache
from repro_torch.bench.registry import get_spec
from repro_torch.kernels.apr_conv import ops as conv_ops
from repro_torch.kernels.apr_matmul.ref import split_range
from repro_torch.kernels.quant_matmul import (K_RANGE, quant_matmul,
                                              quant_matmul_fused,
                                              quant_matmul_fused_ref,
                                              quant_matmul_ref,
                                              quant_matmul_split_ref,
                                              quantize_activations,
                                              quantize_weights)
from repro_torch.kernels.quant_matmul import ops as qmm_ops
from repro_torch.kernels.quant_matmul.ref import int8_split_total, int8_total
from test_torch_qmm import _tie_rows

#: test_torch_qmm.py's tolerance against the JAX kernels: the integer part
#: is exact, only the two fp32 scale multiplies could round apart
QTOL = dict(rtol=1e-4, atol=1e-4)
#: llama3-8b's projections (K, N) at a sixteenth of their widths (wq/wo,
#: wk/wv, w_gate/w_up, w_down), and ragged (M, K, N): none a multiple of
#: the tiles, K short of one 256-row range or of splits x 256 (empty
#: ranges), M past one 16-row block
SHAPES = ([(4, 256, 256), (4, 256, 64), (16, 256, 896), (16, 896, 256)]
          + [(5, 300, 70), (17, 520, 200), (3, 1000, 77)])
ACTIVATIONS = ("none", "relu", "silu", "gelu")


@pytest.fixture(autouse=True)
def _tune_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))


def _both(a: np.ndarray, dtype: str):
    a = np.asarray(a, np.float32)
    j, t = jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _weights(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    jq, js = jax_qmm_ops.quantize_weights(jnp.asarray(w))
    tq, ts = quantize_weights(torch.from_numpy(w))
    return (jq, js), (tq, ts)


# ----------------------------------------------------- split ranges of K
def test_split_ranges_are_whole_256_row_ranges():
    assert K_RANGE == 256 == max(t[2] for t in qmm_ops.TILES)
    assert split_range(4096, 8, K_RANGE) == 512
    assert split_range(14336, 2, K_RANGE) == 7168
    assert split_range(14336, 8, K_RANGE) == 1792
    assert split_range(300, 4, K_RANGE) == 256      # ranges 2, 3 empty
    for k in (1, 255, 256, 257, 4100, 14336):
        for s in qmm_ops.SPLITS:
            rng = split_range(k, s, K_RANGE)
            assert rng % K_RANGE == 0 and rng * s >= k
            assert all(rng % bk == 0 for _, _, bk in qmm_ops.TILES)


@pytest.mark.parametrize("k", [1, 100, 256, 300, 1000, 4100])
@pytest.mark.parametrize("splits", qmm_ops.SPLITS)
def test_split_total_equals_unsplit_bit_for_bit(k, splits):
    """The kernel's split-K in plain form: exact partials per range, added,
    rounded once -- the unsplit total's bits at every split count, empty
    ranges and |x| at the int8 maximum included."""
    rng = np.random.default_rng(k + splits)
    xq = torch.from_numpy(rng.integers(-127, 128, (6, k)).astype(np.int8))
    yq = torch.from_numpy(rng.integers(-127, 128, (k, 40)).astype(np.int8))
    xq[0] = 127
    yq[:, 0] = -127
    got = int8_split_total(xq, yq, splits)
    assert torch.equal(got, int8_total(xq, yq))
    want = xq.numpy().astype(np.int64) @ yq.numpy().astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_ref_equals_unsplit_ref(shape, dtype):
    m, k, n = shape
    _, tx = _both(np.random.default_rng(k).standard_normal((m, k)) * 3, dtype)
    _, (tq, ts) = _weights(k, n, seed=m)
    for out in (torch.float32, torch.bfloat16):
        want = quant_matmul_ref(tx, tq, ts, out)
        for splits in qmm_ops.SPLITS:
            assert torch.equal(quant_matmul_split_ref(tx, tq, ts, splits, out),
                               want)


def test_fp64_reciprocal_product_is_the_ieee_fp32_quotient():
    """The kernel forms each code's quotient fl32(x / scale) as
    fl32(fl64(x * fl64(1 / scale))): within 2^-51.9 of x / scale, which is
    either an fp32 value or at least 2^-49 from every fp32 rounding
    boundary.  Held here against numpy's IEEE fp32 division on random
    scales and values (bf16-valued ones too) and on values at and next to
    the .5 ties of the codes."""
    rng = np.random.default_rng(20)
    n = 400_000
    amax = np.exp(rng.uniform(-30, 30, n)).astype(np.float32)
    scale = (amax * np.float32(1 / 127)).astype(np.float32)
    x = (rng.uniform(-1, 1, n) * amax).astype(np.float32)
    x_bf16 = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)
    ties = ((rng.integers(-127, 127, n) + np.float32(0.5)) * scale
            ).astype(np.float32)
    near = np.nextafter(ties, np.where(rng.random(n) < 0.5, np.inf, -np.inf)
                        .astype(np.float32))
    inv = 1.0 / scale.astype(np.float64)
    for v in (x, x_bf16, ties, near):
        want = v / scale
        got = (v.astype(np.float64) * inv).astype(np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


# ------------------------------------------- the wrappers against JAX
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", qmm_ops.SPLITS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quant_matmul_at_each_split_and_tile_matches_jax(shape, splits,
                                                         dtype):
    """B6 with ``splits`` and a pinned tile (the compiled tiles in turn)
    against the JAX Pallas kernel in interpret mode on the same tile; on
    the CPU the wrapper is the plain version, which equals the split
    mirror bit for bit."""
    m, k, n = shape
    tile = qmm_ops.TILES[(SHAPES.index(shape) + splits) % len(qmm_ops.TILES)]
    bm, bn, bk = tile
    x = np.random.default_rng(m * k + n).standard_normal((m, k)) * 2
    jx, tx = _both(x, dtype)
    (jq, js), (tq, ts) = _weights(k, n, seed=n)
    got = quant_matmul(tx, tq, ts, block_m=bm, block_n=bn, block_k=bk,
                       splits=splits)
    assert torch.equal(got, quant_matmul_split_ref(tx, tq, ts, splits))
    want = jax_qmm_ops.quant_matmul(jx, jq, js, block_m=bm, block_n=bn,
                                    block_k=bk)
    np.testing.assert_allclose(_np(got), _np(want), **QTOL)


@pytest.mark.parametrize("splits", qmm_ops.SPLITS)
@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[4:6], ids=str)
def test_quant_matmul_fused_at_each_split_matches_jax(shape, splits):
    """B8 with bias and each activation in turn, ``splits`` and a pinned
    tile, against the JAX fused kernel in interpret mode."""
    m, k, n = shape
    activation = ACTIVATIONS[(splits + m) % 4]
    tile = qmm_ops.TILES[(splits + k) % len(qmm_ops.TILES)]
    rng = np.random.default_rng(n)
    x = rng.standard_normal((m, k))
    b = rng.standard_normal((n,)).astype(np.float32) * 10
    jx, tx = _both(x, "bfloat16")
    (jq, js), (tq, ts) = _weights(k, n, seed=k)
    got = quant_matmul_fused(tx, tq, ts, torch.from_numpy(b),
                             activation=activation, block_m=tile[0],
                             block_n=tile[1], block_k=tile[2], splits=splits)
    assert torch.equal(got, quant_matmul_fused_ref(tx, tq, ts,
                                                   torch.from_numpy(b),
                                                   activation))
    want = jax_qmm_ops.quant_matmul_fused(
        jx, jq, js, jnp.asarray(b), activation=activation, block_m=tile[0],
        block_n=tile[1], block_k=tile[2])
    np.testing.assert_allclose(_np(got), _np(want), **QTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tie_rows_quantize_bit_equal_to_jax(dtype):
    """The rows whose codes land on .5 ties still quantize as the JAX
    package does, and through B6 on an identity weight (scale 1 a column)
    every output is code * scale, equal to the JAX kernel's bit for bit at
    every split count."""
    rows = _tie_rows()
    jx, tx = _both(rows, dtype)
    jq, js = jax_qmm_ops.quantize_activations(jx)
    tq, ts = quantize_activations(tx)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    k = rows.shape[1]
    eye_q = torch.eye(k, dtype=torch.int8)
    one = torch.ones((1, k))
    want = _np(jax_qmm_ops.quant_matmul(jx, jnp.asarray(eye_q.numpy()),
                                        jnp.asarray(one.numpy())))
    for splits in qmm_ops.SPLITS:
        got = quant_matmul(tx, eye_q, one, splits=splits)
        np.testing.assert_array_equal(_np(got), want)
        assert torch.equal(got, tq.float() * ts)


# -------------------------------------------- tune spaces and the model
@pytest.mark.parametrize("name", ["quant_matmul", "quant_matmul_fused"])
def test_tune_spaces_are_tiles_by_splits(name):
    spec = get_spec(name)
    for k, splits in ((4096, (1, 2, 4, 8)), (14336, (1, 2, 4, 8)),
                      (520, (1, 2)), (256, (1,)), (128, (1,))):
        shape = {"m": 4, "k": k, "n": 1024}
        cands = spec.candidates(shape)
        assert sorted((c["block_m"], c["block_n"], c["block_k"], c["splits"])
                      for c in cands) == sorted(
            t + (s,) for t in qmm_ops.TILES for s in splits), k
        assert spec.default_config(shape) in cands


@pytest.mark.parametrize("name", ["quant_matmul", "quant_matmul_fused"])
def test_traffic_counts_x_at_its_float_width(name):
    """x moves at its float width, once per column tile; no int8 x and no
    activation scale is counted; the weight once per row tile."""
    spec = get_spec(name)
    m, k, n = 4, 4096, 1024
    shape = {"m": m, "k": k, "n": n}
    for cfg in spec.candidates(shape):
        col_tiles = -(-n // cfg["block_n"])
        row_tiles = -(-m // cfg["block_m"])
        fused = 4 * n * row_tiles if name.endswith("fused") else 0
        for dtype, size in (("float32", 4), ("bfloat16", 2)):
            want = (m * k * size * col_tiles + (k * n + 4 * n) * row_tiles
                    + 4 * m * n + fused)
            assert spec.hbm_bytes(shape, cfg, dtype) == want, (cfg, dtype)
        assert spec.vmem_bytes(shape, cfg, "float32") == qmm_ops.smem_bytes(
            cfg["block_m"], cfg["block_n"], cfg["block_k"], 4)


def test_default_splits_at_llama3_8b_shapes():
    """About one block an SM: 8 splits of the 16 column tiles of wk/wv, 2
    of wq/wo's 64, 1 of w_gate/w_up's 224; w_down's 64 tiles take 4, as 2
    would leave each block 7168 rows, past LONG_RANGE."""
    for m in (4, 16):
        got = {(k, n): qmm_ops.default_config(m, k, n)["splits"]
               for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                            (14336, 4096))}
        assert got == {(4096, 4096): 2, (4096, 1024): 8, (4096, 14336): 1,
                       (14336, 4096): 4}
    assert qmm_ops.default_config(4, 100, 1024)["splits"] == 1
    assert qmm_ops.default_config(4, 512, 64)["splits"] == 2
    for m, k, n in ((4, 14336, 4096), (16, 4096, 1024), (1, 300, 77)):
        s = qmm_ops.default_config(m, k, n)["splits"]
        assert s in qmm_ops.SPLITS and s <= max(1, -(-k // K_RANGE))


# -------------------------------------------- kwargs: the JAX resolution
QMM_WRAPPERS = [(quant_matmul, jax_qmm_ops.quant_matmul, "quant_matmul"),
                (quant_matmul_fused, jax_qmm_ops.quant_matmul_fused,
                 "quant_matmul_fused")]
CONV_WRAPPERS = [(conv_ops.apr_conv2d, jax_conv_ops.apr_conv2d, "apr_conv"),
                 (conv_ops.apr_conv2d_fused, jax_conv_ops.apr_conv2d_fused,
                  "apr_conv_fused")]


@pytest.mark.parametrize("ours,theirs,kernel", QMM_WRAPPERS + CONV_WRAPPERS,
                         ids=lambda v: v if isinstance(v, str) else "")
def test_wrappers_take_the_jax_block_kwargs(ours, theirs, kernel):
    mine = inspect.signature(ours).parameters
    for name in ("block_m", "block_n", "block_k", "config"):
        assert name in inspect.signature(theirs).parameters
        assert mine[name].kind is inspect.Parameter.KEYWORD_ONLY
        assert mine[name].default is None
    assert ("splits" in mine) == kernel.startswith("quant")


def _jax_qmm(kernel, m, k, n, dtype, explicit):
    return jax_resolve_config(
        kernel, jax_qmm_ops.shape_key(m, k, n), dtype, "cuda",
        default=jax_qmm_ops.default_config(m, k, n), explicit=explicit)


@pytest.mark.parametrize("kernel", ["quant_matmul", "quant_matmul_fused"])
def test_quant_kwargs_resolve_as_jax(kernel, tmp_path):
    """Pinned ``block_*`` resolve to the JAX package's
    ``resolve_config(..., explicit=...)`` tile: all three pinned, and one
    pinned over a shared cache entry that the JAX package wrote; a pinned
    split count rides along; a tile or split count that is not compiled
    raises TileError."""
    m, k, n = 4, 4096, 1024
    for tile in qmm_ops.TILES:
        pins = dict(zip(("block_m", "block_n", "block_k"), tile))
        got, splits = qmm_ops.resolve_launch(
            kernel, m, k, n, "bfloat16", "cuda", pin_config(None, **pins))
        want = _jax_qmm(kernel, m, k, n, "bfloat16", pins)
        assert got == (want["block_m"], want["block_n"], want["block_k"])
        assert splits == qmm_ops.default_splits(m, k, n, tile[0], tile[1])
    path = tmp_path / "shared.json"
    JaxConfigCache(path).store(kernel, jax_qmm_ops.shape_key(m, k, n),
                               "bfloat16", "cuda",
                               JaxBlockConfig.make(block_m=32, block_n=64,
                                                   block_k=64),
                               metrics={"us": 1.0})
    with jax_scoped_cache(JaxConfigCache(path)):
        want = _jax_qmm(kernel, m, k, n, "bfloat16", {"block_k": 256})
    with scoped_cache(ConfigCache(path)):
        got, splits = qmm_ops.resolve_launch(
            kernel, m, k, n, "bfloat16", "cuda",
            pin_config(None, block_k=256, splits=4))
    assert got == (want["block_m"], want["block_n"], want["block_k"]) \
        == (32, 64, 256)
    assert splits == 4
    for bad in (dict(block_m=128), dict(block_k=32), dict(splits=3)):
        with pytest.raises(TileError):
            qmm_ops.resolve_launch(kernel, m, k, n, "bfloat16", "cuda",
                                   pin_config(None, **bad))


@pytest.mark.parametrize("fused", [False, True])
def test_conv_kwargs_resolve_as_jax(fused, tmp_path):
    """The conv kernels' default tile for M = 32 under the APR key (one of
    the tiles the kernel compiles): pinned ``block_*`` equal to it resolve
    to what the JAX package resolves with the same pins, alone and over a
    shared cache entry of that tile; a pinned value that no compiled tile
    has raises TileError before a launch."""
    x = torch.zeros((2, 8, 8, 16))
    f = torch.zeros((3, 3, 16, 32))
    dims = (2, 8, 8, 16, 3, 3, 32, 1, 1)
    kernel = "apr_conv_fused" if fused else "apr_conv"
    residency = None if fused else "apr"
    b, h, w, c, hf, wf, m, stride, padding = dims
    key = (shape_key_from_dims(b=b, h=h, w=w, c=c, hf=hf, wf=wf, m=m,
                               s=stride, p=padding) if fused
           else jax_conv_ops.shape_key(*dims, "apr"))
    compiled = conv_ops.default_config(*dims, "apr")
    assert compiled in conv_ops.compiled_configs(32, "apr")
    pins = {name: compiled[name] for name in ("block_m", "block_n",
                                              "block_k")}
    want = jax_resolve_config(kernel, key, "float32", "cuda",
                              default=jax_conv_ops.default_config(*dims),
                              explicit=pins)
    got = conv_ops.resolve_launch(kernel, x, f, 1, 1, residency,
                                  pin_config(None, **pins))
    assert got.to_dict() == want.to_dict() == compiled.to_dict()
    path = tmp_path / "shared.json"
    JaxConfigCache(path).store(kernel, key, "float32", "cuda",
                               JaxBlockConfig.make(**pins),
                               metrics={"us": 1.0})
    with scoped_cache(ConfigCache(path)):
        got = conv_ops.resolve_launch(kernel, x, f, 1, 1, residency,
                                      pin_config(None, block_n=pins[
                                          "block_n"]))
    assert got == compiled
    for name in pins:
        with pytest.raises(TileError):
            conv_ops.resolve_launch(kernel, x, f, 1, 1, residency,
                                    pin_config(None, **{name: 2 * pins[
                                        name]}))
    # on CPU tensors the wrappers are the plain versions, pins or not
    wrapper = conv_ops.apr_conv2d_fused if fused else conv_ops.apr_conv2d
    assert torch.equal(wrapper(x, f, padding=1, **pins),
                       wrapper(x, f, padding=1))
