"""Port parity, the split-K matmul bodies: the plain split forms
``matmul_split_ref`` and ``matmul_fused_split_ref`` (fp32 partials over the
128-row K ranges of ``split_range``, added in split order, rounded once)
against the JAX package's ``apr_matmul`` / ``apr_matmul_fused`` (run on the
CPU as its own tests run them) and the port's unsplit plain versions, at
every split count the kernels take, for bf16 and fp32 operands, ragged K
and empty ranges; the fp32 activations over int8 weights on the CPU
against the JAX layers on ``quantize_params`` weights; the default split
count at llama3-8b's shapes; the tune spaces of tiles x splits; the
``splits=`` kwarg; and the split geometry the CUDA source compiles.  The
CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.apr_matmul import apr_matmul as jax_apr_matmul
from repro.kernels.apr_matmul import apr_matmul_fused as jax_apr_matmul_fused
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.quant import QuantizedTensor as JaxQT
from repro.quant import quantize_params as jax_quantize_params
from repro_torch.bench import BlockConfig, ConfigCache, TileError
from repro_torch.bench.config import pin_config, scoped_cache
from repro_torch.bench.registry import get_spec
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.kernels.apr_matmul import (K_RANGE, apr_matmul,
                                            apr_matmul_fused,
                                            matmul_fused_ref,
                                            matmul_fused_split_ref,
                                            matmul_ref, matmul_split_ref,
                                            split_range)
from repro_torch.kernels.apr_matmul import ops as apr_ops
from repro_torch.models import layers as torch_layers
from repro_torch.quant import QuantizedTensor

#: bf16 out: both sum exact products in fp32 and round once; the fp32 order
#: differs, so a value on a rounding boundary may land one bf16 ulp apart
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
#: fp32 out: the same products summed in another fp32 order
F32_RTOL = F32_ATOL = 1e-5
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    """Both packages' tuned-config caches in temp files."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port.json"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _tol(out: str) -> dict:
    return (dict(rtol=F32_RTOL, atol=F32_ATOL) if out == "float32"
            else dict(rtol=BF16_RTOL, atol=BF16_ATOL))


# ------------------------------------------------------------ split ranges
def test_split_range_cuts_whole_128_row_ranges():
    assert K_RANGE == 128
    assert split_range(4096, 1) == 4096 and split_range(4096, 8) == 512
    assert split_range(14336, 4) == 3584 and split_range(14336, 8) == 1792
    # ragged K: whole ranges, the last cut at K, ranges past K empty
    assert split_range(300, 2) == 256 and split_range(300, 8) == 128
    assert split_range(96, 8) == 128 and split_range(0, 4) == 0
    for k in (0, 1, 96, 128, 129, 300, 4100, 14336):
        for s in apr_ops.SPLITS:
            r = split_range(k, s)
            assert r % K_RANGE == 0 and r * s >= k
            # the fewest whole ranges that cover K in s splits
            assert r == 0 or r - K_RANGE < -(-k // s)


#: (M, K, N): K ragged (not a multiple of 8, 16 or 128), a K shorter than
#: 8 x 128 (empty ranges at 4 and 8 splits), one range, several tiles of N
SPLIT_SHAPES = [(3, 300, 37), (4, 520, 64), (1, 96, 40), (5, 1000, 70)]


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES, ids=str)
@pytest.mark.parametrize("splits", apr_ops.SPLITS)
@pytest.mark.parametrize("dtype,out", [("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32"),
                                       ("float32", "float32")])
def test_split_ref_matches_jax_and_unsplit(m, k, n, splits, dtype, out):
    rng = np.random.default_rng(m * 1000 + k + n)
    xj, xt = _both(rng.standard_normal((m, k)), dtype)
    yj, yt = _both(rng.standard_normal((k, n)) / np.sqrt(k), dtype)
    out_t = getattr(torch, out)
    got = matmul_split_ref(xt, yt, splits, out_t)
    assert got.dtype == out_t and got.shape == (m, n)
    ref = jax_apr_matmul(xj, yj, out_dtype=jnp.dtype(out))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(out))
    np.testing.assert_allclose(_np(got), _np(matmul_ref(xt, yt, out_t)),
                               **_tol(out))
    if splits == 1:                       # one range: the unsplit product
        assert torch.equal(got, matmul_ref(xt, yt, out_t))


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES[:2], ids=str)
@pytest.mark.parametrize("splits", apr_ops.SPLITS)
@pytest.mark.parametrize("activation", ["relu", "silu", "gelu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_split_ref_matches_jax_and_unsplit(m, k, n, splits,
                                                 activation, dtype):
    rng = np.random.default_rng(k + n)
    xj, xt = _both(rng.standard_normal((m, k)), dtype)
    yj, yt = _both(rng.standard_normal((k, n)) / np.sqrt(k), dtype)
    bj, bt = _both(rng.standard_normal((n,)), "float32")
    got = matmul_fused_split_ref(xt, yt, splits, bt, activation,
                                 getattr(torch, dtype))
    ref = jax_apr_matmul_fused(xj, yj, bj, activation=activation,
                               out_dtype=jnp.dtype(dtype))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))
    unsplit = matmul_fused_ref(xt, yt, bt, activation, getattr(torch, dtype))
    np.testing.assert_allclose(_np(got), _np(unsplit), **_tol(dtype))
    if splits == 1:
        assert torch.equal(got, unsplit)


def test_empty_ranges_add_exactly_zero():
    """Splits past K's last range hold empty partials: the sum is the one
    over the ranges that hold rows, bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 200)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((200, 24)).astype(np.float32))
    two = matmul_split_ref(x, y, 2)           # ranges [0, 128), [128, 200)
    assert torch.equal(matmul_split_ref(x, y, 4), two)
    assert torch.equal(matmul_split_ref(x, y, 8), two)
    manual = (torch.matmul(x[:, :128], y[:128])
              + torch.matmul(x[:, 128:], y[128:]))
    assert torch.equal(two, manual)
    zero_k = matmul_split_ref(x[:, :0], y[:0], 8)
    assert zero_k.shape == (4, 24) and not zero_k.any()


# ------------------------------------------------ fp32 x over int8 weights
@pytest.fixture(scope="module")
def fp32_int8_params():
    """The JAX smoke params at PRNGKey(0) in fp32, int8-quantized by the
    JAX ``quantize_params``, in both frameworks."""
    cfg = jax_get_config("llama3-8b", smoke=True)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax_build_model(cfg).init_params(
                              jax.random.PRNGKey(0)))
    qparams = jax_quantize_params(params)
    tparams = params_from_numpy({
        k: (np.asarray(v.q), np.asarray(v.scale)) if isinstance(v, JaxQT)
        else np.asarray(v) for k, v in qparams.items()})
    return qparams, tparams


def test_fp32_x_int8_weight_on_cpu_matches_jax_layers(fp32_int8_params):
    """Every int8 weight of the quantized fp32 model (layer 0 of the
    stacked ones) under fp32 activations: the port's ``linear`` and
    ``tp_einsum`` against the JAX layers' einsum over
    ``materialize_weight``; the CPU route is the plain version on the fp32
    dequantized weight, bit for bit."""
    qparams, tparams = fp32_int8_params
    names = [k for k, v in qparams.items() if isinstance(v, JaxQT)]
    assert names, "quantize_params quantized nothing"
    rng = np.random.default_rng(11)
    for name in names:
        wj, wt = qparams[name], tparams[name]
        assert isinstance(wt, QuantizedTensor)
        if wj.q.ndim == 3:                      # stacked (layers, in, out)
            wj = JaxQT(q=wj.q[0], scale=wj.scale[0])
            wt = wt[0]
        k = wj.q.shape[0]
        xj, xt = _both(rng.standard_normal((1, 3, k)), "float32")
        ref = jnp.einsum("btd,dk->btk", xj,
                         jax_layers.materialize_weight(wj, jnp.float32))
        got = torch_layers.linear(xt, wt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(ref), rtol=F32_RTOL,
                                   atol=F32_ATOL, err_msg=name)
        ref_tp = jax.jit(lambda x, w: jax_layers.tp_einsum(
            "btk,kd->btd", x, w))(xj, wj)
        np.testing.assert_allclose(_np(torch_layers.tp_einsum(xt, wt)),
                                   _np(ref_tp), rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)
        x2 = xt.reshape(-1, k)
        deq = wt.dequantize(torch.float32)
        assert torch.equal(apr_matmul(x2, wt), matmul_ref(x2, deq))
        for s in apr_ops.SPLITS:            # the kernel's split order
            np.testing.assert_allclose(
                _np(matmul_split_ref(x2, deq, s)), _np(matmul_ref(x2, deq)),
                rtol=F32_RTOL, atol=F32_ATOL)


def test_fp32_x_int8_weight_is_a_compiled_pair():
    apr_ops.check_dtypes("apr_matmul", torch.float32, torch.int8)
    with pytest.raises(TypeError):
        apr_ops.check_dtypes("apr_matmul_fused", torch.float32, torch.int8)
    assert apr_matmul.f32_int8_launches == 0    # no launch on the CPU


# ------------------------------------------------------- default split count
#: llama3-8b's projections (K, N) and the split count the geometry gives
#: on 64-column tiles at every M: the column tiles of one row tile x splits
#: about one block on each of the h100_sxm profile's 132 SMs for bf16 and
#: fp32 weights, about four for int8 codes under an fp32 x
LLAMA_SPLITS = {(4096, 4096): 2, (4096, 1024): 8, (4096, 14336): 1,
                (14336, 4096): 2, (4096, 128256): 1}
LLAMA_INT8_SPLITS = {(4096, 4096): 8, (4096, 1024): 8, (4096, 14336): 2,
                     (14336, 4096): 8, (4096, 128256): 1}


@pytest.mark.parametrize("m", [4, 16])
def test_default_splits_at_llama3_8b_shapes(m):
    assert apr_ops.SMS == 132
    assert apr_ops.SPLIT_BLOCK_BUDGET == {1: 528, 2: 132, 4: 132}
    for (k, n), want in LLAMA_SPLITS.items():
        assert apr_ops.default_splits(k, n, 64) == want, (k, n)
        assert apr_ops.default_config(m, k, n)["splits"] == want
        assert apr_ops.f32_default_config(m, k, n)["splits"] == want
        assert apr_ops.resolve_launch("apr_matmul", m, k, n, "bfloat16",
                                      "cuda") == (apr_ops.DEFAULT_TILE, want)
        assert apr_ops.resolve_f32("apr_matmul", m, k, n) == BlockConfig.make(
            block_m=16, block_n=64, block_k=64, splits=want)
        assert apr_ops.resolve_f32("apr_matmul", m, k, n, w_int8=True) == \
            apr_ops.f32_default_config(m, k, n, True)
        assert apr_ops.f32_default_config(m, k, n, True)["splits"] == \
            LLAMA_INT8_SPLITS[(k, n)], (k, n)
    # at most one split a 128-row range of K, at least one
    assert apr_ops.default_splits(96, 40, 64) == 1
    assert apr_ops.default_splits(300, 40, 64) == 2
    assert apr_ops.default_splits(0, 40, 64) == 1
    # more row tiles take the same splits: M never enters the count
    assert apr_ops.default_config(64, 4096, 1024)["splits"] == \
        apr_ops.default_config(m, 4096, 1024)["splits"] == 8
    # the memory-resident baseline and the int8-weight kernel: one split
    assert apr_ops.resolve_launch("apr_matmul", m, 4096, 1024, "bfloat16",
                                  "cuda", "hbm")[1] == 1
    assert apr_ops.resolve_launch("apr_matmul", m, 4096, 1024, "bfloat16",
                                  "cuda", w_int8=True)[1] == 1


# ------------------------------------------------------------- tune spaces
def _configs(tiles, splits):
    return {BlockConfig.make(block_m=a, block_n=b, block_k=c, splits=s)
            for a, b, c in tiles for s in splits}


@pytest.mark.parametrize("name", ["apr_matmul", "apr_matmul_fused"])
def test_tune_spaces_are_tiles_by_splits(name):
    spec = get_spec(name)
    shape = {"m": 4, "k": 4096, "n": 1024}
    bf16 = spec.candidates(shape)
    assert set(bf16) == _configs(apr_ops.TILES, apr_ops.SPLITS)
    assert len(bf16) == 24 and spec.candidates(shape, "bfloat16") == bf16
    f32 = spec.candidates(shape, "float32")
    assert set(f32) == _configs(apr_ops.F32_TILES, apr_ops.SPLITS)
    assert spec.default_config(shape) in bf16
    # no more splits than K has 128-row ranges
    short = {"m": 4, "k": 300, "n": 64}
    assert {c["splits"] for c in spec.candidates(short)} == {1, 2}
    assert {c["splits"] for c in spec.candidates(short, "float32")} == {1, 2}
    assert {c["splits"] for c in spec.candidates(
        {"m": 4, "k": 96, "n": 64})} == {1}


def test_baseline_and_int8_weight_spaces():
    spec = get_spec("apr_matmul")
    mkn = {"m": 4, "k": 4096, "n": 1024}
    hbm = spec.candidates({**mkn, "hbm": 1})
    assert set(hbm) == _configs(apr_ops.TILES, (1,))
    assert spec.default_config({**mkn, "hbm": 1})["splits"] == 1
    int8 = spec.candidates({**mkn, "w_int8": 1})
    assert {(c["block_m"], c["block_n"], c["block_k"]) for c in int8} \
        == set(apr_ops.INT8W_TILES)
    assert all("splits" not in c for c in int8)
    # fp32 activations over the int8 weight: the fp32 body's space, under
    # the _wint8 key
    f32 = spec.candidates({**mkn, "w_int8": 1}, "float32")
    assert set(f32) == _configs(apr_ops.F32_TILES, apr_ops.SPLITS)
    assert spec.shape_key({**mkn, "w_int8": 1}).endswith("_wint8")


def test_fp32_int8_route_tunes_under_the_wint8_key_at_float32(tmp_path):
    """A tuned entry of the fp32 x int8 route lives under the ``_wint8``
    key at dtype ``float32``; it moves neither the fp32 x fp32 route (the
    plain key at float32) nor the bf16 int8-weight kernel (``_wint8`` at
    bfloat16)."""
    cache = ConfigCache(tmp_path / "tuned.json", autosave=False)
    tuned = BlockConfig.make(block_m=16, block_n=64, block_k=64, splits=4)
    key = apr_ops.shape_key(4, 4096, 1024, "apr", True)
    cache.store("apr_matmul", key, "float32", "cuda", tuned)
    with scoped_cache(cache):
        assert apr_ops.resolve_f32("apr_matmul", 4, 4096, 1024,
                                   w_int8=True) == tuned
        assert apr_ops.resolve_f32("apr_matmul", 4, 4096, 1024)["splits"] \
            == 8
        assert apr_ops.resolve_launch("apr_matmul", 4, 4096, 1024,
                                      "bfloat16", "cuda", w_int8=True) == (
            (16, 16, 128), 1)


# ----------------------------------------------------------- the kwargs
def test_splits_kwarg_pins_the_split_count():
    assert apr_ops.resolve_launch(
        "apr_matmul", 4, 4096, 4096, "bfloat16", "cuda",
        config=pin_config(None, splits=4)) == ((16, 64, 64), 4)
    assert apr_ops.resolve_launch(
        "apr_matmul_fused", 4, 4096, 4096, "bfloat16", "cuda",
        config=pin_config(BlockConfig.make(splits=8), splits=1,
                          block_k=128)) == ((16, 64, 128), 1)
    for bad in (3, 16):
        with pytest.raises(TileError):
            apr_ops.resolve_launch("apr_matmul", 4, 4096, 4096, "bfloat16",
                                   "cuda", config=pin_config(None,
                                                             splits=bad))
        with pytest.raises(TileError):
            apr_ops.resolve_f32("apr_matmul", 4, 4096, 4096,
                                pin_config(None, splits=bad))
    with pytest.raises(TileError):            # the int8-weight kernel
        apr_ops.resolve_launch("apr_matmul", 4, 4096, 4096, "bfloat16",
                               "cuda", config=pin_config(None, splits=2),
                               w_int8=True)


def test_splits_kwarg_on_the_cpu_and_the_baseline_refusal():
    """On the CPU a pinned split count takes the plain version like any
    pinned tile; the memory-resident baseline runs one split and refuses a
    pinned split count above one before anything else."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    for s in apr_ops.SPLITS:
        assert torch.equal(apr_matmul(x, y, splits=s), matmul_ref(x, y))
        assert torch.equal(apr_matmul_fused(x, y, None, splits=s,
                                            activation="silu"),
                           matmul_fused_ref(x, y, None, "silu"))
    assert torch.equal(apr_matmul(x, y, residency="hbm", splits=1),
                       matmul_ref(x, y))
    for s in (2, 4, 8):
        with pytest.raises(ValueError, match="one split"):
            apr_matmul(x, y, residency="hbm", splits=s)


# ------------------------------------------------------------ the source
def test_source_compiles_the_split_geometry():
    """The fp32-body tiles, the 128-row ranges and the cluster of at most 8
    splits are the wrapper's; the entry points take the split arguments."""
    src = (CSRC / "apr_matmul.cu").read_text()
    tiles = re.search(r"#define F32_TILES\(X\)(.*)", src).group(1)
    assert tuple((16, int(bn), int(bk)) for bn, bk in re.findall(
        r"X\((\d+), (\d+)\)", tiles)) == apr_ops.F32_TILES
    assert re.search(r"constexpr int K_RANGE = (\d+);", src).group(1) \
        == str(K_RANGE)
    assert re.search(r"constexpr int MAX_SPLITS = (\d+);", src).group(1) \
        == str(max(apr_ops.SPLITS))
    for fn in ("apr_matmul_bf16", "apr_matmul_f32", "apr_matmul_f32_int8w"):
        params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                           src).group(1)
        assert "int splits" in params and "int krange" in params, fn
    assert "cluster.map_shared_rank" in src and "cudaLaunchKernelEx" in src
