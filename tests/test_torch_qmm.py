"""Port parity, the int8 and fused matmul kernels: the plain PyTorch versions
of ``quant_matmul`` (B6), ``quant_matmul_fused`` (B8), ``apr_matmul_fused``
(B7's matmul route) and ``apr_matmul(residency="hbm")`` (B4m) against the
JAX package's Pallas kernels run in interpret mode and its oracles; the
activation quantization bit for bit; the accumulator traffic model; the CPU
dispatch of the wrappers and the C interface of ``csrc/quant_matmul.cu``.
The CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py``."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.apr_matmul import accumulator_traffic_bytes as jax_acc_bytes
from repro.kernels.apr_matmul import apr_matmul as jax_apr_matmul
from repro.kernels.apr_matmul.ops import apr_matmul_fused as jax_mm_fused
from repro.kernels.apr_matmul.ref import matmul_fused_ref as jax_mm_fused_ref
from repro.kernels.quant_matmul.ops import quant_matmul as jax_qmm
from repro.kernels.quant_matmul.ops import quant_matmul_fused as jax_qmm_fused
from repro.kernels.quant_matmul.ops import \
    quantize_activations as jax_quantize_activations
from repro.kernels.quant_matmul.ops import quantize_weights as jax_qweights
from repro.kernels.quant_matmul.ref import \
    quant_matmul_fused_ref as jax_qmm_fused_ref
from repro.kernels.quant_matmul.ref import quant_matmul_ref as jax_qmm_ref
from repro_torch.bench import TileError
from repro_torch.kernels.apr_matmul import (accumulator_traffic_bytes,
                                            apr_matmul, apr_matmul_fused,
                                            matmul_fused_ref, matmul_ref)
from repro_torch.kernels.quant_matmul import (quant_matmul,
                                              quant_matmul_fused,
                                              quant_matmul_fused_ref,
                                              quant_matmul_ref,
                                              quantize_activations,
                                              quantize_weights)
from repro_torch.kernels.quant_matmul import ops as qmm_ops

#: the JAX quant specs' own tolerance (repro/bench/specs.py): the integer
#: part is exact, only the two fp32 scale multiplies could round apart
QTOL = dict(rtol=1e-4, atol=1e-4)
#: fp32 sums of the same products in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
ACTIVATIONS = ("none", "relu", "silu", "gelu")
# ragged (M, K, N): none a multiple of the JAX kernel's 128 tiles or of the
# CUDA kernel's 16 x 64 ones
SHAPES = [(5, 96, 40), (16, 130, 70), (1, 256, 128), (4, 70, 33)]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """Both packages resolve tiles through a tune cache: keep each in a
    temp file, so the tests neither read nor write a user's."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))


def _both(a: np.ndarray, dtype: str):
    """The same values for both frameworks; bf16 rounds to nearest even
    on both sides."""
    a = np.asarray(a, np.float32)
    j = jnp.asarray(a)
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _weights(k, n, seed):
    """A float weight and its int8 codes and scales, quantized by each
    package (the two agree bit for bit)."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    jq, js = jax_qweights(jnp.asarray(w))
    tq, ts = quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    return (jq, js), (tq, ts)


# ------------------------------------------------ activation quantization
def _tie_rows() -> np.ndarray:
    """Rows whose codes land exactly on .5 ties (scale 1: amax 127; scale
    2: amax 254), an all-zero row, and rows of one sign."""
    rows = np.zeros((6, 16), np.float32)
    rows[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    rows[1, :8] = [254.0, 1.0, 3.0, 5.0, -1.0, -3.0, -5.0, 253.0]
    rows[2, :8] = [-127.0, 63.5, -63.5, 64.5, -64.5, 0.5, 0.0, -0.0]
    rows[4] = np.linspace(0.0, 1.0, 16)
    rows[5] = -np.linspace(0.25, 3.0, 16)
    return rows                               # row 3: all zeros


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["ties", "random", "wide"])
def test_quantize_activations_bit_equal_jax(case, dtype):
    """Codes and scales equal the JAX package's bit for bit, exact .5 ties
    (rounded half to even) and all-zero rows included."""
    rng = np.random.default_rng(1)
    x = {"ties": _tie_rows(),
         "random": rng.standard_normal((7, 300)).astype(np.float32) * 3,
         "wide": np.concatenate([rng.standard_normal((4, 4096)) * 1e-3,
                                 rng.standard_normal((4, 4096)) * 50])
         .astype(np.float32)}[case]
    jx, tx = _both(x, dtype)
    jq, js = jax_quantize_activations(jx)
    tq, ts = quantize_activations(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    if case == "ties":
        assert tq[0, 1] == 0 and tq[0, 2] == 2 and tq[0, 3] == 2   # even
        assert tq[1, 2] == 2 and tq[1, 3] == 2
        assert not tq[3].any() and ts[3, 0] == np.float32(1 / 127)


# ---------------------------------------------------- quant_matmul (B6)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quant_matmul_plain_matches_jax(shape, dtype):
    """The plain version against the JAX Pallas kernel in interpret mode
    and the JAX oracle."""
    m, k, n = shape
    x = np.random.default_rng(m * k + n).standard_normal((m, k)) * 2
    jx, tx = _both(x, dtype)
    (jq, js), (tq, ts) = _weights(k, n, seed=n)
    got = _np(quant_matmul_ref(tx, tq, ts))
    np.testing.assert_allclose(got, _np(jax_qmm(jx, jq, js)), **QTOL)
    np.testing.assert_allclose(got, _np(jax_qmm_ref(jx, jq, js)), **QTOL)
    # the wrapper on CPU tensors is the plain version, launching nothing
    before = quant_matmul.launches
    assert torch.equal(quant_matmul(tx, tq, ts), quant_matmul_ref(tx, tq, ts))
    assert quant_matmul.launches == before


def test_quant_matmul_integer_part_is_exact():
    """The integer total is exact (fp64 sums of int8 products), so scales
    of 1 give the int32 product itself."""
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (6, 700)).astype(np.int8)
    yq = rng.integers(-127, 128, (700, 50)).astype(np.int8)
    from repro_torch.kernels.quant_matmul.ref import int8_total
    got = int8_total(torch.from_numpy(xq), torch.from_numpy(yq))
    want = xq.astype(np.int64) @ yq.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# ---------------------------------------------- quant_matmul_fused (B8)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_matmul_fused_plain_matches_jax(dtype, activation, bias):
    m, k, n = 5, 96, 40
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, k))
    b = rng.standard_normal((n,)).astype(np.float32) * 10
    jx, tx = _both(x, dtype)
    (jq, js), (tq, ts) = _weights(k, n, seed=9)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    got = _np(quant_matmul_fused_ref(tx, tq, ts, tb, activation))
    np.testing.assert_allclose(
        got, _np(jax_qmm_fused(jx, jq, js, jb, activation=activation)),
        **QTOL)
    np.testing.assert_allclose(
        got, _np(jax_qmm_fused_ref(jx, jq, js, jb, activation)), **QTOL)
    assert torch.equal(quant_matmul_fused(tx, tq, ts, tb,
                                          activation=activation),
                       quant_matmul_fused_ref(tx, tq, ts, tb, activation))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_takes_a_quantized_tensor(out_dtype):
    from repro_torch.quant import quantize_channelwise
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32))
    qt = quantize_channelwise(w)
    got = quant_matmul(x, qt, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, quant_matmul_ref(x, qt.q, qt.scale, out_dtype))


# ------------------------------------------- apr_matmul_fused (B7, matmul)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_apr_matmul_fused_plain_matches_jax(shape, activation, bias):
    m, k, n = shape
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = _np(apr_matmul_fused(tx, ty, tb, activation=activation))
    np.testing.assert_allclose(
        got, _np(jax_mm_fused(jnp.asarray(x), jnp.asarray(y), jb,
                              activation=activation)), **F32_TOL)
    np.testing.assert_allclose(
        got, _np(jax_mm_fused_ref(jnp.asarray(x), jnp.asarray(y), jb,
                                  activation)), **F32_TOL)
    assert torch.equal(apr_matmul_fused(tx, ty, tb, activation=activation),
                       matmul_fused_ref(tx, ty, tb, activation))


# -------------------------------------- apr_matmul(residency="hbm") (B4m)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_hbm_residency_plain_matches_jax(shape):
    """The memory-resident baseline's plain version against the JAX
    package's hbm kernel (K outermost, fp32 partial) and against the APR
    residency: the same function."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = _np(apr_matmul(tx, ty, residency="hbm"))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(
        got, _np(jax_apr_matmul(jx, jy, residency="hbm")), **F32_TOL)
    np.testing.assert_allclose(
        got, _np(jax_apr_matmul(jx, jy, residency="apr")), **F32_TOL)
    assert torch.equal(apr_matmul(tx, ty, residency="hbm"),
                       apr_matmul(tx, ty, residency="apr"))
    assert torch.equal(apr_matmul(tx, ty, residency="hbm"),
                       matmul_ref(tx, ty))


def test_unknown_residency_raises():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="residency"):
        apr_matmul(x, torch.zeros((8, 8)), residency="vmem")


#: benchmarks/kernel_traffic.py's (name, M, N, K, block_k) geometries
TRAFFIC_GEOMS = [
    ("mlp_up d4096xff14336", 4096, 14336, 4096, 512),
    ("attn_qk 32k decode", 8, 32768, 128, 512),
    ("lenet_conv2 im2col", 1600, 16, 150, 128),
    ("expert_ffn arctic", 2048, 4864, 7168, 512),
]


@pytest.mark.parametrize("residency", ["apr", "hbm"])
@pytest.mark.parametrize("geom", TRAFFIC_GEOMS, ids=lambda g: g[0])
def test_accumulator_traffic_bytes_equal_jax(geom, residency):
    _, m, n, k, bk = geom
    for out_bytes in (2, 4):
        assert accumulator_traffic_bytes(m, n, k, bk, residency, out_bytes) \
            == jax_acc_bytes(m, n, k, bk, residency, out_bytes)


# ------------------------------------------------- wrappers off the CPU
def test_quant_wrappers_never_take_the_plain_path_off_the_cpu():
    x = torch.empty((4, 64), device="meta")
    wq = torch.empty((64, 8), dtype=torch.int8, device="meta")
    ws = torch.empty((1, 8), device="meta")
    with pytest.raises(ValueError):
        quant_matmul(x, wq, ws)
    with pytest.raises(ValueError):
        quant_matmul_fused(x, wq, ws)
    with pytest.raises(ValueError):
        apr_matmul_fused(torch.empty((4, 64), dtype=torch.bfloat16,
                                     device="meta"),
                         torch.empty((64, 8), dtype=torch.bfloat16,
                                     device="meta"))


def test_uncompiled_tiles_are_refused():
    """resolve_tile refuses a tile the CUDA kernel is not compiled for
    with TileError (the autotuner's rejection), before any launch."""
    from repro_torch.bench import BlockConfig
    from repro_torch.kernels.apr_matmul import ops as apr_ops
    bad = BlockConfig.make(block_m=128, block_n=128, block_k=128)
    for ops, kernel in ((apr_ops, "apr_matmul"),
                        (apr_ops, "apr_matmul_fused"),
                        (qmm_ops, "quant_matmul"),
                        (qmm_ops, "quant_matmul_fused")):
        with pytest.raises(TileError):
            ops.resolve_tile(kernel, 4, 64, 64, "bfloat16", "cuda",
                             config=bad)
        for tile in ops.TILES:
            cfg = BlockConfig.make(block_m=tile[0], block_n=tile[1],
                                   block_k=tile[2])
            assert ops.resolve_tile(kernel, 4, 64, 64, "bfloat16", "cuda",
                                    config=cfg) == tile
        assert ops.resolve_tile(kernel, 4, 64, 64, "bfloat16", "cuda") \
            == ops.DEFAULT_TILE == (16, 64, 64)


def test_bias_of_the_wrong_size_raises():
    x = torch.zeros((2, 8))
    wq, ws = quantize_weights(torch.ones((8, 4)))
    with pytest.raises(ValueError, match="bias"):
        quant_matmul_fused(x, wq, ws, torch.zeros(5))
    with pytest.raises(ValueError, match="activation"):
        quant_matmul_fused(x, wq, ws, activation="tanh")


# ----------------------------------------------- C interface of the source
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def test_quant_source_exports_the_wrapper_signature():
    """The ctypes signature matches the ``extern "C"`` function argument
    for argument, the compiled tiles are the wrapper's, and the source says
    which TPU kernels it replaces."""
    src = (CSRC / "quant_matmul.cu").read_text()
    assert "Replaces: src/repro/kernels/quant_matmul/kernel.py" in src
    assert 'extern "C" const char* repro_cuda_error_string(int' in src
    for fn, (_, argtypes) in qmm_ops.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert m, fn
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), (fn, params)
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t.__name__ == "c_void_p"), (fn, p, t)
    tiles = re.search(r"#define QMM_TILES\(X\)(.*?)\n\n", src, re.S).group(1)
    assert tuple(tuple(int(v) for v in t) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", tiles)) == qmm_ops.TILES


def test_matmul_source_compiles_the_wrapper_tiles():
    from repro_torch.kernels.apr_matmul import ops as apr_ops
    src = (CSRC / "apr_matmul.cu").read_text()
    tiles = re.search(r"#define APR_MATMUL_TILES\(X\)(.*?)\n\n", src,
                      re.S).group(1)
    assert tuple(tuple(int(v) for v in t) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", tiles)) == apr_ops.TILES


def test_epilogue_is_shared():
    """One activation function for the three fused flushes."""
    header = (CSRC / "epilogue.cuh").read_text()
    assert "__device__ __forceinline__ float activate(float v, int act)" \
        in header
    for name in ("apr_conv.cu", "apr_matmul.cu", "quant_matmul.cu"):
        src = (CSRC / name).read_text()
        assert '#include "epilogue.cuh"' in src, name
        assert "float activate(" not in src, name
