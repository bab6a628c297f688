"""Port parity, the paper's memory-resident baseline: ``apr_matmul`` and
``apr_conv2d`` with ``residency="hbm"`` (B4m, B4c) on the CPU against the
JAX package's ``residency="hbm"`` Pallas kernels run in interpret mode (K
outermost, the fp32 partial revisited at every K step); the refusals, the
launch counters and the fp32 baseline's configuration; and the C interface
of the one-launch baselines in ``csrc/``.  The CUDA kernels themselves are
held to these plain versions on the card by ``chip_smoke.py`` (B4m bit for
bit to B1 at one split)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.apr_conv import apr_conv2d as jax_apr_conv2d
from repro.kernels.apr_matmul import apr_matmul as jax_apr_matmul
from repro_torch.bench import BlockConfig, get_spec
from repro_torch.bench.config import pin_config
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.apr_conv import apr_conv2d, conv2d_ref
from repro_torch.kernels.apr_conv import ops as conv_ops
from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
from repro_torch.kernels.apr_matmul import ops as mm_ops

#: fp32 sums of the same products (exact for bf16 operands) in another
#: order, of O(1) outputs
F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: a bf16 output: the two fp32 sums may round to neighbouring bf16 values
BF16_OUT_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
#: the conv tests' tolerance (tests/test_kernels_conv.py)
CONV_TOL = dict(rtol=2e-4, atol=2e-4)
#: ragged (M, K, N): none a multiple of the JAX kernel's 128 tiles or of
#: the CUDA kernels' 16 x 64 ones; K above and below one 64-row K tile
MATMUL_SHAPES = [(3, 200, 90), (17, 64, 129), (2, 1000, 24), (1, 33, 7)]
#: (B, H, W, C, Hf, Wf, M, stride, pad): stride 2 with padding, ragged
CONV_GEOMETRIES = [
    (3, 9, 11, 1, 3, 3, 5, 2, 1),       # C = 1, odd H and W
    (2, 15, 13, 16, 3, 3, 32, 2, 1),    # a ResNet-20 stage transition
    (2, 12, 12, 4, 5, 5, 7, 2, 2),      # K = 100, pad 2
    (1, 9, 9, 8, 1, 1, 16, 2, 0),       # a strided 1x1 shortcut
]
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """Both packages resolve tiles through a tune cache: keep each in a
    temp file, so the tests neither read nor write a user's."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _counts() -> tuple:
    return (mm_ops.apr_matmul.hbm_launches,
            mm_ops.apr_matmul.hbm_f32_launches, apr_conv2d.hbm_launches)


# ------------------------------------------------------ B4m, matmul route
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_matmul_baseline_matches_jax_hbm_kernel(shape, dtype, out):
    """The port's baseline on the CPU (its plain version) against the JAX
    ``residency="hbm"`` kernel in interpret mode, bf16 and fp32 operands,
    fp32 and bf16 outputs; and equal to the APR residency bit for bit."""
    m, k, n = shape
    rng = np.random.default_rng(m * k + n)
    xj, xt = _both(rng.standard_normal((m, k)), dtype)
    yj, yt = _both(rng.standard_normal((k, n)) * k ** -0.5, dtype)
    before = _counts()
    got = apr_matmul(xt, yt, residency="hbm", out_dtype=getattr(torch, out))
    ref = jax_apr_matmul(xj, yj, residency="hbm", out_dtype=jnp.dtype(out),
                         interpret=True)
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(
        _np(got), _np(ref), **(F32_TOL if out == "float32" else BF16_OUT_TOL))
    assert torch.equal(got, apr_matmul(xt, yt, out_dtype=got.dtype))
    assert torch.equal(got, matmul_ref(xt, yt, got.dtype))
    assert _counts() == before           # the CPU path launches nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_matmul_baseline_refuses_split_k(dtype, splits):
    """The baseline is one chain: a pinned split count above one raises
    before anything is computed, on either operand type, with or without a
    pinned tile; one split is accepted."""
    x = torch.ones((4, 300), dtype=dtype)
    y = torch.ones((300, 16), dtype=dtype)
    with pytest.raises(ValueError, match="one split"):
        apr_matmul(x, y, residency="hbm", splits=splits)
    with pytest.raises(ValueError, match="one split"):
        apr_matmul(x, y, residency="hbm", splits=splits, block_m=16,
                   block_n=64, block_k=64)
    assert torch.equal(apr_matmul(x, y, residency="hbm", splits=1),
                       matmul_ref(x, y))


def test_fp32_baseline_configuration():
    """The fp32 baseline resolves on the fp32 body's tiles at one split
    under the ``_reshbm`` key, where the APR kernel takes a split-K; a
    pinned split count above one is refused before any launch; its tune
    space is the fp32 tiles at one split."""
    for k, n in [(4096, 1024), (4096, 4096), (14336, 4096), (96, 40)]:
        cfg = mm_ops.resolve_f32("apr_matmul", 4, k, n, residency="hbm")
        assert cfg["splits"] == 1
        assert (cfg["block_m"], cfg["block_n"], cfg["block_k"]) \
            in mm_ops.F32_TILES
    assert mm_ops.resolve_f32("apr_matmul", 4, 4096, 1024)["splits"] == 8
    pinned = pin_config(None, splits=2)
    x, w = torch.zeros((4, 256)), torch.zeros((256, 64))
    with pytest.raises(ValueError, match="one split"):
        mm_ops._launch_f32(x, w, None, None, "none", torch.float32,
                           mm_ops.KERNEL_NAME, pinned, "hbm")
    spec = get_spec("apr_matmul")
    shape = {"m": 4, "k": 4096, "n": 1024, "hbm": 1}
    assert set(spec.candidates(shape, "float32")) == {
        BlockConfig.make(block_m=a, block_n=b, block_k=c, splits=1)
        for a, b, c in mm_ops.F32_TILES}
    assert spec.shape_key(shape).endswith("_reshbm")


# --------------------------------------------------------- B4c, conv route
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_GEOMETRIES, ids=str)
def test_conv_baseline_matches_jax_hbm_kernel(case, dtype):
    """``apr_conv2d(residency="hbm")`` on the CPU against the JAX conv on
    its memory-resident matmul (im2col, then the ``residency="hbm"``
    kernel) in interpret mode, at stride 2 with padding; bit for bit the
    APR residency's, and no launch counted."""
    b, h, w, c, hf, wf, m, s, p = case
    rng = np.random.default_rng(b * h + m)
    xj, xt = _both(rng.standard_normal((b, h, w, c)), dtype)
    fj, ft = _both(rng.standard_normal((hf, wf, c, m)), dtype)
    before = _counts()
    got = apr_conv2d(xt, ft, stride=s, padding=p, residency="hbm")
    ref = jax_apr_conv2d(xj, fj, stride=s, padding=p, residency="hbm",
                         interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), **CONV_TOL)
    assert torch.equal(got, apr_conv2d(xt, ft, stride=s, padding=p))
    assert torch.equal(got, conv2d_ref(xt, ft, stride=s, padding=p))
    assert _counts() == before


# ------------------------------------------------------ the C interface
@pytest.mark.parametrize("source, entries", [
    ("apr_matmul.cu", ("apr_matmul_hbm_bf16", "apr_matmul_hbm_f32")),
    ("apr_conv.cu", ("apr_conv_hbm",))])
def test_baselines_are_one_launch_with_a_partial_through_memory(source,
                                                                entries):
    """Each baseline entry takes the whole K range in one launch (no step
    or K-tile range among its arguments), its partial's round trip is the
    shared header's L2-cached store and L1-bypassing load, and the
    wrapper's signature is the source's."""
    src = (CSRC / source).read_text()
    ops = mm_ops if source == "apr_matmul.cu" else conv_ops
    for fn in entries:
        params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                           src).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert not {"step", "t_begin", "t_end", "seed"} & set(names), fn
        assert len(names) == len(ops.SIGNATURES[fn][1]), fn
    assert '#include "partial.cuh"' in src
    assert "st_cg(" in src and "ld_cg(" in src
    header = (CSRC / "partial.cuh").read_text()
    for op in ("st.global.cg.f32", "ld.global.cg.f32"):
        assert re.search(r'asm volatile\("' + re.escape(op) + r'[^;]*;'
                         r'[^)]*\)[^;]*"memory"\);', header), op
