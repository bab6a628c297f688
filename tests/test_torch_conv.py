"""Port parity, conv: the plain PyTorch versions of ``apr_conv`` (and the
fused epilogue of ``apr_matmul``) against the JAX package's oracles and its
Pallas conv kernels run in interpret mode, the im2col order the CUDA kernel
walks, the CPU dispatch of the wrappers, and the C interface of
``csrc/apr_conv.cu``.  The CUDA kernels themselves are held to these plain
versions on the card by ``chip_smoke.py``."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.apr_conv import apr_conv2d as jax_apr_conv2d
from repro.kernels.apr_conv import apr_conv2d_fused as jax_apr_conv2d_fused
from repro.kernels.apr_conv import conv2d_fused_ref as jax_conv2d_fused_ref
from repro.kernels.apr_conv import conv2d_ref as jax_conv2d_ref
from repro.kernels.apr_conv.kernel import im2col as jax_im2col
from repro.kernels.apr_matmul.ref import activation_ref as jax_activation_ref
from repro.kernels.apr_matmul.ref import matmul_fused_ref as jax_mm_fused_ref
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.apr_conv import (apr_conv2d, apr_conv2d_fused,
                                          conv2d_fused_ref, conv2d_ref,
                                          im2col)
from repro_torch.kernels.apr_conv import ops as conv_ops
from repro_torch.kernels.apr_matmul import activation_ref, matmul_fused_ref

#: fp32: the same exact products summed in fp32 in another order (the JAX
#: conv tests' own tolerance, tests/test_kernels_conv.py)
TOL = dict(rtol=2e-4, atol=2e-4)
#: bf16 inputs: both sides widen to fp32 before the products, so they agree
#: as closely as in fp32
BF16_TOL = TOL
ACTIVATIONS = ("none", "relu", "silu", "gelu")

# (B, H, W, C, Hf, Wf, M, stride, pad) -- tests/test_kernels_conv.py
GEOMETRIES = [
    (1, 32, 32, 1, 5, 5, 6, 1, 0),    # LeNet conv1
    (1, 14, 14, 6, 5, 5, 16, 1, 0),   # LeNet conv2
    (1, 16, 16, 16, 3, 3, 32, 2, 1),  # ResNet-20 stage transition
    (1, 8, 8, 64, 1, 1, 64, 1, 0),    # pointwise (MobileNet pw)
    (2, 10, 10, 8, 3, 3, 12, 1, 1),
]


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """The JAX kernels resolve tiles through a tune cache: keep it in a
    temp file, so the tests neither read nor write the user's."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _conv_case(case, seed, dtype="float32"):
    b, h, w, c, hf, wf, m, s, p = case
    rng = np.random.default_rng(seed)
    xj, xt = _both(rng.standard_normal((b, h, w, c)), dtype)
    fj, ft = _both(rng.standard_normal((hf, wf, c, m)), dtype)
    return (xj, fj), (xt, ft), s, p


# ------------------------------------------------------------ plain conv
@pytest.mark.parametrize("case", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_ref_matches_jax_oracle(case, dtype):
    (xj, fj), (xt, ft), s, p = _conv_case(case, 0, dtype)
    got = conv2d_ref(xt, ft, stride=s, padding=p)
    ref = jax_conv2d_ref(xj, fj, stride=s, padding=p)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref),
                               **(TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("case", GEOMETRIES)
@pytest.mark.parametrize("residency", ["apr", "hbm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_ref_matches_jax_pallas_kernel(case, residency, dtype):
    """The JAX Pallas conv (im2col + the APR- or memory-resident matmul),
    in interpret mode, against the port's plain version."""
    (xj, fj), (xt, ft), s, p = _conv_case(case, 1, dtype)
    ref = jax_apr_conv2d(xj, fj, stride=s, padding=p, residency=residency,
                         interpret=True)
    got = conv2d_ref(xt, ft, stride=s, padding=p)
    np.testing.assert_allclose(_np(got), _np(ref),
                               **(TOL if dtype == "float32" else BF16_TOL))


# ---------------------------------------------------------- fused epilogue
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("bias", ["none", "(M,)", "(1, M)"])
def test_conv2d_fused_ref_matches_jax_pallas_kernel(activation, bias):
    case = (2, 9, 9, 8, 3, 3, 12, 2, 1)
    (xj, fj), (xt, ft), s, p = _conv_case(case, 2)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(12).astype(np.float32)
    shape = {"none": None, "(M,)": (12,), "(1, M)": (1, 12)}[bias]
    bj = None if shape is None else jnp.asarray(b.reshape(shape))
    bt = None if shape is None else torch.from_numpy(b.reshape(shape))
    ref = jax_apr_conv2d_fused(xj, fj, bj, activation=activation, stride=s,
                               padding=p, interpret=True)
    got = conv2d_fused_ref(xt, ft, bt, activation, stride=s, padding=p)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    oracle = jax_conv2d_fused_ref(xj, fj, bj, activation, stride=s,
                                  padding=p)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_activation_ref_matches_jax(activation):
    # gelu is the tanh approximation in both (jax.nn.gelu's default)
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    got = activation_ref(torch.from_numpy(x), activation)
    ref = jax_activation_ref(jnp.asarray(x), activation)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_fused_ref_matches_jax_oracle(activation, dtype):
    rng = np.random.default_rng(4)
    xj, xt = _both(rng.standard_normal((5, 40)), dtype)
    yj, yt = _both(rng.standard_normal((40, 24)) / np.sqrt(40), dtype)
    b = rng.standard_normal(24).astype(np.float32)
    got = matmul_fused_ref(xt, yt, torch.from_numpy(b), activation)
    ref = jax_mm_fused_ref(xj, yj, jnp.asarray(b), activation)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        activation_ref(torch.zeros(3), "tanh")
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError):
        apr_conv2d_fused(x, torch.zeros((3, 3, 2, 2)), activation="tanh")


# ------------------------------------------------------------------ im2col
@pytest.mark.parametrize("case", GEOMETRIES + [(2, 9, 11, 3, 3, 3, 4, 2, 1)])
def test_im2col_equals_jax(case):
    (xj, _), (xt, _), s, p = _conv_case(case, 5)
    hf, wf = case[4], case[5]
    got, ho, wo = im2col(xt, hf, wf, s, p)
    ref, jho, jwo = jax.jit(jax_im2col, static_argnums=(1, 2, 3, 4))(
        xj, hf, wf, s, p)
    assert (ho, wo) == (jho, jwo)
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_im2col_order_is_the_filter_reshape():
    """Column k = (di·Wf + dj)·C + c: the patch matrix times
    ``f.reshape(Hf·Wf·C, M)`` is the conv -- the reduction order the CUDA
    kernel decodes from k."""
    case = (2, 7, 6, 3, 3, 2, 5, 1, 1)
    _, (xt, ft), s, p = _conv_case(case, 6)
    cols, ho, wo = im2col(xt, 3, 2, s, p)
    got = (cols.double() @ ft.reshape(-1, 5).double()).reshape(2, ho, wo, 5)
    ref = conv2d_ref(xt, ft, stride=s, padding=p)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- dispatch
def test_apr_conv2d_on_cpu_is_the_plain_version():
    _, (xt, ft), s, p = _conv_case(GEOMETRIES[2], 7)
    before = (apr_conv2d.launches, apr_conv2d.hbm_launches)
    for residency in ("apr", "hbm"):
        got = apr_conv2d(xt, ft, stride=s, padding=p, residency=residency)
        assert torch.equal(got, conv2d_ref(xt, ft, stride=s, padding=p))
    assert (apr_conv2d.launches, apr_conv2d.hbm_launches) == before


@pytest.mark.parametrize("bias_shape", [None, (32,), (1, 32)])
def test_apr_conv2d_fused_on_cpu_is_the_plain_version(bias_shape):
    _, (xt, ft), s, p = _conv_case(GEOMETRIES[2], 8)
    bias = None if bias_shape is None else torch.ones(bias_shape)
    before = apr_conv2d_fused.launches
    got = apr_conv2d_fused(xt, ft, bias, activation="gelu", stride=s,
                           padding=p)
    assert torch.equal(got, conv2d_fused_ref(xt, ft, bias, "gelu", stride=s,
                                             padding=p))
    assert apr_conv2d_fused.launches == before


def test_apr_conv_never_takes_the_plain_path_off_the_cpu(monkeypatch):
    """A tensor that is neither on the CPU nor on a card is refused before
    anything is computed: the wrappers call no library conv or matmul (the
    plain versions, F.conv2d, torch.matmul) off the CPU."""
    def forbidden(*a, **k):
        raise AssertionError("a library op was called off the CPU")
    for mod, name in ((conv_ops, "conv2d_ref"), (conv_ops, "conv2d_fused_ref"),
                      (torch.nn.functional, "conv2d"), (torch, "matmul")):
        monkeypatch.setattr(mod, name, forbidden)
    x = torch.empty((2, 8, 8, 4), device="meta")
    f = torch.empty((3, 3, 4, 8), device="meta")
    for residency in ("apr", "hbm"):
        with pytest.raises(ValueError):
            apr_conv2d(x, f, padding=1, residency=residency)
    with pytest.raises(ValueError):
        apr_conv2d_fused(x, f, torch.empty(8, device="meta"), padding=1)
    with pytest.raises(ValueError):        # one operand on the CPU
        apr_conv2d(torch.zeros((2, 8, 8, 4)), f)
    with pytest.raises(ValueError):
        apr_conv2d(x, f, residency="l2")


def test_bias_of_the_wrong_size_raises():
    x, f = torch.zeros((1, 6, 6, 2)), torch.zeros((3, 3, 2, 4))
    with pytest.raises(ValueError):
        apr_conv2d_fused(x, f, torch.zeros(5))


# --------------------------------------------- C interface of the source
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def test_k_step_of_the_wrapper_is_the_kernels():
    """The memory-resident baseline sends its partial through memory once
    per K step; the wrapper's step count (the partial's traffic) must be
    the kernel's tile depth."""
    src = (CSRC / "apr_conv.cu").read_text()
    assert re.search(r"constexpr int BK = (\d+);", src).group(1) == \
        str(conv_ops.K_STEP)


def test_activation_codes_of_the_kernel():
    """The activation codes of the wrappers are the epilogue's, which the
    conv kernel includes (``csrc/epilogue.cuh``, shared with the matmul
    kernels)."""
    assert '#include "epilogue.cuh"' in (CSRC / "apr_conv.cu").read_text()
    src = (CSRC / "epilogue.cuh").read_text()
    from repro_torch.kernels.apr_matmul.ref import ACTIVATIONS as codes
    for name, code in codes.items():
        if code:
            assert re.search(rf"case {code}:\s*\{{?\s*//\s*{name}", src), name
