"""Port parity, kernels: the plain PyTorch versions of ``apr_matmul`` and
``flash_decode_paged`` against the JAX package's oracles (and its Pallas
paged kernel, run in interpret mode), the CPU dispatch of the wrappers, and
the C interface of the CUDA sources against the wrappers' ctypes
signatures.  The CUDA kernels themselves are held to these plain versions
on the card by ``chip_smoke.py``."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.apr_matmul.ref import matmul_ref as jax_matmul_ref
from repro.kernels.flash_decode import flash_decode_paged as jax_flash_paged
from repro.kernels.flash_decode.ref import (
    gather_pages as jax_gather_pages,
    paged_decode_attention_ref as jax_paged_ref)
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.apr_conv import ops as conv_ops
from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
from repro_torch.kernels.apr_matmul import ops as apr_ops
from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                              gather_pages,
                                              paged_decode_attention_ref)
from repro_torch.kernels.flash_decode import ops as fd_ops

BF16_EPS = 2.0 ** -7   # one bf16 ulp, relative


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


# ------------------------------------------------------------ apr_matmul
MATMUL_SHAPES = [(3, 100, 37), (4, 64, 256), (16, 128, 1000), (1, 8, 8)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype,out", [("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32"),
                                       ("float32", "float32")])
def test_matmul_ref_matches_jax_oracle(m, k, n, dtype, out):
    rng = np.random.default_rng(m * 1000 + k + n)
    xj, xt = _both(rng.standard_normal((m, k)), dtype)
    yj, yt = _both(rng.standard_normal((k, n)) / np.sqrt(k), dtype)
    ref = np.asarray(jax_matmul_ref(xj, yj, out_dtype=jnp.dtype(out)),
                     np.float32)
    got = _np(matmul_ref(xt, yt, getattr(torch, out)))
    if out == "bfloat16":
        # both sum exact products in fp32 and round once; the fp32 order
        # differs, so a value on a rounding boundary may land one bf16 ulp
        # apart
        np.testing.assert_allclose(got, ref, rtol=BF16_EPS, atol=1e-6)
    else:
        # fp32 sums of the same products in another order
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_apr_matmul_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 70))).to(torch.bfloat16)
    y = torch.from_numpy(rng.standard_normal((70, 33))).to(torch.bfloat16)
    before = apr_matmul.launches
    for out in (torch.float32, torch.bfloat16):
        got = apr_matmul(x, y, out_dtype=out)
        assert got.dtype == out
        assert torch.equal(got, matmul_ref(x, y, out))
    assert apr_matmul.launches == before   # no kernel launch on the CPU


def test_apr_matmul_never_takes_the_plain_path_off_the_cpu():
    # a tensor that is neither on the CPU nor on a card must not be
    # computed by the plain version
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    y = torch.empty((8, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        apr_matmul(x, y)
    with pytest.raises(ValueError):
        apr_matmul(torch.zeros((4, 8), dtype=torch.bfloat16), y)


# ------------------------------------------------------ flash_decode_paged
def _paged_case(b, hq, hkv, d, ps, p_max, lengths, seed, dtype):
    """Pools with every row's pages scattered, padding routed to null page
    0, and the same values for both frameworks."""
    rng = np.random.default_rng(seed)
    need = [-(-n // ps) for n in lengths]
    p_pool = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, p_pool))
    tables = np.zeros((b, p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    q = rng.standard_normal((b, hq, d))
    kp = rng.standard_normal((p_pool, ps, hkv, d))
    vp = rng.standard_normal((p_pool, ps, hkv, d))
    lens = np.asarray(lengths, np.int32)
    j = [_both(a, dtype)[0] for a in (q, kp, vp)]
    t = [_both(a, dtype)[1] for a in (q, kp, vp)]
    return (j + [jnp.asarray(lens), jnp.asarray(tables)],
            t + [torch.from_numpy(lens), torch.from_numpy(tables)])


PAGED_CASES = [
    # b, hq, hkv, d, ps, p_max, lengths
    (4, 8, 2, 32, 8, 4, [0, 1, 8, 9]),          # 0, 1, ps, ps+1
    (3, 4, 4, 16, 4, 6, [23, 4, 0]),            # MHA, ragged, idle row
    (2, 32, 8, 64, 16, 3, [40, 17]),            # llama3 group of 4
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ref_matches_jax_oracle(case, dtype):
    b, hq, hkv, d, ps, p_max, lengths = case
    jargs, targs = _paged_case(b, hq, hkv, d, ps, p_max, lengths, 1, dtype)
    got = _np(paged_decode_attention_ref(*targs))
    ref = np.asarray(jax_paged_ref(*jargs), np.float32)
    live = np.asarray(lengths) > 0
    # fp32: the same softmax with the normalisation after the value sum
    # instead of before; bf16: both work in fp32 and round the output once
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=BF16_EPS, atol=1e-3))
    np.testing.assert_allclose(got[live], ref[live], **tol)
    # rows of length 0 are zeros, as the paged kernel returns them (the
    # JAX oracle averages the masked values there instead)
    assert not got[~live].any()


@pytest.mark.parametrize("case", PAGED_CASES[:2])
def test_paged_ref_matches_jax_pallas_kernel(case):
    """The JAX Pallas paged kernel (interpret mode) zeroes idle rows too:
    the port's plain version agrees with it on every row."""
    b, hq, hkv, d, ps, p_max, lengths = case
    jargs, targs = _paged_case(b, hq, hkv, d, ps, p_max, lengths, 2,
                               "float32")
    ref = np.asarray(jax_flash_paged(*jargs, chunk=ps), np.float32)
    got = _np(paged_decode_attention_ref(*targs))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_gather_pages_matches_jax():
    jargs, targs = _paged_case(3, 4, 2, 8, 4, 5, [7, 0, 20], 3, "float32")
    np.testing.assert_array_equal(
        _np(gather_pages(targs[1], targs[4])),
        np.asarray(jax_gather_pages(jargs[1], jargs[4])))


def test_flash_decode_paged_on_cpu_is_the_plain_version():
    _, targs = _paged_case(*PAGED_CASES[0][:6], PAGED_CASES[0][6], 4,
                           "bfloat16")
    before = flash_decode_paged.launches
    got = flash_decode_paged(*targs)
    assert torch.equal(got, paged_decode_attention_ref(*targs))
    assert flash_decode_paged.launches == before


def test_flash_decode_paged_never_takes_the_plain_path_off_the_cpu():
    _, targs = _paged_case(*PAGED_CASES[0][:6], PAGED_CASES[0][6], 4,
                           "bfloat16")
    targs[0] = torch.empty(targs[0].shape, dtype=torch.bfloat16,
                           device="meta")
    with pytest.raises(ValueError):
        flash_decode_paged(*targs)


# --------------------------------------------- C interface of the sources
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


@pytest.mark.parametrize("ops", [apr_ops, fd_ops, conv_ops])
def test_cuda_sources_export_the_wrapper_signatures(ops):
    """Each ctypes signature matches an ``extern "C"`` function of its
    ``.cu`` source, argument for argument (pointers and the stream as
    pointers, ints as ints), and the source says which TPU kernel it
    replaces."""
    src = (CSRC / f"{ops.LIBRARY}.cu").read_text()
    assert "Replaces: src/repro/kernels/" in src
    assert 'extern "C" const char* repro_cuda_error_string(int' in src
    for fn, (restype, argtypes) in ops.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert m, fn
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), (fn, params)
        for p, t in zip(params, argtypes):
            kind = "*" in p
            assert kind == (t.__name__ == "c_void_p"), (fn, p, t)
