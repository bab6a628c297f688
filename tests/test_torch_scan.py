"""Port parity, recurrences (B9 ``rwkv6``, B10 ``mamba2``): the plain
versions ``rwkv6_ref`` / ``mamba2_ref`` against the JAX oracles and the JAX
Pallas kernels in interpret mode (ragged T included), their state in/out
against the JAX chunked formulas (``wkv_chunked``, ``ssd_chunked`` with an
initial state and ``return_state=True``), the port's chunked formulas
against JAX's, and the wrappers on the CPU.  The CUDA kernels are held to
these plain versions on the card by ``chip_smoke.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2 import mamba2_ref as jax_mamba2_ref
from repro.kernels.mamba2 import mamba2_ssd as jax_mamba2_ssd
from repro.kernels.rwkv6 import rwkv6_ref as jax_rwkv6_ref
from repro.kernels.rwkv6 import rwkv6_wkv as jax_rwkv6_wkv
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.mamba2 import mamba2_ref, mamba2_ssd
from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv6_wkv
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

#: fp32 scans over at most 40 steps of O(1) values, the same products summed
#: in another order: a few fp32 ulps of the largest value
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
#: the JAX chunked formulas reach the same sums through exp/cumsum of the
#: log decay and matmuls over a chunk: ~10 fp32 ulps of the largest value
CHUNKED_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16 inputs: both compute in fp32 and round y once to bf16, so a value
#: on a rounding boundary may land one bf16 ulp (2^-7 relative) apart
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)


def _both(a, dtype="float32"):
    """The same values as a JAX array and a torch tensor."""
    j = jnp.asarray(np.asarray(a, np.float32)).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rwkv_arrays(b, t, h, d, seed):
    """r, k, v, w (decay in (0, 1), down to ~1e-24 as the model's), u, and
    an initial state, from a numpy seed."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, d)) * 0.5 for _ in range(3))
    logw = -np.exp(rng.uniform(-8.0, 4.0, (b, t, h, d)))
    u = rng.standard_normal((h, d)) * 0.1
    s0 = rng.standard_normal((b, h, d, d)) * 0.5
    return r, k, v, logw, u, s0


def mamba_arrays(b, t, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)) * 0.5
    bb, c = (rng.standard_normal((b, t, n)) * 0.5 for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h))))
    a = -np.abs(rng.standard_normal(h)) - 0.1
    d = rng.standard_normal(h) * 0.5
    h0 = rng.standard_normal((b, h, p, n)) * 0.5
    return x, bb, c, dt, a, d, h0


RWKV_CASES = [(1, 16, 1, 8, "float32"), (2, 37, 2, 16, "float32"),
              (1, 24, 4, 32, "float32"), (2, 13, 3, 16, "bfloat16")]
MAMBA_CASES = [(1, 16, 1, 8, 16, "float32"), (2, 37, 2, 16, 16, "float32"),
               (1, 24, 4, 8, 64, "float32"), (2, 13, 3, 16, 32, "bfloat16")]


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else FP32_TOL


# ------------------------------------------------------------------ rwkv6
@pytest.mark.parametrize("b,t,h,d,dtype", RWKV_CASES)
def test_rwkv6_ref_matches_jax_ref(b, t, h, d, dtype):
    r, k, v, logw, u, _ = rwkv_arrays(b, t, h, d, seed=t)
    pairs = [_both(a, dtype) for a in (r, k, v)] + [
        _both(np.exp(logw)), _both(u, dtype)]
    ref = jax_rwkv6_ref(*(p[0] for p in pairs))
    got = rwkv6_ref(*(p[1] for p in pairs))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("b,t,h,d,dtype", RWKV_CASES)
def test_rwkv6_ref_matches_jax_pallas_kernel(b, t, h, d, dtype):
    """The TPU kernel in interpret mode, time chunk 8 (ragged T: the JAX
    wrapper legalises the chunk to a divisor of T)."""
    r, k, v, logw, u, _ = rwkv_arrays(b, t, h, d, seed=t + 1)
    pairs = [_both(a, dtype) for a in (r, k, v)] + [
        _both(np.exp(logw)), _both(u, dtype)]
    ref = jax_rwkv6_wkv(*(p[0] for p in pairs), chunk=8, interpret=True)
    got = rwkv6_ref(*(p[1] for p in pairs))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("b,t,h,d,chunk", [(1, 16, 2, 8, 8), (2, 21, 2, 16, 8),
                                           (2, 1, 3, 16, 1)])
def test_rwkv6_state_in_out_matches_jax_wkv_chunked(b, t, h, d, chunk):
    """The port's plain scan and its chunked formula, from a nonzero state,
    against JAX ``wkv_chunked(..., s_init, return_state=True)``: y and the
    final state."""
    r, k, v, logw, u, s0 = rwkv_arrays(b, t, h, d, seed=3 * t)
    j = [_both(a) for a in (r, k, v, logw, u, s0)]
    jy, js = jax.jit(functools.partial(
        jrwkv.wkv_chunked, chunk=chunk, return_state=True))(
            *(p[0] for p in j[:5]), s_init=j[5][0])
    tr, tk, tv, tlw, tu, ts0 = (p[1] for p in j)
    y, s = rwkv6_ref(tr, tk, tv, torch.exp(tlw), tu, s_init=ts0,
                     return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(_np(s), _np(js), **CHUNKED_TOL)
    y, s = trwkv.wkv_chunked(tr, tk, tv, tlw, tu, chunk=chunk, s_init=ts0,
                             return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(_np(s), _np(js), **CHUNKED_TOL)
    # from zeros and without a state out: the TPU kernel's own semantics
    jy = jax.jit(functools.partial(jrwkv.wkv_chunked, chunk=chunk))(
        *(p[0] for p in j[:5]))
    y = trwkv.wkv_chunked(tr, tk, tv, tlw, tu, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(jy), **CHUNKED_TOL)


# ----------------------------------------------------------------- mamba2
@pytest.mark.parametrize("b,t,h,p,n,dtype", MAMBA_CASES)
def test_mamba2_ref_matches_jax_ref(b, t, h, p, n, dtype):
    x, bb, c, dt, a, d, _ = mamba_arrays(b, t, h, p, n, seed=t)
    pairs = [_both(v, dtype) for v in (x, bb, c)] + [
        _both(v) for v in (dt, a, d)]
    ref = jax_mamba2_ref(*(q[0] for q in pairs))
    got = mamba2_ref(*(q[1] for q in pairs))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("b,t,h,p,n,dtype", MAMBA_CASES)
def test_mamba2_ref_matches_jax_pallas_kernel(b, t, h, p, n, dtype):
    x, bb, c, dt, a, d, _ = mamba_arrays(b, t, h, p, n, seed=t + 1)
    pairs = [_both(v, dtype) for v in (x, bb, c)] + [
        _both(v) for v in (dt, a, d)]
    ref = jax_mamba2_ssd(*(q[0] for q in pairs), chunk=8, interpret=True)
    got = mamba2_ref(*(q[1] for q in pairs))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("b,t,h,p,n,chunk", [(1, 16, 2, 8, 16, 8),
                                             (2, 21, 2, 16, 16, 8),
                                             (2, 1, 3, 8, 32, 1)])
def test_mamba2_state_in_out_matches_jax_ssd_chunked(b, t, h, p, n, chunk):
    x, bb, c, dt, a, d, h0 = mamba_arrays(b, t, h, p, n, seed=3 * t)
    j = [_both(v) for v in (x, bb, c, dt, a, d, h0)]
    jy, js = jax.jit(functools.partial(
        jssm.ssd_chunked, chunk=chunk, return_state=True))(
            *(q[0] for q in j[:6]), h_init=j[6][0])
    targs = [q[1] for q in j[:6]]
    y, s = mamba2_ref(*targs, h_init=j[6][1], return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(_np(s), _np(js), **CHUNKED_TOL)
    y, s = tssm.ssd_chunked(*targs, chunk=chunk, h_init=j[6][1],
                            return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(_np(s), _np(js), **CHUNKED_TOL)
    jy = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk))(
        *(q[0] for q in j[:6]))
    y = tssm.ssd_chunked(*targs, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(jy), **CHUNKED_TOL)


# ---------------------------------------------------------------- wrappers
def _rwkv_tensors(b, t, h, d, device="cpu", dtype=torch.float32):
    r, k, v, logw, u, s0 = rwkv_arrays(b, t, h, d, seed=7)
    return ([torch.tensor(a, dtype=dtype, device=device) for a in (r, k, v)]
            + [torch.tensor(np.exp(logw), dtype=torch.float32, device=device),
               torch.tensor(u, dtype=dtype, device=device)],
            torch.tensor(s0, dtype=torch.float32, device=device))


def _mamba_tensors(b, t, h, p, n, device="cpu", dtype=torch.float32):
    x, bb, c, dt, a, d, h0 = mamba_arrays(b, t, h, p, n, seed=7)
    return ([torch.tensor(v, dtype=dtype, device=device) for v in (x, bb, c)]
            + [torch.tensor(v, dtype=torch.float32, device=device)
               for v in (dt, a, d)],
            torch.tensor(h0, dtype=torch.float32, device=device))


@pytest.mark.parametrize("init", [False, True])
def test_wrappers_on_cpu_are_the_plain_versions(init):
    args, s0 = _rwkv_tensors(2, 9, 2, 16)
    kw = dict(s_init=s0 if init else None, return_state=True)
    for got, ref in zip(rwkv6_wkv(*args, **kw), rwkv6_ref(*args, **kw)):
        assert torch.equal(got, ref)
    args, h0 = _mamba_tensors(2, 9, 2, 16, 32)
    kw = dict(h_init=h0 if init else None, return_state=True)
    for got, ref in zip(mamba2_ssd(*args, **kw), mamba2_ref(*args, **kw)):
        assert torch.equal(got, ref)
    assert rwkv6_wkv.launches == 0 and mamba2_ssd.launches == 0


@pytest.mark.parametrize("d", [8, 24, 144])
def test_rwkv6_wrapper_refuses_head_dims_the_kernel_does_not_take(d):
    """Off the CPU the wrapper checks the kernel's limits (D a multiple of
    16 up to 128) before anything else; meta tensors reach that check
    without a card."""
    args, s0 = _rwkv_tensors(1, 2, 1, d, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_wkv(*args, s_init=s0)


@pytest.mark.parametrize("p,n", [(8, 16), (80, 16), (16, 24), (16, 144)])
def test_mamba2_wrapper_refuses_shapes_the_kernel_does_not_take(p, n):
    args, h0 = _mamba_tensors(1, 2, 1, p, n, device="meta")
    with pytest.raises(ValueError, match="multiples of 16"):
        mamba2_ssd(*args, h_init=h0)


def test_wrappers_refuse_mixed_devices_and_dtypes():
    args, _ = _rwkv_tensors(1, 2, 1, 16, device="meta")
    with pytest.raises(ValueError, match="tensors on"):
        rwkv6_wkv(*args)                               # meta is not CUDA
    args[3] = args[3].to(torch.bfloat16)               # decay not fp32
    with pytest.raises(TypeError, match="fp32 decay"):
        rwkv6_wkv(*args)
    args, _ = _mamba_tensors(1, 2, 1, 16, 16, device="meta")
    args[1] = args[1].to(torch.bfloat16)               # b not in x's dtype
    with pytest.raises(TypeError, match="one dtype"):
        mamba2_ssd(*args)
