"""Port parity, the recurrences' gradients: the plain backwards
``rwkv6_ref_bwd`` / ``mamba2_ref_bwd`` against ``jax.vjp`` of the JAX
package's oracles (``repro/kernels/{rwkv6,mamba2}/ref.py``), and the
autograd Functions ``Rwkv6Function`` / ``Mamba2Function`` on the CPU: their
gradients are the plain backwards' bit for bit, cast to the inputs' dtypes
and given only where asked; a state in or out under a gradient is refused
by name, and the CUDA backward wrappers refuse CPU tensors.

Tolerance of the plain backwards against JAX: fp32, each gradient within
1e-5 of its largest magnitude (the same step-by-step sums in another order
and association), at T = 1, 37, 64 and decays near 1e-24 and near 1.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2.ref import mamba2_ref as jax_mamba2_ref
from repro.kernels.rwkv6.ref import rwkv6_ref as jax_rwkv6_ref
from repro_torch.kernels.mamba2 import (Mamba2Function, mamba2_ref_bwd,
                                        mamba2_ssd, mamba2_ssd_backward,
                                        mamba2_ssd_grad)
from repro_torch.kernels.mamba2 import ops as mamba2_ops
from repro_torch.kernels.rwkv6 import (Rwkv6Function, rwkv6_ref_bwd,
                                       rwkv6_wkv, rwkv6_wkv_backward,
                                       rwkv6_wkv_grad)
from repro_torch.kernels.rwkv6 import ops as rwkv6_ops

TOL = 1e-5
TS = (1, 37, 64)
#: the decay's range: ordinary, near 1e-24 (w at rwkv's clamp), near 1
DECAYS = {"mid": (0.05, 0.95), "tiny": (1e-24, 1e-20), "one": (0.9999, 1.0)}
CSRC = Path(rwkv6_ops.__file__).resolve().parents[2] / "csrc"


def rwkv_inputs(t, decay="mid", b=2, h=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                   for _ in range(4))
    w = rng.uniform(*DECAYS[decay], (b, t, h, d)).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    return r, k, v, w, u, dy


def mamba_inputs(t, decay="mid", b=2, h=3, p=16, n=16, seed=0):
    """dt and a set the decay exp(a dt): ordinary, underflowing, ~1."""
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((b, t, h, p)).astype(np.float32)
             for _ in range(2))
    bm, cm = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    lo, hi = {"mid": (0.01, 0.5), "tiny": (20.0, 30.0),
              "one": (1e-5, 1e-4)}[decay]
    dt = rng.uniform(lo, hi, (b, t, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    d = rng.standard_normal((h,)).astype(np.float32)
    return x, bm, cm, dt, a, d, dy


@pytest.fixture(scope="module")
def jax_vjps():
    """One jitted vjp a oracle, shared by the tests (one compile a
    shape)."""
    def vjp_of(fn):
        return jax.jit(lambda args, dy: jax.vjp(fn, *args)[1](dy))
    return {"rwkv6": vjp_of(jax_rwkv6_ref), "mamba2": vjp_of(jax_mamba2_ref)}


def _close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("t", TS)
def test_rwkv6_ref_bwd_matches_jax_vjp(t, decay, jax_vjps):
    *args, dy = rwkv_inputs(t, decay)
    ref = jax_vjps["rwkv6"](tuple(args), jnp.asarray(dy))
    got = rwkv6_ref_bwd(*(torch.from_numpy(a) for a in (*args, dy)))
    for name, g, r in zip(("dr", "dk", "dv", "dw", "du"), got, ref):
        assert g.dtype == torch.float32
        _close(g, r, name)


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("t", TS)
def test_mamba2_ref_bwd_matches_jax_vjp(t, decay, jax_vjps):
    *args, dy = mamba_inputs(t, decay)
    ref = jax_vjps["mamba2"](tuple(args), jnp.asarray(dy))
    got = mamba2_ref_bwd(*(torch.from_numpy(a) for a in (*args, dy)))
    for name, g, r in zip(("dx", "db", "dc", "ddt", "da", "dd"), got, ref):
        assert g.dtype == torch.float32
        _close(g, r, name)


RWKV_WANTS = [(True,) * 5, (True, False, False, True, False),
              (False, False, True, False, True)]
MAMBA_WANTS = [(True,) * 6, (True, False, False, True, False, False),
               (False, True, True, False, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wants", RWKV_WANTS)
def test_rwkv6_function_gives_the_plain_backward(wants, dtype):
    r, k, v, w, u, dy = (torch.from_numpy(a) for a in rwkv_inputs(9))
    r, k, v, u, dy = (x.to(dtype) for x in (r, k, v, u, dy))
    leaves = [x.clone().requires_grad_(want)
              for x, want in zip((r, k, v, w, u), wants)]
    y = Rwkv6Function.apply(*leaves)
    assert torch.equal(y, rwkv6_wkv(r, k, v, w, u))
    y.backward(dy)
    ref = rwkv6_ref_bwd(r, k, v, w, u, dy)
    for leaf, g, want in zip(leaves, ref, wants):
        if want:
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, g.to(leaf.dtype))
        else:
            assert leaf.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wants", MAMBA_WANTS)
def test_mamba2_function_gives_the_plain_backward(wants, dtype):
    x, b, c, dt, a, d, dy = (torch.from_numpy(v) for v in mamba_inputs(9))
    x, b, c, dy = (v.to(dtype) for v in (x, b, c, dy))
    leaves = [v.clone().requires_grad_(want)
              for v, want in zip((x, b, c, dt, a, d), wants)]
    y = Mamba2Function.apply(*leaves)
    assert torch.equal(y, mamba2_ssd(x, b, c, dt, a, d))
    y.backward(dy)
    ref = mamba2_ref_bwd(x, b, c, dt, a, d, dy)
    for leaf, g, want in zip(leaves, ref, wants):
        if want:
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, g.to(leaf.dtype))
        else:
            assert leaf.grad is None


def test_functions_take_strided_inputs():
    """B10's forward reads column slices of a fused projection: the
    Function's gradient lands in the slices' places."""
    x, b, c, dt, a, d, dy = (torch.from_numpy(v) for v in mamba_inputs(7))
    fused = torch.cat([x.reshape(2, 7, -1), b, c], dim=-1).requires_grad_()
    hp, n = x.shape[2] * x.shape[3], b.shape[-1]
    xs, bs, cs = torch.split(fused, [hp, n, n], dim=-1)
    y = Mamba2Function.apply(xs.reshape(x.shape), bs, cs, dt, a, d)
    y.backward(dy)
    ref = mamba2_ref_bwd(x, b, c, dt, a, d, dy)
    assert torch.equal(fused.grad, torch.cat(
        [ref[0].reshape(2, 7, -1), ref[1], ref[2]], dim=-1))


def test_states_under_a_gradient_are_refused_by_name():
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in rwkv_inputs(3))
    s0 = torch.zeros((2, 3, 16, 16))
    with pytest.raises(NotImplementedError, match="s_init"):
        rwkv6_wkv_grad(r, k, v, w, u, s_init=s0)
    with pytest.raises(NotImplementedError, match="return_state"):
        rwkv6_wkv_grad(r, k, v, w, u, return_state=True)
    x, b, c, dt, a, d, _ = (torch.from_numpy(v) for v in mamba_inputs(3))
    h0 = torch.zeros((2, 3, 16, 16))
    with pytest.raises(NotImplementedError, match="h_init"):
        mamba2_ssd_grad(x, b, c, dt, a, d, h_init=h0)
    with pytest.raises(NotImplementedError, match="return_state"):
        mamba2_ssd_grad(x, b, c, dt, a, d, return_state=True)


def test_backward_wrappers_launch_or_raise():
    """The CUDA backward wrappers take CUDA tensors only (the Functions
    run the plain backwards on CPU tensors): CPU tensors raise before any
    launch, and the counts do not move."""
    before = (rwkv6_wkv_backward.launches, mamba2_ssd_backward.launches)
    rw = [torch.from_numpy(a) for a in rwkv_inputs(4)]
    with pytest.raises(ValueError, match="tensors on"):
        rwkv6_wkv_backward(*rw)
    mb = [torch.from_numpy(v) for v in mamba_inputs(4)]
    with pytest.raises(ValueError, match="tensors on"):
        mamba2_ssd_backward(*mb)
    assert (rwkv6_wkv_backward.launches,
            mamba2_ssd_backward.launches) == before


def _smem_floats(name: str) -> str:
    """The body of ``smem_floats`` in ``csrc/<name>.cu``, as a Python
    expression (C's integer division)."""
    src = (CSRC / f"{name}.cu").read_text()
    body = re.search(r"smem_floats\([^)]*\) \{\s*return (.*?);", src,
                     re.S).group(1)
    return "(" + body.replace("/", "//") + ")"


@pytest.mark.parametrize("t,d,chunk", [(512, 64, 11), (1, 16, 1),
                                       (37, 16, 16), (9, 128, 3)])
def test_rwkv6_backward_chunk_fits_the_source_layout(t, d, chunk):
    dp = rwkv6_ops.head_rows(d)
    assert rwkv6_ops.bwd_chunk(t, d) == chunk
    floats = eval(_smem_floats("rwkv6_bwd"), {"ch": chunk, "dp": dp})
    assert floats * 4 <= rwkv6_ops.MAX_SMEM
    if chunk < min(t, rwkv6_ops.BWD_MAX_CHUNK):
        assert eval(_smem_floats("rwkv6_bwd"),
                    {"ch": chunk + 1, "dp": dp}) * 4 > rwkv6_ops.MAX_SMEM


@pytest.mark.parametrize("t,p,n,chunk", [(512, 64, 128, 6), (512, 64, 64, 11),
                                         (1, 16, 16, 1), (37, 16, 16, 16)])
def test_mamba2_backward_chunk_fits_the_source_layout(t, p, n, chunk):
    np_ = mamba2_ops.state_cols(n)
    assert mamba2_ops.bwd_chunk(t, p, n) == chunk
    floats = eval(_smem_floats("mamba2_bwd"), {"ch": chunk, "p": p,
                                               "np": np_})
    assert floats * 4 <= mamba2_ops.MAX_SMEM
    if chunk < min(t, mamba2_ops.BWD_MAX_CHUNK):
        assert eval(_smem_floats("mamba2_bwd"), {
            "ch": chunk + 1, "p": p, "np": np_}) * 4 > mamba2_ops.MAX_SMEM
