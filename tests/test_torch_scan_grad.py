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

The backward kernels split each (b, h) state over blocks (B10 in column
tiles, B9 in row tiles; ``bwd_geometry``): their shared memory and chunk
against the sources' ``smem_floats``, the geometry at every shape of
``chip_smoke.py``'s phase 9e-a (enough blocks or one wave, two blocks an
SM, scratch buffers of the sizes the sources index), and the split's
algebra -- the plain backward run tile by tile, its per-tile partials
summed in the kernels' order, equals the whole plain backward within
1e-6 of each gradient's largest magnitude in fp32 (the same sums,
regrouped).
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


#: B9 backward cases: (B, T, H, D) and the chunk the geometry gives
RWKV_CHUNKS = [((2, 512, 40, 64), 12), ((2, 1, 4, 16), 1),
               ((2, 37, 4, 16), 32), ((2, 9, 4, 128), 8),
               ((1, 1024, 40, 64), 18)]
#: B10 backward cases: (B, T, H, P, N) and the chunk
MAMBA_CHUNKS = [((2, 512, 80, 64, 128), 4), ((2, 512, 64, 64, 64), 10),
                ((2, 1, 4, 16, 16), 1), ((2, 37, 4, 16, 16), 32),
                ((1, 1024, 80, 64, 128), 7)]


def _fits(ops, floats, geom, blocks_wanted):
    """The source's floats are the wrapper's bytes; they fit a block, and
    ``blocks_wanted`` such blocks an SM."""
    assert floats * 4 == geom["smem"] <= ops.MAX_SMEM
    return mamba2_ops.blocks_per_sm(floats * 4,
                                    geom["threads"]) >= blocks_wanted


@pytest.mark.parametrize("shape,chunk", RWKV_CHUNKS)
def test_rwkv6_backward_chunk_fits_the_source_layout(shape, chunk):
    """The chunk is the longest (up to BWD_MAX_CHUNK and T) at which the
    blocks an SM one wave needs (at least 2) fit, by the source's
    ``smem_floats``."""
    b, t, h, d = shape
    g = rwkv6_ops.bwd_geometry(*shape, 2)
    assert g["chunk"] == chunk and g["chunks"] == -(-t // chunk)
    want = max(2, -(-g["blocks"] // rwkv6_ops.SMS))
    env = dict(d=d, dp=rwkv6_ops.head_rows(d), w=g["warps"], es=2)
    assert _fits(rwkv6_ops, eval(_smem_floats("rwkv6_bwd"),
                                 dict(env, ch=chunk)), g, want)
    if chunk < min(t, mamba2_ops.BWD_MAX_CHUNK):
        more = eval(_smem_floats("rwkv6_bwd"), dict(env, ch=chunk + 1))
        assert mamba2_ops.blocks_per_sm(more * 4, g["threads"]) < want


@pytest.mark.parametrize("shape,chunk", MAMBA_CHUNKS)
def test_mamba2_backward_chunk_fits_the_source_layout(shape, chunk):
    b, t, h, p, n = shape
    g = mamba2_ops.bwd_geometry(*shape, 2)
    assert g["chunk"] == chunk and g["chunks"] == -(-t // chunk)
    want = max(2, -(-g["blocks"] // mamba2_ops.SMS))
    assert g["wave"] == (want >= mamba2_ops.BWD_WAVE_BLOCKS
                         and g["rows_per_lane"] == 4)
    env = dict(p=p, nc=g["cols"], w=g["warps"], es=2)
    assert _fits(mamba2_ops, eval(_smem_floats("mamba2_bwd"),
                                  dict(env, ch=chunk)), g, want)
    if chunk < min(t, mamba2_ops.BWD_MAX_CHUNK):
        more = eval(_smem_floats("mamba2_bwd"), dict(env, ch=chunk + 1))
        assert mamba2_ops.blocks_per_sm(more * 4, g["threads"]) < want


#: every shape of chip_smoke.py's phase 9e-a (SCAN_GRAD_SHAPES, the
#: training shapes, and SCAN_GRAD_ODD), and the smoke configs' (P = N = D
#: = 16)
GRAD_SHAPES = {
    "rwkv6": [(2, 512, 40, 64), (2, 1, 4, 64), (2, 37, 4, 64),
              (1, 96, 4, 64), (1, 1024, 40, 64), (2, 96, 4, 64),
              (2, 9, 3, 16)],
    "mamba2": [(2, 512, 80, 64, 128), (2, 512, 64, 64, 64),
               (2, 1, 4, 64, 128), (2, 37, 4, 64, 128), (1, 96, 4, 64, 64),
               (1, 1024, 80, 64, 128), (2, 96, 4, 64, 128),
               (2, 9, 3, 16, 16)]}


def _source_extents(kind, shape, g):
    """One past the largest element each scratch buffer's index takes in
    the source (``csrc/{rwkv6,mamba2}_bwd.cu``), at the largest value of
    every variable of the index (each index grows with each variable)."""
    blocks, chunks, thr = g["blocks"], g["chunks"], g["threads"]
    rt = g["rows_per_lane"]
    # my_ckpt[(c * RT + m) * threads], my_ckpt = ckpt + blockIdx.x *
    # chunks * RT * threads + tid, in float4
    ckpt = 4 * ((blocks - 1) * chunks * rt * thr + thr - 1
                + ((chunks - 1) * rt + rt - 1) * thr + 1)
    if kind == "rwkv6":
        b, t, h, d = shape
        rows, tiles = b * t * h, g["tiles"]
        return {"ckpt": ckpt,
                # tile * rows * d + ((b * T + t) * step + h * d + j)
                "dv_part": (tiles - 1) * rows * d + rows * d,
                # tile * rows + (b * T + t) * H + h
                "beta_part": (tiles - 1) * rows + rows,
                # (b * H + h) * d + r0 + i
                "du_part": (b * h - 1) * d + (tiles - 1) * 16 + 16}
    b, t, h, p, n = shape
    rows, tiles = b * t * h, g["tiles"]
    return {"ckpt": ckpt,
            "dx_part": ((tiles - 1) * rows + rows - 1) * p + p,   # ct*rows+row
            "db_part": (rows - 1) * n + (tiles - 1) * g["cols"] + g["cols"],
            "dc_part": (rows - 1) * n + (tiles - 1) * g["cols"] + g["cols"],
            "q_part": (tiles - 1) * rows + rows,
            "s_part": (tiles - 1) * rows + rows,
            "xdy": rows, "dterm": rows}


@pytest.mark.parametrize("kind,shape", [(k, s_) for k, shapes in
                                        GRAD_SHAPES.items()
                                        for s_ in shapes])
def test_backward_geometry_fills_the_card(kind, shape):
    """At least one block an SM (or every block in one wave), two blocks
    an SM by shared memory, whole warps, and scratch buffers of the sizes
    the source indexes."""
    ops = rwkv6_ops if kind == "rwkv6" else mamba2_ops
    g = ops.bwd_geometry(*shape, 2)
    sms = ops.SMS
    assert g["blocks"] >= sms or g["blocks"] <= g["blocks_per_sm"] * sms
    assert g["waves"] == 1
    assert mamba2_ops.SM_SMEM // (g["smem"] + mamba2_ops.BLOCK_RESERVED) >= 2
    assert g["threads"] % 32 == 0 and 32 <= g["threads"] <= 256
    buffers = ops.bwd_buffers(*shape, g)
    extents = _source_extents(kind, shape, g)
    assert list(buffers) == list(extents)
    for name, dims in buffers.items():
        assert int(np.prod(dims)) == extents[name], name


@pytest.mark.parametrize("p", [16, 32, 48, 64])
def test_mamba2_backward_geometry_has_a_compiled_body(p):
    """Every (lanes, rows a lane, wave) the wrapper asks for is one of the
    bodies ``csrc/mamba2_bwd.cu`` dispatches to."""
    src = (CSRC / "mamba2_bwd.cu").read_text()
    bodies = {(int(ln), int(rt), w == "true") for ln, rt, w in re.findall(
        r"REPRO_SSD_BWD_TILE\((\d+), (\d+), (true|false)\)", src)}
    assert bodies
    for n in (16, 32, 48, 64, 128):
        for b, h in ((2, 4), (2, 80), (16, 128)):
            g = mamba2_ops.bwd_geometry(b, 64, h, p, n, 2)
            assert (g["lanes"], g["rows_per_lane"], g["wave"]) in bodies


def _tiled_mamba2_bwd(x, b, c, dt, a, d, dy, cols):
    """The plain backward of mamba2_ref run on column tiles of ``cols`` of
    the state, fp32: each tile's recurrences alone, its partials of dx's
    G b, of q and of s = x (G b); the partials summed tile by tile in
    order, as ssd_bwd_reduce does (and dd, da over steps)."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    dec = torch.exp(a[None, None, :] * dt)
    gb_t, q_t, s_t, db, dc = [], [], [], torch.zeros_like(b), \
        torch.zeros_like(c)
    for j0 in range(0, n, cols):
        bc, cc = b[..., j0:j0 + cols], c[..., j0:j0 + cols]
        hs = [torch.zeros((bsz, h, p, cols))]
        for i in range(t):
            hs.append(dec[:, i, :, None, None] * hs[-1]
                      + dt[:, i, :, None, None] * (x[:, i, :, :, None]
                                                   * bc[:, i, None, None, :]))
        carry = torch.zeros_like(hs[0])
        gb, q = torch.zeros((bsz, t, h, p)), torch.zeros((bsz, t, h))
        for i in reversed(range(t)):
            g = carry + dy[:, i, :, :, None] * cc[:, i, None, None, :]
            gb[:, i] = torch.einsum("bhpn,bn->bhp", g, bc[:, i])
            q[:, i] = (g * hs[i]).sum((-1, -2))
            db[:, i, j0:j0 + cols] = torch.einsum(
                "bhpn,bhp,bh->bn", g, x[:, i], dt[:, i])
            dc[:, i, j0:j0 + cols] = torch.einsum(
                "bhpn,bhp->bn", hs[i + 1], dy[:, i])
            carry = dec[:, i, :, None, None] * g
        gb_t.append(gb)
        q_t.append(q)
        s_t.append((x * gb).sum(-1))
    gb, q, s_ = (sum(v[1:], v[0]) for v in (gb_t, q_t, s_t))
    dx = dt[..., None] * gb + d[None, None, :, None] * dy
    q = dec * q
    ddt = a[None, None, :] * q + s_
    return dx, db, dc, ddt, (dt * q).sum((0, 1)), (dy * x).sum((0, 1, 3))


def _tiled_rwkv6_bwd(r, k, v, w, u, dy, rows=16):
    """The plain backward of rwkv6_ref run on row tiles of ``rows`` of the
    state, fp32: each tile's recurrences alone give its rows' dr, dk, dw
    whole and its partials of dv and of the bonus u r k, summed tile by
    tile in order, as wkv_bwd_reduce does."""
    bsz, t, h, d = r.shape
    vdy = (v * dy).sum(-1)
    dr, dk, dw = (torch.zeros_like(r) for _ in range(3))
    dv_t, beta_t = [], []
    for i0 in range(0, d, rows):
        sl = slice(i0, i0 + rows)
        rs, ks, ws, us = r[..., sl], k[..., sl], w[..., sl], u[:, sl]
        st = [torch.zeros((bsz, h, rows, d))]
        for i in range(t):
            st.append(ws[:, i, :, :, None] * st[-1]
                      + ks[:, i, :, :, None] * v[:, i, :, None, :])
        g = torch.zeros_like(st[0])
        dvp = torch.zeros_like(v)
        for i in reversed(range(t)):
            dr[:, i, :, sl] = (torch.einsum("bhij,bhj->bhi", st[i], dy[:, i])
                               + us * ks[:, i] * vdy[:, i, :, None])
            dk[:, i, :, sl] = (torch.einsum("bhij,bhj->bhi", g, v[:, i])
                               + us * rs[:, i] * vdy[:, i, :, None])
            dw[:, i, :, sl] = (g * st[i]).sum(-1)
            dvp[:, i] = torch.einsum("bhij,bhi->bhj", g, ks[:, i])
            g = ws[:, i, :, :, None] * g + rs[:, i, :, :, None] * \
                dy[:, i, :, None, :]
        dv_t.append(dvp)
        beta_t.append((rs * us * ks).sum(-1))
    beta = sum(beta_t[1:], beta_t[0])
    dv = sum(dv_t[1:], dv_t[0]) + beta[..., None] * dy
    return dr, dk, dv, dw, (r * k * vdy[..., None]).sum((0, 1))


def _within(got, ref, names, tol=1e-6):
    for name, g, r in zip(names, got, ref):
        assert float((g - r).abs().max()) <= tol * float(r.abs().max()), name


@pytest.mark.parametrize("n,cols", [(64, 32), (48, 16), (128, 32)])
def test_mamba2_column_tiles_sum_to_the_whole_backward(n, cols):
    args = [torch.from_numpy(a) for a in mamba_inputs(37, n=n)]
    _within(_tiled_mamba2_bwd(*args, cols), mamba2_ref_bwd(*args),
            ("dx", "db", "dc", "ddt", "da", "dd"))


@pytest.mark.parametrize("d", [48, 64])
def test_rwkv6_row_tiles_sum_to_the_whole_backward(d):
    args = [torch.from_numpy(a) for a in rwkv_inputs(37, d=d)]
    _within(_tiled_rwkv6_bwd(*args), rwkv6_ref_bwd(*args),
            ("dr", "dk", "dv", "dw", "du"))
