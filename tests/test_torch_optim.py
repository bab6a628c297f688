"""Port parity, the optimizers and the schedule (``repro_torch.optim``)
against the JAX package's ``repro.optim`` on the same trees, made from a
numpy seed: ``warmup_cosine`` over a run of steps; ``adamw_update`` and
``adafactor_update`` over several steps on trees of fp32 and bf16 leaves
(vectors, factored matrices, a stacked 3-D leaf and an unfactored one
with a trailing dim of 1).  The ops are the JAX ops in the JAX order, one
fp32 rounding each; only the reductions (the global norm, Adafactor's
means) and the transcendental functions (``cos``, ``pow``, ``sqrt``) may
round differently, so every fp32 result is held within 1e-6 relative (of
the leaf's largest value) and the bf16 params to one bf16 ulp.  Then the
JAX convergence tests (``tests/test_infra_misc.py``) mirrored, and the
optimizer-state bridge both ways."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor_init as j_adafactor_init
from repro.optim import adafactor_update as j_adafactor_update
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.bridge import (opt_state_from_numpy, opt_state_to_numpy,
                                tensor_from_numpy)
from repro_torch.optim import (AdafactorState, AdamWState, adafactor_init,
                               adafactor_update, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.optim import adafactor as adafactor_mod
from repro_torch.optim.tree import tree_leaves

#: fp32 results: the same ops, reductions and transcendentals may round
#: differently (a few ulps)
F32_RTOL = 1e-6
#: the leaves of the test trees: name -> shape (factored: >= 2-D with
#: both trailing dims > 1)
SHAPES = {"vec": (7,), "mat": (12, 9), "stack": (3, 8, 5), "col": (6, 1),
          "nested": {"a": (4, 4), "b": (10,)}}
STEPS = 4


def _tree(shapes, rng, dtype):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, dtype) for k, v in shapes.items()}
    return rng.standard_normal(shapes).astype(np.float32).astype(dtype)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, rtol=F32_RTOL):
    """Every leaf within ``rtol`` of the JAX leaf's largest magnitude."""
    gl, rl = tree_leaves(got), jax.tree.leaves(ref)
    assert len(gl) == len(rl)
    for g, r in zip(gl, rl):
        g, r = _np(g), _np(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=rtol * max(np.abs(r).max(), 1e-30))


def _bf16_close(got, ref):
    """bf16 params: equal or one bf16 ulp apart (a master on a rounding
    boundary)."""
    for g, r in zip(tree_leaves(got), jax.tree.leaves(ref)):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        g, r = _np(g), _np(r)
        np.testing.assert_allclose(g, r, rtol=2.0 ** -7, atol=0)


def test_warmup_cosine_matches_jax():
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 500, 999, 1000, 2000]:
        kw = dict(peak_lr=3e-3, warmup=10, total=1000)
        ref = float(j_warmup_cosine(jnp.asarray(step, jnp.int32), **kw))
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(warmup_cosine(step, **kw)) == float(got)
        assert abs(float(got) - ref) <= F32_RTOL * 3e-3, (step, got, ref)


def _grads(rng, like_shapes):
    return _tree(like_shapes, rng, np.float32)


@pytest.mark.parametrize("dtype, clip", [("float32", 1.0),
                                         ("bfloat16", 1e3)])
def test_adamw_matches_jax(dtype, clip):
    """``STEPS`` updates from the same params and grads (large enough that
    the clip scales them, or below it): new params (bf16), the moments and
    the fp32 master."""
    rng = np.random.default_rng(0)
    params = _tree(SHAPES, rng, dtype)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = j_adamw_init(jp), adamw_init(tp)
    _close(ts.master, js.master, rtol=0)
    update = jax.jit(functools.partial(j_adamw_update, grad_clip=clip))
    for i in range(STEPS):
        g = _grads(rng, SHAPES)
        lr = 0.01 * (i + 1)
        jp, js = update(_to_jax(g), js, jnp.float32(lr))
        tp, ts = adamw_update(_to_torch(g), ts, torch.tensor(lr),
                              grad_clip=clip)
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32
        for field in ("m", "v", "master"):
            _close(getattr(ts, field), getattr(js, field))
        _bf16_close(tp, jp)


def test_adamw_donate_gives_the_same_state_and_empties_the_inputs():
    rng = np.random.default_rng(1)
    params = _to_torch(_tree(SHAPES, rng, np.float32))
    g = _to_torch(_grads(rng, SHAPES))
    ref_p, ref_s = adamw_update(g, adamw_init(params), 0.01)
    state = adamw_init(params)
    got_p, got_s = adamw_update(g, state, 0.01, donate=True)
    assert state.m == {} and state.v == {} and state.master == {} and g == {}
    for a, b in zip(tree_leaves((ref_p, ref_s)), tree_leaves((got_p, got_s))):
        assert torch.equal(a, b)
    assert list(got_s.m) == sorted(SHAPES)


@pytest.mark.parametrize("dtype, weight_decay", [("float32", 0.1),
                                                 ("bfloat16", 0.0)])
def test_adafactor_matches_jax(dtype, weight_decay):
    """``STEPS`` updates: factored row/column moments for the matrices and
    the stacked leaf, full ones for the vectors and the (6, 1) leaf; new
    params in each param's own dtype."""
    rng = np.random.default_rng(2)
    params = _tree(SHAPES, rng, dtype)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = j_adafactor_init(jp), adafactor_init(tp)
    for field in ("vr", "vc"):
        for a, b in zip(tree_leaves(getattr(ts, field)),
                        jax.tree.leaves(getattr(js, field))):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    update = jax.jit(functools.partial(j_adafactor_update,
                                       weight_decay=weight_decay))
    for i in range(STEPS):
        g = _grads(rng, SHAPES)
        lr = 0.01 * (i + 1)
        jp, js = update(_to_jax(g), js, jp, jnp.float32(lr))
        tp, ts = adafactor_update(_to_torch(g), ts, tp, torch.tensor(lr),
                                  weight_decay=weight_decay)
        assert int(ts.step) == int(js.step) == i + 1
        _close(ts.vr, js.vr)
        _close(ts.vc, js.vc)
        if dtype == "float32":
            _close(tp, jp)
        else:
            _bf16_close(tp, jp)


@pytest.mark.parametrize("slice_elements", [24, 80])
def test_adafactor_in_slices_matches_jax(slice_elements, monkeypatch):
    """The update cut into slices of at most ``slice_elements`` elements
    (24: every matrix cut by rows, the vectors in runs; 80: runs of two of
    the stacked leaf's matrices) against JAX's whole-leaf update, over
    ``STEPS`` steps on fp32 leaves, at this file's tolerance."""
    monkeypatch.setattr(adafactor_mod, "SLICE_ELEMENTS", slice_elements)
    rng = np.random.default_rng(5)
    params = _tree(SHAPES, rng, "float32")
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = j_adafactor_init(jp), adafactor_init(tp)
    update = jax.jit(functools.partial(j_adafactor_update,
                                       weight_decay=0.1))
    for i in range(STEPS):
        g = _grads(rng, SHAPES)
        jp, js = update(_to_jax(g), js, jp, jnp.float32(0.01))
        tp, ts = adafactor_update(_to_torch(g), ts, tp, torch.tensor(0.01),
                                  weight_decay=0.1)
        _close(ts.vr, js.vr)
        _close(ts.vc, js.vc)
        _close(tp, jp)


def _whole_leaf_update(g, vr, vc, p, lr, decay=0.99, eps=1e-30):
    """The JAX ``upd`` of one leaf, whole-leaf ops in the JAX order."""
    g = g.float()
    g2 = g * g + eps
    if len(g.shape) >= 2 and g.shape[-1] > 1 and g.shape[-2] > 1:
        vr = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
        vc = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
        r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
        u = g / torch.sqrt(torch.clamp(r[..., None] * vc[..., None, :],
                                       min=eps))
    else:
        vr = decay * vr + (1 - decay) * g2
        u = g / torch.sqrt(torch.clamp(vr, min=eps))
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
    u = u / torch.clamp(rms / 1.0, min=1.0)
    pf = p.float()
    return vr, vc, (pf - lr * u - lr * 0.0 * pf).to(p.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_donate_writes_the_params_in_place(dtype):
    """``donate=True``: each new param lands in the old one's storage
    (``data_ptr`` equal), bit for bit the non-donating update's params and
    state, and the grads' container is emptied; a leaf within one slice
    gets the whole-leaf formula's bits."""
    rng = np.random.default_rng(6)
    params = _to_torch(_tree(SHAPES, rng, dtype))
    state = adafactor_init(params)
    for i in range(2):
        g = _to_torch(_grads(rng, SHAPES))
        ref_p, ref_s = adafactor_update(g, state, params, 0.01)
        for gl, r, c, pl, want in zip(
                tree_leaves(g), tree_leaves(state.vr), tree_leaves(state.vc),
                tree_leaves(params), tree_leaves(ref_p)):
            assert torch.equal(_whole_leaf_update(gl, r, c, pl, 0.01)[2],
                               want)
        ptrs = [p.data_ptr() for p in tree_leaves(params)]
        got_p, got_s = adafactor_update(g, state, params, 0.01, donate=True)
        assert g == {}
        assert [p.data_ptr() for p in tree_leaves(got_p)] == ptrs
        assert list(got_p) == sorted(SHAPES)
        for a, b in zip(tree_leaves((ref_p, ref_s)),
                        tree_leaves((got_p, got_s))):
            assert torch.equal(a, b)
        params, state = got_p, got_s


# ---------------- the JAX convergence tests (tests/test_infra_misc.py)
def _quad_params():
    return {"w": torch.tensor([3.0, -2.0]),
            "b": {"x": torch.full((4, 4), 1.5)}}


def test_adamw_converges_on_quadratic():
    params = {"w": _quad_params()["w"].bfloat16(),
              "b": {"x": _quad_params()["b"]["x"].bfloat16()}}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": params["w"].float(), "b": {"x": params["b"]["x"].float()}}
        params, state = adamw_update(grads, state, lr=0.05, weight_decay=0.0)
    assert max(float(p.float().abs().max()) for p in tree_leaves(params)) < 0.2


def test_adafactor_converges_and_state_is_factored():
    params = {"w": torch.ones((32, 16)) * 2.0}
    state = adafactor_init(params)
    assert state.vr["w"].shape == (32,)
    assert state.vc["w"].shape == (16,)
    for _ in range(300):
        grads = params
        params, state = adafactor_update(grads, state, params, lr=0.05)
    assert float(params["w"].abs().max()) < 0.3


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_bridge_round_trips_with_jax(kind):
    """A JAX optimizer state after one update, bridged to the port bit for
    bit, and the port's back to a JAX state that the JAX update takes."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    jp = _to_jax(params)
    if kind == "adamw":
        _, js = j_adamw_update(_to_jax(grads), j_adamw_init(jp), 0.01)
    else:
        _, js = j_adafactor_update(_to_jax(grads), j_adafactor_init(jp), jp,
                                   0.01)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js))
    assert type(ts) is (AdamWState if kind == "adamw" else AdafactorState)
    assert ts._fields == js._fields
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = opt_state_to_numpy(ts)
    js2 = type(js)(**{k: jax.tree.map(jnp.asarray, v)
                      for k, v in back.items()})
    for a, b in zip(jax.tree.leaves(js2), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if kind == "adamw":
        assert isinstance(js2, JAdamWState)
        j_adamw_update(_to_jax(grads), js2, 0.01)
    with pytest.raises(ValueError, match="fields"):
        opt_state_from_numpy({"step": np.zeros((), np.int32)})
