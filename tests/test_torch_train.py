"""Port parity, the training path: ``AprMatmulFunction`` (B1 under
autograd) on the CPU, ``cross_entropy_loss``, ``loss_and_grads`` and
``make_train_step`` against the JAX package's ``repro.train.step`` on the
llama3-8b smoke config (and internvl2-1b's for the vlm mask), from the
same weights (JAX-initialised and bridged; the all-zero norm offsets
filled from a numpy seed so they carry signal) and the same
``SyntheticLMSource`` batches.

Tolerances: fp32 params, step 0 -- the loss within 1e-5 relative and each
gradient leaf within 1e-4 of its largest magnitude (two frameworks, sums in
another order).  bf16 -- the JAX step is jitted (one compile a
test), and a jitted bf16 body drops intermediate roundings that
the port, like eager JAX, makes (ROADMAP C.0): losses within
``BF16_LOSS_RTOL``, grad norms within ``BF16_GNORM_RTOL``, and the fp32
masters within ``MASTER_BOUND`` (median ``MASTER_MEDIAN``).  Serving
through ``linear`` and ``tp_einsum`` is held to the very calls it made
before training existed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.data import SyntheticLMSource as JSyntheticLMSource
from repro.models import build_model as jax_build_model
from repro.parallel import ParallelContext
from repro.train import step as jstep
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import SyntheticLMSource
from repro_torch.kernels.apr_matmul import (AprMatmulFunction, matmul_ref,
                                            needs_grad)
from repro_torch.kernels.apr_matmul import ops as mm_ops
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.quant import quantize_channelwise
from repro_torch.train import step as tstep

PCTX = ParallelContext(None)
ARCH = "llama3-8b"
#: the batches: B = 4 rows of 32 tokens (two microbatches of 2)
SHAPE = (32, 4)
F32_LOSS_RTOL = 1e-5
F32_GRAD_RTOL = 1e-4
#: bf16, port (eager) against the jitted JAX step, over 3 steps
BF16_LOSS_RTOL = 2e-3
BF16_GNORM_RTOL = 1e-2
#: an AdamW step moves a master by at most ~lr (|mhat / sqrt(vhat)| <= 1
#: at these steps); a gradient element near 0 whose sign differs between
#: the two moves it the other way, so the masters may part by 2 x the sum
#: of the learning rates
HYPER = dict(peak_lr=1e-2, warmup=2, total_steps=10)
MASTER_BOUND = 2 * sum((0.0, 5e-3, 1e-2)) + 1e-6
#: ... and their median element within 2 % of the ~0.015 the masters move
#: over the three steps (the bf16 gradients lie ~1 % apart)
MASTER_MEDIAN = 3e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _base_params(jbundle):
    rng = np.random.default_rng(0)
    base = {}
    for name, a in sorted(jbundle.init_params(jax.random.PRNGKey(0)).items()):
        a = np.asarray(a.astype(jnp.float32))
        if not a.any():
            a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        base[name] = a
    return base


def _both(base, dtype):
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in base.items()}
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()})


@pytest.fixture(scope="module")
def llama():
    """The JAX smoke bundle, its filled params, the port's bundle and the
    JAX batches (numpy) of steps 0..2."""
    jcfg = jax_get_config(ARCH, smoke=True)
    jbundle = jax_build_model(jcfg)
    src = JSyntheticLMSource(jcfg, JShapeSpec("t", *SHAPE, "train"))
    return dict(jbundle=jbundle, base=_base_params(jbundle),
                bundle=build_model(get_config(ARCH, smoke=True), device="cpu"),
                batches=[src.batch_at(s) for s in range(3)])


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------- B1 under autograd (CPU)
@pytest.fixture
def recorded(monkeypatch):
    """Every ``apr_matmul`` call made by ``AprMatmulFunction``: (x, w,
    out_dtype)."""
    calls = []
    inner = mm_ops.apr_matmul

    def rec(x, w, *, out_dtype=torch.float32, **kw):
        calls.append((x, w, out_dtype))
        return inner(x, w, out_dtype=out_dtype, **kw)
    monkeypatch.setattr(mm_ops, "apr_matmul", rec)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("wants", [(True, True), (True, False),
                                   (False, True)])
def test_function_backward_equals_autograd_through_matmul_ref(
        recorded, dtype, m, wants):
    """dX and dW of the Function equal torch autograd through the plain
    ``matmul_ref`` bit for bit; each product runs on ``apr_matmul`` only
    when asked for, on contiguous transposes, in the input's dtype."""
    g = torch.Generator().manual_seed(m)
    k, n = 96, 40
    x = torch.randn((m, k), generator=g).to(dtype)
    w = (torch.randn((k, n), generator=g) * k ** -0.5).to(dtype)
    dy = torch.randn((m, n), generator=g).to(dtype)
    xa, wa = (x.clone().requires_grad_(wants[0]),
              w.clone().requires_grad_(wants[1]))
    y = AprMatmulFunction.apply(xa, wa, dtype)
    xr, wr = (x.clone().requires_grad_(wants[0]),
              w.clone().requires_grad_(wants[1]))
    ref = matmul_ref(xr, wr, dtype)
    assert torch.equal(y, ref) and y.dtype == dtype
    y.backward(dy)
    ref.backward(dy)
    for a, b, want in ((xa, xr, wants[0]), (wa, wr, wants[1])):
        if want:
            assert a.grad.dtype == dtype and torch.equal(a.grad, b.grad)
        else:
            assert a.grad is None
    assert len(recorded) == 1 + sum(wants)
    for xx, ww, out in recorded[1:]:
        assert xx.is_contiguous() and ww.is_contiguous() and out == dtype


def test_linear_and_tp_einsum_backward_run_the_function(recorded):
    """``linear`` (3-D input) and the CPU path of ``tp_einsum`` (its split-K
    slices, fp32 partials) under a gradient: every forward product and both
    backward products of each go through the Function; the values equal
    torch autograd through the plain formulas."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 64), generator=g).bfloat16()
    w = (torch.randn((64, 48), generator=g) / 8).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (tl.linear(xa, wa).float().sum() + tl.tp_einsum(xa, wa).float().square()
     .sum()).backward()
    assert len(recorded) == 3 * (1 + tl.TP_CHUNKS)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    lin = matmul_ref(xr.reshape(-1, 64), wr, torch.bfloat16).reshape(2, 3, 48)
    step = 64 // tl.TP_CHUNKS
    tp = tl._tree_sum([matmul_ref(xr.reshape(-1, 64)[:, i:i + step],
                                  wr[i:i + step]) for i in range(0, 64, step)]
                      ).to(torch.bfloat16).reshape(2, 3, 48)
    (lin.float().sum() + tp.float().square().sum()).backward()
    assert torch.equal(xa.grad, xr.grad) and torch.equal(wa.grad, wr.grad)


def test_int8_weight_under_a_gradient_is_refused():
    x = torch.randn((4, 64)).bfloat16().requires_grad_()
    qw = quantize_channelwise(torch.randn((64, 32)).bfloat16())
    with pytest.raises(TypeError, match="int8 QuantizedTensor"):
        tl.linear(x, qw)
    qw.scale.requires_grad_()
    with torch.no_grad():     # serving with int8 weights: no gradient
        tl.linear(x, qw)
    with pytest.raises(TypeError, match="int8 QuantizedTensor"):
        tl.linear(x.detach(), qw)


def test_serving_makes_the_calls_it_made_before(monkeypatch):
    """With no operand that requires grad (the engines' case, grad mode on
    or off) and under ``no_grad`` with ones that do, ``linear`` makes one
    plain ``layers.apr_matmul`` call on the reshaped input (the seam the
    card's launch counters and chip_smoke's stand-ins see) and
    ``tp_einsum`` its ``TP_CHUNKS`` plain ``matmul_ref`` slices; outputs
    equal the plain formulas bit for bit; no Function in the graph."""
    calls = {"apr": [], "ref": []}
    apr, ref = tl.apr_matmul, tl.matmul_ref
    monkeypatch.setattr(tl, "apr_matmul", lambda x, w, **kw: (
        calls["apr"].append((x.shape, kw)), apr(x, w, **kw))[1])
    monkeypatch.setattr(tl, "matmul_ref", lambda *a: (
        calls["ref"].append(a[0].shape), ref(*a))[1])
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 5, 64), generator=g).bfloat16()
    w = (torch.randn((64, 32), generator=g) / 8).bfloat16()
    want_lin = matmul_ref(x.reshape(-1, 64), w, torch.bfloat16).reshape(
        2, 5, 32)
    for grad_mode, rg in ((True, False), (False, False), (False, True)):
        calls["apr"].clear()
        calls["ref"].clear()
        wv = w.clone().requires_grad_(rg)
        with torch.set_grad_enabled(grad_mode):
            assert not needs_grad(x.reshape(-1, 64), wv)
            lin = tl.linear(x, wv)
            tp = tl.tp_einsum(x, wv)
        assert lin.grad_fn is None and tp.grad_fn is None
        assert torch.equal(lin, want_lin)
        assert calls["apr"] == [(torch.Size([10, 64]),
                                 {"out_dtype": torch.bfloat16})]
        assert calls["ref"] == [torch.Size([10, 64 // tl.TP_CHUNKS])] \
            * tl.TP_CHUNKS


def test_remat_recomputes_the_same_gradients(llama):
    """``cfg.remat`` (each super-block under ``torch.utils.checkpoint``),
    the same under ``remat_policy="dots"`` (the products kept) and no remat
    give the same loss and gradients bit for bit; serving (no gradient)
    never enters the checkpoint."""
    _, tp = _both(llama["base"], "float32")
    batch = llama["batches"][0]
    cfg = get_config(ARCH, smoke=True)
    out = []
    for remat in (True, False):
        bundle = build_model(dataclasses.replace(cfg, remat=remat),
                             device="cpu")
        out.append(tstep.loss_and_grads(bundle, tp, batch))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    bundle = build_model(dataclasses.replace(cfg, remat_policy="dots"),
                         device="cpu")
    l3, g3 = tstep.loss_and_grads(bundle, tp, batch)
    assert torch.equal(l3, l1)
    for k in g1:
        assert torch.equal(g3[k], g1[k]), k
    bundle.forward(tp, torch.from_numpy(batch["tokens"]))   # serving: fine


# ------------------------------------------------------------ the loss
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    logits[..., 45:] = -1e30               # padded vocab slots
    labels = rng.integers(0, 45, (3, 7)).astype(np.int32)
    mask = (np.arange(7) >= 3)[None].repeat(3, 0).astype(np.float32) \
        if masked else None
    ref = jstep.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None else jnp.asarray(mask))
    got = tstep.cross_entropy_loss(
        torch.from_numpy(logits).bfloat16().float(), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    ref_bf = jstep.cross_entropy_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(ref_bf)) <= 1e-6 * abs(float(ref_bf))
    got32 = tstep.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     None if mask is None
                                     else torch.from_numpy(mask))
    assert abs(float(got32) - float(ref)) <= 1e-6 * abs(float(ref))


# ------------------------------------------------------- the train step
def test_fp32_step0_loss_and_grads_match_jax(llama):
    jp, tp = _both(llama["base"], "float32")
    batch = llama["batches"][0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jstep._loss_fn(
        llama["jbundle"], PCTX, p, b)))(jp, _jbatch(batch))
    tl_, tg = tstep.loss_and_grads(llama["bundle"], tp, batch)
    assert abs(float(tl_) - float(jl)) <= F32_LOSS_RTOL * abs(float(jl))
    assert sorted(tg) == sorted(jg)
    for k in jg:
        ref = _np(jg[k])
        assert tg[k].dtype == torch.float32 and tg[k].shape == ref.shape
        np.testing.assert_allclose(_np(tg[k]), ref, rtol=0,
                                   atol=F32_GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=k)
    assert all(p.grad is None and not p.requires_grad for p in tp.values())


def test_fp32_two_microbatches_match_jax_scan(llama):
    """``num_microbatches=2`` (a Python loop accumulating fp32 grads) against
    the JAX step's ``lax.scan`` at step 0: the loss, the grad norm and the
    AdamW first moment (0.1 x the clipped fp32 gradient) leaf by leaf."""
    jp, tp = _both(llama["base"], "float32")
    batch = llama["batches"][0]
    hyper = dict(HYPER, num_microbatches=2)
    jcfg = jax_get_config(ARCH, smoke=True)
    jfn = jax.jit(jstep.make_train_step(llama["jbundle"], PCTX,
                                        jstep.TrainHyper(**hyper)))
    _, jo, jm = jfn(jp, jstep.init_optimizer(jcfg, jp), _jbatch(batch),
                    jnp.asarray(0, jnp.int32))
    cfg = get_config(ARCH, smoke=True)
    fn = tstep.make_train_step(llama["bundle"], tstep.TrainHyper(**hyper))
    tparams, to, tm = fn(tp, tstep.init_optimizer(cfg, tp), batch, 0)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            F32_LOSS_RTOL * abs(float(jm[key])), key
    assert float(tm["lr"]) == float(jm["lr"]) == 0.0
    for k in jo.m:
        ref = _np(jo.m[k])
        np.testing.assert_allclose(_np(to.m[k]), ref, rtol=0,
                                   atol=F32_GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=k)
    assert all(p.dtype == torch.bfloat16 for p in tparams.values())


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_bf16_three_steps_match_jax(llama, optimizer):
    jp, tp = _both(llama["base"], "bfloat16")
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               optimizer=optimizer)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              optimizer=optimizer)
    jfn = jax.jit(jstep.make_train_step(jax_build_model(jcfg), PCTX,
                                        jstep.TrainHyper(**HYPER)))
    fn = tstep.make_train_step(build_model(cfg, device="cpu"),
                               tstep.TrainHyper(**HYPER))
    jo, to = jstep.init_optimizer(jcfg, jp), tstep.init_optimizer(cfg, tp)
    for s, batch in enumerate(llama["batches"]):
        jp, jo, jm = jfn(jp, jo, _jbatch(batch), jnp.asarray(s, jnp.int32))
        tp, to, tm = fn(tp, to, batch, s)
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            BF16_LOSS_RTOL * abs(float(jm["loss"])), (s, tm, jm)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            BF16_GNORM_RTOL * float(jm["grad_norm"]), (s, tm, jm)
    assert int(to.step) == int(jo.step) == 3
    if optimizer == "adamw":
        for k in jo.master:
            diff = np.abs(_np(to.master[k]) - _np(jo.master[k]))
            assert diff.max() <= MASTER_BOUND, (k, diff.max())
            assert np.median(diff) <= MASTER_MEDIAN, (k, np.median(diff))
            assert tp[k].dtype == torch.bfloat16
            assert torch.equal(tp[k], to.master[k].bfloat16())
    else:
        for k in jp:
            assert tp[k].dtype == torch.bfloat16
            diff = np.abs(_np(tp[k]) - _np(jp[k]))
            assert diff.max() <= MASTER_BOUND, (k, diff.max())


def test_vlm_masked_loss_and_grads_match_jax():
    """internvl2-1b smoke, fp32: the vision prefix's positions carry no
    labels (mask), the vision embeddings enter as ``prefix_embeds``."""
    jcfg = jax_get_config("internvl2-1b", smoke=True)
    jbundle = jax_build_model(jcfg)
    jp, tp = _both(_base_params(jbundle), "float32")
    batch = JSyntheticLMSource(jcfg, JShapeSpec("t", 24, 2, "train")
                               ).batch_at(0)
    assert batch["labels"].shape == (2, 24)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jstep._loss_fn(
        jbundle, PCTX, p, b)))(jp, _jbatch(batch))
    bundle = build_model(get_config("internvl2-1b", smoke=True), device="cpu")
    tl_, tg = tstep.loss_and_grads(bundle, tp, batch)
    assert abs(float(tl_) - float(jl)) <= F32_LOSS_RTOL * abs(float(jl))
    for k in jg:
        ref = _np(jg[k])
        np.testing.assert_allclose(_np(tg[k]), ref, rtol=0,
                                   atol=F32_GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=k)
    # the prefix's labels do not count: changing them moves nothing
    batch2 = dict(batch, labels=batch["labels"].copy())
    batch2["labels"][:, :jcfg.vision_tokens] = 7
    assert torch.equal(tstep.loss_and_grads(bundle, tp, batch2)[0], tl_)


# ------------------------------------------------------------- the data
@pytest.mark.parametrize("arch", ["llama3-8b", "internvl2-1b"])
def test_synthetic_batches_equal_jax_bit_for_bit(arch):
    jsrc = JSyntheticLMSource(jax_get_config(arch, smoke=True),
                              JShapeSpec("t", 24, 3, "train"), seed=5)
    src = SyntheticLMSource(get_config(arch, smoke=True),
                            ShapeSpec("t", 24, 3, "train"), seed=5)
    for step in (0, 1, 17):
        a, b = jsrc.batch_at(step), src.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shape", [(4096, 256), (64, 4), (1024, 3),
                                   (8192, 7)])
def test_microbatches_for_matches_jax(shape):
    for arch in ("llama3-8b", "internvl2-1b"):
        ref = jstep.microbatches_for(jax_get_config(arch),
                                     JShapeSpec("t", *shape, "train"), PCTX)
        assert tstep.microbatches_for(get_config(arch),
                                      ShapeSpec("t", *shape, "train")) == ref


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", ["arctic-480b"])
def test_untrained_families_are_refused_by_name(arch):
    """The moe family trains on one device (``make_train_step`` takes it);
    what stays refused by name is its expert-parallel mesh (``moe_block``
    with a mesh, ROADMAP A.12) and a family outside ``TRAIN_FAMILIES``."""
    cfg = get_config(arch, smoke=True)
    assert cfg.family == "moe" and cfg.family in tstep.TRAIN_FAMILIES
    bundle = build_model(cfg, device="cpu")
    tstep.make_train_step(bundle, tstep.TrainHyper())
    from repro_torch.models import moe
    params = bundle.init_params()
    layer = {k[len("blk.0."):]: v[0] for k, v in params.items()
             if k.startswith("blk.0.moe.")}
    mesh = dataclasses.make_dataclass("Ctx", ["mesh"])(mesh=object())
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        moe.moe_block(layer, "moe", cfg, torch.zeros(1, 2, cfg.d_model),
                      pctx=mesh)
    other = dataclasses.replace(cfg, family="cnn")
    with pytest.raises(NotImplementedError, match="'cnn'"):
        tstep.check_trainable(other)


def test_compress_cross_pod_is_refused(llama):
    with pytest.raises(NotImplementedError, match="compress_cross_pod"):
        tstep.make_train_step(llama["bundle"],
                              tstep.TrainHyper(compress_cross_pod=True))


def test_train_step_takes_tensor_batches_and_donates(llama):
    """A batch of tensors steps like the same batch in numpy; ``donate``
    gives the same params, state and metrics and empties the old state."""
    _, tp = _both(llama["base"], "bfloat16")
    cfg = get_config(ARCH, smoke=True)
    batch = llama["batches"][1]
    hyper = tstep.TrainHyper(**HYPER)
    ref = tstep.make_train_step(llama["bundle"], hyper)(
        tp, tstep.init_optimizer(cfg, tp), batch, 1)
    state = tstep.init_optimizer(cfg, tp)
    got = tstep.make_train_step(llama["bundle"], hyper, donate=True)(
        tp, state, {k: tensor_from_numpy(v) for k, v in batch.items()}, 1)
    assert state.m == {} and state.master == {}
    for a, b in zip(jax.tree.leaves(ref[0]), jax.tree.leaves(got[0])):
        assert torch.equal(a, b)
    for k in ref[2]:
        assert torch.equal(ref[2][k], got[2][k])
    for a, b in zip(ref[1].master.values(), got[1].master.values()):
        assert torch.equal(a, b)
