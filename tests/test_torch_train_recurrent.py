"""Port parity, training the recurrent and audio families: ``loss_and_grads``
on the rwkv6-3b (``ssm``), mamba2-2.7b (``mamba``), zamba2-1.2b
(``hybrid``) and whisper-large-v3 (``audio``) smoke configs against the
JAX package's ``jax.value_and_grad(_loss_fn)`` from the same weights (JAX-
initialised and bridged; the all-zero offsets filled from a numpy seed so
they carry signal) and the same ``SyntheticLMSource`` batch; remat on and
off; the recurrences' autograd Functions on the model's path through the
``use_scan_kernel`` seam; the launcher on the CPU; the remat policies the
port does not have refused by name on an moe config.

Tolerances, fp32 params: the loss within 1e-5 relative and each gradient
leaf within 1e-4 of its largest magnitude (two frameworks, sums in another
order; zamba2 5e-4, whose shared attention block sums the gradients of
its every application, ROADMAP C.0).  The seam: the per-step plain
backwards against autograd through the chunked formulas, 1e-4 of each
leaf's largest magnitude.
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.mamba2 import ops as mamba2_ops
from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
from repro_torch.models import build_model
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.train import step as tstep

PCTX = ParallelContext(None)
ARCHS = ("rwkv6-3b", "mamba2-2.7b", "zamba2-1.2b", "whisper-large-v3")
RECURRENT = ARCHS[:3]
#: B = 2 rows of 32 tokens
SHAPE = (32, 2)
F32_LOSS_RTOL = 1e-5
F32_GRAD_RTOL = {"zamba2-1.2b": 5e-4}
SEAM_GRAD_RTOL = 1e-4


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


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One smoke arch: the JAX bundle, its filled fp32 params on both
    sides, the port's bundle, a batch, and the JAX loss and gradients
    (one jit an arch, shared by the tests of the module)."""
    name = request.param
    jcfg = jax_get_config(name, smoke=True)
    jbundle = jax_build_model(jcfg)
    base = _base_params(jbundle)
    jp = {k: jnp.asarray(v) for k, v in base.items()}
    batch = JSyntheticLMSource(jcfg, JShapeSpec("t", *SHAPE, "train")
                               ).batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jstep._loss_fn(
        jbundle, PCTX, p, b)))(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return dict(name=name, base=base, batch=batch, jloss=float(jl),
                jgrads={k: _np(v) for k, v in jg.items()},
                tparams=params_from_numpy(base),
                bundle=build_model(get_config(name, smoke=True),
                                   device="cpu"))


def _check_grads(name, got, ref, rtol):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].shape == ref[k].shape
        np.testing.assert_allclose(_np(got[k]), ref[k], rtol=0,
                                   atol=rtol * np.abs(ref[k]).max(),
                                   err_msg=f"{name} {k}")


def test_fp32_loss_and_grads_match_jax(arch):
    loss, grads = tstep.loss_and_grads(arch["bundle"], arch["tparams"],
                                       arch["batch"])
    assert abs(float(loss) - arch["jloss"]) <= \
        F32_LOSS_RTOL * abs(arch["jloss"])
    _check_grads(arch["name"], grads, arch["jgrads"],
                 F32_GRAD_RTOL.get(arch["name"], 1e-4))


def test_remat_on_and_off_give_the_same_gradients(arch):
    """``cfg.remat`` recomputes each layer (super-block) in the backward:
    the loss and every gradient equal the run that keeps them."""
    cfg = get_config(arch["name"], smoke=True)
    assert cfg.remat
    out = {}
    for remat in (True, False):
        bundle = build_model(dataclasses.replace(cfg, remat=remat),
                             device="cpu")
        out[remat] = tstep.loss_and_grads(bundle, arch["tparams"],
                                          arch["batch"])
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[True][1].items():
        assert torch.equal(g, out[False][1][k]), k


@pytest.fixture
def through_the_seam(monkeypatch):
    """The models' kernel branches on the CPU (``use_scan_kernel`` True):
    the recurrences run ``rwkv6_wkv`` / ``mamba2_ssd`` (the plain forwards
    on CPU tensors) under ``Rwkv6Function`` / ``Mamba2Function``, whose
    backward calls are counted."""
    calls = {"rwkv6": 0, "mamba2": 0}

    def counted(key, fn):
        def run(*args):
            calls[key] += 1
            return fn(*args)
        return run
    monkeypatch.setattr(trwkv, "use_scan_kernel", lambda x: True)
    monkeypatch.setattr(tssm, "use_scan_kernel", lambda x: True)
    monkeypatch.setattr(rwkv6_ops, "rwkv6_ref_bwd",
                        counted("rwkv6", rwkv6_ops.rwkv6_ref_bwd))
    monkeypatch.setattr(mamba2_ops, "mamba2_ref_bwd",
                        counted("mamba2", mamba2_ops.mamba2_ref_bwd))
    return calls


@pytest.mark.parametrize("name", RECURRENT)
def test_model_path_through_the_functions_matches_the_chunked_autograd(
        name, through_the_seam):
    """The training path through the Functions (the card's path, with the
    plain per-step backwards in the kernels' place) against autograd
    through the JAX chunked formulas (the CPU path): the loss and every
    gradient; one backward call a recurrent layer."""
    cfg = get_config(name, smoke=True)
    bundle = build_model(cfg, device="cpu")
    params = {k: v.float() for k, v in bundle.init_params().items()}
    batch = JSyntheticLMSource(jax_get_config(name, smoke=True),
                               JShapeSpec("t", *SHAPE, "train")).batch_at(1)
    loss, grads = tstep.loss_and_grads(bundle, params, batch)
    layers = cfg.num_layers          # zamba2: its super-blocks' and tail's
    assert through_the_seam == {"rwkv6": layers if name == "rwkv6-3b" else 0,
                                "mamba2": 0 if name == "rwkv6-3b" else layers}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trwkv, "use_scan_kernel", lambda x: False)
        mp.setattr(tssm, "use_scan_kernel", lambda x: False)
        ref_loss, ref = tstep.loss_and_grads(bundle, params, batch)
    assert abs(float(loss) - float(ref_loss)) <= \
        F32_LOSS_RTOL * abs(float(ref_loss))
    _check_grads(name, grads, {k: _np(v) for k, v in ref.items()},
                 SEAM_GRAD_RTOL)


def test_train_step_runs_the_smoke_configs_and_refuses_moe():
    """Three AdamW steps of each smoke config (bf16) with finite losses
    that fall; an moe config's train step is made (the family trains:
    ``tests/test_torch_train_moe.py``), and under the ``"dots"`` or
    ``"save_coll"`` remat policy its first step equals the ``"nothing"``
    policy's bit for bit (on one device ``"save_coll"`` keeps nothing;
    ``"dots"`` keeps the products, which equal their recompute)."""
    hyper = tstep.TrainHyper(peak_lr=1e-2, warmup=1, total_steps=10)
    for name in ARCHS:
        cfg = get_config(name, smoke=True)
        bundle = build_model(cfg, device="cpu")
        params = bundle.init_params()
        opt = tstep.init_optimizer(cfg, params)
        src = JSyntheticLMSource(jax_get_config(name, smoke=True),
                                 JShapeSpec("t", *SHAPE, "train"))
        step = tstep.make_train_step(bundle, hyper)
        losses = []
        for s in range(3):
            params, opt, m = step(params, opt, src.batch_at(0), s)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses)), (name, losses)
        assert losses[-1] < losses[0], (name, losses)
    cfg = get_config("arctic-480b", smoke=True)
    batch = JSyntheticLMSource(jax_get_config("arctic-480b", smoke=True),
                               JShapeSpec("t", *SHAPE, "train")).batch_at(0)
    params = build_model(cfg, device="cpu").init_params()
    stepped = []
    for policy in ("nothing", "dots", "save_coll"):
        bundle = build_model(dataclasses.replace(cfg, remat_policy=policy),
                             device="cpu")
        step = tstep.make_train_step(bundle, hyper)
        stepped.append(step(params, tstep.init_optimizer(cfg, params),
                            batch, 0))
    (p0, _, m0), *others = stepped
    for p1, _, m1 in others:
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
        assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_launcher_trains_a_recurrent_arch_on_the_cpu(tmp_path):
    from repro_torch.launch import train as launch_train
    report = launch_train.main([
        "--arch", "mamba2-2.7b", "--device", "cpu", "--steps", "3",
        "--batch", "2", "--seq", "16", "--ckpt-every", "2",
        "--ckpt-dir", str(tmp_path)])
    assert report.steps_completed == 3
    assert all(np.isfinite(report.losses))
    assert (tmp_path / "heartbeat.json").exists()
