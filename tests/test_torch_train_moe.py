"""Port parity, training the moe family: ``loss_and_grads`` on the
arctic-480b and llama4-maverick-400b-a17b smoke configs against the JAX
package's ``jax.value_and_grad(_loss_fn)`` from the same weights (JAX-
initialised and bridged; the all-zero offsets filled from a numpy seed so
they carry signal) and the same ``SyntheticLMSource`` batch, also at
arctic's published capacity factor on a batch that drops dispatches; three
bf16 Adafactor steps against the JAX step run op by op; remat on and off; the
grouped expert products (``moe.ExpertMatmulFunction``) against autograd
through serving's products; each stacked expert leaf's gradient made as one
tensor; the launcher on the CPU, resumed.

Tolerances: fp32 as ``tests/test_torch_train.py``'s, the loss within 1e-5
relative and each gradient leaf within 1e-4 of its largest magnitude (two
frameworks, sums in another order).  bf16 over 3 Adafactor steps: that
file's bounds (losses 2e-3, grad norms 1e-2, each param within 2 x the
learning rates' sum, median 3e-4), against the JAX step run op by op
(layers unrolled, not jitted: the roundings the port repeats; the jitted
step drops some, ROADMAP C.0), with the port routing every token to the
experts the JAX step chose (:func:`replayed_routing`).  A token at a
near-tie of the router routes one way or the other, and Adafactor's
normalised update of a sparse expert gradient then moves that expert's
params by many learning rates; so the port replays JAX's selection, and
the test counts the tokens whose own top-k differs and holds them, on a
step that starts from router params equal on both sides, to near-ties of
the port's gates.  One leaf is held otherwise: under top-1 routing
(llama4) the normalised gate ``w / sum(w)`` is 1 whatever the router, so
the router's gradient is zero in exact arithmetic and both frameworks
give rounding noise (~1e-8 of the step's largest gradient, each its own):
in fp32 both are held below ``ZERO_GRAD_RTOL`` of the step's largest
gradient magnitude; in bf16 Adafactor normalises each side's noise into a
step of its own direction, so that leaf's difference is held by its RMS,
which the update clip bounds by the learning rate a step on each side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.data import SyntheticLMSource as JSyntheticLMSource
from repro.models import build_model as jax_build_model
from repro.parallel import ParallelContext
from repro.train import step as jstep
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.kernels.apr_matmul import matmul_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.train import step as tstep

PCTX = ParallelContext(None)
ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
#: B = 2 rows of 32 tokens
SHAPE = (32, 2)
#: the published capacity factor, and the batch (steps of the source) on
#: which the smoke arctic drops dispatches at it
DROP_FACTOR = 1.25
DROP_STEP = 3
F32_LOSS_RTOL = 1e-5
F32_GRAD_RTOL = 1e-4
#: test_torch_train.py's bf16 bounds (test_bf16_three_steps_match_jax)
HYPER = dict(peak_lr=1e-2, warmup=2, total_steps=10)
BF16_LOSS_RTOL = 2e-3
BF16_GNORM_RTOL = 1e-2
PARAM_BOUND = 2 * sum((0.0, 5e-3, 1e-2)) + 1e-6
PARAM_MEDIAN = 3e-4
#: a near-tie of the port's fp32 gates: the k-th largest gate and an
#: expert JAX chose instead within a bf16 ulp of each other, relative (the
#: router product rounds to bf16 on both sides)
NEAR_TIE_RTOL = 2.0 ** -7
#: a gradient that is zero in exact arithmetic, against the largest
#: gradient magnitude of the step
ZERO_GRAD_RTOL = 1e-6


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


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _configs(name, factor=None):
    jcfg, cfg = jax_get_config(name, smoke=True), get_config(name, smoke=True)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    return jcfg, cfg


class CountsRead:
    """Every ``moe.expert_counts`` read while the ``with`` block runs:
    (counts, capacity)."""

    def __enter__(self):
        self.reads, self._inner = [], moe.expert_counts

        def read(r):
            counts = self._inner(r)
            self.reads.append((counts, r.capacity))
            return counts
        moe.expert_counts = read
        return self

    def __exit__(self, *exc):
        moe.expert_counts = self._inner


@pytest.fixture(scope="module", params=ARCHS + ("arctic-480b@drops",))
def case(request):
    """One smoke arch (or arctic at the published capacity factor on a
    batch that drops): the JAX bundle, its filled fp32 params, the port's
    bundle, a batch, and the JAX loss and gradients."""
    name, _, drops = request.param.partition("@")
    jcfg, cfg = _configs(name, DROP_FACTOR if drops else None)
    jbundle = jax_build_model(jcfg)
    base = _base_params(jbundle)
    src = JSyntheticLMSource(jcfg, JShapeSpec("t", *SHAPE, "train"))
    batch = src.batch_at(DROP_STEP if drops else 0)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jstep._loss_fn(
        jbundle, PCTX, p, b)))({k: jnp.asarray(v) for k, v in base.items()},
                               _jbatch(batch))
    return dict(name=name, drops=bool(drops), cfg=cfg, base=base,
                batch=batch, jloss=float(jl),
                jgrads={k: _np(v) for k, v in jg.items()},
                bundle=build_model(cfg, device="cpu"))


def test_fp32_loss_and_grads_match_jax(case):
    with CountsRead() as seen:
        loss, grads = tstep.loss_and_grads(case["bundle"],
                                           params_from_numpy(case["base"]),
                                           case["batch"])
    dropped = sum(max(c - cap, 0) for counts, cap in seen.reads
                  for c in counts)
    assert (dropped > 0) == case["drops"], dropped
    assert abs(float(loss) - case["jloss"]) <= \
        F32_LOSS_RTOL * abs(case["jloss"])
    ref = case["jgrads"]
    assert sorted(grads) == sorted(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for k in ref:
        assert grads[k].dtype == torch.float32
        assert grads[k].shape == ref[k].shape
        if case["cfg"].experts_per_token == 1 and k.endswith(".router"):
            assert max(np.abs(ref[k]).max(), np.abs(_np(grads[k])).max()) \
                <= ZERO_GRAD_RTOL * top, k
            continue
        np.testing.assert_allclose(_np(grads[k]), ref[k], rtol=0,
                                   atol=F32_GRAD_RTOL * np.abs(ref[k]).max(),
                                   err_msg=f"{case['name']} {k}")


def test_remat_on_and_off_give_the_same_gradients(case):
    """``cfg.remat`` recomputes each super-block in the backward, routing
    again: the recompute reads the forward's counts (in reverse layer
    order), and the loss and every gradient equal the run that keeps the
    activations, bit for bit."""
    cfg = case["cfg"]
    assert cfg.remat
    params = params_from_numpy(case["base"])
    out, reads = {}, {}
    for remat in (True, False):
        bundle = build_model(dataclasses.replace(cfg, remat=remat),
                             device="cpu")
        with CountsRead() as seen:
            out[remat] = tstep.loss_and_grads(bundle, params, case["batch"])
        reads[remat] = seen.reads
    n = len(reads[False])
    assert n == cfg.num_layers // cfg.moe_every
    assert reads[True][:n] == reads[False]
    assert reads[True][n:] == reads[False][::-1]
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[True][1].items():
        assert torch.equal(g, out[False][1][k]), k


def _bf16_start(jcfg):
    base = _base_params(jax_build_model(jcfg))
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in base.items()}
    src = JSyntheticLMSource(jcfg, JShapeSpec("t", *SHAPE, "train"))
    return jp, [_jbatch(src.batch_at(s)) for s in range(3)]


def jax_selections(monkeypatch) -> list:
    """Every ``jax.lax.top_k`` index array the JAX MoE layer computes while
    the test runs, appended in call order (a host callback, so that the
    JAX step's own selections are read, under ``value_and_grad``)."""
    got, top_k = [], jax.lax.top_k

    def recorded(x, k):
        values, idx = top_k(x, k)
        jax.debug.callback(lambda i: got.append(np.asarray(i)), idx)
        return values, idx
    monkeypatch.setattr(jax.lax, "top_k", recorded)
    return got


def replayed_routing(monkeypatch, selections):
    """The port's ``moe.top_k`` taking, for the ``n``-th distinct gates it
    sees (the forward's MoE layers in order; remat's recompute sees the
    same gates again), the experts ``selections[n]`` and its own gates
    there; each row whose own top-k differs is recorded with the relative
    gap of JAX's extra expert below the port's k-th largest gate."""
    chosen, swaps, top_k = {}, [], moe.top_k

    def replayed(x, k):
        key = x.detach().numpy().tobytes()
        if key not in chosen:
            sel = torch.from_numpy(selections[len(chosen)].astype(np.int64))
            gates = x.detach()
            own_v, own = top_k(gates, k)
            for row in range(x.shape[0]):
                extra = set(sel[row].tolist()) - set(own[row].tolist())
                if extra:
                    kth = float(own_v[row, -1])
                    swaps.append(max(kth - float(gates[row, e])
                                     for e in extra) / kth)
            chosen[key] = sel
        sel = chosen[key]
        return torch.gather(x, -1, sel), sel
    monkeypatch.setattr(moe, "top_k", replayed)
    return chosen, swaps


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_three_adafactor_steps_match_jax(name, monkeypatch):
    """Three bf16 Adafactor steps from the same params and batches: the
    port (registry config, remat on) against the JAX step run op by op,
    the port routing as the JAX step did, at test_torch_train.py's
    bounds on every step."""
    jcfg, cfg = _configs(name)
    assert cfg.optimizer == jcfg.optimizer == "adafactor"
    jp, batches = _bf16_start(jcfg)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    efn = jstep.make_train_step(
        jax_build_model(dataclasses.replace(jcfg, scan_layers=False,
                                            remat=False)),
        PCTX, jstep.TrainHyper(**HYPER))
    fn = tstep.make_train_step(build_model(cfg, device="cpu"),
                               tstep.TrainHyper(**HYPER))
    jo, to = jstep.init_optimizer(jcfg, jp), tstep.init_optimizer(cfg, tp)
    selections = jax_selections(monkeypatch)
    router = [k for k in jp if k.endswith(".router")]
    n_moe = cfg.num_layers // cfg.moe_every
    swapped = []
    for s, batch in enumerate(batches):
        same_router = all(np.array_equal(_np(tp[k]), _np(jp[k]))
                          for k in router)
        selections.clear()
        jp, jo, jm = efn(jp, jo, batch, jnp.asarray(s, jnp.int32))
        jax.effects_barrier()
        assert len(selections) == n_moe
        with monkeypatch.context() as mp:
            chosen, swaps = replayed_routing(mp, list(selections))
            tp, to, tm = fn(tp, to, {k: np.array(v)
                                     for k, v in batch.items()}, s)
        assert len(chosen) == n_moe
        swapped.append(len(swaps))
        if same_router:
            assert all(gap <= NEAR_TIE_RTOL for gap in swaps), (s, swaps)
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            BF16_LOSS_RTOL * abs(float(jm["loss"])), (s, tm, jm)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            BF16_GNORM_RTOL * float(jm["grad_norm"]), (s, tm, jm)
    assert int(to.step) == int(jo.step) == 3
    for k in jp:
        assert tp[k].dtype == torch.bfloat16
        diff = np.abs(_np(tp[k]) - _np(jp[k]))
        if cfg.experts_per_token == 1 and k.endswith(".router"):
            rms = float(np.sqrt(np.mean(np.square(diff))))
            assert rms <= PARAM_BOUND, (k, rms)
            continue
        assert diff.max() <= PARAM_BOUND, (k, diff.max(), swapped)
        assert np.median(diff) <= PARAM_MEDIAN, (k, np.median(diff))


# ------------------------------------------- the grouped expert products
def _layer(dtype, seed=0):
    """An arctic smoke MoE layer's params (bf16 or fp32) and rows."""
    cfg = get_config("arctic-480b", smoke=True)
    g = torch.Generator().manual_seed(seed)
    p = {name: (torch.randn(shape, generator=g) * scale).to(dtype)
         for name, (shape, scale) in moe.moe_params("moe", cfg, None).items()}
    x = torch.randn((40, cfg.d_model), generator=g).to(dtype)
    return cfg, p, x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_expert_function_equals_autograd_through_serving_products(
        dtype, monkeypatch):
    """Under a gradient the expert pass runs its three stacked leaves'
    products through ``ExpertMatmulFunction``; its values equal serving's
    bit for bit, and its gradients (rows, router, the three stacked leaves)
    equal autograd through serving's per-queue ``linear`` / ``tp_einsum``
    calls (``moe.expert_products``) bit for bit.  Serving runs the same
    products without the Function."""
    cfg, p, x = _layer(dtype)
    grouped = []
    apply = moe.ExpertMatmulFunction.apply
    monkeypatch.setattr(moe.ExpertMatmulFunction, "apply", staticmethod(
        lambda *a: (grouped.append(a[2]), apply(*a))[1]))
    with torch.no_grad():
        served = moe.moe_ffn_local(p, "moe", cfg, x)
    assert not grouped
    dy = torch.randn(served.shape, generator=torch.Generator().manual_seed(1)
                     ).to(dtype)
    out = {}
    for path in ("grouped", "serving"):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xa = x.clone().requires_grad_()
        with monkeypatch.context() as mp:
            if path == "serving":
                mp.setattr(moe, "grad_wanted", lambda *a: False)
            y = moe.moe_ffn_local(leaves, "moe", cfg, xa)
        y.backward(dy)
        out[path] = (y, xa.grad, {k: v.grad for k, v in leaves.items()})
    assert len(grouped) == 3 and grouped[0] and grouped[0] == grouped[2]
    assert torch.equal(out["grouped"][0], served)
    assert torch.equal(out["serving"][0], served)
    assert torch.equal(out["grouped"][1], out["serving"][1])
    for k in ("moe.router", *(f"moe.{n}" for n in moe.EXPERT_LEAVES)):
        g = out["grouped"][2][k]
        assert g.dtype == dtype and torch.equal(g, out["serving"][2][k]), k
    # an expert with an empty queue gets zeros in its slice
    ran = {e for e, _, _ in grouped[0]}
    for e in set(range(cfg.num_experts)) - ran:
        assert not out["grouped"][2]["moe.w_gate"][e].any()


@pytest.mark.parametrize("rows", [1, 5, 13, 20])
def test_expert_function_backward_equals_autograd_through_matmul_ref(rows):
    """One queue of ``rows`` rows (1 to 20: the queue lengths of the
    full-width expert backward), bf16: dX and dW of the Function against
    torch autograd through the plain product, bit for bit; the other
    experts' slices zero."""
    g = torch.Generator().manual_seed(rows)
    e, k, n = 4, 64, 96
    x = torch.randn((rows, k), generator=g).bfloat16()
    w = (torch.randn((e, k, n), generator=g) * k ** -0.5).bfloat16()
    dy = torch.randn((rows, n), generator=g).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    moe.ExpertMatmulFunction.apply(
        xa, wa, [(2, 0, rows)],
        lambda a, b: matmul_ref(a, b, torch.bfloat16)).backward(dy)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    matmul_ref(xr, wr[2], torch.bfloat16).backward(dy)
    assert torch.equal(xa.grad, xr.grad)
    assert torch.equal(wa.grad, wr.grad)
    assert not wa.grad[[0, 1, 3]].any()


class NewStorages(TorchDispatchMode):
    """Every op output of a shape in ``shapes`` whose storage is new (not
    one of the op's inputs'): its shape."""

    def __init__(self, shapes):
        super().__init__()
        self.watch, self.shapes = set(shapes), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {a.untyped_storage().data_ptr()
                for a in jax.tree.leaves((args, kwargs))
                if isinstance(a, torch.Tensor)}
        for t in jax.tree.leaves(out):
            if (isinstance(t, torch.Tensor) and tuple(t.shape) in self.watch
                    and t.untyped_storage().data_ptr() not in seen):
                self.shapes.append(tuple(t.shape))
        return out


def test_backward_makes_one_tensor_of_each_expert_leaf():
    """arctic-480b smoke at one layer (one super-block): the backward of a
    training step (remat's recompute included) makes exactly one new
    tensor of each stacked expert leaf's shape (with or without its
    super-block dim) -- its gradient."""
    cfg = dataclasses.replace(get_config("arctic-480b", smoke=True),
                              num_layers=1)
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params()
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert params["blk.0.moe.w_gate"].shape == (1, e, d, ff)
    batch = JSyntheticLMSource(jax_get_config("arctic-480b", smoke=True),
                               JShapeSpec("t", *SHAPE, "train")).batch_at(0)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = tstep._loss_fn(bundle, leaves, tstep.batch_to_device(
        batch, "cpu"))
    names = sorted(leaves)
    with NewStorages([(e, d, ff), (1, e, d, ff), (e, ff, d),
                      (1, e, ff, d)]) as made:
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
    assert sorted(made.shapes) == sorted([(e, d, ff), (e, d, ff),
                                          (e, ff, d)])
    for name in moe.EXPERT_LEAVES:
        assert grads[f"blk.0.moe.{name}"].shape == \
            params[f"blk.0.moe.{name}"].shape


# ---------------------------------------------------------- the launcher
def test_launcher_trains_arctic_and_resumes_bit_equal(tmp_path, capsys):
    """The arctic smoke config (Adafactor) through ``launch.train`` on the
    CPU: 4 steps in one run against 2, then ``--resume`` for 2 from the
    step-2 checkpoint, under one schedule: the losses equal bit for
    bit, finite."""
    def args(ckpt, steps, *more):
        return ["--arch", "arctic-480b", "--device", "cpu", "--steps",
                str(steps), "--batch", "2", "--seq", "16", "--ckpt-dir",
                str(ckpt), "--ckpt-every", "2", "--total-steps", "4", *more]
    whole = launch_train.main(args(tmp_path / "whole", 4))
    assert whole.steps_completed == 4 and all(np.isfinite(whole.losses))
    first = launch_train.main(args(tmp_path / "split", 2))
    assert CheckpointManager(str(tmp_path / "split")).latest_step() == 2
    second = launch_train.main(args(tmp_path / "split", 2, "--resume"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert first.losses + second.losses == whole.losses
