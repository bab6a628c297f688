"""The remat policies on one device (``cfg.remat_policy``), on the CPU.

The JAX package reads the policy only in the dense, moe and vlm families'
super-blocks (``repro.models.lm._remat_policy``): ``"dots"`` keeps the
outputs of the products without batch dimensions
(``dots_with_no_batch_dims_saveable``), ``"save_coll"`` the values named
``moe_a2a``, which only the expert-parallel branch over a mesh names, so on
one device it keeps nothing.  Every other family checkpoints with
``nothing_saveable`` whatever the policy says.

Here: the recurrent and audio families give the same loss and gradients
bit for bit under every policy; ``"save_coll"`` runs as ``"nothing"`` on
one device and is refused over a mesh; ``"dots"`` gives the gradients of
``"nothing"`` bit for bit (the kernel's bits depend on the shape alone, so
a kept product equals its recompute), recomputes no ``AprMatmulFunction``
product in the backward, and keeps of one super-block the products JAX's
``saved_residuals`` lists, in number and shape.  The mapping: JAX's
``reduce_precision`` outputs of ``dot_general`` are the products; the
output of the jitted ``silu`` is the gate product, which that call
forwards as its residual; a JAX (B, T, N) product is the port's (B·T, N)
one.  JAX keeps no closing ``w_down`` (``res_down`` in arctic) product: the
backward never reads it, and the port neither keeps nor recomputes it.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import lm as jlm
from repro.parallel import ParallelContext
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import SyntheticLMSource
from repro_torch.kernels.apr_matmul import AprMatmulFunction, ProductTape
from repro_torch.kernels.apr_matmul import ops as mm_ops
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.train import step as tstep

RECURRENT = ("rwkv6-3b", "mamba2-2.7b", "zamba2-1.2b", "whisper-large-v3")
LM = ("llama3-8b", "arctic-480b", "llama4-maverick-400b-a17b",
      "internvl2-1b")
#: B = 2 rows of 32 tokens
SHAPE = (32, 2)


def _params(cfg, dtype):
    """The smoke config's random params (seed 0) in ``dtype``, the
    all-zero norm offsets filled from a numpy seed so they carry signal."""
    rng = np.random.default_rng(0)
    out = {}
    for k, v in sorted(build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0)).items()):
        a = v.float().numpy()
        if not a.any():
            a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        out[k] = torch.from_numpy(a).to(dtype)
    return out


def _run(name, policy, dtype=torch.float32):
    """Loss and gradients of the smoke config of ``name`` under
    ``policy``, the ``apr_matmul`` calls that ``AprMatmulFunction``'s
    forward made inside the backward (the recompute's products), and the
    ``ExpertMatmulFunction`` forwards run there (the experts' recompute)."""
    cfg = get_config(name, smoke=True)
    batch = SyntheticLMSource(cfg, ShapeSpec("t", *SHAPE, "train")
                              ).batch_at(0)
    bundle = build_model(dataclasses.replace(cfg, remat_policy=policy),
                         device="cpu")
    recomputed = []
    inner_mm, inner_fwd = mm_ops.apr_matmul, AprMatmulFunction.forward

    def mm(x, w, **kw):
        if torch._C._current_graph_task_id() != -1:
            recomputed.append(tuple(x.shape[:1]) + tuple(w.shape[1:]))
        return inner_mm(x, w, **kw)

    def forward(ctx, x, w, out_dtype):
        mm_ops.apr_matmul = mm
        try:
            return inner_fwd(ctx, x, w, out_dtype)
        finally:
            mm_ops.apr_matmul = inner_mm
    experts = []
    inner_expert = tmoe.ExpertMatmulFunction.forward

    def expert_forward(ctx, x, w, queues, product):
        if torch._C._current_graph_task_id() != -1:
            experts.append(len(queues))
        return inner_expert(ctx, x, w, queues, product)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AprMatmulFunction, "forward", staticmethod(forward))
        mp.setattr(tmoe.ExpertMatmulFunction, "forward",
                   staticmethod(expert_forward))
        loss, grads = tstep.loss_and_grads(bundle, _params(cfg, dtype),
                                           batch)
    return loss, grads, recomputed, experts


@functools.lru_cache(maxsize=None)
def _nothing(name, dtype=torch.float32):
    return _run(name, "nothing", dtype)


def _assert_bit_equal(a, b, what):
    (la, ga, *_), (lb, gb, *_) = a, b
    assert torch.equal(la, lb), what
    assert sorted(ga) == sorted(gb)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), (what, k)


# ----------------------------------- repair: the families JAX never asks
@pytest.mark.parametrize("policy", ["dots", "save_coll"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_and_audio_families_ignore_the_policy(name, policy):
    """rwkv6-3b, mamba2-2.7b, zamba2-1.2b and whisper-large-v3 recompute
    their blocks whole under any policy, as JAX does (``nothing_saveable``
    whatever ``cfg.remat_policy``): loss and grads bit-equal to
    ``"nothing"``."""
    _assert_bit_equal(_run(name, policy), _nothing(name), (name, policy))


def test_save_coll_runs_as_nothing_on_one_device():
    """arctic-480b under ``"save_coll"``: nothing carries the name
    ``moe_a2a`` on one device, so the grads are ``"nothing"``'s bit for
    bit, the recompute's products included."""
    got = _run("arctic-480b", "save_coll")
    _assert_bit_equal(got, _nothing("arctic-480b"), "save_coll")
    assert got[2] == _nothing("arctic-480b")[2]


def test_save_coll_over_a_mesh_is_refused_by_name():
    cfg = dataclasses.replace(get_config("arctic-480b", smoke=True),
                              remat_policy="save_coll")
    params = {k: v.requires_grad_() for k, v in
              _params(cfg, torch.float32).items()}
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="'save_coll'.*A.12"):
        tlm.lm_forward(params, cfg, tokens,
                       pctx=types.SimpleNamespace(mesh=object()))
    assert tlm.remat_policy(cfg) == "nothing"
    for policy, kept in (("dots", "dots"), ("nothing", "nothing"),
                         ("anything", "nothing")):
        assert tlm.remat_policy(dataclasses.replace(
            cfg, remat_policy=policy)) == kept


# ------------------------------------------------------ "dots" (A.13-1b)
@pytest.mark.parametrize("name,dtype", [(n, torch.float32) for n in LM]
                         + [("llama3-8b", torch.bfloat16)])
def test_dots_gives_the_gradients_of_nothing(name, dtype):
    """Grads under ``"dots"`` bit-equal to ``"nothing"``, and the backward
    recomputes no ``AprMatmulFunction`` product (``"nothing"`` recomputes
    every one of the super-blocks'); the MoE experts' products (inside
    ``ExpertMatmulFunction``) are recomputed under both."""
    got, ref = _run(name, "dots", dtype), _nothing(name, dtype)
    _assert_bit_equal(got, ref, (name, dtype))
    assert got[2] == [] and ref[2]
    moe = bool(get_config(name, smoke=True).num_experts)
    assert got[3] == ref[3] and bool(got[3]) == moe


def test_dots_recomputes_again_through_a_retained_graph():
    """A second backward through a retained graph recomputes each
    super-block again, replaying the products the forward kept: the
    gradients of the first, bit for bit."""
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              remat_policy="dots")
    params = {k: v.requires_grad_() for k, v in
              _params(cfg, torch.float32).items()}
    tokens = torch.from_numpy(SyntheticLMSource(cfg, ShapeSpec(
        "t", *SHAPE, "train")).batch_at(0)["tokens"])
    loss = tlm.lm_forward(params, cfg, tokens).float().square().mean()
    once = torch.autograd.grad(loss, list(params.values()),
                               retain_graph=True)
    again = torch.autograd.grad(loss, list(params.values()))
    for a, b in zip(once, again):
        assert torch.equal(a, b)


def _jax_kept(name, dtype):
    """(rows, columns, dtype) of every product JAX's ``"dots"`` policy
    keeps of one super-block of the smoke config at B x T = 2 x 8."""
    jcfg = dataclasses.replace(jax_get_config(name, smoke=True),
                               remat_policy="dots")
    params = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    blk = {k: v[0].astype(dtype) for k, v in params.items()
           if k.startswith("blk.")}
    b, t = 2, 8
    x = jnp.ones((b, t, jcfg.d_model), dtype)
    pos = jnp.broadcast_to(jnp.arange(t), (b, t))
    body = jax.checkpoint(
        lambda x, lp: jlm._super_block(jcfg, ParallelContext(None), x, lp,
                                       pos),
        policy=jlm._remat_policy(jcfg))
    kept = []
    for aval, where in saved_residuals(body, x, blk):
        if where.startswith("output of reduce_precision") or \
                where.startswith("output of jitted function 'silu'"):
            shape = aval.shape
            kept.append((int(np.prod(shape[:-1])), shape[-1],
                         jnp.dtype(aval.dtype).name))
        else:
            assert where.startswith(("from the argument", "from a constant")
                                    ), where
    return sorted(kept)


@pytest.mark.parametrize("name,dtype", [
    ("llama3-8b", "float32"), ("llama3-8b", "bfloat16"),
    ("arctic-480b", "float32"), ("llama4-maverick-400b-a17b", "float32")])
def test_dots_keeps_the_products_jax_keeps(name, dtype):
    """The outputs a :class:`ProductTape` keeps of one super-block (its
    forward recorded under a gradient) equal, in number and shape, the dot
    residuals ``saved_residuals`` lists for JAX's ``"dots"`` policy: q, k,
    v, the canonical split-K partials of ``wo`` (and of each ``w_down`` but
    the closing one), gate and up, and the MoE router."""
    cfg = dataclasses.replace(get_config(name, smoke=True), dtype=dtype)
    tdt = getattr(torch, dtype)
    params = {k: v.requires_grad_() for k, v in
              _params(cfg, tdt).items()}
    _, layers = next(tlm._super_blocks(params, cfg))
    b, t = 2, 8
    x = torch.ones((b, t, cfg.d_model), dtype=tdt)
    positions = torch.arange(t).expand(b, t)
    tape = ProductTape()
    with tape.contexts()[0]:
        tlm._super_block(cfg, lambda sj, lp, h: tl.attention(
            lp, "attn", cfg, h, positions), 0, layers, x)
    kept = sorted((y.shape[0], y.shape[1], str(y.dtype).split(".")[-1])
                  for y in tape.outputs if y is not None)
    assert kept == _jax_kept(name, getattr(jnp, dtype))
