"""Port parity, recurrent models: ``rwkv_forward``, ``rwkv_prefill``,
``rwkv_decode_step``, ``rwkv_decode_paged`` and their mamba2 counterparts
against the JAX package on the smoke configs, with the same weights
(JAX-initialised and bridged; the parameters JAX initialises to zero --
token-shift mixes, decay and norm offsets, ``a_log``, ``d_skip``,
``dt_bias`` -- are filled with the same seeded numbers in both packages so
that every path carries signal).  In fp32 logits, states and pools agree to
a tight tolerance; in bf16 greedy tokens are identical and the max |logits
diff| is bounded.  The JAX side runs with ``scan_layers=False``, the layer
loop unrolled as the port runs it, and in bf16 op by op (eager): XLA
compiles a jitted or scanned body with fewer bf16 roundings, and JAX's own
jitted and eager bf16 logits differ by up to 0.07 on these smoke models,
where the port's bf16 decode step equals the eager one bit for bit.  In
fp32 the JAX side is jitted (1e-5 from eager).  The launcher serves
both archs, and the zamba2 hybrid, on the CPU."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import rwkv_lm as jrwkv_lm
from repro.models import ssm as jssm
from repro.parallel import ParallelContext
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import rwkv_lm as trwkv_lm
from repro_torch.models import ssm as tssm

PCTX = ParallelContext(None)
ARCHS = ["rwkv6-3b", "mamba2-2.7b"]
#: fp32: the same model in two frameworks; XLA's exp and cumsum differ from
#: torch's in the last fp32 bit and sums run in another order, so logits
#: (O(1) at this init) and states agree to a few fp32 ulps of their size
FP32_LOGITS_ATOL = 5e-4
FP32_STATE_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16: one-ulp roundings at different places compound over the layers;
#: the dense path's bound (test_torch_model.py) holds here too
BF16_LOGITS_BOUND = 0.125


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """JAX smoke bundle and params at PRNGKey(0), its all-zero params filled
    from a numpy seed, in fp32 and bf16, bridged to the port."""
    arch = request.param
    jbundle = jax_build_model(dataclasses.replace(
        jax_get_config(arch, smoke=True), scan_layers=False))
    rng = np.random.default_rng(0)
    base = {}
    for name, a in sorted(jbundle.init_params(jax.random.PRNGKey(0)).items()):
        a = np.asarray(a.astype(jnp.float32))
        if not a.any():
            a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        base[name] = a
    out = {}
    for dtype in ("float32", "bfloat16"):
        jp = {k: jnp.asarray(v).astype(dtype) for k, v in base.items()}
        out[dtype] = (jp, params_from_numpy({k: np.asarray(v)
                                             for k, v in jp.items()}))
    return arch, jbundle, out


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, t)
                                                ).astype(np.int32)


def _jax(fn, dtype):
    """``fn`` jitted for fp32 (speed), op by op for bf16 (numerics)."""
    return jax.jit(fn) if dtype == "float32" else fn


def _bf16_ok(got, ref):
    """bf16: greedy tokens identical, max |logits diff| within the bound."""
    err = float(np.abs(_np(got) - _np(ref)).max())
    assert err <= BF16_LOGITS_BOUND, err
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(ref).argmax(-1))
    return err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill(model, dtype):
    """``forward`` over a 21-token batch (ragged against the JAX chunk of
    the CPU formula) and ``prefill``'s last logits and decode carry."""
    arch, jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 21)
    ref = _jax(lambda p, t: jbundle.forward(p, {"tokens": t}, PCTX),
               dtype)(jp, jnp.asarray(toks))
    got = bundle.forward(tp, torch.from_numpy(toks))
    jl, jstate = _jax(lambda p, t: jbundle.prefill(p, {"tokens": t}, PCTX),
                      dtype)(jp, jnp.asarray(toks))
    tl, tstate = bundle.prefill(tp, torch.from_numpy(toks))
    assert got.shape == ref.shape and tl.shape == jl.shape == (2, 1,
                                                               cfg.padded_vocab)
    assert sorted(tstate) == sorted(jstate)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                   atol=FP32_LOGITS_ATOL)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=FP32_LOGITS_ATOL)
        for k in jstate:
            assert tstate[k].dtype == getattr(torch, str(jstate[k].dtype))
            np.testing.assert_allclose(_np(tstate[k]), _np(jstate[k]),
                                       **FP32_STATE_TOL)
    else:
        _bf16_ok(got, ref)
        _bf16_ok(tl, jl)
    # prefill's logits are forward's last row in the port itself
    np.testing.assert_allclose(_np(tl[:, 0]), _np(got[:, -1]), rtol=0,
                               atol=1e-6 if dtype == "float32" else 0.07)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step(model, dtype):
    """Three decode steps from a prefilled carry, each side fed the JAX
    greedy tokens: logits and the carried state after every step."""
    arch, jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 9, seed=1)
    _, jstate = _jax(lambda p, t: jbundle.prefill(p, {"tokens": t}, PCTX),
                     dtype)(jp, jnp.asarray(toks))
    step = _jax(lambda p, s, t: jbundle.decode_step(p, s, t, None, PCTX),
                dtype)
    tstate = {k: torch.from_numpy(np.array(_np(v))).to(
        getattr(torch, str(v.dtype))) for k, v in jstate.items()}
    nxt = toks[:, -1:]
    lengths = np.full(2, 9, np.int32)
    for _ in range(3):
        jl, jstate = step(jp, jstate, jnp.asarray(nxt))
        tl = bundle.decode_step(tp, tstate, torch.from_numpy(nxt),
                                torch.from_numpy(lengths))
        if dtype == "float32":
            np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                       atol=FP32_LOGITS_ATOL)
            for k in jstate:
                np.testing.assert_allclose(_np(tstate[k]), _np(jstate[k]),
                                           **FP32_STATE_TOL)
        else:
            _bf16_ok(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
        lengths = lengths + 1


def _state_tables(reads, writes):
    """Combined block tables of a pure recurrent family: the KV page
    columns (2 here; the model never reads them), the read column, the T
    write columns."""
    b = len(reads)
    return np.concatenate([np.zeros((b, 2), np.int32),
                           np.asarray(reads, np.int32)[:, None],
                           np.asarray(writes, np.int32)], axis=1)


@pytest.mark.parametrize("dtype,state_dtype", [("float32", "float32"),
                                               ("float32", "int8"),
                                               ("bfloat16", "float32")])
def test_decode_paged(model, dtype, state_dtype):
    """One prefill chunk of 6 (row 1 padded after 4 tokens; its post-token
    state goes to slot 3, row 0's to slot 2, the rest to the trash slot 1),
    then two decode ticks reading and writing slots 2 and 3: logits, and
    every pool (int8 codes and scales included) after each call."""
    arch, jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    jcache = jbundle.init_paged_cache(5, 8, state_slots=6,
                                      state_dtype=state_dtype)
    tcache = bundle.init_paged_cache(5, 8, state_slots=6,
                                     state_dtype=state_dtype)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    toks = _tokens(cfg, 2, 6, seed=2)
    counts = np.array([6, 4], np.int32)
    lengths = np.zeros(2, np.int32)
    tables = _state_tables([0, 0], [[1, 1, 1, 1, 1, 2], [1, 1, 1, 3, 1, 1]])
    fwd = _jax(lambda p, c, *a: jbundle.decode_paged(p, c, *a, PCTX), dtype)
    for _ in range(3):
        args = (toks, lengths, counts, tables)
        jl, jcache = fwd(jp, jcache, *map(jnp.asarray, args))
        tl = bundle.decode_paged(tp, tcache, *map(torch.from_numpy, args))
        rows = np.arange(2), counts - 1
        if dtype == "float32":
            np.testing.assert_allclose(_np(tl)[rows], _np(jl)[rows], rtol=0,
                                       atol=FP32_LOGITS_ATOL)
            for k in jcache:
                live = slice(2, 4)       # slots 0 and 1 are null and trash
                if k.endswith("_scale") or tcache[k].dtype != torch.int8:
                    np.testing.assert_allclose(
                        _np(tcache[k])[:, live], _np(jcache[k])[:, live],
                        **FP32_STATE_TOL)
                else:                     # int8 codes: at most one step off
                    diff = np.abs(_np(tcache[k])[:, live]
                                  - _np(jcache[k])[:, live])
                    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            assert not _np(tcache[next(iter(tcache))])[:, 0].any()
        else:
            _bf16_ok(tl[rows], jl[rows])
        nxt = np.asarray(jnp.argmax(jl[rows], axis=-1)).astype(np.int32)
        toks = nxt[:, None]
        lengths = lengths + counts
        counts = np.ones(2, np.int32)
        tables = _state_tables([2, 3], [[2], [3]])


def test_init_state_and_pools_match_jax():
    """Zero carries and pools of the JAX shapes and dtypes, and the pools'
    bytes at full width as the JAX package counts them."""
    for arch, jinit, tinit, jpaged, tpaged in [
            ("rwkv6-3b", jrwkv_lm.init_state_abstract, trwkv_lm.init_state,
             jrwkv_lm.init_paged_state_abstract, trwkv_lm.init_paged_state),
            ("mamba2-2.7b", jssm.init_lm_state_abstract, tssm.init_lm_state,
             jssm.init_paged_state_abstract, tssm.init_paged_state)]:
        for smoke in (True, False):
            jcfg, tcfg = jax_get_config(arch, smoke), get_config(arch, smoke)
            pairs = [(jinit(jcfg, 3), tinit(tcfg, 3, device="meta"))] + [
                (jpaged(jcfg, 10, sd), tpaged(tcfg, 10, sd, device="meta"))
                for sd in ("float32", "int8")]
            for jtree, ttree in pairs:
                assert sorted(jtree) == sorted(ttree)
                for k, s in jtree.items():
                    assert tuple(ttree[k].shape) == s.shape, (arch, k)
                    assert str(ttree[k].dtype) == f"torch.{s.dtype}", (arch,
                                                                       k)
        with pytest.raises(ValueError, match="state_dtype"):
            tpaged(get_config(arch, smoke=True), 10, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b"])
@pytest.mark.parametrize("args", [[], ["--engine", "slot"],
                                  ["--state-dtype", "int8"],
                                  ["--kv-dtype", "int8"]])
def test_launcher_serves_on_the_cpu(arch, args):
    """Both engines serve each recurrent arch and the zamba2 hybrid, whose
    paged engine holds int8 KV pages with ``--kv-dtype int8``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", arch, "--device", "cpu", "--requests",
                           "2", "--slots", "2", "--max-new", "3",
                           "--prompt-len", "6", "--prefill-chunk", "4"]
                          + args)
    out = buf.getvalue()
    assert "served 2/2 requests on cpu" in out
    assert out.count("tokens=3") == 2
    if "--state-dtype" in args:
        assert "state pools int8" in out
    if "--kv-dtype" in args and arch == "zamba2-1.2b":
        assert "kv pool int8 + state pools float32" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_models_hand_the_kernels_what_they_take(arch, monkeypatch):
    """With the models' kernel branches forced on, every tensor they hand
    ``rwkv6_wkv`` / ``mamba2_ssd`` passes the CUDA kernel's own argument
    checks (dtypes, shapes, limits, strides), and every ``apr_matmul``
    operand is 2-D row-major, in forward, prefill (two rows, so the head
    reads a strided last position), the decode step and the paged step;
    the plain versions then stand in for the kernels, so the logits are
    unchanged."""
    from repro_torch.kernels import mamba2, rwkv6
    from repro_torch.kernels.mamba2 import ops as mamba2_ops
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.models import rwkv as trwkv
    calls = []

    def spy(check, ref):
        def run(*args, **kw):
            calls.append(check(*args, kw.get("s_init", kw.get("h_init"))))
            return ref(*args, **kw)
        return run

    monkeypatch.setattr(trwkv, "rwkv6_wkv",
                        spy(rwkv6_ops.check_kernel_args, rwkv6.rwkv6_ref))
    monkeypatch.setattr(tssm, "mamba2_ssd",
                        spy(mamba2_ops.check_kernel_args, mamba2.mamba2_ref))
    matmul = tl.apr_matmul

    def matmul_spy(x, w, **kw):
        # the apr_matmul kernel's layout: 2-D row-major operands
        assert x.dim() == 2 and x.is_contiguous() and w.is_contiguous()
        return matmul(x, w, **kw)

    monkeypatch.setattr(tl, "apr_matmul", matmul_spy)
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params()
    toks = torch.from_numpy(_tokens(cfg, 2, 5))
    ref = bundle.forward(params, toks)
    for mod in (trwkv, tssm):
        monkeypatch.setattr(mod, "use_scan_kernel", lambda x: True)
    got = bundle.forward(params, toks)
    _, state = bundle.prefill(params, toks)
    bundle.decode_step(params, state, toks[:, :1], None)
    cache = bundle.init_paged_cache(5, 8, state_slots=6)
    bundle.decode_paged(params, cache, toks, None, None,
                        torch.from_numpy(_state_tables([0, 0], [[1] * 5] * 2)))
    # forward + prefill: one launch per layer each; decode: one per layer;
    # paged: one per layer per token
    assert len(calls) == cfg.num_layers * (3 + toks.shape[1])
    assert _bf16_ok(got, ref) < BF16_LOGITS_BOUND
