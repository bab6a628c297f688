"""Port parity, the dense whole-sequence entry points: ``layers.attention``,
``lm.lm_forward`` and ``lm.lm_prefill`` (through ``ModelBundle.forward`` /
``.prefill``) against the JAX package on the llama3-8b smoke config, with
the same weights (JAX-initialised and bridged; the norm offsets, zero in
JAX's init, filled with the same seeded numbers in both packages so that
they carry signal).  fp32: logits within 1e-4 and the prefilled cache equal
to JAX's padded one; bf16: logits within 0.125 of JAX run op by op (the
layers unrolled, ``scan_layers=False``, and eager: a jitted bf16 body drops
roundings, ROADMAP C.0) with greedy tokens equal.  Then the prefilled cache
drives ``lm_decode_step`` on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro.parallel import ParallelContext
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.apr_matmul import matmul_ref, matmul_split_ref
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm

ARCH = "llama3-8b"
PCTX = ParallelContext(None)
#: fp32: the same model in two frameworks, sums in another order
FP32_LOGITS_ATOL = 1e-4
#: bf16: one-ulp roundings at different places, compounded over the layers
#: (the dense decode path's bound, test_torch_model.py)
BF16_LOGITS_BOUND = 0.125


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def model():
    """JAX smoke bundle (layers unrolled) and its PRNGKey(0) params with
    the all-zero ones filled from a numpy seed, in fp32 and bf16, bridged
    to the port."""
    jbundle = jax_build_model(dataclasses.replace(
        jax_get_config(ARCH, smoke=True), scan_layers=False))
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
    return jbundle, out


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, t)
                                                ).astype(np.int32)


def _jax(fn, dtype):
    """``fn`` jitted for fp32 (speed), op by op for bf16 (numerics)."""
    return jax.jit(fn) if dtype == "float32" else fn


def _close(got, ref, dtype):
    """fp32: within the fp32 tolerance; bf16: within the bound, greedy
    tokens equal."""
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                   atol=FP32_LOGITS_ATOL)
        return
    err = float(np.abs(_np(got) - _np(ref)).max())
    assert err <= BF16_LOGITS_BOUND, err
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(ref).argmax(-1))


@pytest.mark.parametrize("t", [1, 7, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention(model, dtype, t):
    """Layer 1's attention block alone: causal self-attention over a
    (2, t, d) input, against the JAX layer."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    jlp = {k[len("blk.0."):]: v[1] for k, v in jp.items()
           if k.startswith("blk.0.attn")}
    tlp = {k[len("blk.0."):]: v[1] for k, v in tp.items()
           if k.startswith("blk.0.attn")}
    rng = np.random.default_rng(t)
    x = jnp.asarray(rng.standard_normal((2, t, cfg.d_model))).astype(dtype)
    pos = np.broadcast_to(np.arange(t)[None], (2, t)).astype(np.int32)
    ref = _jax(lambda p, x, pos: jl.attention(p, "attn", cfg, x,
                                              positions=pos, causal=True),
               dtype)(jlp, x, jnp.asarray(pos))
    got = tl.attention(tlp, "attn", cfg,
                       tensor_from_numpy(np.asarray(x)),
                       tensor_from_numpy(pos))
    assert got.shape == ref.shape == (2, t, cfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)
    else:         # one bf16 ulp of O(1) values, a few where sums tie
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2 ** -6,
                                   atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill(model, dtype):
    """``forward`` over a (2, 11) batch; ``prefill`` of the same tokens into
    a cache of max_seq 16: its last-position logits and its K/V, which are
    JAX's bf16 cache, zero-padded past T (bit for bit in fp32)."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 11)
    ref = _jax(lambda p, t: jbundle.forward(p, {"tokens": t}, PCTX),
               dtype)(jp, jnp.asarray(toks))
    got = bundle.forward(tp, torch.from_numpy(toks))
    jl_, jcache = _jax(lambda p, t: jbundle.prefill(
        p, {"tokens": t}, PCTX, max_seq=16), dtype)(jp, jnp.asarray(toks))
    tl_, tcache = bundle.prefill(tp, torch.from_numpy(toks), max_seq=16)
    assert got.shape == ref.shape == (2, 11, cfg.padded_vocab)
    assert tl_.shape == jl_.shape == (2, 1, cfg.padded_vocab)
    _close(got, ref, dtype)
    _close(tl_, jl_, dtype)
    assert sorted(tcache) == sorted(jcache) == ["k", "v"]
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape == (
            cfg.num_layers, 1, 2, 16, cfg.num_kv_heads,
            cfg.resolved_head_dim)
        assert tcache[k].dtype == torch.bfloat16 == getattr(
            torch, str(jcache[k].dtype))
        assert not tcache[k][:, :, :, 11:].any()
        if dtype == "float32":
            np.testing.assert_array_equal(_np(tcache[k]), _np(jcache[k]))
        else:
            np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]),
                                       rtol=2 ** -6, atol=2e-2)
    # prefill's logits are forward's last row in the port itself
    np.testing.assert_array_equal(_np(tl_[:, 0]), _np(got[:, -1]))
    # max_seq defaults to T
    assert bundle.prefill(tp, torch.from_numpy(toks))[1]["k"].shape[3] == 11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_hands_off_to_decode_step(model, dtype):
    """Three decode steps from each side's own prefilled cache (an 11-token
    prompt, max_seq 16), each fed the JAX greedy tokens: logits and, in
    fp32, the cache bit for bit after every step."""
    jbundle, params = model
    jp, tp = params[dtype]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 11, seed=2)
    jl_, jcache = _jax(lambda p, t: jbundle.prefill(
        p, {"tokens": t}, PCTX, max_seq=16), dtype)(jp, jnp.asarray(toks))
    _, tcache = bundle.prefill(tp, torch.from_numpy(toks), max_seq=16)
    step = _jax(lambda p, c, t, n: jbundle.decode_step(p, c, t, n, PCTX),
                dtype)
    nxt = np.asarray(jnp.argmax(jl_[:, -1], axis=-1))[:, None].astype(
        np.int32)
    lengths = np.full(2, 11, np.int32)
    for _ in range(3):
        jl_, jcache = step(jp, jcache, jnp.asarray(nxt), jnp.asarray(lengths))
        tl_ = bundle.decode_step(tp, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(lengths))
        _close(tl_, jl_, dtype)
        if dtype == "float32":
            for k in ("k", "v"):
                np.testing.assert_array_equal(_np(tcache[k]), _np(jcache[k]))
        nxt = np.asarray(jnp.argmax(jl_[:, -1], axis=-1))[:, None].astype(
            np.int32)
        lengths = lengths + 1


def test_unported_inputs_raise_by_name(model):
    """The audio family runs on ``models/encdec.py``, not on the LM
    entry points, which refuse it by name; its bundle needs ``frames`` and
    takes no ``prefix_embeds``; the non-LM families refuse
    ``prefix_embeds``."""
    _, params = model
    tp = params["float32"][1]
    audio = get_config("whisper-large-v3", smoke=True)
    toks = torch.ones((1, 3), dtype=torch.long)
    for fn in (tlm.lm_forward, tlm.lm_prefill):
        with pytest.raises(NotImplementedError, match="audio"):
            fn(tp, audio, toks)
    whisper = build_model(audio, device="cpu")
    with pytest.raises(ValueError, match="prefix_embeds"):
        whisper.forward({}, toks, prefix_embeds=torch.zeros((1, 2, 64)),
                        frames=torch.zeros((1, 16, 64)))
    with pytest.raises(ValueError, match="frames"):
        whisper.prefill({}, toks)
    rwkv = build_model(get_config("rwkv6-3b", smoke=True), device="cpu")
    with pytest.raises(ValueError, match="prefix_embeds"):
        rwkv.forward({}, toks, prefix_embeds=torch.zeros((1, 2, 64)))


def test_forward_hands_the_kernel_what_it_takes(model, monkeypatch):
    """Every ``apr_matmul`` operand of ``forward`` and ``prefill`` is 2-D
    row-major, as the CUDA kernel takes it, and one forward makes the
    projections the card counts: q, k, v, gate and up in each layer
    (``wo`` and ``w_down`` go through ``tp_einsum``, one more launch each
    on the card) and the head."""
    _, params = model
    tp = params["bfloat16"][1]
    cfg = get_config(ARCH, smoke=True)
    bundle = build_model(cfg, device="cpu")
    calls = []
    matmul = tl.apr_matmul

    def spy(x, w, **kw):
        assert x.dim() == 2 and x.is_contiguous() and w.is_contiguous()
        calls.append(x.shape[0])
        return matmul(x, w, **kw)

    monkeypatch.setattr(tl, "apr_matmul", spy)
    toks = torch.from_numpy(_tokens(cfg, 2, 9))
    bundle.forward(tp, toks)
    assert calls == [18] * (5 * cfg.num_layers + 1)
    calls.clear()
    bundle.prefill(tp, toks, max_seq=12)
    assert calls == [18] * (5 * cfg.num_layers) + [2]   # head: last rows


def _projection_shapes() -> list:
    """The (K, N) of every projection weight of the llama3-8b and zamba2
    smoke configs."""
    from repro_torch.models.registry import param_specs
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
             "w_out", "lm_head")
    return sorted({specs[-2:] for arch in (ARCH, "zamba2-1.2b")
                   for name, (specs, _) in param_specs(
                       get_config(arch, smoke=True)).items()
                   if name.split(".")[-1] in names})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kn", _projection_shapes(), ids=str)
def test_plain_matmul_row_bits_independent_of_m(kn, dtype):
    """The plain B1 (``matmul_ref``, and ``matmul_split_ref`` at two
    splits) gives each row the same bits at M = 1, 2, 4 and 16 on the
    CPU, at every smoke projection shape: a paged prefill chunk of one row
    and the slot engine's batch of all slots then round alike."""
    k, n = kn
    rng = np.random.default_rng(k * 1000 + n)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((16, k), np.float32)).to(dt)
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32)
                         * k ** -0.5).to(dt)
    for fn in (lambda a: matmul_ref(a, w, dt),
               lambda a: matmul_split_ref(a, w, 2, dt)):
        whole = fn(x)
        for m in (1, 2, 4):
            assert torch.equal(fn(x[:m]), whole[:m]), m
        for i in range(16):
            assert torch.equal(fn(x[i:i + 1]), whole[i:i + 1]), i
