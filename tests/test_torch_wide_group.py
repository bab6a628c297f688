"""Port parity, GQA groups wider than 8: starcoder2-15b (G = 48 / 4 = 12)
and chatglm3-6b (G = 32 / 2 = 16, rotary over half the head).

* the ``--arch`` modules and the full-width geometry and weight bytes;
* the smoke configs (G = 2) and G-wide narrow variants (``scale_down`` to
  12 or 16 query heads over one kv head of 128, as ``chip_smoke.py``
  builds them) against the JAX package on the same weights: forward and
  paged-decode logits (fp32 within 1e-4; bf16 within 0.125 of JAX run op
  by op, greedy tokens equal), and the port's paged and slot engines'
  tokens against the JAX engines';
* the decode-attention plain versions at G = 12 and 16 (D = 128) against
  the JAX oracles and the JAX Pallas kernels in interpret mode, over bf16,
  int8 and fp32 pools and a contiguous cache, at every split count;
* the wrappers' geometry check, which refuses only G > 16 (or D > 128),
  and the default split counts of the new geometries;
* padded positions of the folded paged call (``paged_attention_folded``)
  equal to the gather path's at every position (ROADMAP C.3).

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import scale_down as jax_scale_down
from repro.kernels.flash_decode import decode_attention_ref as jax_oracle
from repro.kernels.flash_decode import flash_decode as jax_flash
from repro.kernels.flash_decode import flash_decode_paged as jax_flash_paged
from repro.models import build_model as jax_build_model
from repro.parallel import ParallelContext
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config, scale_down
from repro_torch.kernels.flash_decode import (decode_attention_split_ref,
                                              paged_decode_attention_q_ref,
                                              paged_decode_attention_ref,
                                              paged_decode_attention_split_ref)
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import build_model
from repro_torch.models.layers import (paged_attention_folded,
                                       paged_attention_gather)
from repro_torch.models.registry import param_specs
from repro_torch.quant import quantize_channelwise
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

PCTX = ParallelContext(None)
FP32_LOGITS_ATOL = 1e-4
BF16_LOGITS_BOUND = 0.125
BF16_EPS = 2.0 ** -7
#: int8 pools against the plain version that rounds the dequantized K/V to
#: bf16 (the JAX oracle's rounding; the split form keeps them fp32):
#: chip_smoke.py's bound for B2q
Q_ATOL = 0.03
#: the wide archs: (name, Hq, Hkv) at full width
WIDE_ARCHS = {"starcoder2-15b": (48, 4), "chatglm3-6b": (32, 2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def wide_variant(cfg, groups: int):
    """The G-wide narrow variant of a full-width config (``scale_down``
    from either package's ``configs.base``): ``groups`` query heads over
    one kv head of 128."""
    down = jax_scale_down if type(cfg).__module__.startswith("repro.") \
        else scale_down
    return down(cfg, num_heads=groups, num_kv_heads=1, head_dim=128,
                name=f"{cfg.name}-g{groups}")


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("module", ["starcoder2_15b", "chatglm3_6b",
                                    "whisper_large_v3"])
def test_config_modules_equal_jax(module):
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    jmod = importlib.import_module(f"repro.configs.{module}")
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(mod, name)) == \
            dataclasses.asdict(getattr(jmod, name))


def test_full_width_geometry_and_weights():
    """G = 12 and 16 at D = 128, and the weights one card holds in bf16:
    21.995 B parameters (44.0 GB; SwiGLU at d_ff 24576) and 6.243 B (12.5
    GB)."""
    counts = {}
    for arch, (hq, hkv) in WIDE_ARCHS.items():
        cfg = get_config(arch)
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == \
            (hq, hkv, 128)
        counts[arch] = sum(int(np.prod(s))
                           for s, _ in param_specs(cfg).values())
    assert counts == {"starcoder2-15b": 21_995_427_840,
                      "chatglm3-6b": 6_243_454_976}
    assert get_config("chatglm3-6b").rope_fraction == 0.5
    for arch, groups in (("starcoder2-15b", 12), ("chatglm3-6b", 16)):
        v = wide_variant(get_config(arch), groups)
        assert (v.num_heads // v.num_kv_heads, v.resolved_head_dim,
                v.num_layers, v.d_model) == (groups, 128, 2, 64)
        assert dataclasses.asdict(v) == dataclasses.asdict(
            wide_variant(jax_get_config(arch), groups))


# ------------------------------------------------------------------ models
MODELS = ["starcoder2-15b", "chatglm3-6b", "starcoder2-15b-g12",
          "chatglm3-6b-g16"]


def _configs(name):
    """(port config, JAX config) of a smoke config or a wide variant."""
    if name.endswith(("-g12", "-g16")):
        arch, g = name.rsplit("-g", 1)
        return (wide_variant(get_config(arch), int(g)),
                wide_variant(jax_get_config(arch), int(g)))
    return get_config(name, smoke=True), jax_get_config(name, smoke=True)


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, port config, JAX bundle with its layers unrolled, {dtype:
    (JAX params, torch params)}): PRNGKey(0) weights, the all-zero norm
    offsets filled from a numpy seed in both."""
    cfg, jcfg = _configs(request.param)
    jbundle = jax_build_model(dataclasses.replace(jcfg, scan_layers=False))
    rng = np.random.default_rng(0)
    base = {}
    for name, a in sorted(jbundle.init_params(jax.random.PRNGKey(0)).items()):
        a = np.asarray(a.astype(jnp.float32))
        if not a.any():
            a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        base[name] = a
    params = {}
    for dtype in ("float32", "bfloat16"):
        jp = {k: jnp.asarray(v).astype(dtype) for k, v in base.items()}
        params[dtype] = (jp, params_from_numpy(
            {k: np.asarray(v) for k, v in jp.items()}))
    return request.param, cfg, jbundle, params


def _dtypes(name):
    """The wide variants exercise the kernels' geometry, which the CPU's
    gather path does not see: fp32 is enough there."""
    return ("float32",) if name.endswith(("-g12", "-g16")) else \
        ("float32", "bfloat16")


def _close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                   atol=FP32_LOGITS_ATOL)
        return
    err = float(np.abs(_np(got) - _np(ref)).max())
    assert np.isfinite(err) and err <= BF16_LOGITS_BOUND, err
    np.testing.assert_array_equal(_np(got).argmax(-1), _np(ref).argmax(-1))


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, t)
                                                ).astype(np.int32)


def test_forward(model):
    """The whole-sequence forward over a (2, 9) batch (chatglm3's rotary
    over half of each head included)."""
    name, cfg, jbundle, params = model
    bundle = build_model(cfg, device="cpu")
    toks = _tokens(cfg, 2, 9)
    for dtype in _dtypes(name):
        jp, tp = params[dtype]
        fwd = (lambda p, t: jbundle.forward(p, {"tokens": t}, PCTX))
        ref = (jax.jit(fwd) if dtype == "float32" else fwd)(
            jp, jnp.asarray(toks))
        got = bundle.forward(tp, torch.from_numpy(toks))
        assert got.shape == ref.shape == (2, 9, cfg.padded_vocab)
        _close(got, ref, dtype)


def test_decode_paged(model):
    """A prefill chunk of 6 over pages of 4 (row 1 padded after 4 tokens),
    then two decode ticks, on pools of the params' dtype: the live rows'
    logits after each call."""
    name, cfg, jbundle, params = model
    bundle = build_model(cfg, device="cpu")
    for dtype in _dtypes(name):
        kv_dtype = dtype
        jp, tp = params[dtype]
        jcache = jbundle.init_paged_cache(7, 4, kv_dtype)
        tcache = bundle.init_paged_cache(7, 4, kv_dtype)
        toks = _tokens(cfg, 2, 6, seed=2)
        counts = np.array([6, 4], np.int32)
        lengths = np.zeros(2, np.int32)
        tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
        for _ in range(3):
            args = (toks, lengths, counts, tables)
            jl, jcache = jbundle.decode_paged(
                jp, jcache, *map(jnp.asarray, args), PCTX)
            tl = bundle.decode_paged(tp, tcache, *map(torch.from_numpy, args))
            rows = np.arange(2), counts - 1
            _close(tl[rows], jl[rows], dtype)
            toks = np.asarray(jnp.argmax(jl[rows], -1)).astype(np.int32
                                                               )[:, None]
            lengths, counts = lengths + counts, np.ones(2, np.int32)


def _serve(engine, prompts, request_cls, max_new=5):
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def test_engines_match_jax_engines(model):
    """fp32 params, 3 ragged requests on 2 slots (one admitted mid-flight),
    pages and chunks of 8: the port's paged engine on fp32 pools gives the
    JAX paged engine's greedy tokens and its slot engine the JAX slot
    engine's."""
    name, cfg, jbundle, params = model
    jp, tp = params["float32"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 12, 9)]
    kw = dict(slots=2, page_size=8, prefill_chunk=8)
    slot_kw = dict(slots=2, max_seq=32)
    bundle = build_model(cfg, device="cpu")
    assert _serve(PagedServeEngine(bundle, tp, device="cpu",
                                   kv_dtype="float32", **kw),
                  prompts, Request) == \
        _serve(JaxEngine(jbundle, jp, PCTX, kv_dtype="float32", **kw),
               prompts, JaxRequest)
    assert _serve(ServeEngine(bundle, tp, device="cpu", **slot_kw), prompts,
                  Request) == \
        _serve(JaxServeEngine(jbundle, jp, PCTX, **slot_kw), prompts,
               JaxRequest)


# --------------------------------------------- decode attention at G > 8
#: (B, Hq, Hkv, D, ps, P_max, lengths): starcoder2's group (12, one kv
#: head here) and chatglm3's (16 over two), lengths 0, 1, ps - 1, ps + 1
#: and full, and ragged ones
WIDE_CASES = [(4, 12, 1, 128, 8, 8, [0, 1, 9, 64]),
              (3, 32, 2, 128, 8, 6, [47, 0, 7])]
POOLS = ["bfloat16", "int8", "float32"]


@functools.lru_cache(maxsize=None)
def _case(ci: int, pool: str):
    """Inputs of WIDE_CASES[ci], for JAX and torch: a bf16 q, pools of
    ``pool`` (int8 codes with fp32 scales) with each row's pages shuffled
    across the pool and the table padded with the null page 0."""
    b, hq, hkv, d, ps, p_max, lengths = WIDE_CASES[ci]
    rng = np.random.default_rng(ci)
    need = [-(-n // ps) for n in lengths]
    p_pool = 1 + sum(need) + 1
    perm = rng.permutation(np.arange(1, p_pool))
    tables = np.zeros((b, p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    q = jnp.asarray(rng.standard_normal((b, hq, d)), jnp.bfloat16)
    raw = [rng.standard_normal((p_pool, ps, hkv, d)) for _ in range(2)]
    out = dict(q=(q, tensor_from_numpy(np.asarray(q))),
               lengths=np.asarray(lengths, np.int32), tables=tables)
    if pool == "int8":
        scales = [(np.abs(rng.standard_normal((p_pool, ps, hkv))) / 127
                   + 1e-3).astype(np.float32) for _ in range(2)]
        codes = [np.clip(np.round(p / np.abs(p).max(-1, keepdims=True)
                                  * 127), -127, 127).astype(np.int8)
                 for p in raw]
        out.update(kv=[(jnp.asarray(c), torch.from_numpy(c)) for c in codes],
                   scales=[(jnp.asarray(s), torch.from_numpy(s))
                           for s in scales])
    else:
        kv = [jnp.asarray(p, jnp.float32).astype(pool) for p in raw]
        out.update(kv=[(j, tensor_from_numpy(np.asarray(j))) for j in kv])
    return out


def _tol(q):
    return dict(rtol=BF16_EPS, atol=1e-3) if q.dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("ci", range(len(WIDE_CASES)),
                         ids=[f"g{c[1] // c[2]}" for c in WIDE_CASES])
def test_paged_plain_versions_match_pallas(ci, pool):
    """B2 (bf16, fp32 pools) and B2q (int8 pools) at G = 12 and 16: the
    split form at every split count and the unsplit plain version against
    the JAX Pallas paged kernel (interpret mode); int8 pools also within
    B2q's bound of the plain version that rounds the dequantized K/V to
    bf16, as the JAX oracle does; rows of length 0 exactly zero."""
    c = _case(ci, pool)
    (kj, kt), (vj, vt) = c["kv"]
    qj, qt = c["q"]
    lens, tables = c["lengths"], c["tables"]
    sc_j = sc_t = {}
    if pool == "int8":
        (ksj, kst), (vsj, vst) = c["scales"]
        sc_j = dict(k_scales=ksj, v_scales=vsj)
        sc_t = dict(k_scales=kst, v_scales=vst)
    ref = _np(jax_flash_paged(qj, kj, vj, jnp.asarray(lens),
                              jnp.asarray(tables), chunk=WIDE_CASES[ci][4],
                              **sc_j))
    lt, tt = torch.from_numpy(lens), torch.from_numpy(tables)
    for splits in fd_ops.SPLITS:
        got = paged_decode_attention_split_ref(qt, kt, vt, lt, tt, splits,
                                               **sc_t)
        assert got.dtype == qt.dtype
        np.testing.assert_allclose(_np(got), ref, **_tol(qt))
        assert not _np(got)[lens == 0].any()
    if pool == "int8":
        plain = paged_decode_attention_q_ref(qt, kt, vt, sc_t["k_scales"],
                                             sc_t["v_scales"], lt, tt)
        assert (np.abs(_np(got) - _np(plain))
                <= BF16_EPS * np.abs(_np(plain)) + Q_ATOL).all()
    else:
        plain = paged_decode_attention_ref(qt, kt, vt, lt, tt)
        np.testing.assert_allclose(_np(plain), ref, **_tol(qt))


@pytest.mark.parametrize("q_dtype,kv_dtype", [("bfloat16", "bfloat16"),
                                              ("float32", "bfloat16"),
                                              ("bfloat16", "float32")])
@pytest.mark.parametrize("ci", range(len(WIDE_CASES)),
                         ids=[f"g{c[1] // c[2]}" for c in WIDE_CASES])
def test_contiguous_plain_versions_match_jax(ci, q_dtype, kv_dtype):
    """B3 at G = 12 and 16 over the contiguous cache holding the same K/V
    as the pages: the split form at every split count against the JAX
    oracle and, for a bf16 q over a bf16 cache, the JAX Pallas kernel
    (interpret mode); a row of length 0 is the mean of V, as in both."""
    b, hq, hkv, d, ps, p_max, lengths = WIDE_CASES[ci]
    c = _case(ci, "float32")
    s = ps * p_max
    tables = torch.from_numpy(c["tables"]).long()
    k, v = (t[tables].reshape(b, s, hkv, d) for _, t in c["kv"])
    q = c["q"][1].to(getattr(torch, q_dtype))
    k, v = k.to(getattr(torch, kv_dtype)), v.to(getattr(torch, kv_dtype))
    qj, kj, vj = (jnp.asarray(_np(t)).astype(str(t.dtype)[6:])
                  for t in (q, k, v))
    lj = jnp.asarray(c["lengths"])
    ref = _np(jax_oracle(qj, kj, vj, lj))
    if q_dtype == kv_dtype == "bfloat16":
        np.testing.assert_allclose(_np(jax_flash(qj, kj, vj, lj)), ref,
                                   rtol=BF16_EPS, atol=1e-3)
    lt = torch.from_numpy(c["lengths"])
    for splits in fd_ops.SPLITS:
        got = decode_attention_split_ref(q, k, v, lt, splits)
        assert got.dtype == q.dtype
        np.testing.assert_allclose(_np(got), ref, **_tol(q))


def test_geometry_check_moves_to_sixteen():
    """The wrappers take every G = Hq / Hkv up to 16 at D <= 128 (a group
    wider than 8 in parts of 8 on the grid) and refuse G > 16, D > 128 or
    Hq not a multiple of Hkv before any launch."""
    assert (fd_ops.BLOCK_GROUP, fd_ops.MAX_GROUP, fd_ops.MAX_HEAD_DIM) == \
        (8, 16, 128)
    for hq, hkv in ((8, 1), (12, 1), (48, 4), (32, 2), (16, 1), (56, 8)):
        fd_ops.check_geometry("flash_decode", (4, hq, 128), (4, 256, hkv,
                                                             128))
    for hq, hkv, d in ((17, 1, 128), (24, 1, 128), (64, 2, 64),
                       (12, 1, 129), (12, 5, 128)):
        with pytest.raises(ValueError, match="G = Hq / Hkv <= 16"):
            fd_ops.check_geometry("flash_decode_paged", (4, hq, d),
                                  (9, 16, hkv, d))
    assert [fd_ops.group_parts(hq, hkv) for hq, hkv in
            ((32, 8), (8, 1), (12, 1), (48, 4), (32, 2), (16, 1))] == \
        [1, 1, 2, 2, 2, 2]


def test_default_splits_of_the_wide_geometries():
    """The default split count counts a row's blocks (kv heads x parts)
    at the served widths (4 slots, pages of 16, 16 a table; the slot cache
    at 256): 8 splits over bf16 and int8 caches; over fp32 ones, whose
    blocks fill an SM's registers, 2 for starcoder2's 8 blocks a row and 4
    for chatglm3's 4."""
    want = {"starcoder2-15b": {2: 8, 1: 8, 4: 2},
            "chatglm3-6b": {2: 8, 1: 8, 4: 4}}
    for arch, (hq, hkv) in WIDE_ARCHS.items():
        got = {kv_bytes: fd_ops.default_config(
            4, hq, hkv, 128, 256, kv_bytes)["splits"]
            for kv_bytes in (2, 1, 4)}
        assert got == want[arch]
        assert fd_ops.paged_default_config(
            4, hq, hkv, 128, 16, 16, kv_int8=True)["splits"] == 8
        assert fd_ops.paged_default_config(
            4, hq, hkv, 128, 16, 16, kv_bytes=4)["splits"] == want[arch][4]
    # past the budget the parts count: 12 kv heads in parts of 2
    assert fd_ops.default_config(4, 192, 12, 128, 256)["splits"] == 2
    assert fd_ops.default_config(4, 96, 12, 128, 256)["splits"] == 4


# ------------------------------------- padded positions (ROADMAP C.3)
@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("hq,hkv", [(12, 1), (16, 2), (8, 2)])
def test_folded_padded_positions_equal_gather(hq, hkv, kind):
    """A prefill chunk and a verify step folded into one call: every
    position, padded ones included (rows whose count ends early, an idle
    row of count 0, a chunk that runs past the row's allocated pages
    onto the null page 0), attends to the positions at or before its own
    over the same table, as the gather path does: within one bf16 ulp of
    the output's scale for a bf16 q, 1e-5 for an fp32 q."""
    rng = np.random.default_rng(hq + hkv)
    b, t, d, ps, width = 3, 6, 32, 4, 5
    k = rng.standard_normal((1 + b * 3, ps, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1 + b * 3, ps, hkv, d)).astype(np.float32)
    scales = {}
    if kind == "int8":
        kq, vq = (quantize_channelwise(torch.from_numpy(a), axis=-1)
                  for a in (k, v))
        kp, vp = kq.q, vq.q
        scales = dict(k_scales=kq.scale[..., 0], v_scales=vq.scale[..., 0])
    else:
        dt = getattr(torch, kind)
        kp, vp = torch.from_numpy(k).to(dt), torch.from_numpy(v).to(dt)
    # three live pages a row, then the null page 0, as the engine pads
    tables = np.zeros((b, width), np.int32)
    tables[:, :3] = 1 + rng.permutation(b * 3).reshape(b, 3)
    lens = torch.tensor([2, 7, 0], dtype=torch.int32)
    qdt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d)).astype(
        np.float32)).to(qdt)
    tt = torch.from_numpy(tables)
    positions = lens.long()[:, None] + torch.arange(t)[None]
    got = paged_attention_folded(q, kp, vp, lens, tt, **scales)
    ref = paged_attention_gather(q, kp, vp, positions, tt, **scales)
    diff = float((got.float() - ref.float()).abs().max())
    if qdt == torch.bfloat16:
        assert diff <= BF16_EPS * float(ref.float().abs().max())
    else:
        assert diff <= 1e-5
    # the decode tick (T = 1): an idle row attends to its position too
    one = paged_attention_folded(q[:, :1], kp, vp, lens, tt, **scales)
    ref1 = paged_attention_gather(q[:, :1], kp, vp, positions[:, :1], tt,
                                  **scales)
    assert float((one.float() - ref1.float()).abs().max()) <= \
        (BF16_EPS * float(ref1.float().abs().max()) if qdt == torch.bfloat16
         else 1e-5)
