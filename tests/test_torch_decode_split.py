"""Port parity, the contiguous decode kernel's split form and the fp32
operands of the decode kernels: the plain split-then-combine version
(``decode_attention_split_ref``) against the JAX oracle of
``flash_decode`` and the port's ``decode_attention_ref`` at every split
count the kernel takes, an fp32 q over a bf16 cache included; the paged
plain version over fp32 pools under a bf16 q against the JAX oracle; an
fp32-param model on the slot engine (bf16 cache) beside the JAX one; a bf16 model over fp32 pools, layer and
engine, against the JAX package; the (q, K/V) and (x, weight) dtype tables
of the CUDA kernels; which parameter dtypes the card takes; and the tune
spaces of the split count and of the int8-weight tiles.  The CUDA kernels are
held to these plain versions on the card by ``chip_smoke.py``."""
import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import all_specs as jax_all_specs
from repro.configs import get_config as jax_get_config
from repro.kernels.flash_decode.ref import (
    decode_attention_ref as jax_decode_ref,
    paged_decode_attention_ref as jax_paged_ref)
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.parallel import ParallelContext
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bench.registry import get_spec
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.cost import estimate_kernel, get_profile, rank_candidates
from repro_torch.kernels.apr_matmul import ops as apr_ops
from repro_torch.kernels.flash_decode import (decode_attention_ref,
                                              decode_attention_split_ref,
                                              paged_decode_attention_ref)
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import (NEG_INF,
                                                  decode_split_states,
                                                  split_range)
from repro_torch.models import build_model
from repro_torch.models import layers as torch_layers
from repro_torch.models.registry import check_param_dtype, check_params
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

ARCH = "llama3-8b"
BF16_EPS = 2.0 ** -7   # one bf16 ulp, relative
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _np(t) -> np.ndarray:
    """A torch tensor's or a JAX array's values as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _contig(b, hq, hkv, d, s, lengths, seed, q_dtype, kv_dtype):
    rng = np.random.default_rng(seed)
    q = _both(rng.standard_normal((b, hq, d)), q_dtype)
    k = _both(rng.standard_normal((b, s, hkv, d)), kv_dtype)
    v = _both(rng.standard_normal((b, s, hkv, d)), kv_dtype)
    lens = np.asarray(lengths, np.int32)
    return ([q[0], k[0], v[0], jnp.asarray(lens)],
            [q[1], k[1], v[1], torch.from_numpy(lens)])


SPLIT_CASES = [
    # b, hq, hkv, d, s, lengths
    (3, 4, 4, 16, 70, [0, 33, 70]),       # G = 1, S not a multiple of 32
    (2, 8, 2, 32, 48, [1, 0]),            # G = 4; 8 splits: 6 are empty
    (2, 14, 2, 24, 130, [129, 5]),        # G = 7 in the kernel's G = 8
    (2, 32, 8, 64, 256, [40, 196]),       # llama3's group, serving S
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"g{c[1] // c[2]}_s{c[4]}" for c in SPLIT_CASES])
@pytest.mark.parametrize("splits", fd_ops.SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_jax_oracle(case, splits, dtype):
    """Every row, ``lengths == 0`` included (the mean of V): the split form
    against the JAX oracle and the port's unsplit plain version."""
    jargs, targs = _contig(*case, seed=splits, q_dtype=dtype,
                           kv_dtype=dtype)
    got = _np(decode_attention_split_ref(*targs, splits))
    # fp32: the same softmax summed in another order (per split, then the
    # combine); bf16: both work in fp32 and round the output once
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=BF16_EPS, atol=1e-3))
    np.testing.assert_allclose(got, _np(jax_decode_ref(*jargs)), **tol)
    np.testing.assert_allclose(got, _np(decode_attention_ref(*targs)),
                               **tol)
    b, hq, hkv, d, s, lengths = case
    empty = np.asarray(lengths) == 0
    v_mean = np.repeat(_np(targs[2]).mean(axis=1), hq // hkv, axis=1)
    np.testing.assert_allclose(got[empty], v_mean[empty], **tol)


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"g{c[1] // c[2]}_s{c[4]}" for c in SPLIT_CASES])
@pytest.mark.parametrize("splits", fd_ops.SPLITS)
def test_split_ref_fp32_q_bf16_cache_matches_jax_oracle(case, splits):
    """An fp32 q over a bf16 cache, the pair an fp32-param model gives the
    slot engine's kernel (its cache is bf16 in both packages): the split
    form in fp32 against the JAX oracle, which widens K and V to fp32, at
    fp32 tolerance; the output is fp32, q's dtype."""
    jargs, targs = _contig(*case, seed=splits, q_dtype="float32",
                           kv_dtype="bfloat16")
    got = decode_attention_split_ref(*targs, splits)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(jax_decode_ref(*jargs)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(decode_attention_ref(*targs)),
                               rtol=1e-5, atol=1e-5)


def test_split_states_of_empty_splits_and_empty_rows():
    """A split past a row's walk keeps m = -1e30, l = 0, acc = 0; every
    split of a row of length 0 has m = -1e30 and weighs each of its
    positions 1."""
    _, (q, k, v, lens) = _contig(2, 8, 2, 32, 48, [1, 0], 0, "float32",
                                 "float32")
    assert split_range(48, 8) == 32 and split_range(4096, 4) == 1024
    states = decode_split_states(q, k, v, lens, 8)
    for i, (m, l, acc) in enumerate(states):
        if i >= 1:                         # row 0 walks one position
            assert (m[0] == NEG_INF).all() and not l[0].any() \
                and not acc[0].any()
        assert (m[1] == NEG_INF).all()     # row 1: length 0
        assert (l[1] == (32 if i == 0 else 16 if i == 1 else 0)).all()


PAGED_F32_CASES = [
    # b, hq, hkv, d, ps, p_max, lengths
    (4, 8, 2, 32, 8, 4, [0, 1, 8, 9]),
    (2, 14, 2, 64, 16, 4, [64, 5]),
    (2, 32, 8, 64, 16, 3, [40, 17]),
]


@pytest.mark.parametrize("case", PAGED_F32_CASES)
def test_paged_ref_fp32_pools_bf16_q_match_jax_oracle(case):
    """A bf16 q over fp32 pools, the pair a bf16 model with
    ``kv_dtype="float32"`` gives the paged kernel: live rows equal the JAX
    oracle's at the bf16 output's tolerance, in q's dtype."""
    b, hq, hkv, d, ps, p_max, lengths = case
    rng = np.random.default_rng(7)
    need = [-(-n // ps) for n in lengths]
    p_pool = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, p_pool))
    tables = np.zeros((b, p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    qj, qt = _both(rng.standard_normal((b, hq, d)), "bfloat16")
    kj, kt = _both(rng.standard_normal((p_pool, ps, hkv, d)), "float32")
    vj, vt = _both(rng.standard_normal((p_pool, ps, hkv, d)), "float32")
    lens = np.asarray(lengths, np.int32)
    got = paged_decode_attention_ref(qt, kt, vt, torch.from_numpy(lens),
                                     torch.from_numpy(tables))
    ref = jax_paged_ref(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tables))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    live = lens > 0
    np.testing.assert_allclose(_np(got)[live], _np(ref)[live],
                               rtol=BF16_EPS, atol=1e-3)
    assert not _np(got)[~live].any()


# ------------------------------------ a bf16 model over fp32 pools, whole
@pytest.fixture(scope="module")
def bf16_smoke():
    """The JAX llama3-8b smoke bundle with bf16 params at PRNGKey(0), and
    the same params bridged to torch."""
    cfg = jax_get_config(ARCH, smoke=True)
    bundle = jax_build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          bundle.init_params(jax.random.PRNGKey(0)))
    return cfg, bundle, params, params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()})


@pytest.mark.parametrize("t", [1, 3], ids=["decode", "chunk"])
def test_attention_bf16_model_fp32_pools(bf16_smoke, t):
    """Layer 0 of a bf16 model over fp32 pools, against the JAX layer.  The
    port returns q's dtype (bf16) on every device, as the decode kernels
    do; the JAX layer promotes the attention output to fp32.  So the port
    rounds it to bf16 once before ``wo``, and the product once more: two
    bf16 roundings apart.  The pools' live pages are equal."""
    cfg, _, params, _ = bf16_smoke
    jp = {k[len("blk.0."):]: v[0] for k, v in params.items()
          if k.startswith("blk.0.")}
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    rng = np.random.default_rng(5)
    ps, hkv, dh = 4, cfg.num_kv_heads, cfg.resolved_head_dim
    kpj, kpt = _both(rng.standard_normal((7, ps, hkv, dh)), "float32")
    vpj, vpt = _both(rng.standard_normal((7, ps, hkv, dh)), "float32")
    xj, xt = _both(rng.standard_normal((2, t, cfg.d_model)), "bfloat16")
    lengths = np.array([5, 2], np.int32)
    counts = np.array([t, min(t, 2)], np.int32)
    tables = np.array([[3, 1, 0], [5, 0, 0]], np.int32)
    out_j, kpj, vpj = jax.jit(
        lambda p, *a: jax_layers.attention_decode_paged(p, "attn", cfg, *a))(
        jp, xj, kpj, vpj, jnp.asarray(lengths), jnp.asarray(counts),
        jnp.asarray(tables))
    out_t = torch_layers.attention_decode_paged(
        tp, "attn", cfg, xt, kpt, vpt, torch.from_numpy(lengths),
        torch.from_numpy(counts), torch.from_numpy(tables))
    assert out_t.dtype == torch.bfloat16 and out_j.dtype == jnp.float32
    live = np.arange(t)[None] < counts[:, None]   # padded rows are garbage
    np.testing.assert_allclose(_np(out_t)[live], _np(out_j)[live],
                               rtol=2 * BF16_EPS, atol=1e-2)
    np.testing.assert_array_equal(_np(kpt)[1:], _np(kpj)[1:])
    np.testing.assert_array_equal(_np(vpt)[1:], _np(vpj)[1:])


def test_engine_bf16_model_fp32_pools(bf16_smoke):
    """``PagedServeEngine(kv_dtype="float32")`` on a bf16 model, the
    configuration the card now serves.  The JAX engine refuses it (its
    layer scan needs the attention to keep the bf16 activations, and the
    JAX layer promotes them to fp32), so the layer test above is the
    parity check; here the port serves every request in full over fp32
    pools.  Its tokens beside the JAX engine's on bf16 pools (the same K/V
    values, attention summed at another precision) are printed, not held:
    a near-tie may flip."""
    cfg, bundle, params, tparams = bf16_smoke
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 12, 9)]
    kw = dict(slots=2, page_size=8, prefill_chunk=8)

    def serve(engine, request_cls):
        reqs = [request_cls(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        return [r.output for r in reqs]

    pctx = ParallelContext(None)
    with pytest.raises(TypeError, match="carry"):
        serve(JaxEngine(bundle, params, pctx, kv_dtype="float32", **kw),
              JaxRequest)
    ref = serve(JaxEngine(bundle, params, pctx, kv_dtype="bfloat16", **kw),
                JaxRequest)
    eng = PagedServeEngine(build_model(get_config(ARCH, smoke=True),
                                       device="cpu"),
                           tparams, device="cpu", kv_dtype="float32", **kw)
    assert eng.cache["k"].dtype == torch.float32
    got = serve(eng, Request)
    assert len(got) == len(prompts) and all(len(o) == 6 for o in got)
    assert eng.metrics.requests_done == len(prompts)
    same = sum(a == b for g, r in zip(got, ref) for a, b in zip(g, r))
    print(f"bf16 model, fp32 pools: tokens equal to the JAX engine's on "
          f"bf16 pools {same}/{sum(map(len, ref))}")


# ------------------------------------- an fp32-param model, slot engine
#: |port logits - JAX logits| of the fp32-param smoke model on the bf16
#: slot cache (tests/test_torch_slot.py's bound: a K/V value ~1e-7 apart
#: can round to a neighbouring bf16 value in the cache)
F32_SLOT_LOGITS_BOUND = 1e-2


def test_fp32_param_slot_engine_matches_jax_engine():
    """An fp32-param model on the slot engine, the configuration the card
    now serves through ``flash_decode`` with an fp32 q over the bf16 cache:
    3 ragged requests on 2 slots (the third reuses a slot), greedy tokens
    equal to the JAX slot engine's, the active slots' logits of every
    forward within F32_SLOT_LOGITS_BOUND."""
    cfg = jax_get_config(ARCH, smoke=True)
    jbundle = jax_build_model(cfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jbundle.init_params(jax.random.PRNGKey(0)))
    tparams = params_from_numpy({k: np.asarray(v)
                                 for k, v in jparams.items()})
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 12, 9)]
    logits = {"jax": [], "port": []}

    def recorded(fn, engine, store):
        def run(*a):
            out = fn(*a)
            logits = out[0] if isinstance(out, tuple) else out
            active = np.array([r is not None for r in engine.active])
            store.append(_np(logits)[active, 0])
            return out
        return run

    def serve(engine, request_cls):
        reqs = [request_cls(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        assert all(r.done for r in reqs)
        return [r.output for r in reqs]

    jeng = JaxServeEngine(jbundle, jparams, ParallelContext(None), slots=2,
                          max_seq=32)
    jeng._decode = recorded(jeng._decode, jeng, logits["jax"])
    ref = serve(jeng, JaxRequest)
    eng = ServeEngine(build_model(get_config(ARCH, smoke=True),
                                  device="cpu"), tparams, device="cpu",
                      slots=2, max_seq=32)
    assert eng.cache["k"].dtype == torch.bfloat16
    eng._decode = recorded(eng._decode, eng, logits["port"])
    assert serve(eng, Request) == ref
    assert len(logits["port"]) == len(logits["jax"]) > 6
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(logits["port"], logits["jax"]) if a.size)
    assert diff <= F32_SLOT_LOGITS_BOUND, diff


# ------------------------------------------------ the kernels' dtype table
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
#: per kernel family: its wrapper module, its CUDA source, and the (first,
#: second operand) dtypes -- (q, K/V) or (x, weight) -- each entry point of
#: the source takes for it
COMPILED_PAIRS = {
    "flash_decode_paged": (fd_ops, "flash_decode.cu", {
        "flash_decode_paged_bf16": [(BF16, BF16), (F32, BF16)],
        "flash_decode_paged_int8": [(BF16, I8), (F32, I8)],
        "flash_decode_paged_f32": [(BF16, F32), (F32, F32)]}),
    "flash_decode": (fd_ops, "flash_decode.cu", {
        "flash_decode_bf16": [(BF16, BF16), (F32, BF16)],
        "flash_decode_f32": [(BF16, F32), (F32, F32)]}),
    "apr_matmul": (apr_ops, "apr_matmul.cu", {
        "apr_matmul_bf16": [(BF16, BF16)],
        "apr_matmul_int8w": [(BF16, I8)],
        "apr_matmul_f32": [(F32, F32)],
        "apr_matmul_f32_int8w": [(F32, I8)]}),
    "apr_matmul_fused": (apr_ops, "apr_matmul.cu", {
        "apr_matmul_bf16": [(BF16, BF16)],
        "apr_matmul_f32": [(F32, F32)]}),
}
DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8]


@pytest.mark.parametrize("name", sorted(COMPILED_PAIRS))
def test_dtype_table_accepts_exactly_the_compiled_pairs(name):
    ops, source, entries = COMPILED_PAIRS[name]
    src = (CSRC / source).read_text()
    for fn in entries:                    # each entry point exists and binds
        assert re.search(r'extern "C" int ' + fn + r"\(", src), fn
        assert fn in ops.SIGNATURES
    compiled = {p for pairs in entries.values() for p in pairs}
    assert ops.KERNEL_DTYPES[name] == compiled
    for pair in itertools.product(DTYPES, DTYPES):
        if pair in compiled:
            ops.check_dtypes(name, *pair)
        else:
            with pytest.raises(TypeError, match=str(pair[1])):
                ops.check_dtypes(name, *pair)


# ------------------------------------------------ fp32 params on the card
@pytest.mark.parametrize("dtype", ["float32", torch.float32, torch.float16])
def test_fp32_params_are_refused_on_the_card(dtype):
    """fp32 parameters run on the card (``apr_matmul_f32``); fp16 ones,
    which no kernel takes, are still refused there.  Both run on the
    CPU."""
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="no apr_matmul kernel"):
            check_param_dtype(dtype, "cuda")
    else:
        check_param_dtype(dtype, "cuda")
    check_param_dtype(dtype, "cpu")       # the CPU path takes them
    check_param_dtype("bfloat16", "cuda")
    check_param_dtype(torch.bfloat16, "cuda")


def test_engines_check_every_float_param():
    params = {"embed": torch.zeros(4, 2, dtype=torch.bfloat16),
              "w": torch.zeros(2, 2, dtype=torch.bfloat16),
              "pos": torch.zeros(3, dtype=torch.int32)}
    check_params(params, "cuda")
    params["norm"] = torch.zeros(2, dtype=torch.float32)
    check_params(params, "cuda")
    params["half"] = torch.zeros(2, dtype=torch.float16)
    check_params(params, "cpu")
    with pytest.raises(ValueError, match="no apr_matmul kernel"):
        check_params(params, "cuda")


# ------------------------------------------------------------ tune spaces
DECODE_SHAPE = {"b": 4, "hq": 32, "hkv": 8, "d": 128, "s": 256}
INT8W_SHAPES = [{"m": 4, "k": 4096, "n": 1024, "w_int8": 1},
                {"m": 16, "k": 14336, "n": 4096, "w_int8": 1},
                {"m": 4, "k": 4096, "n": 14336, "w_int8": 1}]


def test_split_counts_enumerate_and_price():
    spec = get_spec("flash_decode")
    cands = spec.candidates(DECODE_SHAPE)
    assert sorted(c["splits"] for c in cands) == list(fd_ops.SPLITS)
    assert all(c["chunk"] == 32 for c in cands)
    assert set(cands) == set(fd_ops.compiled_configs())
    # the default: 4 x 8 rows x heads, 8 splits put 256 blocks on 132 SMs
    assert spec.default_config(DECODE_SHAPE)["splits"] == 8
    assert fd_ops.default_splits(8, 4096) == 8
    assert fd_ops.default_splits(8, 40) == 2           # two 32-token steps
    # the batch never enters: 64 rows take the count of 4
    assert fd_ops.resolve_splits(64, 32, 8, 128, 4096, "bfloat16",
                                 "cuda") == 8
    # the JAX package's key, unchanged
    assert spec.shape_key(DECODE_SHAPE) == \
        jax_all_specs()["flash_decode"].shape_key(DECODE_SHAPE)
    for prof in ("h100_sxm", "cpu"):
        ranked = rank_candidates(spec, DECODE_SHAPE, cands,
                                 profile=get_profile(prof), dtype="bfloat16")
        assert len(ranked) == len(cands)
        assert all(est.predicted_s > 0 for _, est in ranked)


@pytest.mark.parametrize("shape", INT8W_SHAPES,
                         ids=[f"k{s['k']}_n{s['n']}" for s in INT8W_SHAPES])
def test_int8_weight_tiles_enumerate_and_price(shape):
    spec = get_spec("apr_matmul")
    cands = spec.candidates(shape)
    tiles = {(c["block_m"], c["block_n"], c["block_k"]) for c in cands}
    assert tiles == set(apr_ops.INT8W_TILES)
    default = spec.default_config(shape)
    assert (default["block_m"], default["block_n"], default["block_k"]) \
        in apr_ops.INT8W_TILES
    assert (default["block_n"], default["block_k"]) == (
        {1024: 16, 4096: 32, 14336: 64}[shape["n"]], 128)
    # its own key: the bf16 kernel's key with a suffix no JAX key carries
    plain = {k: v for k, v in shape.items() if k != "w_int8"}
    assert spec.shape_key(shape) == spec.shape_key(plain) + "_wint8"
    assert spec.shape_key(plain) == jax_all_specs()["apr_matmul"].shape_key(
        plain)
    ests = [estimate_kernel(spec, shape, cfg, profile=get_profile(
        "h100_sxm"), dtype="bfloat16") for cfg in cands]
    for cfg, est in zip(cands, ests):
        assert est.vmem_ok and est.vmem_bytes <= 48 * 1024
        # the weight streams at one byte per element, half the bf16 bytes
        assert est.hbm_bytes < spec.hbm_bytes(plain, cfg, "bfloat16")
    # the activations count once (the L2 serves the column blocks), so at
    # M <= 16 every tile moves the same bytes
    assert len({est.hbm_bytes for est in ests}) == 1
