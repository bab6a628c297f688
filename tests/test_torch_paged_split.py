"""Port parity, the paged decode kernels' split form and the wrappers'
per-parameter kwargs: the plain split-then-combine version of the paged
kernels (``paged_decode_attention_split_ref``) at every split count
against the JAX package's Pallas paged kernel (interpret mode) and the
port's unsplit ``paged_decode_attention_ref``, over bf16, fp32 and int8
pools, fp32 pools under a bf16 q and bf16 and int8 pools under an fp32 q,
with lengths {0, 1, ps-1, ps, ps+1, full}, shuffled tables and
out-of-pool entries past the length; its split states; an fp32-param
model served by the paged engine on bf16 and int8 pools, and with int8
weights on fp32 pools, beside the JAX engine; the paged tune space of
split counts; the ``block_m/n/k`` and ``chunk`` kwargs; and
``ConfigCache.entries()``/``keys_for_kernel()`` against the JAX
package's.  The CUDA kernels are held to these plain versions on the card
by ``chip_smoke.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import all_specs as jax_all_specs
from repro.configs import get_config as jax_get_config
from repro.bench.config import BlockConfig as JaxBlockConfig
from repro.bench.config import ConfigCache as JaxConfigCache
from repro.kernels.apr_matmul import apr_matmul as jax_apr_matmul
from repro.kernels.flash_decode import flash_decode_paged as jax_flash_paged
from repro.models import build_model as jax_build_model
from repro.parallel import ParallelContext
from repro.quant import QuantizedTensor as JaxQT
from repro.quant import quantize_params as jax_quantize_params
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.bench import BlockConfig, ConfigCache, TileError
from repro_torch.bench.config import pin_config
from repro_torch.bench.registry import get_spec
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.apr_matmul import apr_matmul, apr_matmul_fused
from repro_torch.kernels.apr_matmul import matmul_fused_ref, matmul_ref
from repro_torch.kernels.apr_matmul import ops as apr_ops
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged,
                                              paged_decode_attention_q_ref,
                                              paged_decode_attention_ref,
                                              paged_decode_attention_split_ref)
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import build_model
from repro_torch.serve import PagedServeEngine, Request
from repro_torch.kernels.flash_decode.ref import (NEG_INF,
                                                  combine_split_states,
                                                  paged_decode_split_states,
                                                  split_range)

BF16_EPS = 2.0 ** -7   # one bf16 ulp, relative
#: int8 pools against the plain version that rounds the dequantized K/V to
#: bf16 (the JAX oracle's rounding; the kernels keep them fp32): one bf16
#: ulp of the output plus 0.03, chip_smoke.py's bound for B2q
Q_ATOL = 0.03


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


PAGED_CASES = [
    # b, hq, hkv, d, ps, p_max, lengths: 0, 1, ps-1, ps, ps+1, full
    (6, 8, 2, 32, 8, 8, [0, 1, 7, 8, 9, 64]),
    (3, 6, 2, 16, 5, 8, [40, 0, 6]),       # G = 3 in G = 4; pages of 5
    (2, 32, 8, 64, 16, 8, [128, 70]),      # llama3's group, pages of 16
]
#: (q dtype, pool dtype): bf16 pools, fp32 pools under an fp32 and a bf16
#: q, int8 pools with fp32 scales, and an fp32 q (an fp32-param model) over
#: bf16 and int8 pools
KINDS = [("bfloat16", "bfloat16"), ("float32", "float32"),
         ("bfloat16", "float32"), ("bfloat16", "int8"),
         ("float32", "bfloat16"), ("float32", "int8")]
KIND_IDS = ["bf16", "fp32", "fp32pools_bf16q", "int8", "bf16pools_fp32q",
            "int8_fp32q"]
DEAD = 99   # added to the pool size: an entry outside the pool


@functools.lru_cache(maxsize=None)
def _case(ci: int, kind: int):
    """Inputs of PAGED_CASES[ci] as KINDS[kind], for JAX and torch: pages
    shuffled across the pool, the table padded with the null page 0 past
    each row's pages, and (``dead``) the same table with those padding
    entries outside the pool (-1 and p_pool + DEAD, alternately)."""
    b, hq, hkv, d, ps, p_max, lengths = PAGED_CASES[ci]
    q_dtype, kv_dtype = KINDS[kind]
    rng = np.random.default_rng(100 * ci + kind)
    need = [-(-n // ps) for n in lengths]
    p_pool = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, p_pool))
    tables = np.zeros((b, p_max), np.int32)
    dead = np.zeros((b, p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = dead[i, :n] = perm[at:at + n]
        dead[i, n:] = [-1 if j % 2 else p_pool + DEAD
                       for j in range(p_max - n)]
        at += n
    qj, qt = _both(rng.standard_normal((b, hq, d)), q_dtype)
    pools = [rng.standard_normal((p_pool, ps, hkv, d)) for _ in range(2)]
    lens = np.asarray(lengths, np.int32)
    common = dict(lengths=(jnp.asarray(lens), torch.from_numpy(lens)),
                  tables=(jnp.asarray(tables), torch.from_numpy(tables)),
                  dead=torch.from_numpy(dead), q=(qj, qt))
    if kv_dtype == "int8":
        scales = [np.abs(rng.standard_normal((p_pool, ps, hkv))) / 127 + 1e-3
                  for _ in range(2)]
        codes = [np.clip(np.round(p / np.abs(p).max(-1, keepdims=True)
                                  * 127), -127, 127).astype(np.int8)
                 for p in pools]
        return dict(common, k=(jnp.asarray(codes[0]),
                               torch.from_numpy(codes[0])),
                    v=(jnp.asarray(codes[1]), torch.from_numpy(codes[1])),
                    ks=(jnp.asarray(scales[0], jnp.float32),
                        torch.from_numpy(scales[0].astype(np.float32))),
                    vs=(jnp.asarray(scales[1], jnp.float32),
                        torch.from_numpy(scales[1].astype(np.float32))))
    return dict(common, k=_both(pools[0], kv_dtype),
                v=_both(pools[1], kv_dtype))


@functools.lru_cache(maxsize=None)
def _pallas(ci: int, kind: int) -> np.ndarray:
    """The JAX Pallas paged kernel (interpret mode) on the case."""
    c = _case(ci, kind)
    kw = ({"k_scales": c["ks"][0], "v_scales": c["vs"][0]} if "ks" in c
          else {})
    out = jax_flash_paged(c["q"][0], c["k"][0], c["v"][0], c["lengths"][0],
                          c["tables"][0], chunk=PAGED_CASES[ci][4], **kw)
    assert out.dtype == c["q"][0].dtype
    return _np(out)


def _split(c, splits, tables):
    kw = ({"k_scales": c["ks"][1], "v_scales": c["vs"][1]} if "ks" in c
          else {})
    return paged_decode_attention_split_ref(
        c["q"][1], c["k"][1], c["v"][1], c["lengths"][1], tables, splits,
        **kw)


def _tol(c):
    if c["q"][1].dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5)
    # both work in fp32 and round the output to bf16 once
    return dict(rtol=BF16_EPS, atol=1e-3)


@pytest.mark.parametrize("splits", fd_ops.SPLITS)
@pytest.mark.parametrize("kind", range(len(KINDS)), ids=KIND_IDS)
@pytest.mark.parametrize("ci", range(len(PAGED_CASES)),
                         ids=[f"g{c[1] // c[2]}_ps{c[4]}"
                              for c in PAGED_CASES])
def test_paged_split_ref_matches_pallas_and_unsplit(ci, kind, splits):
    """Every row at every split count: the split form against the Pallas
    paged kernel and the port's unsplit plain version, on a shuffled
    table; the same table with out-of-pool entries past each row's length
    gives the same bits; rows of length 0 are exactly zero, as in the
    Pallas kernel (the JAX oracle gives the mean of V there)."""
    c = _case(ci, kind)
    got = _split(c, splits, c["tables"][1])
    assert got.dtype == c["q"][1].dtype
    tol = _tol(c)
    np.testing.assert_allclose(_np(got), _pallas(ci, kind), **tol)
    q, k, v = c["q"][1], c["k"][1], c["v"][1]
    lens, tables = c["lengths"][1], c["tables"][1]
    if "ks" in c:
        # the unsplit plain version on the fp32-dequantized pools, and the
        # JAX oracle's bf16-rounded dequantize (chip_smoke.py's B2q bound)
        ks, vs = c["ks"][1], c["vs"][1]
        ref32 = paged_decode_attention_ref(
            q.float(), k.float() * ks[..., None], v.float() * vs[..., None],
            lens, tables).to(q.dtype)
        np.testing.assert_allclose(_np(got), _np(ref32), **tol)
        ref_q = _np(paged_decode_attention_q_ref(q, k, v, ks, vs, lens,
                                                 tables))
        assert (np.abs(_np(got) - ref_q)
                <= BF16_EPS * np.abs(ref_q) + Q_ATOL).all()
    else:
        np.testing.assert_allclose(
            _np(got), _np(paged_decode_attention_ref(q, k, v, lens, tables)),
            **tol)
    assert torch.equal(_split(c, splits, c["dead"]), got)
    if "ks" not in c:                    # the unsplit version alike
        assert torch.equal(
            paged_decode_attention_ref(q, k, v, lens, c["dead"]),
            paged_decode_attention_ref(q, k, v, lens, tables))
    empty = np.asarray(PAGED_CASES[ci][6]) == 0
    assert not _np(got)[empty].any() and not _pallas(ci, kind)[empty].any()


def test_paged_split_states_of_dead_splits_and_empty_rows():
    """A split past a row's walk, and every split of a row of length 0,
    keep m = -1e30, l = 0, acc = 0 (a paged row weighs no position it does
    not walk, unlike the contiguous kernel's empty rows), so the combine
    gives exact zeros there; an entry outside the pool inside the walk
    takes its page's positions out of the softmax."""
    c = _case(0, 1)                      # fp32
    q, k, v = c["q"][1], c["k"][1], c["v"][1]
    lens, tables = c["lengths"][1], c["tables"][1]
    assert lens.tolist() == [0, 1, 7, 8, 9, 64]
    assert split_range(64, 8) == 32 and split_range(64, 1) == 64
    states = paged_decode_split_states(q, k, v, lens, tables, 8)
    for i, (m, l, acc) in enumerate(states):
        for row, n in enumerate(lens.tolist()):
            if n <= 32 * i:              # the walk ends before the split
                assert (m[row] == NEG_INF).all() and not l[row].any() \
                    and not acc[row].any(), (i, row)
            else:
                assert (l[row] >= 1).all(), (i, row)
    out = combine_split_states(states)
    assert not out[0].any() and (out[1:].abs().sum(-1) > 0).all()
    # row 5's second page outside the pool: the attention over its other
    # 56 positions (packed into a table of seven pages)
    dead = tables.clone()
    dead[5, 1] = k.shape[0] + DEAD
    packed, lens56 = tables.clone(), lens.clone()
    packed[5] = torch.cat([tables[5, :1], tables[5, 2:], tables[5, :1] * 0])
    lens56[5] = 56
    np.testing.assert_allclose(
        _np(paged_decode_attention_split_ref(q, k, v, lens, dead, 2)),
        _np(paged_decode_attention_ref(q, k, v, lens56, packed)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------- an fp32-param model, paged engine
#: |port logits - JAX logits| of the fp32-param smoke model on bf16 or int8
#: pools: both compute in fp32, but a K/V value written ~1e-7 apart can
#: round to a neighbouring bf16 value (or int8 code) in the pools, one in
#: a few thousand, which moves O(1) logits by up to ~1e-3 (the slot
#: cache's bound in tests/test_torch_slot.py)
F32_PARAM_LOGITS_BOUND = 1e-2


@pytest.fixture(scope="module")
def fp32_params():
    """The JAX smoke bundle with its PRNGKey(0) params in fp32, plain and
    int8-quantized (``quantize_params``), and both bridged to torch."""
    cfg = jax_get_config("llama3-8b", smoke=True)
    bundle = jax_build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          bundle.init_params(jax.random.PRNGKey(0)))
    qparams = jax_quantize_params(params)
    bridged = {name: params_from_numpy({
        k: (np.asarray(v.q), np.asarray(v.scale)) if isinstance(v, JaxQT)
        else np.asarray(v) for k, v in p.items()})
        for name, p in (("fp32", params), ("int8", qparams))}
    return bundle, {"fp32": params, "int8": qparams}, bridged


def _decode_logits(store):
    """A recorder of the live rows' logits of every decode tick (T = 1) of
    a ``decode_paged``-shaped call (params, cache, tokens, lengths,
    counts, tables)."""
    def record(fn):
        def run(*a):
            out = fn(*a)
            logits = out[0] if isinstance(out, tuple) else out
            if logits.shape[1] == 1:
                live = np.asarray(a[4]) > 0
                store.append(_np(logits)[live, 0])
            return out
        return run
    return record


@pytest.mark.parametrize("weights,kv_dtype", [("fp32", "bfloat16"),
                                              ("fp32", "int8"),
                                              ("int8", "float32")])
def test_fp32_param_engine_matches_jax_engine(fp32_params, weights,
                                              kv_dtype):
    """The configurations an fp32-param model serves in on the card: 3
    ragged requests on 2 slots through the port's ``PagedServeEngine`` and
    the JAX one, fp32 activations over bf16 or int8 pools, or over int8
    weights (fp32 pools): greedy tokens equal, every decode tick's live
    logits within F32_PARAM_LOGITS_BOUND."""
    jbundle, jparams, tparams = fp32_params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 12, 9)]
    kw = dict(slots=2, page_size=8, prefill_chunk=8, kv_dtype=kv_dtype)
    logits = {"jax": [], "port": []}

    def serve(engine, request_cls):
        reqs = [request_cls(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        assert all(r.done for r in reqs)
        return [r.output for r in reqs]

    jeng = JaxEngine(jbundle, jparams[weights], ParallelContext(None), **kw)
    jeng._decode_step = _decode_logits(logits["jax"])(jeng._decode_step)
    ref = serve(jeng, JaxRequest)
    bundle = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    bundle.decode_paged = _decode_logits(logits["port"])(bundle.decode_paged)
    eng = PagedServeEngine(bundle, tparams[weights], device="cpu", **kw)
    assert eng.cache["k"].dtype == getattr(torch, kv_dtype)
    got = serve(eng, Request)
    assert got == ref
    assert len(logits["port"]) == len(logits["jax"]) >= 5
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(logits["port"], logits["jax"]))
    assert diff <= F32_PARAM_LOGITS_BOUND, diff


# ------------------------------------------------------------ tune space
PAGED_SHAPE = {"b": 4, "hq": 32, "hkv": 8, "d": 128, "pages": 16, "ps": 16}


@pytest.mark.parametrize("kv_int8", [0, 1], ids=["bf16", "int8"])
def test_paged_split_counts_enumerate_and_default(kv_int8):
    shape = {**PAGED_SHAPE, "kv_int8": kv_int8}
    spec = get_spec("flash_decode_paged")
    cands = spec.candidates(shape)
    assert sorted(c["splits"] for c in cands) == list(fd_ops.SPLITS)
    assert all(c["chunk"] == 32 for c in cands)
    assert set(cands) == set(fd_ops.compiled_configs())
    # the spec's default is the split count the wrapper takes untuned: 4
    # rows x 8 kv heads, 8 splits put 256 blocks on 132 SMs
    default = spec.default_config(shape)
    assert default["splits"] == fd_ops.resolve_paged_splits(
        4, 32, 8, 128, 16, 16, bool(kv_int8), "bfloat16", "cuda") == 8
    assert fd_ops.paged_default_config(4, 32, 8, 128, 2, 16)["splits"] == 1
    # the JAX package's key, _kvint8 for int8 pools
    assert spec.shape_key(shape) == \
        jax_all_specs()["flash_decode_paged"].shape_key(shape)
    assert spec.shape_key(shape).endswith("_kvint8") == bool(kv_int8)


def test_default_splits_weigh_the_cache_bytes():
    """bf16 and int8 caches aim at two blocks a SM, fp32 ones at one to
    every two SMs; both wrappers resolve the default of their cache's
    bytes, under the same key."""
    # the batch never enters: every B takes the count of 4 rows
    assert [fd_ops.resolve_paged_splits(b, 32, 8, 128, 16, 16, False,
                                        "bfloat16", "cuda")
            for b in (1, 4, 8, 16, 64)] == [8, 8, 8, 8, 8]
    assert fd_ops.default_splits(8, 256, 1) == 8
    assert [fd_ops.resolve_paged_splits(b, 32, 8, 128, 16, 16, False,
                                        "bfloat16", "cuda", kv_bytes=4)
            for b in (1, 2, 4, 8)] == [2, 2, 2, 2]
    assert fd_ops.default_splits(8, 40, 4) == 2        # two 32-token steps
    assert fd_ops.resolve_paged_splits(4, 32, 8, 128, 16, 16, False,
                                       "bfloat16", "cuda", kv_bytes=4) == 2
    assert fd_ops.resolve_paged_splits(4, 32, 8, 128, 16, 16, True,
                                       "bfloat16", "cuda", kv_bytes=1) == 8
    assert fd_ops.resolve_splits(4, 32, 8, 128, 256, "bfloat16", "cuda",
                                 kv_bytes=4) == 2
    assert fd_ops.resolve_splits(4, 32, 8, 128, 256, "float32", "cuda",
                                 kv_bytes=4) == 2


# ---------------------------------------------------------- kwargs, cache
@pytest.mark.parametrize("blocks", [(128, 128, 128), (64, 128, 128),
                                   (128, 128, 256)])
def test_matmul_block_kwargs_as_the_jax_tests_pass_them(blocks):
    """``apr_matmul(x, y, block_m=, block_n=, block_k=)`` as
    ``tests/test_kernels_matmul.py`` calls the JAX wrapper: on the CPU the
    plain version, equal to the JAX kernel's result; on the card such a
    tile (none is compiled) is refused before any launch."""
    bm, bn, bk = blocks
    rng = np.random.default_rng(bm + bk)
    xj, xt = _both(rng.standard_normal((64, 256)), "float32")
    yj, yt = _both(rng.standard_normal((256, 128)), "float32")
    got = apr_matmul(xt, yt, block_m=bm, block_n=bn, block_k=bk)
    assert torch.equal(got, matmul_ref(xt, yt))
    ref = jax_apr_matmul(xj, yj, block_m=bm, block_n=bn, block_k=bk)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-4)
    fused = apr_matmul_fused(xt, yt, None, block_m=bm, block_n=bn,
                             block_k=bk, activation="silu")
    assert torch.equal(fused, matmul_fused_ref(xt, yt, None, "silu"))
    cfg = pin_config(None, block_m=bm, block_n=bn, block_k=bk)
    for dtype in ("bfloat16", "float32"):
        with pytest.raises(TileError):
            apr_ops.resolve_tile("apr_matmul", 64, 256, 128, dtype, "cuda",
                                 config=cfg)
    with pytest.raises(ValueError):       # TileError is a ValueError
        apr_ops.resolve_f32("apr_matmul", 64, 256, 128, cfg)


def test_kwargs_pin_the_config():
    """A kwarg overrides the same key of ``config`` and of the default, as
    in the JAX wrappers (``resolve_config(explicit=...)``); a value no
    kernel is compiled for raises ``TileError``."""
    assert pin_config(None) is None
    base = BlockConfig.make(block_m=16, block_n=64, block_k=64)
    assert pin_config(base, block_k=None) is base
    assert apr_ops.resolve_tile("apr_matmul", 4, 4096, 4096, "bfloat16",
                                "cuda", config=pin_config(
                                    base, block_k=128)) == (16, 64, 128)
    assert apr_ops.resolve_tile("apr_matmul_fused", 4, 4096, 4096,
                                "bfloat16", "cuda", config=pin_config(
                                    None, block_m=32)) == (32, 64, 64)
    assert apr_ops.resolve_f32("apr_matmul_fused", 4, 96, 40, pin_config(
        None, block_m=16, block_n=64, block_k=64)) == BlockConfig.make(
            block_m=16, block_n=64, block_k=64, splits=1)
    assert apr_ops.resolve_f32("apr_matmul", 4, 4096, 1024, pin_config(
        None, splits=2, block_k=32)) == BlockConfig.make(
            block_m=16, block_n=64, block_k=32, splits=2)
    with pytest.raises(TileError):          # not an fp32-body tile
        apr_ops.resolve_f32("apr_matmul", 4, 96, 40,
                            pin_config(None, block_n=32, block_k=8))
    with pytest.raises(TileError):
        apr_ops.resolve_f32("apr_matmul", 4, 96, 40,
                            pin_config(None, splits=3))
    two = fd_ops.COMPILED.replace(splits=2)
    assert fd_ops.resolve_splits(4, 32, 8, 128, 256, "bfloat16", "cuda",
                                 pin_config(two, chunk=32)) == 2
    assert fd_ops.resolve_paged_splits(4, 32, 8, 128, 16, 16, True,
                                       "bfloat16", "cuda",
                                       pin_config(two, chunk=32)) == 2
    for chunk in (16, 512):              # the JAX wrappers' defaults
        with pytest.raises(TileError):
            fd_ops.resolve_splits(4, 32, 8, 128, 256, "bfloat16", "cuda",
                                  pin_config(None, chunk=chunk))
        with pytest.raises(TileError):
            fd_ops.resolve_paged_splits(4, 32, 8, 128, 16, 16, False,
                                        "bfloat16", "cuda",
                                        pin_config(two, chunk=chunk))


def test_decode_chunk_kwargs_on_the_cpu():
    """``chunk=`` as the JAX wrappers take it: the CPU path is the plain
    version whatever the chunk."""
    c = _case(0, 0)
    args = (c["q"][1], c["k"][1], c["v"][1], c["lengths"][1],
            c["tables"][1])
    assert torch.equal(flash_decode_paged(*args, chunk=8),
                       paged_decode_attention_ref(*args))
    q = c["q"][1]
    kc = torch.randn(6, 40, 2, 32).to(torch.bfloat16)
    lens = torch.tensor([0, 1, 7, 8, 9, 40], dtype=torch.int32)
    assert torch.equal(flash_decode(q, kc, kc, lens, chunk=40),
                       flash_decode(q, kc, kc, lens))


def test_config_cache_entries_match_jax(tmp_path):
    """``entries()`` and ``keys_for_kernel()`` on a file written by the
    port, read by both packages' caches."""
    path = tmp_path / "cache.json"
    ours = ConfigCache(path)
    stored = [("flash_decode_paged", fd_ops.paged_shape_key(
                   4, 32, 8, 128, 16, 16), {"chunk": 32, "splits": 8}),
              ("flash_decode_paged", fd_ops.paged_shape_key(
                   4, 32, 8, 128, 16, 16, True), {"chunk": 32, "splits": 4}),
              ("apr_matmul", apr_ops.shape_key(4, 4096, 4096),
               {"block_m": 16, "block_n": 64, "block_k": 128})]
    for kernel, key, cfg in stored:
        ours.store(kernel, key, "bfloat16", "cuda", BlockConfig.make(**cfg),
                   metrics={"us": 1.0})
    theirs = JaxConfigCache(path)
    assert ours.entries() == theirs.entries()
    assert len(ours.entries()) == len(stored)
    for kernel in ("flash_decode_paged", "apr_matmul", "flash_decode"):
        assert sorted(ours.keys_for_kernel(kernel)) == \
            sorted(theirs.keys_for_kernel(kernel))
    assert len(ours.keys_for_kernel("flash_decode_paged")) == 2
    assert ours.keys_for_kernel("flash_decode") == []
    # a copy: changing it leaves the cache alone
    ours.entries().clear()
    assert len(ours) == len(stored)
    assert JaxBlockConfig.make(**theirs.lookup(
        "flash_decode_paged", stored[1][1], "bfloat16", "cuda").to_dict()
    ) == JaxBlockConfig.make(chunk=32, splits=4)
