"""Port parity, the tuning layer (``repro_torch.bench``): the CPU cases of
the JAX package's ``tests/test_autotune.py`` on the port -- BlockConfig,
the cache round trip, resolution priority, the correctness gate, a smoke
sweep whose winner the wrappers pick up, nested scopes, two engines' caches
side by side -- and the port held to the JAX package: the same cache keys,
a JAX-written cache file resolving alike, the same family names, and the
same FLOP and (at float32) traffic models."""
import json

import numpy as np
import pytest
import torch

from repro.bench import ConfigCache as JaxConfigCache
from repro.bench import all_specs as jax_all_specs
from repro.bench.config import cache_key as jax_cache_key
from repro.kernels.apr_conv import ops as jax_conv_ops
from repro.kernels.apr_matmul import ops as jax_matmul_ops
from repro.kernels.flash_decode import ops as jax_decode_ops
from repro.kernels.mamba2 import ops as jax_mamba_ops
from repro.kernels.quant_matmul import ops as jax_qmm_ops
from repro.kernels.rwkv6 import ops as jax_rwkv_ops
from repro_torch.bench import (BlockConfig, ConfigCache, TileError,
                               all_specs, autotune, get_spec, resolve_config,
                               scoped_cache, set_default_cache, warm_cache)
from repro_torch.bench.config import (active_cache, cache_key,
                                      default_cache, resolve_cached)
from repro_torch.bench.registry import KernelSpec, TuneSpace
from repro_torch.kernels.apr_conv import ops as conv_ops
from repro_torch.kernels.apr_matmul import apr_matmul, matmul_ref
from repro_torch.kernels.apr_matmul import ops as matmul_ops
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.kernels.mamba2 import ops as mamba_ops
from repro_torch.kernels.quant_matmul import ops as qmm_ops
from repro_torch.kernels.rwkv6 import ops as rwkv_ops

#: benchmarks/bench_kernels.py's quick suite (SUITES["quick"])
QUICK = {
    "apr_matmul": [{"m": 64, "k": 128, "n": 64}],
    "apr_matmul_fused": [{"m": 64, "k": 128, "n": 64}],
    "quant_matmul": [{"m": 64, "k": 128, "n": 64}],
    "quant_matmul_fused": [{"m": 64, "k": 128, "n": 64}],
    "apr_conv": [{"b": 1, "h": 8, "w": 8, "c": 4, "hf": 3, "wf": 3,
                  "m": 8, "stride": 1, "padding": 1}],
    "apr_conv_fused": [{"b": 1, "h": 8, "w": 8, "c": 4, "hf": 3, "wf": 3,
                        "m": 8, "stride": 1, "padding": 1}],
    "flash_decode": [{"b": 2, "hq": 4, "hkv": 2, "d": 32, "s": 128}],
    "flash_decode_paged": [{"b": 2, "hq": 4, "hkv": 2, "d": 32,
                            "pages": 4, "ps": 32},
                           {"b": 2, "hq": 4, "hkv": 2, "d": 32,
                            "pages": 4, "ps": 32, "kv_int8": 1}],
    "mamba2": [{"b": 1, "t": 32, "h": 2, "p": 8, "n": 8}],
    "rwkv6": [{"b": 1, "t": 32, "h": 2, "d": 8}],
}
QUICK_CASES = [(name, shape) for name, shapes in QUICK.items()
               for shape in shapes]


@pytest.fixture
def cache(tmp_path):
    c = ConfigCache(tmp_path / "tune_cache.json")
    set_default_cache(c)
    yield c
    set_default_cache(None)  # restore the env-derived default


@pytest.fixture(autouse=True)
def _isolated_default(tmp_path, monkeypatch):
    """The default caches of both packages in temp files."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                       str(tmp_path / "default.json"))
    set_default_cache(None)
    yield
    set_default_cache(None)


class TestBlockConfig:
    def test_make_is_order_insensitive_and_hashable(self):
        a = BlockConfig.make(block_m=64, block_k=128)
        b = BlockConfig.make(block_k=128, block_m=64)
        assert a == b and hash(a) == hash(b)
        assert a["block_m"] == 64 and a.get("missing") is None

    def test_replace_merges(self):
        a = BlockConfig.make(block_m=64, block_k=128)
        b = a.replace(block_m=256, chunk=32)
        assert b.to_dict() == {"block_m": 256, "block_k": 128, "chunk": 32}


class TestCacheRoundTrip:
    def test_write_read_same_config(self, cache, tmp_path):
        cfg = BlockConfig.make(block_m=16, block_n=64, block_k=128)
        cache.store("apr_matmul", "k128_m64_n64", "float32", "cpu", cfg,
                    metrics={"us": 12.5})
        reloaded = ConfigCache(tmp_path / "tune_cache.json")
        assert reloaded.lookup("apr_matmul", "k128_m64_n64", "float32",
                               "cpu") == cfg
        assert reloaded.lookup("apr_matmul", "k128_m64_n64", "float32",
                               "cuda") is None
        raw = json.loads((tmp_path / "tune_cache.json").read_text())
        assert raw["version"] == 1
        entry = raw["entries"]["apr_matmul|k128_m64_n64|float32|cpu"]
        assert entry["config"] == cfg.to_dict()
        assert entry["metrics"]["us"] == 12.5

    def test_resolve_priority(self, cache):
        default = BlockConfig.make(block_m=128, block_n=128)
        args = ("apr_matmul", "key", "float32", "cpu")
        assert resolve_config(*args, default=default)["block_m"] == 128
        cache.store(*args, BlockConfig.make(block_m=64))
        assert resolve_config(*args, default=default)["block_m"] == 64
        got = resolve_config(*args, default=default,
                             explicit={"block_m": 256, "block_n": None})
        assert got["block_m"] == 256 and got["block_n"] == 128

    def test_memoized_resolution_follows_the_cache(self, cache):
        """resolve_cached memoizes per cache and forgets on every store."""
        calls = []

        def key(*dims):
            calls.append(dims)
            return "k"

        default = BlockConfig.make(block_m=16)
        got = [resolve_cached("fam", (1, 2), "bfloat16", "cuda",
                              shape_key=key, default=lambda *d: default)
               for _ in range(3)]
        assert got == [default] * 3 and len(calls) == 1
        cache.store("fam", "k", "bfloat16", "cuda",
                    BlockConfig.make(block_m=32))
        assert resolve_cached("fam", (1, 2), "bfloat16", "cuda",
                              shape_key=key,
                              default=lambda *d: default)["block_m"] == 32
        assert len(calls) == 2

    def test_default_path_is_the_ports_own(self, monkeypatch):
        monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
        monkeypatch.setenv("REPRO_TUNE_CACHE", "/nonexistent/jax.json")
        path = ConfigCache().path
        assert path.name == "tune_cache.json"
        assert path.parent.name == "_tune"
        assert path.parent.parent.name == "repro_torch"
        assert ".cache" not in path.parts


def _broken_matmul_spec():
    """A spec where one candidate computes wrong numbers and one is
    refused by the wrapper."""
    base = get_spec("apr_matmul")

    def run(args, cfg):
        if cfg["block_m"] == 7:
            raise TileError("not compiled")
        out = apr_matmul(args[0], args[1])
        if cfg["block_m"] == 13:
            out = out + 1.0  # deliberately-wrong candidate
        return out

    return KernelSpec(
        name="broken_matmul",
        make_inputs=base.make_inputs,
        run=run,
        ref=lambda args: matmul_ref(args[0], args[1]),
        tune_space=lambda shape: TuneSpace.make(block_m=(13, 7, 128)),
        default_config=base.default_config,
        shape_key=base.shape_key,
        flops=base.flops,
        hbm_bytes=lambda shape, cfg, dtype="float32": 0,
        rtol=1e-4, atol=1e-4,
    )


class TestCorrectnessGate:
    def test_rejects_wrong_and_refused_candidates(self, cache):
        spec = _broken_matmul_spec()
        res = autotune(spec, {"m": 16, "k": 32, "n": 16}, dtype="float32",
                       device="cpu", cache=cache, iters=1, warmup=0)
        assert res.ok and res.backend == "cpu"
        assert res.config["block_m"] == 128
        reasons = {cfg["block_m"]: why for cfg, why in res.rejected}
        assert set(reasons) == {13, 7}
        assert "err" in reasons[13] and "refused" in reasons[7]
        stored = cache.lookup("broken_matmul", res.shape_key, "float32",
                              "cpu")
        assert stored is not None and stored["block_m"] == 128

    def test_other_errors_propagate(self, cache):
        """Only the wrapper's tile refusal is a rejection; any other error
        (a failed build, a CUDA error) ends the sweep."""
        spec = _broken_matmul_spec()

        def run(args, cfg):
            raise RuntimeError("nvcc failed")

        spec = KernelSpec(**{**spec.__dict__, "run": run})
        with pytest.raises(RuntimeError, match="nvcc"):
            autotune(spec, {"m": 16, "k": 32, "n": 16}, dtype="float32",
                     device="cpu", cache=cache, iters=1, warmup=0)

    def test_entry_point_defaults_to_the_card(self, cache, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            autotune(get_spec("apr_matmul"), {"m": 4, "k": 32, "n": 16},
                     cache=cache)


class TestSmokeSweep:
    def test_tiny_matmul_sweep_and_cache_pickup(self, cache):
        spec = get_spec("apr_matmul")
        shape = {"m": 16, "k": 64, "n": 16}
        res = autotune(spec, shape, dtype="float32", device="cpu",
                       cache=cache, max_candidates=2, iters=1, warmup=0)
        assert res.ok and res.n_candidates == 2
        assert res.us > 0 and res.gflops > 0 and res.hbm_bytes > 0
        # the wrapper's resolution now returns the tuned winner
        tile = (res.config["block_m"], res.config["block_n"],
                res.config["block_k"])
        assert matmul_ops.resolve_tile("apr_matmul", 16, 64, 16, "float32",
                                       "cpu") == tile
        x, y = torch.ones((16, 64)), torch.ones((64, 16))
        np.testing.assert_allclose(apr_matmul(x, y).numpy(),
                                   matmul_ref(x, y).numpy())

    def test_all_families_registered(self):
        assert set(all_specs()) == set(jax_all_specs())
        for name, shape in QUICK_CASES:
            assert all_specs()[name].candidates(shape), name

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name,shape", QUICK_CASES,
                             ids=[f"{n}{'-int8' if s.get('kv_int8') else ''}"
                                  for n, s in QUICK_CASES])
    def test_every_family_sweeps_on_the_cpu(self, name, shape, dtype,
                                            cache):
        """Every family validates and caches a winner at its quick shape;
        on the CPU the wrappers run their plain versions."""
        spec = get_spec(name)
        res = autotune(spec, shape, dtype=dtype, device="cpu", cache=cache,
                       iters=1, warmup=0)
        assert res.ok and not res.rejected
        assert res.config in spec.candidates(shape)
        assert cache.lookup(name, res.shape_key, dtype, "cpu") == res.config

    def test_memory_resident_baseline_tunes_under_its_own_key(self, cache):
        spec = get_spec("apr_matmul")
        res = autotune(spec, {"m": 4, "k": 96, "n": 16, "hbm": 1},
                       dtype="float32", device="cpu", cache=cache, iters=1,
                       warmup=0)
        assert res.ok and res.shape_key.endswith("_reshbm")
        apr = spec.hbm_bytes({"m": 4, "k": 96, "n": 16}, res.config)
        assert res.hbm_bytes > apr          # the partial's round trips

    def test_warm_cache_reads_then_sweeps(self, cache):
        shapes = [("apr_matmul", {"m": 4, "k": 64, "n": 32}),
                  ("flash_decode_paged", {"b": 2, "hq": 4, "hkv": 2,
                                          "d": 16, "pages": 2, "ps": 8})]
        got = warm_cache(shapes, device="cpu", cache=cache)
        assert list(got.values()) == [None, None]
        results = {}
        got = warm_cache(shapes, device="cpu", cache=cache, sweep=True,
                         results=results, iters=1, warmup=0, prune_top_k=3)
        assert all(cfg is not None for cfg in got.values())
        assert set(results) == set(got)
        mm = results[next(k for k in got if k.startswith("apr_matmul"))]
        assert mm.pruned_from == 6 and mm.n_timed == 3
        assert warm_cache(shapes, device="cpu", cache=cache) == got


class TestScopedCache:
    def test_scoped_cache_nests_and_restores(self, tmp_path):
        key = ("apr_matmul", "scopekey", "float32", "cpu")
        default = BlockConfig.make(block_m=512)
        inner = ConfigCache(tmp_path / "inner.json")
        inner.store(*key, BlockConfig.make(block_m=64))
        outer = ConfigCache(tmp_path / "outer.json")
        outer.store(*key, BlockConfig.make(block_m=128))
        assert resolve_config(*key, default=default)["block_m"] == 512
        with scoped_cache(outer):
            assert resolve_config(*key, default=default)["block_m"] == 128
            with scoped_cache(inner):
                assert resolve_config(*key, default=default)["block_m"] == 64
            assert resolve_config(*key, default=default)["block_m"] == 128
        assert resolve_config(*key, default=default)["block_m"] == 512
        with scoped_cache(None):
            assert resolve_config(*key, default=default)["block_m"] == 512


def test_two_engine_tune_caches_coexist(tmp_path):
    """An engine's ``tune_cache`` is scoped to that engine, so two engines
    with different tuned profiles resolve independently and the second
    engine's construction never redirects the first one's kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("llama3-8b", smoke=True)
    bundle = build_model(cfg, device="cpu")
    backend = "cpu"
    a_path, b_path = tmp_path / "bf16.json", tmp_path / "f32.json"
    eng_a = ServeEngine(bundle, None, device="cpu", tune_cache=str(a_path))
    eng_b = ServeEngine(bundle, None, device="cpu", tune_cache=str(b_path))
    key_shape = ("flash_decode", "anyshape")
    eng_a.tune_cache.store(*key_shape, "bfloat16", backend,
                           BlockConfig.make(chunk=64))
    eng_b.tune_cache.store(*key_shape, "float32", backend,
                           BlockConfig.make(chunk=128))
    default = BlockConfig.make(chunk=512)
    with scoped_cache(eng_a.tune_cache):
        assert active_cache() is eng_a.tune_cache
        got = resolve_config(*key_shape, "bfloat16", backend, default=default)
        assert got["chunk"] == 64
        got = resolve_config(*key_shape, "float32", backend, default=default)
        assert got["chunk"] == 512
    with scope_of(eng_b):
        got = resolve_config(*key_shape, "float32", backend, default=default)
        assert got["chunk"] == 128
    assert default_cache().lookup(*key_shape, "bfloat16", backend) is None
    assert default_cache().lookup(*key_shape, "float32", backend) is None


def scope_of(engine):
    return scoped_cache(engine.tune_cache)


def test_paged_engine_takes_a_tune_cache(tmp_path):
    """The paged engine warms its decode shapes from its own cache and
    serves with the tuned configurations in scope."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServeEngine, Request

    cfg = get_config("llama3-8b", smoke=True)
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    path = tmp_path / "engine.json"
    eng = PagedServeEngine(bundle, params, device="cpu", slots=2,
                           page_size=8, tune_cache=str(path),
                           autotune_at_start=True)
    shapes = eng._decode_kernel_shapes()
    assert [name for name, _ in shapes] == ["flash_decode_paged",
                                            "apr_matmul"]
    assert shapes[1][1] == {"m": 2, "k": cfg.d_model, "n": cfg.d_ff}
    assert len(eng.tuned_configs) == 2
    assert all(c is not None for c in eng.tuned_configs.values())
    # a fresh engine on the same file reads the winners without a sweep
    again = PagedServeEngine(bundle, params, device="cpu", slots=2,
                             page_size=8, tune_cache=str(path))
    assert again.tuned_configs == eng.tuned_configs
    # every forward runs with the engine's cache active
    seen = []
    forward = bundle.decode_paged

    def spy(*a):
        seen.append(active_cache())
        return forward(*a)

    again.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    bundle.decode_paged = spy
    try:
        again.run_until_drained()
    finally:
        bundle.decode_paged = forward
    assert seen and all(c is again.tune_cache for c in seen)
    int8 = PagedServeEngine(bundle, params, device="cpu", slots=2,
                            page_size=8, kv_dtype="int8")
    assert int8._decode_kernel_shapes()[0][1]["kv_int8"] == 1


# ------------------------------------------------------------ JAX parity
def test_cache_keys_equal_jax():
    for args in [("apr_matmul", "k4096_m4_n4096_resapr", "bfloat16", "cuda"),
                 ("flash_decode_paged", "b4_d128_hkv8_hq32_pages16_ps16"
                  "_kvint8", "float32", "cpu")]:
        assert cache_key(*args) == jax_cache_key(*args)


SHAPE_KEY_CASES = [
    (matmul_ops.shape_key(4, 4096, 14336),
     jax_matmul_ops.shape_key(4, 4096, 14336)),
    (matmul_ops.shape_key(16, 96, 40, "hbm"),
     jax_matmul_ops.shape_key(16, 96, 40, "hbm")),
    (qmm_ops.shape_key(5, 96, 40), jax_qmm_ops.shape_key(5, 96, 40)),
    (conv_ops.shape_key(2, 32, 32, 3, 3, 3, 16, 1, 1, "hbm"),
     jax_conv_ops.shape_key(2, 32, 32, 3, 3, 3, 16, 1, 1, "hbm")),
    (decode_ops.shape_key(4, 32, 8, 128, 256),
     jax_decode_ops.shape_key(4, 32, 8, 128, 256)),
    (decode_ops.paged_shape_key(4, 32, 8, 128, 16, 16),
     jax_decode_ops.paged_shape_key(4, 32, 8, 128, 16, 16)),
    (decode_ops.paged_shape_key(4, 32, 8, 128, 16, 16, True),
     jax_decode_ops.paged_shape_key(4, 32, 8, 128, 16, 16) + "_kvint8"),
    (mamba_ops.shape_key(4, 1, 80, 64, 128),
     jax_mamba_ops.shape_key(4, 1, 80, 64, 128)),
    (rwkv_ops.shape_key(4, 1, 40, 64), jax_rwkv_ops.shape_key(4, 1, 40, 64)),
]


@pytest.mark.parametrize("ours,theirs", SHAPE_KEY_CASES)
def test_shape_keys_equal_jax(ours, theirs):
    assert ours == theirs


@pytest.mark.parametrize("name,shape", QUICK_CASES,
                         ids=[f"{n}{'-int8' if s.get('kv_int8') else ''}"
                              for n, s in QUICK_CASES])
def test_spec_shape_keys_equal_jax(name, shape):
    assert get_spec(name).shape_key(shape) == \
        jax_all_specs()[name].shape_key(shape)


def test_jax_written_cache_resolves_alike(tmp_path):
    """A cache file written by the JAX package's ConfigCache loads in the
    port and resolves to the same configurations."""
    path = tmp_path / "jax_written.json"
    jax_cache = JaxConfigCache(path)
    entries = [("apr_matmul", jax_matmul_ops.shape_key(4, 64, 64), "float32",
                "cpu", {"block_m": 16, "block_n": 64, "block_k": 32}),
               ("flash_decode_paged",
                jax_decode_ops.paged_shape_key(2, 4, 2, 16, 2, 8),
                "bfloat16", "cpu", {"chunk": 8})]
    from repro.bench.config import BlockConfig as JaxBlockConfig
    for kernel, key, dtype, backend, cfg in entries:
        jax_cache.store(kernel, key, dtype, backend,
                        JaxBlockConfig.make(**cfg), metrics={"us": 1.0})
    ours = ConfigCache(path)
    assert len(ours) == len(entries)
    for kernel, key, dtype, backend, cfg in entries:
        assert ours.lookup(kernel, key, dtype, backend).to_dict() == cfg
        with scoped_cache(ours):
            got = resolve_config(kernel, key, dtype, backend,
                                 default=BlockConfig.make(chunk=1))
        assert got.to_dict() == {**{"chunk": 1}, **cfg}
    # resolution through the port's wrapper keys
    assert matmul_ops.resolve_tile("apr_matmul", 4, 64, 64, "float32", "cpu"
                                   ) == matmul_ops.DEFAULT_TILE
    with scoped_cache(ours):
        assert matmul_ops.resolve_tile("apr_matmul", 4, 64, 64, "float32",
                                       "cpu") == (16, 64, 32)


def _jax_candidates(name, shape):
    return jax_all_specs()[name].candidates(shape)


@pytest.mark.parametrize("name,shape", QUICK_CASES,
                         ids=[f"{n}{'-int8' if s.get('kv_int8') else ''}"
                              for n, s in QUICK_CASES])
def test_models_equal_jax_at_float32(name, shape):
    """FLOPs equal the JAX package's; at float32 the traffic models equal
    its, at the JAX tune space's configurations and at the port's."""
    ours, theirs = get_spec(name), jax_all_specs()[name]
    assert ours.flops(shape) == theirs.flops(shape)
    configs = _jax_candidates(name, shape) + ours.candidates(shape)
    for cfg in configs:
        jcfg = type(_jax_candidates(name, shape)[0]).make(**cfg.to_dict())
        assert ours.hbm_bytes(shape, cfg, "float32") == \
            theirs.hbm_bytes(shape, jcfg), (name, cfg)
        # bf16 operands move fewer bytes, never more
        assert ours.hbm_bytes(shape, cfg, "bfloat16") <= \
            ours.hbm_bytes(shape, cfg, "float32")


def test_one_point_families_compile_one_configuration():
    for name, shape in QUICK_CASES:
        spec = get_spec(name)
        cands = spec.candidates(shape)
        if name.startswith(("apr_matmul", "quant_matmul")):
            assert len(cands) == 6
        else:
            assert cands == [spec.default_config(shape)], name
