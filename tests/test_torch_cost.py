"""Port parity, the kernel cost model (``repro_torch.cost``) and the hardware
profiles (``repro_torch.roofline``): the CPU cases of the JAX package's
``tests/test_cost.py`` (TestProfiles, TestKernelModel, TestPruningParity,
TestTiming) on the port, and the two ``estimate_kernel`` /
``rank_candidates`` held to each other on one duck-typed spec and one
profile with identical numbers."""
import dataclasses

import pytest

from repro.bench.config import BlockConfig as JaxBlockConfig
from repro.cost import HardwareProfile as JaxHardwareProfile
from repro.cost import estimate_kernel as jax_estimate_kernel
from repro.cost import rank_candidates as jax_rank_candidates
from repro.cost.model import OVERLAP_LEAK as JAX_OVERLAP_LEAK
from repro.cost.model import SPILL_PENALTY as JAX_SPILL_PENALTY
from repro_torch.bench import (BlockConfig, ConfigCache, autotune,
                               set_default_cache)
from repro_torch.bench.autotune import resolve_timing, time_stats
from repro_torch.bench.registry import get_spec
from repro_torch.cost import (OVERLAP_LEAK, SPILL_PENALTY, HardwareProfile,
                              all_profiles, combine_times, estimate_kernel,
                              get_profile, rank_candidates)

QUICK_SHAPES = {
    "apr_matmul": {"m": 64, "k": 128, "n": 64},
    "apr_matmul_fused": {"m": 64, "k": 128, "n": 64},
    "quant_matmul": {"m": 64, "k": 128, "n": 64},
    "quant_matmul_fused": {"m": 64, "k": 128, "n": 64},
    "apr_conv": {"b": 1, "h": 8, "w": 8, "c": 4, "hf": 3, "wf": 3,
                 "m": 8, "stride": 1, "padding": 1},
    "apr_conv_fused": {"b": 1, "h": 8, "w": 8, "c": 4, "hf": 3, "wf": 3,
                       "m": 8, "stride": 1, "padding": 1},
    "flash_decode": {"b": 2, "hq": 4, "hkv": 2, "d": 32, "s": 128},
    "flash_decode_paged": {"b": 2, "hq": 4, "hkv": 2, "d": 32,
                           "pages": 4, "ps": 32},
    "mamba2": {"b": 1, "t": 32, "h": 2, "p": 8, "n": 8},
    "rwkv6": {"b": 1, "t": 32, "h": 2, "d": 8},
}


@pytest.fixture
def cache(tmp_path):
    c = ConfigCache(tmp_path / "tune_cache.json")
    set_default_cache(c)
    yield c
    set_default_cache(None)


@pytest.fixture(autouse=True)
def _no_profile_env(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_HW_PROFILE", raising=False)


class TestProfiles:
    def test_default_follows_the_device(self):
        assert get_profile(device="cuda").name == "h100_sxm"
        assert get_profile(device="cpu").name == "cpu"
        # this machine has no card: the device-free default is the CPU's
        assert get_profile().name == "cpu"
        assert {"h100_sxm", "cpu"} == set(all_profiles())

    def test_env_selects(self, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_HW_PROFILE", "h100_sxm")
        assert get_profile(device="cpu").name == "h100_sxm"
        # explicit name outranks the env
        assert get_profile("cpu").name == "cpu"

    def test_ignores_the_jax_packages_variable(self, monkeypatch):
        monkeypatch.setenv("REPRO_HW_PROFILE", "tpu_v5e")
        assert get_profile(device="cuda").name == "h100_sxm"
        with pytest.raises(KeyError):
            get_profile("tpu_v5e")

    def test_unknown_profile_raises(self):
        with pytest.raises(KeyError):
            get_profile("not_a_chip")

    def test_ridge_intensity(self):
        p = get_profile("h100_sxm")
        assert p.ridge_intensity == pytest.approx(p.peak_flops / p.hbm_bw)
        # the datasheet numbers the module cites
        assert (p.peak_flops, p.hbm_bw, p.vmem_bytes) == \
            (989e12, 3.35e12, 228 * 1024)


class TestKernelModel:
    def test_constants_equal_jax(self):
        assert OVERLAP_LEAK == JAX_OVERLAP_LEAK
        assert SPILL_PENALTY == JAX_SPILL_PENALTY
        assert combine_times(2.0, 1.0) == 2.0 + OVERLAP_LEAK

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_monotone_in_traffic(self, dtype):
        """More traffic at fixed FLOPs always prices higher."""
        spec = get_spec("apr_matmul")
        shape = QUICK_SHAPES["apr_matmul"]
        ests = [estimate_kernel(spec, shape, cfg, profile=get_profile("cpu"),
                                dtype=dtype)
                for cfg in spec.candidates(shape)]
        by_traffic = sorted(ests, key=lambda e: e.hbm_bytes)
        for a, b in zip(by_traffic, by_traffic[1:]):
            if b.hbm_bytes > a.hbm_bytes:
                assert b.predicted_s > a.predicted_s
            else:
                assert b.predicted_s == pytest.approx(a.predicted_s)

    def test_profile_scales_prediction(self):
        spec = get_spec("apr_matmul")
        shape = QUICK_SHAPES["apr_matmul"]
        cfg = spec.candidates(shape)[0]
        fast = estimate_kernel(spec, shape, cfg,
                               profile=get_profile("h100_sxm"))
        slow = estimate_kernel(spec, shape, cfg, profile=get_profile("cpu"))
        assert slow.predicted_s > fast.predicted_s
        assert slow.profile == "cpu"

    def test_vmem_overflow_penalised(self):
        """A config whose shared-memory footprint exceeds the profile's
        ceiling prices worse than the same traffic without the spill."""
        spec = get_spec("apr_matmul")
        shape = {"m": 512, "k": 512, "n": 512}
        cfg = BlockConfig.make(block_m=32, block_n=64, block_k=128)
        h100 = get_profile("h100_sxm")
        tiny = dataclasses.replace(h100, name="tiny_smem",
                                   vmem_bytes=64 * 1024)
        ok = estimate_kernel(spec, shape, cfg, profile=h100)
        spilled = estimate_kernel(spec, shape, cfg, profile=tiny)
        assert ok.vmem_ok and not spilled.vmem_ok
        assert spilled.predicted_s > ok.predicted_s

    def test_rank_is_stable_and_complete(self):
        spec = get_spec("apr_matmul")
        shape = QUICK_SHAPES["apr_matmul"]
        cands = spec.candidates(shape)
        ranked = rank_candidates(spec, shape, cands, profile=get_profile())
        assert sorted(c.items for c, _ in ranked) \
            == sorted(c.items for c in cands)
        costs = [est.predicted_s for _, est in ranked]
        assert costs == sorted(costs)


class _DuckSpec:
    """A spec with the JAX package's two-argument models, made of nothing
    but arithmetic, so both cost models can price it."""

    name = "duck"

    def flops(self, shape):
        return 2 * shape["m"] * shape["k"] * shape["n"]

    def hbm_bytes(self, shape, cfg):
        return (shape["m"] * shape["k"] * 4 * (shape["n"] // cfg["block_n"])
                + shape["k"] * shape["n"] * 4 * (shape["m"] // cfg["block_m"])
                + 4 * shape["m"] * shape["n"])

    def vmem_bytes(self, shape, cfg):
        return 4 * (cfg["block_m"] * cfg["block_k"]
                    + cfg["block_k"] * cfg["block_n"]
                    + cfg["block_m"] * cfg["block_n"])


PROFILE_NUMBERS = dict(name="same", peak_flops=989e12, hbm_bw=3.35e12,
                       vmem_bytes=228 * 1024, hbm_bytes=80 * 1024**3)
DUCK_SHAPES = [{"m": 4, "k": 4096, "n": 4096}, {"m": 512, "k": 512,
                                                  "n": 512},
               {"m": 4096, "k": 4096, "n": 4096}]


@pytest.mark.parametrize("shape", DUCK_SHAPES, ids=str)
def test_estimates_and_ranking_equal_jax(shape):
    spec = _DuckSpec()
    ours_p = HardwareProfile(**PROFILE_NUMBERS)
    theirs_p = JaxHardwareProfile(**PROFILE_NUMBERS)
    tiles = [(bm, bn, bk) for bm in (16, 64, 256) for bn in (64, 128, 256)
             for bk in (32, 128, 512)]
    ours_c = [BlockConfig.make(block_m=a, block_n=b, block_k=c)
              for a, b, c in tiles]
    theirs_c = [JaxBlockConfig.make(block_m=a, block_n=b, block_k=c)
                for a, b, c in tiles]
    for oc, tc in zip(ours_c, theirs_c):
        ours = estimate_kernel(spec, shape, oc, profile=ours_p)
        theirs = jax_estimate_kernel(spec, shape, tc, profile=theirs_p)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.predicted_us == theirs.predicted_us
        assert ours.dominant == theirs.dominant
        assert ours.intensity == theirs.intensity
    ours_rank = [c.to_dict() for c, _ in rank_candidates(
        spec, shape, ours_c, profile=ours_p)]
    theirs_rank = [c.to_dict() for c, _ in jax_rank_candidates(
        spec, shape, theirs_c, profile=theirs_p)]
    assert ours_rank == theirs_rank
    # some candidates spill past 228 KB, so the penalty is compared too
    assert any(not e.vmem_ok for _, e in rank_candidates(
        spec, shape, ours_c, profile=ours_p))


class TestPruningParity:
    @pytest.mark.parametrize("kernel", sorted(QUICK_SHAPES))
    def test_pruned_matches_exhaustive(self, kernel, cache):
        """The pruned sweep selects the exhaustive winner, a config the
        model prices within 1%, or one within the runs' timer spread.  The
        sweeps run at float32, so the candidates are those of that dtype
        (the matmul families' fp32 body has tiles of its own)."""
        spec = get_spec(kernel)
        shape = QUICK_SHAPES[kernel]
        cands = spec.candidates(shape, "float32")[:4]
        k = max(1, len(cands) // 2)
        kw = dict(dtype="float32", device="cpu", cache=cache,
                  max_candidates=4)
        ex = autotune(spec, shape, **kw)
        pr = autotune(spec, shape, prune_top_k=k, **kw)
        assert ex.ok and pr.ok
        assert pr.predicted_us is not None
        if len(cands) > k:
            assert pr.pruned_from == len(cands)
            assert pr.n_timed <= k < pr.pruned_from
        else:                               # a one-point space: nothing
            assert pr.pruned_from is None   # to prune
        if pr.config == ex.config:
            return
        pred = {cfg: est.predicted_us
                for cfg, est in rank_candidates(spec, shape, cands,
                                                profile=get_profile("cpu"),
                                                dtype="float32")}
        tied = abs(pred[pr.config] - pred[ex.config]) \
            <= 0.01 * max(pred[pr.config], pred[ex.config])
        within_noise = abs(pr.us - ex.us) <= pr.spread_us + ex.spread_us
        assert tied or within_noise

    def test_exhaustive_records_no_pruning(self, cache):
        spec = get_spec("apr_matmul")
        res = autotune(spec, QUICK_SHAPES["apr_matmul"], dtype="float32",
                       device="cpu", cache=cache)
        assert res.pruned_from is None
        assert res.n_timed == res.n_candidates - len(res.rejected)


class TestTiming:
    def test_env_overrides(self, monkeypatch):
        monkeypatch.delenv("REPRO_TORCH_BENCH_ITERS", raising=False)
        monkeypatch.delenv("REPRO_TORCH_BENCH_WARMUP", raising=False)
        assert resolve_timing() == (3, 1)
        monkeypatch.setenv("REPRO_TORCH_BENCH_ITERS", "7")
        monkeypatch.setenv("REPRO_TORCH_BENCH_WARMUP", "0")
        assert resolve_timing() == (7, 0)
        assert resolve_timing(2, 5) == (2, 5)
        monkeypatch.setenv("REPRO_TORCH_BENCH_ITERS", "junk")
        assert resolve_timing()[0] == 3

    def test_time_stats_spread(self, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_BENCH_ITERS", "5")
        monkeypatch.delenv("REPRO_TORCH_BENCH_WARMUP", raising=False)
        calls = []
        med, spread = time_stats(lambda: calls.append(1))
        assert len(calls) == 5 + 1     # default warmup 1 still applies
        assert med >= 0.0 and spread >= 0.0
