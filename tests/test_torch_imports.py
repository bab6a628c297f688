"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` never
import jax or the JAX package, the package imports with jax unavailable,
and its entry points refuse to drop to the CPU unless asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import PagedServeEngine, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    print(m.name)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.split()
    assert lines[-1] == "ok"
    # the int8 and slot-engine modules among them, and the recurrent ones
    assert {"repro_torch.quant", "repro_torch.quant.quantize",
            "repro_torch.kernels.flash_decode.ops",
            "repro_torch.kernels.apr_matmul.ops", "repro_torch.bridge",
            "repro_torch.serve.engine"} <= set(lines)
    assert {"repro_torch.serve.state_cache", "repro_torch.models.paged_state",
            "repro_torch.models.rwkv", "repro_torch.models.rwkv_lm",
            "repro_torch.models.ssm", "repro_torch.kernels.rwkv6",
            "repro_torch.kernels.rwkv6.ops", "repro_torch.kernels.rwkv6.ref",
            "repro_torch.kernels.mamba2", "repro_torch.kernels.mamba2.ops",
            "repro_torch.kernels.mamba2.ref",
            "repro_torch.configs.rwkv6_3b"} <= set(lines)
    # the zamba2 hybrid family
    assert {"repro_torch.models.hybrid",
            "repro_torch.configs.zamba2_1p2b"} <= set(lines)
    # the moe and vlm families, MobileNet, and the configs of this slice
    assert {"repro_torch.models.moe", "repro_torch.models.lm",
            "repro_torch.models.cnn", "repro_torch.configs.arctic_480b",
            "repro_torch.configs.llama4_maverick_400b",
            "repro_torch.configs.internvl2_1b",
            "repro_torch.configs.deepseek_coder_33b"} <= set(lines)
    # speculative decoding
    assert {"repro_torch.spec", "repro_torch.spec.draft",
            "repro_torch.spec.engine"} <= set(lines)
    # the tuning layer, the cost model, the hardware profiles and the int8
    # matmul family
    assert {"repro_torch.bench", "repro_torch.bench.config",
            "repro_torch.bench.registry", "repro_torch.bench.specs",
            "repro_torch.bench.autotune", "repro_torch.cost",
            "repro_torch.cost.model", "repro_torch.roofline",
            "repro_torch.roofline.hw", "repro_torch.kernels.quant_matmul",
            "repro_torch.kernels.quant_matmul.ops",
            "repro_torch.kernels.quant_matmul.ref"} <= set(lines)


def test_tuning_layer_works_without_jax():
    """Every family registers and a sweep runs on the CPU in a process
    where jax and the JAX package cannot be imported."""
    code = (
        "import sys, tempfile\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.bench import ConfigCache, all_specs, warm_cache\n"
        "print(len(all_specs()))\n"
        "c = ConfigCache(tempfile.mkdtemp() + '/t.json')\n"
        "got = warm_cache([('quant_matmul_fused', {'m': 4, 'k': 64, "
        "'n': 32})], device='cpu', cache=c, sweep=True, iters=1, warmup=0)\n"
        "print(sorted(got.values())[0] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["10", "True"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bundle_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_config("llama3-8b", smoke=True))


def test_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    bundle = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    params = bundle.init_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedServeEngine(bundle, params)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "mamba2-2.7b", "zamba2-1.2b"])
def test_recurrent_bundles_default_to_cuda(no_cuda, arch):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_config(arch, smoke=True))


def test_spec_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.spec import SpeculativeServeEngine
    bundle = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    params = bundle.init_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeculativeServeEngine(bundle, params)


def test_slot_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    bundle = build_model(get_config("llama3-8b", smoke=True), device="cpu")
    params = bundle.init_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(bundle, params)


def test_launcher_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--requests", "1"])


@pytest.mark.parametrize("args", [["--engine", "slot"],
                                  ["--int8-weights", "--kv-dtype", "int8"],
                                  ["--arch", "rwkv6-3b"],
                                  ["--arch", "mamba2-2.7b", "--state-dtype",
                                   "int8"],
                                  ["--arch", "zamba2-1.2b", "--kv-dtype",
                                   "int8"],
                                  ["--draft-model", "ngram"],
                                  ["--draft-model", "auto", "--spec-k",
                                   "2"]])
def test_launcher_new_paths_default_to_cuda(no_cuda, args):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--requests", "1"] + args)


def test_autotune_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.bench import warm_cache
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        warm_cache([("apr_matmul", {"m": 4, "k": 64, "n": 64})], sweep=True)


def test_default_tune_cache_dir_is_ignored_by_git():
    """The port's default tune cache lives beside the package, never in the
    user's home, and git ignores it."""
    from repro_torch.bench.config import DEFAULT_PATH
    assert DEFAULT_PATH.parent == PORT / "_tune"
    assert "src/repro_torch/_tune/" in \
        (ROOT / ".gitignore").read_text().split()


def test_kernel_build_dir_is_ignored_by_git():
    """nvcc writes the kernels' libraries beside the package; the directory
    is listed in .gitignore so a build never dirties a checkout."""
    from repro_torch.kernels import _build
    assert _build.BUILD_DIR == PORT / "_build"
    assert "src/repro_torch/_build/" in \
        (ROOT / ".gitignore").read_text().split()
