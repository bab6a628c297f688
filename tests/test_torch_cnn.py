"""Port parity, CNNs: LeNet-5 and ResNet-20 of ``repro_torch.models.cnn``
against the JAX package's ``repro.models.cnn`` on the same (JAX-initialised,
bridged) weights and inputs, their parameter layout and init scales, their
conv geometries against the Level-A workloads, and the edge launcher."""
import jax
import numpy as np
import pytest
import torch

from repro.models import cnn as jax_cnn
from repro.models.layers import ParamBuilder
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.core.program import ConvLayer
from repro_torch.core.workloads import MODELS
from repro_torch.launch import edge
from repro_torch.models import cnn
from repro_torch.models.cnn import CNNS

NETS = ["lenet", "resnet20"]
#: max |logits diff| <= LOGITS_RTOL * max |reference logit|: fp32 sum order
#: alone.  ResNet-20 has no normalisation and the JAX init scales a filter
#: by C^-1/2 (not (Hf·Wf·C)^-1/2), so its logits reach ~1e6 at batch 2 and
#: only a bound relative to the largest logit means anything
LOGITS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """The JAX conv kernel resolves tiles through a tune cache: keep it in
    a temp file."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


@pytest.fixture(scope="module", params=NETS)
def net(request):
    """(name, JAX params, the same params bridged to torch, a batch-2 input
    as a JAX array and as a tensor)."""
    name = request.param
    spec = jax_cnn.CNNS[name]
    params = jax.jit(spec["params"])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2,) + spec["input"]).astype(np.float32)
    return (name, params,
            params_from_numpy({k: np.asarray(v) for k, v in params.items()}),
            jax.numpy.asarray(x), tensor_from_numpy(x))


def test_cnns_are_the_reference_nets_minus_mobilenet():
    assert set(CNNS) == set(NETS)
    assert set(jax_cnn.CNNS) - set(CNNS) == {"mobilenet_v1"}
    for name in NETS:
        assert CNNS[name]["input"] == jax_cnn.CNNS[name]["input"]


def test_param_names_shapes_and_scales_equal_the_jax_builders(net):
    name, jparams, *_ = net
    specs = CNNS[name]["specs"]()
    assert {k: tuple(v.shape) for k, v in jparams.items()} == \
        {k: shape for k, (shape, _) in specs.items()}
    pb = ParamBuilder()
    for k, (shape, scale) in specs.items():
        pb.param(k, shape, (None,) * len(shape))
        assert scale == pb._defs[k][2], k     # fan_in = shape[-2], as JAX


def test_init_draws_normal_times_scale(net):
    """Every tensor of the port's init has the spec's scale as its standard
    deviation, within 4 standard errors (deterministic: seed 0)."""
    name = net[0]
    params = CNNS[name]["params"](torch.Generator().manual_seed(0),
                                  device="cpu")
    specs = CNNS[name]["specs"]()
    assert list(params) == sorted(specs)
    for k, t in params.items():
        shape, scale = specs[k]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        n = t.numel()
        assert abs(float(t.std()) / scale - 1) <= 4 / np.sqrt(2 * n), k
        assert abs(float(t.mean())) <= 4 * scale / np.sqrt(n), k


@pytest.mark.parametrize("conv_impl", ["pallas", "xla"])
def test_forward_matches_jax(net, conv_impl):
    name, jparams, tparams, xj, xt = net
    ref = np.asarray(jax_cnn.CNNS[name]["forward"](jparams, xj,
                                                   conv_impl=conv_impl))
    got = CNNS[name]["forward"](tparams, xt).numpy()
    assert got.shape == ref.shape == (2, 10)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= LOGITS_RTOL * scale
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_baseline_conv_is_the_same_forward_on_the_cpu(net):
    name, _, tparams, _, xt = net
    fwd = CNNS[name]["forward"]
    assert torch.equal(fwd(tparams, xt, conv=cnn.hbm_conv), fwd(tparams, xt))


def test_conv_geometries_are_the_level_a_workloads(net):
    """The convs one forward runs are, layer for layer, the Level-A model's
    conv layers (``core/workloads.py``) -- the two levels model one net."""
    name = net[0]
    geoms = cnn.conv_geometries(name, batch=4)
    layers = [l for l in MODELS[name]() if isinstance(l, ConvLayer)]
    assert len(geoms) == len(layers) == {"lenet": 2, "resnet20": 21}[name]
    for g, l in zip(geoms, layers):
        b, h, w, c = g["x_shape"]
        hf, wf, c2, m = g["f_shape"]
        s, p = g["stride"], g["padding"]
        assert b == 4 and c == c2
        assert (m, c, hf, wf, s) == (l.M, l.C, l.Hf, l.Wf, l.stride)
        assert ((h + 2 * p - hf) // s + 1, (w + 2 * p - wf) // s + 1) == \
            (l.Ho, l.Wo)


# --------------------------------------------------------------- entry points
@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_params_default_to_cuda_and_raise_without_it(no_cuda):
    for name in NETS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CNNS[name]["params"]()


def test_edge_launcher_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edge.main(["--quick"])


def test_edge_launcher_runs_on_the_cpu(capsys):
    edge.main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out
    assert "lenet     logits (2, 10)" in out
    assert "RV64R over RV64F" in out


def test_edge_level_b_checks_resnet20_on_the_cpu():
    rows = edge.run_level_b(["resnet20"], 2, "cpu", iters=1)
    assert rows[0]["logits_shape"] == (2, 10)
    assert rows[0]["apr_conv_launches"] == 0     # plain path on the CPU
    assert rows[0]["rel_err"] == 0.0
