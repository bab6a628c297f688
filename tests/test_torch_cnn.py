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
from repro_torch.kernels.apr_conv import conv2d_ref
from repro_torch.core.workloads import MODELS
from repro_torch.launch import edge
from repro_torch.models import cnn
from repro_torch.models.cnn import CNNS

NETS = ["lenet", "resnet20", "mobilenet_v1"]
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


def _mobilenet_jax(params):
    """The JAX MobileNet's params as its forward runs them: each ``dw{i}``
    reshaped from the as-built ``(3, 3, cin, 1)`` to the ``(3, 3, 1, cin)``
    that its grouped ``lax`` conv takes (the same values in the same
    memory order: channel c's filter is ``[:, :, c, 0]`` before and
    ``[:, :, 0, c]`` after), which the unmodified ``mobilenet_forward``
    then runs (as built it raises, ROADMAP C.1)."""
    return {k: v.reshape(3, 3, 1, -1) if k.startswith("dw") else v
            for k, v in params.items()}


@pytest.fixture(scope="module", params=NETS)
def net(request):
    """(name, JAX params as the JAX forward takes them, the same params
    bridged to torch, a batch-2 input as a JAX array and as a tensor).
    MobileNet's depthwise filters are rescaled by sqrt(cin) / 3 in both
    (its init scales them by cin^-1/2, not 9^-1/2, which leaves logits of
    ~1e-14 and a relative gate that means nothing)."""
    name = request.param
    spec = jax_cnn.CNNS[name]
    params = jax.jit(spec["params"])(jax.random.PRNGKey(0))
    if name == "mobilenet_v1":
        params = {k: v * (np.sqrt(v.shape[2]) / 3) if k.startswith("dw")
                  else v for k, v in params.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2,) + spec["input"]).astype(np.float32)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    if name == "mobilenet_v1":
        params = _mobilenet_jax(params)
    return (name, params, tparams, jax.numpy.asarray(x),
            tensor_from_numpy(x))


def test_cnns_are_the_reference_nets_minus_mobilenet():
    assert set(CNNS) == set(NETS) == set(jax_cnn.CNNS)
    for name in NETS:
        assert CNNS[name]["input"] == jax_cnn.CNNS[name]["input"]


def test_param_names_shapes_and_scales_equal_the_jax_builders(net):
    name, _, tparams, *_ = net
    specs = CNNS[name]["specs"]()
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
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
    conv layers (``core/workloads.py``) -- the two levels model one net.
    ``conv_geometries`` lists the ``apr_conv`` ones; MobileNet's depthwise
    convs (Level A's C = 1 layers ``dw{i}``) run through ``dw=`` in the
    same order."""
    name = net[0]
    geoms = cnn.conv_geometries(name, batch=4)
    layers = [l for l in MODELS[name]() if isinstance(l, ConvLayer)]
    dense = [l for l in layers if not l.name.startswith("dw")]
    assert len(geoms) == len(dense) == {"lenet": 2, "resnet20": 21,
                                        "mobilenet_v1": 14}[name]
    for g, l in zip(geoms, dense):
        b, h, w, c = g["x_shape"]
        hf, wf, c2, m = g["f_shape"]
        s, p = g["stride"], g["padding"]
        assert b == 4 and c == c2
        assert (m, c, hf, wf, s) == (l.M, l.C, l.Hf, l.Wf, l.stride)
        assert ((h + 2 * p - hf) // s + 1, (w + 2 * p - wf) // s + 1) == \
            (l.Ho, l.Wo)
    if name != "mobilenet_v1":
        assert len(dense) == len(layers)
        return
    calls = []

    def record(x, f, stride):
        calls.append((tuple(x.shape), tuple(f.shape), stride))
        return cnn.depthwise(x, f, stride)

    spec = CNNS[name]
    params = {n: torch.empty(shape, device="meta")
              for n, (shape, _) in spec["specs"]().items()}
    spec["forward"](params, torch.empty((4,) + spec["input"], device="meta"),
                    conv=conv2d_ref, dw=record)
    dws = [l for l in layers if l.name.startswith("dw")]
    assert len(calls) == len(dws) == 13
    for (xs, fs, s), l in zip(calls, dws):
        assert (xs[3], fs, s, l.C) == (l.M, (3, 3, l.M, 1), l.stride, 1)
        assert (xs[1], (xs[1] + 2 - 3) // s + 1) == (l.Hin, l.Ho)


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


def test_edge_launcher_runs_mobilenet_on_the_cpu(capsys):
    edge.main(["--device", "cpu", "--quick", "--net", "mobilenet_v1"])
    assert "lenet     logits (2, 10)" in capsys.readouterr().out
    rows = edge.run_level_b(["mobilenet_v1"], 2, "cpu", iters=1)
    assert rows[0]["logits_shape"] == (2, 10) and rows[0]["rel_err"] == 0.0


def test_edge_level_b_checks_resnet20_on_the_cpu():
    rows = edge.run_level_b(["resnet20"], 2, "cpu", iters=1)
    assert rows[0]["logits_shape"] == (2, 10)
    assert rows[0]["apr_conv_launches"] == 0     # plain path on the CPU
    assert rows[0]["rel_err"] == 0.0
