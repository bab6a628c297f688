"""The port's one-device roofline (``repro_torch.roofline.analysis``) and
``configs.shapes.input_specs`` against the JAX package's.

``input_specs``: every arch of ``ARCHS`` at every applicable shape, at
full size (the port's stand-ins are ``meta`` tensors, JAX's
ShapeDtypeStructs, neither allocates): the same keys, shapes and dtypes.
``model_flops``, ``analytic_hbm_bytes`` (both optimizers, every kind, 1 and
4 chips) and ``extrapolate``: JAX's values within 1e-12 relative.
``RooflineTerms``: its terms, ``dominant``, ``bound_time`` and ``as_dict``
equal JAX's under a profile registered with the same constants in both
packages, ``links_per_chip`` given; the port's default takes the profile's
links.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import input_specs as jinput_specs
from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch.configs import ARCHS, SHAPES, applicable, input_specs
from repro_torch.roofline import (RooflineTerms, analytic_hbm_bytes,
                                  extrapolate, hw, model_flops)
from repro_torch.roofline import analysis

RTOL = 1e-12
#: one profile registered in both packages with the same constants
PROBE = dict(name="roofline_parity_probe", peak_flops=3.5e14,
             hbm_bw=1.7e12, vmem_bytes=1 << 20, hbm_bytes=32 << 30,
             ici_bw_per_link=6.25e10, links_per_chip=7)


def _flat(specs, prefix=""):
    """{dotted key: (shape, dtype name)} of a (nested) dict of stand-ins."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            assert v.device.type == "meta", k
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        else:
            out[prefix + k] = (tuple(v.shape), jnp.dtype(v.dtype).name)
    return out


def _cells(name):
    return [s for s in SHAPES if applicable(ARCHS[name], SHAPES[s])]


def test_same_archs_and_shapes():
    assert sorted(ARCHS) == sorted(JARCHS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_match_jax(name):
    for shape in _cells(name):
        got = _flat(input_specs(ARCHS[name], SHAPES[shape]))
        want = _flat(jinput_specs(JARCHS[name], JSHAPES[shape]))
        assert got == want, (name, shape)
    if ARCHS[name].family == "mamba":   # JAX's decode gives it no cache
        assert "cache" not in input_specs(ARCHS[name], SHAPES["decode_32k"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_flops_match_jax(name):
    for shape in _cells(name):
        for training in (True, False):
            got = model_flops(ARCHS[name], SHAPES[shape], training)
            want = janalysis.model_flops(JARCHS[name], JSHAPES[shape],
                                         training)
            assert got == pytest.approx(want, rel=RTOL), (shape, training)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_analytic_hbm_bytes_match_jax(name):
    for optimizer in ("adamw", "adafactor"):
        cfg = dataclasses.replace(ARCHS[name], optimizer=optimizer)
        jcfg = dataclasses.replace(JARCHS[name], optimizer=optimizer)
        for shape in _cells(name):
            for chips in (1, 4):
                kw = dict(param_count=cfg.param_count(),
                          cache_bytes=3 << 30, microbatches=2)
                got = analytic_hbm_bytes(cfg, SHAPES[shape], chips, **kw)
                want = janalysis.analytic_hbm_bytes(jcfg, JSHAPES[shape],
                                                    chips, **kw)
                assert got == pytest.approx(want, rel=RTOL), \
                    (optimizer, shape, chips)


@pytest.mark.parametrize("c1,c2,depth,multiplier", [
    (1.0, 3.0, 32, 1.0), (2.5e12, 4.75e12, 80, 4.0), (7.0, 5.0, 12, 1.0),
    (0.0, 0.0, 1, 2.0), (1e9, 1e9 + 1.0, 126, 8.0)])
def test_extrapolate_matches_jax(c1, c2, depth, multiplier):
    assert extrapolate(c1, c2, depth, multiplier) == pytest.approx(
        janalysis.extrapolate(c1, c2, depth, multiplier), rel=RTOL)


@pytest.fixture(scope="module")
def probe():
    """The same profile in both packages' registries, taken out again at
    teardown (other tests hold the registries to their own profiles)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (hw, jhw):
            mp.setitem(mod._PROFILES, PROBE["name"],
                       mod.HardwareProfile(**PROBE))
        yield hw.get_profile(PROBE["name"]), jhw.get_profile(PROBE["name"])


@pytest.mark.parametrize("flops,hbm_bytes,wire_bytes,chips,links", [
    (1e15, 1e11, 1e9, 1, 7), (1e12, 5e12, 0.0, 4, 7),
    (1e10, 1e8, 5e13, 4, 3), (0.0, 0.0, 0.0, 1, 0)])
def test_roofline_terms_match_jax(probe, flops, hbm_bytes, wire_bytes,
                                  chips, links):
    ours, theirs = probe
    got = RooflineTerms(flops, hbm_bytes, wire_bytes, chips,
                        links_per_chip=links, profile=ours)
    want = janalysis.RooflineTerms(flops, hbm_bytes, wire_bytes, chips,
                                   links_per_chip=links, profile=theirs)
    for term in ("t_compute", "t_memory", "t_collective", "bound_time"):
        assert getattr(got, term) == pytest.approx(getattr(want, term),
                                                   rel=RTOL), term
    assert got.dominant == want.dominant
    a, b = got.as_dict(), want.as_dict()
    assert sorted(a) == sorted(b) and a["dominant"] == b["dominant"]
    np.testing.assert_allclose([a[k] for k in sorted(a) if k != "dominant"],
                               [b[k] for k in sorted(b) if k != "dominant"],
                               rtol=RTOL)
    # the port's default links are the profile's, not a TPU torus's
    assert RooflineTerms(1.0, 1.0, 1.0, 1, profile=ours).links == 7
    h100 = hw.get_profile("h100_sxm")
    assert RooflineTerms(0.0, 0.0, 9e11, 1, profile=h100).t_collective == \
        pytest.approx(9e11 / (18 * h100.ici_bw_per_link), rel=RTOL)


def test_no_tpu_rate_in_the_module():
    text = open(analysis.__file__).read()
    assert "197" not in text and "819" not in text
