"""Port parity, Level A: the port's copy of ``core/`` reproduces the JAX
package's Table III and residency traffic model exactly."""
import dataclasses

import pytest

from repro import core as jax_core
from repro.core import apr as jax_apr
from repro.core import workloads as jax_workloads
from repro_torch import core
from repro_torch.core import apr
from repro_torch.core import workloads

MODELS = ("lenet", "resnet20", "mobilenet_v1")


def _fields(m) -> dict:
    d = dataclasses.asdict(m)
    d["isa"] = m.isa.value
    return d


@pytest.mark.parametrize("model", MODELS)
def test_table3_equals_the_reference_field_by_field(model):
    got = core.table3((model,))
    ref = jax_core.table3((model,))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _fields(g) == _fields(r)


@pytest.mark.parametrize("model", MODELS)
def test_enhancement_equals_the_reference(model):
    g = {m.isa.value: m for m in core.table3((model,))}
    r = {m.isa.value: m for m in jax_core.table3((model,))}
    assert core.enhancement(g["rv64f"], g["rv64r"]) == \
        jax_core.enhancement(r["rv64f"], r["rv64r"])


@pytest.mark.parametrize("model", MODELS)
def test_workloads_equal_the_reference(model):
    assert [dataclasses.asdict(l) for l in workloads.MODELS[model]()] == \
        [dataclasses.asdict(l) for l in jax_workloads.MODELS[model]()]


@pytest.mark.parametrize("residency", ["apr", "hbm"])
@pytest.mark.parametrize("out_elems,n_steps,out_bytes", [
    (1, 1, 4), (4_194_304, 5, 4), (1_048_576, 18, 2), (84, 13, 4)])
def test_reduction_hbm_traffic_agrees(residency, out_elems, n_steps,
                                      out_bytes):
    assert apr.reduction_hbm_traffic(out_elems, n_steps, out_bytes,
                                     residency) == \
        jax_apr.reduction_hbm_traffic(out_elems, n_steps, out_bytes,
                                      residency)
    assert apr.traffic_reduction(out_elems, n_steps) == \
        jax_apr.traffic_reduction(out_elems, n_steps)


def test_accumulator_spec_bytes_agree():
    for shape, dtype in (((128, 128), "float32"), ((16, 64), "bfloat16")):
        assert apr.AccumulatorSpec(shape, dtype).bytes == \
            jax_apr.AccumulatorSpec(shape, dtype).bytes


def test_core_is_a_copy_not_an_import():
    assert core.__file__ != jax_core.__file__
    assert core.Isa is not jax_core.Isa
