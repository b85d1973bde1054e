"""The port's serving planner held against `repro.core.planner`.

Both packages get the same hardware (the reference's TPU v5e constants,
passed explicitly as ``hw``, and the port's H100 constants rebuilt in
the reference's `HardwareSpec`), the same counters and the same SLOs.
Roofline terms are Python floats: equal exactly.  The queueing side runs
in float32 in both (the bisection, Eq 7 / Eq 8): integers (cells, chips)
equal, rates and responses to rtol 1e-6.
"""

import dataclasses
import math

import pytest

from repro.core import planner as j_planner
from repro_torch.core import planner as t_planner

RTOL = 1e-6


def _hw(spec):
    """The same constants as each package's HardwareSpec."""
    fields = dataclasses.asdict(spec)
    return t_planner.HardwareSpec(**fields), j_planner.HardwareSpec(**fields)


HW = {"tpu_v5e": _hw(j_planner.TPU_V5E), "h100_sxm": _hw(t_planner.H100_SXM)}

# (flops, bytes, collective bytes, chips, batch per step)
CELLS = {
    "runtime_test": (1e15, 5e12, 2e12, 256, 128),
    "decode_one_chip": (1.7e11, 1.68e10, 0.0, 1, 8),
    "collective_bound": (1e12, 1e10, 5e11, 8, 32),
}


def _models(cell, hw_name):
    flops, nbytes, coll, chips, batch = CELLS[cell]
    t_hw, j_hw = HW[hw_name]
    t_terms = t_planner.terms_from_analysis(
        hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll,
        n_chips=chips, hw=t_hw)
    j_terms = j_planner.terms_from_analysis(
        hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll,
        n_chips=chips, hw=j_hw)
    return (t_planner.ServingModel(name=cell, terms=t_terms, n_chips=chips,
                                   batch_per_step=batch),
            j_planner.ServingModel(name=cell, terms=j_terms, n_chips=chips,
                                   batch_per_step=batch))


@pytest.mark.parametrize("hw_name", sorted(HW))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_terms_from_analysis_equal(cell, hw_name):
    port, ref = _models(cell, hw_name)
    assert dataclasses.astuple(port.terms) == dataclasses.astuple(ref.terms)
    assert port.terms.bound == ref.terms.bound
    assert (port.terms.step_time_lower_bound
            == ref.terms.step_time_lower_bound)
    assert (port.terms.step_time_serial_bound
            == ref.terms.step_time_serial_bound)


@pytest.mark.parametrize("jitter", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_serving_params_equal(cell, jitter):
    port, ref = _models(cell, "h100_sxm")
    t_p = t_planner.serving_params(port, overlap_fraction=0.3,
                                   straggler_jitter=jitter, device="cpu")
    j_p = j_planner.serving_params(ref, overlap_fraction=0.3,
                                   straggler_jitter=jitter)
    for f in ("p", "s_broker", "s_hit", "s_miss", "hit"):
        assert getattr(t_p, f) == getattr(j_p, f), f
    assert math.isclose(t_p.s_disk, j_p.s_disk, rel_tol=RTOL)


def _assert_plans_equal(port, ref):
    assert (port.model, port.cells, port.chips, port.bound) == (
        ref.model, ref.cells, ref.chips, ref.bound)
    for f in ("per_cell_rate", "response_upper_ms", "utilization"):
        t, j = getattr(port, f), getattr(ref, f)
        assert t == j or math.isclose(t, j, rel_tol=RTOL), (f, t, j)


@pytest.mark.parametrize("hw_name", sorted(HW))
@pytest.mark.parametrize("cell,rate,slo", [
    ("runtime_test", 2000.0, 0.5),
    ("decode_one_chip", 500.0, 0.05),
    ("decode_one_chip", 40.0, 0.2),
    ("collective_bound", 300.0, 1.0),
])
@pytest.mark.parametrize("cache", [None, (0.3, 1e-4)])
def test_plan_serving_equal(hw_name, cell, rate, slo, cache):
    port, ref = _models(cell, hw_name)
    _assert_plans_equal(
        t_planner.plan_serving(port, rate, slo, result_cache=cache,
                               device="cpu"),
        j_planner.plan_serving(ref, rate, slo, result_cache=cache))


@pytest.mark.parametrize("cache", [None, (0.3, 1e-4)])
def test_plan_serving_infeasible_slo(cache):
    """An SLO below one step's service time: no fleet size helps."""
    port, ref = _models("runtime_test", "tpu_v5e")
    slo = 0.5 * port.terms.step_time_lower_bound
    t_plan = t_planner.plan_serving(port, 100.0, slo, result_cache=cache,
                                    device="cpu")
    _assert_plans_equal(t_plan, j_planner.plan_serving(
        ref, 100.0, slo, result_cache=cache))
    assert (t_plan.cells, t_plan.response_upper_ms) == (0, float("inf"))


def test_h100_constants_and_default():
    hw = t_planner.H100_SXM
    assert (hw.peak_flops, hw.hbm_bandwidth, hw.ici_bandwidth,
            hw.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)
    terms = t_planner.terms_from_analysis(hlo_flops=989e12,
                                          hlo_bytes=3.35e12,
                                          collective_bytes=0.0, n_chips=1)
    assert (terms.compute_s, terms.memory_s) == (1.0, 1.0)
