"""The port's Section-6 tables and solvers held against
`repro.core.capacity`."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import queueing as jq
from repro_torch.core import capacity as tcap
from repro_torch.core import queueing as tq

CPU = "cpu"
SCENARIOS = ["baseline", "memory+disks", "memory+cpus", "cpus+disks",
             "memory+cpus+disks"]


def test_tables_are_the_reference_tables():
    assert tcap.MEMORY_TABLE == jcap.MEMORY_TABLE
    assert tcap.TABLE5_SBROKER == jcap.TABLE5_SBROKER
    assert dataclasses.asdict(tcap.TABLE5_PARAMS) == dataclasses.asdict(
        jcap.TABLE5_PARAMS)


def test_broker_service_time_dense():
    p = np.arange(1, 2049, dtype=np.int32)
    np.testing.assert_allclose(
        tcap.broker_service_time(torch.from_numpy(p)).numpy(),
        np.asarray(jcap.broker_service_time(p)), rtol=1e-6)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenarios_and_curves(name):
    pj = jcap.scenario(name)
    pt = tcap.scenario(name, device=CPU)
    for f in dataclasses.fields(jq.ServerParams):
        np.testing.assert_allclose(
            np.asarray(getattr(pt, f.name)), np.asarray(getattr(pj, f.name)),
            rtol=1e-6)
    grid = np.linspace(1.0, 80.0, 200, dtype=np.float32)
    np.testing.assert_allclose(
        tcap.upper_bound_curve(torch.from_numpy(grid), pt).numpy(),
        np.asarray(jcap.upper_bound_curve(grid, pj)), rtol=1e-6)


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("cache", [None, (0.5, 0.069e-3)])
def test_slo_solver_and_replicas(name, cache):
    pj = jcap.scenario(name)
    pt = tcap.scenario(name, device=CPU)
    for slo in (0.2, 0.25, 0.3, 0.5):
        lam_t = tcap.max_rate_under_slo(pt, slo, result_cache=cache)
        lam_j = jcap.max_rate_under_slo(pj, slo, result_cache=cache)
        # the responses AT the two solutions agree to f32 precision
        _, r_t = jq.response_time_bounds(float(lam_t), pj)
        _, r_j = jq.response_time_bounds(float(lam_j), pj)
        np.testing.assert_allclose(float(r_t), float(r_j), rtol=1e-6)
        if slo == 0.2:
            # memory+disks has R(0) = 0.19991 s: R(lambda) is nearly flat
            # below this SLO, so one ulp of R moves lambda (and the
            # replica count) by ~3e-4 relative — the response check above
            # is the meaningful one there
            continue
        np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-5,
                                   atol=1e-6)
        n_t, _ = tcap.replicas_needed(pt, 195.0, slo, result_cache=cache)
        n_j, _ = jcap.replicas_needed(pj, 195.0, slo, result_cache=cache)
        assert int(n_t) == int(n_j)


def test_paper_case_study_numbers():
    """tests/test_capacity.py's paper checks, through the port."""
    p4 = tcap.scenario("memory+cpus+disks", device=CPU)
    assert np.isclose(float(tcap.broker_service_time(100, device=CPU))
                      * 1e3, 3.45, atol=0.02)
    _, hi = tq.response_time_bounds(56.0, p4)
    assert abs(float(hi) * 1e3 - 286.0) < 3.0
    r = tq.response_time_with_result_cache(65.0, p4, 0.5, 0.069e-3)
    assert abs(float(r) * 1e3 - 282.0) < 5.0
    n, _ = tcap.replicas_needed(p4, 195.0, 0.300,
                                result_cache=(0.5, 0.069e-3))
    assert int(n) == 3
    lam = tcap.max_rate_under_slo(p4, 0.300)
    _, at = tq.response_time_bounds(float(lam), p4)
    _, above = tq.response_time_bounds(float(lam) * 1.02, p4)
    assert float(at) <= 0.300 + 1e-5 < float(above)
