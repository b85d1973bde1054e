"""The port's serving planner held against `repro.core.planner`.

Both packages get the same hardware (the reference's TPU v5e constants,
passed explicitly as ``hw``, and the port's H100 constants rebuilt in
the reference's `HardwareSpec`), the same counters and the same SLOs.
Roofline terms are Python floats: equal exactly.  The queueing side runs
in float32 in both (the bisection, Eq 7 / Eq 8): integers (cells, chips)
equal, rates and responses to rtol 1e-6.

`plan_over_grid` gets grids built from the same numpy axes: the analytic
frontier must choose the reference's configurations, and the simulated
one, run on the reference's draws (a diurnal profile included), the
reference's too.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capacity as j_capacity
from repro.core import planner as j_planner
from repro.core import queueing as j_queueing
from repro.core import simulator as j_sim
from repro.core import sweep as j_sweep
from repro.workloadgen import loadgen as j_loadgen
from repro_torch import interop
from repro_torch.core import planner as t_planner
from repro_torch.core import sweep as t_sweep
from repro_torch.workloadgen import loadgen as t_loadgen

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


# ------------------------------------------------------------ plan_over_grid

T5 = j_capacity.TABLE5_PARAMS


def _grids(**axes):
    j_kw, t_kw = {}, {}
    for k, v in axes.items():
        if k in ("lam", "p", "cpu", "disk", "hit", "r"):
            v = np.asarray(v, np.float32)
            j_kw[k], t_kw[k] = jnp.asarray(v), torch.from_numpy(v)
        else:
            j_kw[k] = t_kw[k] = v
    return (j_sweep.SweepGrid.build(**j_kw),
            t_sweep.SweepGrid.build(device="cpu", **t_kw))


def _frontiers_equal(port, ref):
    for f in ("lam", "p", "cpu", "disk", "hit", "r", "feasible"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(port.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-6)
    for i in range(port.lam.shape[0]):
        assert port.describe(i) == ref.describe(i)


@pytest.mark.parametrize("memory", [1, 2, 3, 4])
@pytest.mark.parametrize("quantile", [None, 0.95])
def test_plan_over_grid_analytic_matches_reference(memory, quantile):
    """examples/whatif_sweep.py's Table 6 columns through both planners."""
    jg, tg = _grids(lam=[16.0, 32.0, 56.0, 80.0],
                    p=[50.0, 100.0, 150.0, 200.0],
                    cpu=np.linspace(1.0, 4.0, 7),
                    disk=np.linspace(1.0, 4.0, 7), memory=memory)
    j_res, j_fr = j_planner.plan_over_grid(jg, 0.3, quantile=quantile)
    t_res, t_fr = t_planner.plan_over_grid(tg, 0.3, quantile=quantile)
    _frontiers_equal(t_fr, j_fr)
    hi, hi_ref = t_res.response_upper.numpy(), np.asarray(j_res.response_upper)
    np.testing.assert_array_equal(np.isinf(hi), np.isinf(hi_ref))
    np.testing.assert_allclose(hi[np.isfinite(hi_ref)],
                               hi_ref[np.isfinite(hi_ref)], rtol=1e-5)


def test_plan_over_grid_simulated_diurnal_matches_reference():
    """simulate=True, quantile=0.95 and a diurnal profile, on the
    reference's draws: the same p95 frontier."""
    jg, tg = _grids(lam=[14.0, 30.0], p=[4.0], cpu=[1.0, 1.5, 2.0],
                    base=T5, hit=[0.17], broker_from_p=False)
    profile = np.asarray(j_loadgen.diurnal_rates(1.0))
    n, chunk, bin_s, key = 4096, 512, 120.0, jax.random.PRNGKey(3)
    j_res, j_fr = j_planner.plan_over_grid(
        jg, 0.3, simulate=True, key=key, quantile=0.95, n_queries=n,
        profile=jnp.asarray(profile), profile_bin_seconds=bin_s,
        chunk_size=chunk)
    # the reference's one dispatch: its key, its (S,) parameters
    _, params_full = jg.broadcast_full()
    params = j_queueing.ServerParams(**{
        f.name: getattr(params_full, f.name).reshape(-1)
        for f in dataclasses.fields(j_queueing.ServerParams)})
    k0 = jax.random.split(key, 1)[0]
    per_chunk = [tuple(np.asarray(x) for x in j_sim.chunk_random_draws(
        k0, c, 6, chunk, 4, params, "exponential"))
        for c in range(n // chunk)]
    t_res, t_fr = t_planner.plan_over_grid(
        tg, 0.3, simulate=True, seed=3, quantile=0.95, n_queries=n,
        profile=torch.from_numpy(profile), profile_bin_seconds=bin_s,
        chunk_size=chunk,
        draws=lambda k: interop.draws_from_numpy(per_chunk, device="cpu"))
    np.testing.assert_allclose(t_res.mean.numpy(), np.asarray(j_res.mean),
                               rtol=1e-4)
    _frontiers_equal(t_fr, j_fr)


def test_plan_over_grid_refuses_simulation_kwargs_when_analytic():
    _, tg = _grids(lam=[10.0], p=[4.0], base=T5)
    for kw in (dict(profile=torch.ones(3)), dict(seed=1),
               dict(n_queries=100), dict(chunk_size=64)):
        with pytest.raises(ValueError, match="simulate=True"):
            t_planner.plan_over_grid(tg, 0.5, **kw)


def test_diurnal_p95_frontier_costs_at_least_the_stationary_mean():
    """tests/test_sweep.py's planning question through the port: the
    cheapest config whose p95 survives the diurnal peak costs at least
    the one planned on the stationary mean, and more somewhere."""
    _, grid = _grids(lam=[14.0, 20.0], p=[4.0, 8.0, 16.0], base=T5,
                     hit=[0.17], broker_from_p=False)
    slo, n = 0.8, 40_000
    _, mean_fr = t_planner.plan_over_grid(grid, slo, simulate=True, seed=7,
                                          n_queries=n)
    profile = t_loadgen.diurnal_rates(1.0, device="cpu")
    _, p95_fr = t_planner.plan_over_grid(
        grid, slo, simulate=True, seed=7, n_queries=n, quantile=0.95,
        profile=profile,
        profile_bin_seconds=n / 14.0 / profile.shape[0] / 4)
    assert bool((p95_fr.cost >= mean_fr.cost).all())
    assert bool((p95_fr.cost > mean_fr.cost).any()) or \
        not bool(p95_fr.feasible.all())
