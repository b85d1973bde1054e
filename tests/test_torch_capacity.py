"""The port's Section-6 tables, solvers and plans held against
`repro.core.capacity`.

The simulated cross-check of `plan_capacity` runs on the reference's own
draws: the reference's planned run is ``simulate_fork_join(key, ...)``
with one scenario, so its chunks draw ``chunk_random_draws(key, c, 1,
...)`` plus the random-routing side stream, and the port receives them
through ``plan_capacity(draws=...)``.  Means agree to 1e-4 in float32 (as
in tests/test_torch_replication.py), the p95 to one part in 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import queueing as jq
from repro.core import simulator as jsim
from repro.core.cluster import ClusterSpec as JCluster
from repro_torch import interop
from repro_torch.core import capacity as tcap
from repro_torch.core import queueing as tq
from repro_torch.core.cluster import ClusterSpec
from repro_torch.launch.elastic import AutoscalePolicy

CPU = "cpu"
T5J = jcap.TABLE5_PARAMS
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


def _assert_plans_equal(port, ref, rtol=1e-5):
    for f in ("n_replicas", "servers_per_replica", "total_servers",
              "routing", "survive_faults", "autoscale",
              "mean_active_replicas", "response_faulted_p95_ms"):
        assert getattr(port, f) == getattr(ref, f), f
    np.testing.assert_allclose(port.per_replica_rate_qps,
                               ref.per_replica_rate_qps, rtol=1e-12)
    for f in ("response_upper_ms", "response_lower_ms", "utilization"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=rtol, err_msg=f)


@pytest.mark.parametrize("target", [56.0, 195.0, 200.0])
@pytest.mark.parametrize("cache", [None, (0.5, 0.069e-3)])
@pytest.mark.parametrize("name", SCENARIOS)
def test_plan_capacity_matches_reference(name, cache, target):
    ref = jcap.plan_capacity(jcap.scenario(name), target, 0.300,
                             cluster=JCluster(result_cache=cache))
    port = tcap.plan_capacity(tcap.scenario(name, device=CPU), target,
                              0.300, cluster=ClusterSpec(result_cache=cache))
    _assert_plans_equal(port, ref)
    assert port.response_simulated_ms is None
    assert port.response_simulated_p95_ms is None


def test_paper_plans():
    """tests/test_capacity.py's plans through the port: 4 x 100 servers
    serve 200 qps within 300 ms (Scenario 4); with result caching, 3 x
    100 serve 195 qps (Scenario 6)."""
    p4 = tcap.scenario("memory+cpus+disks", device=CPU)
    plan = tcap.plan_capacity(p4, 200.0, 0.300)
    assert (plan.n_replicas, plan.servers_per_replica,
            plan.total_servers) == (4, 100, 400)
    assert plan.response_upper_ms < 300.0
    plan6 = tcap.plan_capacity(
        p4, 195.0, 0.300, cluster=ClusterSpec(result_cache=(0.5, 0.069e-3)))
    assert plan6.n_replicas == 3


def _reference_plan_draws(key, params, n_queries, chunk, r, routing):
    """The reference plan's simulated run's draws (one scenario)."""
    vp = jsim._vec_params(params)
    p = int(params.p)
    per_chunk = []
    for c in range(-(-n_queries // chunk)):
        g, b, sv = jsim.chunk_random_draws(key, c, 1, chunk, p, vp,
                                           "exponential")
        side = {}
        if r > 1 and routing == "random":
            kc = jax.random.fold_in(key, c)
            side["route"] = np.asarray(jax.random.randint(
                jax.random.fold_in(kc, jsim._ROUTE_SALT), (1, chunk), 0, r))
        per_chunk.append((np.asarray(g), np.asarray(b), np.asarray(sv),
                          side))
    return per_chunk


@pytest.mark.parametrize("routing", ["random", "round_robin", "jsq"])
def test_plan_capacity_simulated_on_reference_draws(routing):
    """plan_capacity(simulate=True) on the reference's draws: the same
    fleet, the same simulated mean and p95."""
    n_queries, chunk, key = 12_000, 4096, jax.random.PRNGKey(10)
    ref = jcap.plan_capacity(T5J, 80.0, 0.9, simulate=True,
                             cluster=JCluster(routing=routing), key=key,
                             n_queries=n_queries)
    per_chunk = _reference_plan_draws(key, T5J, n_queries, chunk,
                                      ref.n_replicas, routing)
    port = tcap.plan_capacity(
        tcap.TABLE5_PARAMS, 80.0, 0.9, simulate=True,
        cluster=ClusterSpec(routing=routing), n_queries=n_queries,
        draws=interop.draws_from_numpy(per_chunk, device=CPU), device=CPU)
    _assert_plans_equal(port, ref)
    assert port.n_replicas >= 2
    np.testing.assert_allclose(port.response_simulated_ms,
                               ref.response_simulated_ms, rtol=1e-4)
    np.testing.assert_allclose(port.response_simulated_p95_ms,
                               ref.response_simulated_p95_ms, rtol=1e-3)


def test_plan_capacity_simulated_crosscheck():
    """tests/test_replication.py:276 through the port, on its own RNG:
    the simulated mean respects the SLO the plan promised and stays above
    the Eq 7 lower bound."""
    plan = tcap.plan_capacity(tcap.TABLE5_PARAMS, 80.0, 0.9, simulate=True,
                              cluster=ClusterSpec(routing="random"), seed=10,
                              device=CPU)
    assert plan.n_replicas >= 2
    assert plan.response_simulated_ms is not None
    assert plan.response_simulated_ms <= 0.9 * 1e3
    assert plan.response_simulated_ms >= plan.response_lower_ms * 0.9
    assert plan.response_simulated_p95_ms > plan.response_simulated_ms
    assert plan.routing == "random"


def test_plan_capacity_refusals():
    p4 = tcap.scenario("memory+cpus+disks", device=CPU)
    with pytest.raises(ValueError, match="sizes the fleet itself"):
        tcap.plan_capacity(p4, 200.0, 0.3, cluster=ClusterSpec(r=2))
    with pytest.raises(ValueError, match="survive_faults must be >= 0"):
        tcap.plan_capacity(p4, 200.0, 0.3, survive_faults=-1)
    with pytest.raises(ValueError, match="sizes a static fleet"):
        tcap.plan_capacity(
            p4, 200.0, 0.3, survive_faults=1, simulate=True,
            cluster=ClusterSpec(autoscale=AutoscalePolicy(min_r=1,
                                                          max_r=4)))
    # an infeasible SLO skips the cross-check with the reference's warning
    base = tcap.scenario("baseline", device=CPU)
    with pytest.warns(UserWarning, match="infeasible SLO"):
        plan = tcap.plan_capacity(base, 10.0, 0.3, simulate=True)
    assert plan.response_simulated_ms is None and plan.routing is None


@pytest.mark.parametrize("cache", [None, (0.5, 0.069e-3)])
@pytest.mark.parametrize("memory", [1, 2, 3, 4])
def test_upgrade_grid_matches_reference(memory, cache):
    for lam in (4.0, 56.0):
        ref = np.asarray(jcap.upgrade_grid(lam, memory=memory,
                                           result_cache=cache))
        port = tcap.upgrade_grid(lam, memory=memory, result_cache=cache,
                                 device=CPU).numpy()
        assert port.shape == ref.shape == (7, 7)
        np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(port[fin], ref[fin], rtol=1e-5)
    speeds = np.array([1.0, 1.3, 2.2, 5.0], np.float32)
    ref = np.asarray(jcap.upgrade_grid(20.0, memory=memory, p=50,
                                       cpu_speeds=jnp.asarray(speeds),
                                       disk_speeds=jnp.asarray(speeds[:3])))
    port = tcap.upgrade_grid(20.0, memory=memory, p=50,
                             cpu_speeds=torch.from_numpy(speeds),
                             disk_speeds=speeds[:3], device=CPU).numpy()
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    np.testing.assert_allclose(port[np.isfinite(ref)],
                               ref[np.isfinite(ref)], rtol=1e-5)


def test_upgrade_grid_paper_shapes():
    """tests/test_capacity.py's Fig 13 checks through the port."""
    g1 = tcap.upgrade_grid(4.0, memory=1, device=CPU).numpy()
    g4 = tcap.upgrade_grid(4.0, memory=4, device=CPU).numpy()
    assert g1.shape == (7, 7)
    assert (np.diff(g1, axis=0) <= 1e-9).all()  # faster cpu -> lower R
    assert (np.diff(g1, axis=1) <= 1e-9).all()  # faster disk -> lower R
    assert g1[0, 0] - g1[0, -1] > g1[0, 0] - g1[-1, 0]  # 1x: disk-bound
    assert g4[0, 0] - g4[-1, 0] > g4[0, 0] - g4[0, -1]  # 4x: cpu-bound
