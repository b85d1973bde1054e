"""Elastic autoscaling in the port, held against the reference engine's
elastic slice.

Mirrors tests/test_autoscale.py, port against port on the port's own
random numbers: a pinned policy (min_r == max_r == r) is bit-identical to
the static-r engine under round-robin with chunk % r != 0 and under JSQ,
fused and masked; under a live policy the fused engine equals the masked
oracle in float64; ``replica_seconds`` lies between min_r and max_r times
``elapsed_seconds``; a static run has no elastic fields; the ClusterSpec
refusals; the policy grid axis and its replica-second frontier; and the
`plan_capacity` cross-check.

Not mirrored: the two legacy-keyword tests (tests/test_autoscale.py:157
and :189), because the port takes ``cluster=`` only.  The policy
validation, `for_slo` and the chunking property of `autoscale_scan` are
in tests/test_torch_elastic.py.

Against the reference, on its own draws (the canonical chunk draws and
the ``"route"`` / ``"route_u"`` uniforms random routing reads, built as
the reference builds them; see tests/test_torch_faults.py) in float64: a
live policy under the three routings, fused and masked, and at max_r = 1
through `simulate_fork_join`; a policy grid through `sweep_simulated`,
`extract_frontier` and `plan_over_grid`; and the `plan_capacity`
cross-check.  Counts are exact, sums agree to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import simulator as jsim
from repro.core import sweep as jsweep
from repro.core.cluster import ClusterSpec as JCluster
from repro.launch import elastic as jel
from repro_torch import interop
from repro_torch.core import capacity as tcap
from repro_torch.core import planner as tplanner
from repro_torch.core import simulator as tsim
from repro_torch.core import sweep as tsweep
from repro_torch.core.cluster import ClusterSpec
from repro_torch.launch.elastic import AutoscalePolicy
from repro_torch.obs import TelemetrySpec
from test_torch_faults import (assert_matches_reference, both_batch,
                               dispatch_draws, reference_draws)

CPU = "cpu"
F64 = torch.float64
T5 = tcap.TABLE5_PARAMS
_SUMS = ("sum_response", "sumsq_response", "sum_broker", "sum_cluster",
         "sum_server")
_LIVE = dict(min_r=1, max_r=3, target_utilization=0.5,
             decision_interval_seconds=0.3, stabilization_intervals=2)


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _pinned(r, **kw):
    """A policy that can never move: min_r == max_r == r."""
    return AutoscalePolicy(min_r=r, max_r=r, decision_interval_seconds=0.5,
                           **kw)


def _jpolicy(pol):
    return jel.AutoscalePolicy(**dataclasses.asdict(pol))


# --------------------------------------------------------- degenerate policy

@pytest.mark.parametrize("routing,r", [
    ("round_robin", 3),   # chunk % r != 0, and the reshape fast path is
                          # gated off under a policy: the sorted path
    ("jsq", 3),
])
@pytest.mark.parametrize("impl", ["fused", "masked"])
def test_pinned_policy_matches_static_engine(routing, r, impl):
    """min_r == max_r == r reproduces the static-r engine's statistics
    exactly: the controller runs, every decision is a no-op."""
    kw = dict(chunk_size=1024, tap_size=16, device=CPU)
    static = tsim.simulate_fork_join(
        0, 45.0, 8_000, T5,
        cluster=ClusterSpec(r=r, routing=routing, replica_impl=impl), **kw)
    pinned = tsim.simulate_fork_join(
        0, 45.0, 8_000, T5,
        cluster=ClusterSpec(routing=routing, replica_impl=impl,
                            autoscale=_pinned(r)), **kw)
    for name in ("count",) + _SUMS + ("hist",):
        assert torch.equal(getattr(static, name), getattr(pinned, name)), \
            f"{routing} r={r} {impl}: {name}"
    np.testing.assert_allclose(float(pinned.mean_active_replicas), r,
                               rtol=1e-6)


def test_active_policy_fused_matches_masked():
    """Under a LIVE policy the fused route-compacted engine agrees with the
    masked phantom oracle in float64."""
    pol = AutoscalePolicy(**_LIVE)
    params = dataclasses.replace(tcap.scenario_params(memory=1, p=4,
                                                      device=CPU), p=4)
    out = {}
    for impl in ("fused", "masked"):
        out[impl] = tsim.simulate_fork_join(
            1, 55.0, 6_000, params, chunk_size=512, mode="cache", p=4,
            cluster=ClusterSpec(routing="jsq", replica_impl=impl,
                                autoscale=pol), device=CPU, dtype=F64)
    assert 1.0 < float(out["fused"].mean_active_replicas) < 3.0
    for name in ("count",) + _SUMS + ("replica_seconds", "elapsed_seconds"):
        np.testing.assert_allclose(getattr(out["fused"], name).numpy(),
                                   getattr(out["masked"], name).numpy(),
                                   rtol=1e-9, err_msg=name)


# ------------------------------------------------------------ cost integral

def test_replica_seconds_bounds():
    """replica_seconds integrates the active count over valid time, so
    min_r * elapsed <= replica_seconds <= max_r * elapsed, and 60 qps on
    one Table-5 replica makes the policy scale out; telemetry's
    active_replicas exposes the trajectory, within [min_r, max_r], and
    it reacts to load (tests/test_autoscale.py:118)."""
    pol = AutoscalePolicy(min_r=1, max_r=4, target_utilization=0.6,
                          decision_interval_seconds=0.4,
                          stabilization_intervals=2)
    res = tsim.simulate_fork_join(
        2, 60.0, 12_000, T5, chunk_size=1024,
        cluster=ClusterSpec(routing="jsq", autoscale=pol),
        telemetry=TelemetrySpec(n_bins=16), device=CPU)
    rs, el = float(res.replica_seconds), float(res.elapsed_seconds)
    assert 0.0 < el
    assert pol.min_r * el <= rs <= pol.max_r * el * (1 + 1e-6)
    assert 1.5 <= float(res.mean_active_replicas) <= 4.0
    act = res.timeline.active_replicas.numpy()
    live = res.timeline.count.numpy() > 0
    assert live.any()
    assert np.all(act[live] >= pol.min_r - 1e-6)
    assert np.all(act[live] <= pol.max_r + 1e-6)
    assert act[live].max() > 1.5


def test_static_run_has_no_elastic_fields():
    res = tsim.simulate_fork_join(3, 20.0, 2_000, T5, device=CPU)
    assert res.replica_seconds is None
    assert res.elapsed_seconds is None
    with pytest.raises(ValueError, match="no autoscaler ran"):
        _ = res.mean_active_replicas


def test_cluster_spec_validation():
    with pytest.raises(ValueError, match="unknown routing"):
        ClusterSpec(routing="nope")
    with pytest.raises(ValueError, match="unknown replica_impl"):
        ClusterSpec(replica_impl="nope")
    with pytest.raises(ValueError, match="leave r at its default"):
        ClusterSpec(r=2, autoscale=AutoscalePolicy(min_r=1, max_r=4))
    with pytest.raises(TypeError, match="AutoscalePolicy"):
        ClusterSpec(autoscale="1..4")
    with pytest.raises(TypeError, match="AutoscalePolicy"):
        ClusterSpec(autoscale=jel.AutoscalePolicy(min_r=1, max_r=4))
    assert ClusterSpec(autoscale=AutoscalePolicy(min_r=1,
                                                 max_r=4)).engine_r == 4
    assert ClusterSpec(r=3).engine_r == 3
    assert hash(ClusterSpec(result_cache=(0.3, 1e-3))) == \
        hash(ClusterSpec(result_cache=(0.3, 1e-3)))


# ----------------------------------------------------------- sweep plumbing

_POLS = (AutoscalePolicy(min_r=1, max_r=2, decision_interval_seconds=0.5),
         AutoscalePolicy(min_r=1, max_r=3, decision_interval_seconds=0.5))


def test_policy_grid_axis_and_frontier():
    """The policy axis rides the sweep: shape swaps r for len(policies),
    the frontier prices by replica-seconds, and the analytic path
    refuses."""
    grid = tsweep.SweepGrid.build(lam=[25.0, 50.0], p=[8.0], base=T5,
                                  hit=[0.17], broker_from_p=False,
                                  autoscale=_POLS, device=CPU)
    assert grid.shape == (2, 1, 1, 1, 1, 2)
    with pytest.raises(ValueError, match="sweep_analytical cannot"):
        tsweep.sweep_analytical(grid)
    with pytest.raises(ValueError, match="policy grid"):
        grid.lam_replica()
    res = tsweep.sweep_simulated(grid, 6, n_queries=4_000, chunk_size=512,
                                 cluster=ClusterSpec(routing="jsq"))
    assert tuple(res.stats.replica_seconds.shape) == grid.shape
    eff = (res.stats.replica_seconds
           / res.stats.elapsed_seconds.clamp_min(1e-30))
    assert bool((eff >= 1.0 - 1e-6).all())
    assert bool((eff[..., 0] <= 2.0 + 1e-6).all())
    assert bool((eff[..., 1] <= 3.0 + 1e-6).all())
    fr = tsweep.extract_frontier(res, 2.0)
    assert fr.autoscale is not None and len(fr.autoscale) == 2
    for i in range(2):
        if bool(fr.feasible[i]):
            assert fr.autoscale[i] in _POLS
            assert "autoscale" in fr.describe(i)
    with pytest.raises(ValueError, match="replica-seconds"):
        tsweep.extract_frontier(
            tsweep.SimSweepResult(grid=grid, stats=dataclasses.replace(
                res.stats, replica_seconds=None)), 2.0)
    with pytest.raises(ValueError, match="sweep axis"):
        tsweep.sweep_simulated(grid, cluster=ClusterSpec(
            autoscale=_POLS[0]))


def test_policy_grid_keeps_r_axis_static_error():
    with pytest.raises(ValueError, match="policy grid replaces"):
        tsweep.SweepGrid.build(lam=[20.0], p=[8.0], base=T5, r=[2.0],
                               autoscale=(_POLS[0],), device=CPU)
    with pytest.raises(TypeError, match="AutoscalePolicy"):
        tsweep.SweepGrid.build(lam=[20.0], p=[8.0], base=T5,
                               autoscale=(None,), device=CPU)


def test_plan_capacity_autoscale_crosscheck():
    """plan_capacity keeps the static Sec-6 sizing as the headline but
    simulates the elastic fleet and reports its mean active count."""
    pol = AutoscalePolicy(min_r=1, max_r=6, decision_interval_seconds=1.0)
    with pytest.raises(ValueError, match="simulate=True"):
        tcap.plan_capacity(T5, 60.0, 0.9, cluster=ClusterSpec(autoscale=pol),
                           device=CPU)
    plan = tcap.plan_capacity(T5, 60.0, 0.9, simulate=True, seed=7,
                              n_queries=12_000,
                              cluster=ClusterSpec(routing="jsq",
                                                  autoscale=pol),
                              device=CPU)
    assert plan.autoscale is pol
    assert plan.mean_active_replicas is not None
    assert 1.0 <= plan.mean_active_replicas <= 6.0
    assert plan.response_simulated_ms is not None


# ------------------------------------------------------- against reference

@pytest.mark.parametrize("routing,impl", [
    ("round_robin", "fused"), ("random", "fused"), ("jsq", "fused"),
    ("round_robin", "masked"), ("random", "masked"), ("jsq", "masked")])
def test_active_policy_matches_reference(x64, routing, impl):
    """A live policy (it scales out and drains) with the result cache, on
    the reference's draws; random routing thins the reference's
    ``route_u`` uniforms over the active count."""
    pol = AutoscalePolicy(**_LIVE)
    ref, port = both_batch(routing, cache=(0.25, 2e-3), policy=pol,
                           jpolicy=_jpolicy(pol), impl=impl, lam=2.0)
    assert_matches_reference(port, ref,
                             extra=("replica_seconds", "elapsed_seconds"))
    active = port.mean_active_replicas
    assert bool((active > 1.5).all()) and bool((active <= 3.0).all())


def test_active_policy_timeline_matches_reference(x64):
    """The autoscaler's trajectory on a `Timeline` (JSQ, the cache)
    against the reference's on its draws: the active-replica sums beside
    the base channels; no fault channel."""
    from test_torch_obs import assert_timelines_match
    pol = AutoscalePolicy(**_LIVE)
    ref, port = both_batch("jsq", cache=(0.25, 2e-3), policy=pol,
                           jpolicy=_jpolicy(pol), lam=2.0, n=2_048,
                           chunk=256, tap=0,
                           telemetry=TelemetrySpec(n_bins=6))
    tl = port.timeline
    assert_timelines_match(tl, ref.timeline)
    assert tl.up_sum is None and tl.spill_sum is None
    act = tl.active_replicas.numpy()
    assert act.min() >= 1.0 and act.max() <= 3.0 and act.max() > 1.5


def test_single_replica_policy_matches_reference(x64):
    """max_r = 1 through `simulate_fork_join`: the r = 1 engine with the
    controller's cost integral."""
    pol = AutoscalePolicy(min_r=1, max_r=1, decision_interval_seconds=0.3)
    key, n, chunk = jax.random.PRNGKey(4), 3000, 512
    ref = jsim.simulate_fork_join(key, 18.0, n, jcap.TABLE5_PARAMS,
                                  impl="xla", chunk_size=chunk,
                                  cluster=JCluster(autoscale=_jpolicy(pol)))
    per_chunk = reference_draws(
        key, -(-n // chunk), 1, chunk, int(jcap.TABLE5_PARAMS.p),
        jsim._vec_params(jcap.TABLE5_PARAMS), "exponential", r=1,
        routing="round_robin", elastic=True)
    port = tsim.simulate_fork_join(
        4, 18.0, n, T5, chunk_size=chunk, cluster=ClusterSpec(autoscale=pol),
        device=CPU, dtype=F64,
        draws=interop.draws_from_numpy(per_chunk, device=CPU, dtype=F64))
    assert port.count.shape == ()
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    for name in _SUMS + ("replica_seconds", "elapsed_seconds"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, err_msg=name)
    np.testing.assert_allclose(float(port.mean_active_replicas), 1.0)


def test_policy_grid_matches_reference(x64):
    """A policy axis through sweep_simulated, extract_frontier (priced by
    replica-seconds) and plan_over_grid, on the reference's per-dispatch
    draws, random routing."""
    axes = dict(lam=np.array([25.0, 50.0], np.float32),
                p=np.array([8.0], np.float32),
                hit=np.array([0.17], np.float32))
    t5 = jcap.TABLE5_PARAMS
    jg = jsweep.SweepGrid.build(
        **{k: jnp.asarray(v) for k, v in axes.items()}, base=t5,
        broker_from_p=False, autoscale=tuple(_jpolicy(p) for p in _POLS))
    tg = tsweep.SweepGrid.build(
        **{k: torch.from_numpy(v) for k, v in axes.items()}, base=T5,
        broker_from_p=False, autoscale=_POLS, device=CPU)
    assert tg.shape == jg.shape
    n, chunk, key, routing = 3072, 512, jax.random.PRNGKey(6), "random"
    kw = dict(n_queries=n, chunk_size=chunk)
    ref = jsweep.sweep_simulated(jg, key, cluster=JCluster(routing=routing),
                                 **kw)
    per = dispatch_draws(key, jg, [(p.max_r, True, None) for p in _POLS],
                         n=n, chunk=chunk, mode="exponential",
                         routing=routing)

    def draws(k):
        return interop.draws_from_numpy(per[k], device=CPU, dtype=F64)
    port = tsweep.sweep_simulated(tg, 6, cluster=ClusterSpec(
        routing=routing), draws=draws, dtype=F64, **kw)
    np.testing.assert_array_equal(port.stats.count.numpy(),
                                  np.asarray(ref.stats.count))
    for name in _SUMS + ("replica_seconds", "elapsed_seconds"):
        np.testing.assert_allclose(getattr(port.stats, name).numpy(),
                                   np.asarray(getattr(ref.stats, name)),
                                   rtol=1e-10, err_msg=name)
    for slo in (0.2, 2.0):
        fr_ref = jsweep.extract_frontier(ref, slo)
        fr = tsweep.extract_frontier(port, slo)
        np.testing.assert_array_equal(fr.feasible.numpy(),
                                      np.asarray(fr_ref.feasible))
        np.testing.assert_allclose(fr.cost.numpy(), np.asarray(fr_ref.cost),
                                   rtol=1e-6)
        np.testing.assert_allclose(fr.r.numpy(), np.asarray(fr_ref.r),
                                   rtol=1e-10)
        assert [dataclasses.asdict(p) for p in fr.autoscale] == [
            dataclasses.asdict(p) for p in fr_ref.autoscale]
    # plan_over_grid is the sweep and its frontier
    _, fr_plan = tplanner.plan_over_grid(
        tg, 2.0, simulate=True, seed=6, cluster=ClusterSpec(routing=routing),
        draws=draws, dtype=F64, **kw)
    fr_ref = jsweep.extract_frontier(ref, 2.0)
    np.testing.assert_allclose(fr_plan.r.numpy(), np.asarray(fr_ref.r),
                               rtol=1e-10)
    assert [fr_plan.describe(i) for i in range(2)] == [
        fr_ref.describe(i) for i in range(2)]


def test_plan_capacity_autoscale_matches_reference():
    """The plan's elastic cross-check on the reference's draws: the same
    headline fleet, the same mean active count and simulated response."""
    pol = AutoscalePolicy(min_r=1, max_r=6, decision_interval_seconds=1.0)
    n_queries, chunk, key = 12_000, 4096, jax.random.PRNGKey(7)
    t5 = jcap.TABLE5_PARAMS
    ref = jcap.plan_capacity(t5, 60.0, 0.9, simulate=True, key=key,
                             n_queries=n_queries,
                             cluster=JCluster(routing="random",
                                              autoscale=_jpolicy(pol)))
    per_chunk = reference_draws(key, -(-n_queries // chunk), 1, chunk,
                                int(t5.p), jsim._vec_params(t5),
                                "exponential", r=pol.max_r,
                                routing="random", elastic=True)
    port = tcap.plan_capacity(
        T5, 60.0, 0.9, simulate=True, n_queries=n_queries,
        cluster=ClusterSpec(routing="random", autoscale=pol),
        draws=interop.draws_from_numpy(per_chunk, device=CPU), device=CPU)
    assert (port.n_replicas, port.total_servers) == (ref.n_replicas,
                                                     ref.total_servers)
    assert port.autoscale is pol and ref.autoscale is not None
    np.testing.assert_allclose(port.mean_active_replicas,
                               ref.mean_active_replicas, rtol=1e-5)
    np.testing.assert_allclose(port.response_simulated_ms,
                               ref.response_simulated_ms, rtol=1e-4)
