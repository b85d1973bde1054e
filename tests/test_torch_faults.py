"""Fault injection in the port, held against `repro.core.faults` and the
reference engine's fault slice.

Mirrors tests/test_faults.py test for test, port against port on the
port's own random numbers: ``fault=None`` and an all-up `FaultSpec` are
bit-identical to the fault-free engine under every routing; failover
spills a down replica's share to the survivors; all replicas down counts
queries unavailable; a k-of-p broker timeout caps the join and counts
degraded responses; hedging never hurts; ``plan_capacity(survive_faults=
k)`` is conservative; the sweep's fault axis round-trips; the spec
validates; and `fault_scan` is chunking-invariant (hypothesis).

Against the reference, on the reference's own random numbers (its
canonical chunk draws and its salted side streams, built as it builds
them: ``"route"`` / ``"route_u"``, the cache's, ``"fault_u"`` from
``fold_in(k_fault, 0)`` and ``"hedge"`` from ``fold_in(k_fault, 1 + j)``,
handed over through ``draws=``), in float64: a run with all four fault
channels at r = 3 under the three routings, fused and masked, and at
r = 1; the fault axis of a simulated sweep with its frontier and
`plan_over_grid`; and the N+k plan.  Counts are exact, sums
agree to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import faults as jfaults
from repro.core import queueing as jq
from repro.core import simulator as jsim
from repro.core import sweep as jsweep
from repro.core.arrivals import ArrivalProcess as JArrival
from repro.core.cluster import ClusterSpec as JCluster
from repro_torch import interop
from repro_torch.core import capacity as tcap
from repro_torch.core import planner as tplanner
from repro_torch.core import simulator as tsim
from repro_torch.core import sweep as tsweep
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec, fault_init, fault_scan
from repro_torch.core.queueing import ServerParams

CPU = "cpu"
F64 = torch.float64
PARAMS = ServerParams(p=4, s_broker=0.004, s_hit=0.0125, s_miss=0.05,
                      s_disk=0.04, hit=0.5)
SEED = 42

# statistics the fault-free and all-up programs must share bitwise
SHARED = ("count", "sum_response", "sumsq_response", "sum_broker",
          "sum_cluster", "sum_server", "hist", "tap_response")
_SUMS = ("sum_response", "sumsq_response", "sum_broker", "sum_cluster",
         "sum_server")
_CHANNELS = ("spill_count", "unavail_count", "degraded_count")

ALL_UP = FaultSpec(degraded=((0, 1.0), (2, 1.0)),
                   broker_timeout_seconds=1e9, quorum_k=1,
                   hedge_after_seconds=1e9, hedge_attempts=2)
# all four channels: an outage window, the MTBF/MTTR chain, a degraded
# server, a broker timeout with k = p - 1, and a hedge
ALL_FOUR = dict(outages=((0, 20.0, 60.0),), mtbf_seconds=30.0,
                mttr_seconds=5.0, degraded=((1, 2.0),),
                broker_timeout_seconds=0.05, quorum_k=3,
                hedge_after_seconds=0.04, hedge_attempts=2)


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _spec(fault: FaultSpec) -> jfaults.FaultSpec:
    """The reference's FaultSpec with the port spec's fields."""
    return jfaults.FaultSpec(**dataclasses.asdict(fault))


def reference_draws(key, n_chunks, s, chunk, p, params_j, mode, *, r,
                    routing, cache=None, tap=False, elastic=False,
                    fault=None):
    """The reference's per-chunk draws, every side stream a run of this
    topology reads built as the reference builds it, as numpy."""
    dtype = jnp.result_type(float)
    per_chunk = []
    for c in range(n_chunks):
        g, b, sv = jsim.chunk_random_draws(key, c, s, chunk, p, params_j,
                                           mode)
        kc = jax.random.fold_in(key, c)
        side = {}
        if r > 1 and routing == "random":
            k_route = jax.random.fold_in(kc, jsim._ROUTE_SALT)
            if elastic:
                side["route_u"] = np.asarray(
                    jax.random.uniform(k_route, (s, chunk)))
            else:
                side["route"] = np.asarray(
                    jax.random.randint(k_route, (s, chunk), 0, r))
        if cache is not None:
            kh, ks = jax.random.split(jax.random.fold_in(kc,
                                                         jsim._CACHE_SALT))
            side["cache_hit"] = np.asarray(jax.random.bernoulli(
                kh, jnp.full((s, chunk), cache[0], dtype)))
            side["cache_unit"] = np.asarray(
                jax.random.exponential(ks, (s, chunk)))
        if tap:
            side["tap"] = np.asarray(jax.random.uniform(
                jax.random.fold_in(kc, jsim._TAP_SALT), (s, chunk), dtype))
        if fault is not None:
            k_fault = jax.random.fold_in(kc, jsim._FAULT_SALT)
            if fault.mtbf_seconds is not None:
                side["fault_u"] = np.asarray(jax.random.uniform(
                    jax.random.fold_in(k_fault, 0), (s, chunk, r)))
            if fault.hedge_after_seconds is not None:
                side["hedge"] = np.stack([np.asarray(
                    jax.random.exponential(
                        jax.random.fold_in(k_fault, 1 + j), (s, p, chunk)))
                    for j in range(int(fault.hedge_attempts))])
        per_chunk.append((np.asarray(g), np.asarray(b), np.asarray(sv),
                          side))
    return per_chunk


def params_np(s, p):
    base = jcap.TABLE5_PARAMS
    f = np.linspace(1.0, 1.3, s)
    return dict(p=np.full(s, p), s_broker=base.s_broker * f,
                s_hit=base.s_hit * f, s_miss=base.s_miss * f,
                s_disk=base.s_disk / f, hit=np.full(s, base.hit))


def both_batch(routing, *, r=3, cache=None, fault=None, policy=None,
               jpolicy=None, impl="fused", n=4000, s=2, p=4, chunk=512,
               mode="cache", tap=16, lam=None, seed=0):
    """The reference and the port, batch entry points, on the reference's
    draws in float64; returns (ref, port)."""
    pj = params_np(s, p)
    params_j = jq.ServerParams(**{k: jnp.asarray(v) for k, v in pj.items()})
    rr = policy.max_r if policy is not None else r
    rates = (rr if lam is None else lam) * np.linspace(16.0, 22.0, s)
    key = jax.random.PRNGKey(seed)
    topo = dict(routing=routing, result_cache=cache, replica_impl=impl)
    jr = 1 if policy is not None else r
    ref = jsim.simulate_fork_join_batch(
        key, JArrival.stationary(jnp.asarray(rates)), params_j, n, p=p,
        mode=mode, impl="xla", chunk_size=chunk, tap_size=tap,
        cluster=JCluster(r=jr, autoscale=jpolicy,
                         fault=None if fault is None else _spec(fault),
                         **topo))
    per_chunk = reference_draws(key, -(-n // chunk), s, chunk, p, params_j,
                                mode, r=rr, routing=routing, cache=cache,
                                tap=tap > 0, elastic=policy is not None,
                                fault=fault)
    port = tsim.simulate_fork_join_batch(
        seed, torch.tensor(rates, dtype=F64),
        interop.server_params_from_numpy(pj, device=CPU, dtype=F64), n,
        p=p, mode=mode, chunk_size=chunk, tap_size=tap,
        cluster=ClusterSpec(r=jr, autoscale=policy, fault=fault, **topo),
        device=CPU, dtype=F64,
        draws=interop.draws_from_numpy(per_chunk, device=CPU, dtype=F64))
    return ref, port


def assert_matches_reference(port, ref, extra=()):
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    for name in _SUMS + tuple(extra):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, err_msg=name)
    np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))
    np.testing.assert_allclose(np.sort(port.tap_response.numpy()),
                               np.sort(np.asarray(ref.tap_response)),
                               rtol=1e-10)


def run(fault, *, routing="round_robin", r=3, n=4_000, rate=60.0,
        seed=SEED, **kw):
    return tsim.simulate_fork_join(
        seed, rate, n, PARAMS, chunk_size=512,
        cluster=ClusterSpec(r=r, routing=routing, fault=fault), device=CPU,
        **kw)


# ---------------------------------------------------------------- identity

@pytest.mark.parametrize("routing", ["round_robin", "random", "jsq"])
def test_fault_none_and_all_up_bit_identical(routing):
    """fault=None and the all-up spec give bit-identical shared
    statistics under every routing policy, port against port."""
    a = run(None, routing=routing, tap_size=16)
    b = run(ALL_UP, routing=routing, tap_size=16)
    for name in SHARED:
        assert torch.equal(getattr(a, name).nan_to_num(-7.0),
                           getattr(b, name).nan_to_num(-7.0)), \
            f"{routing}: all-up FaultSpec perturbed {name}"
    assert a.spill_count is None and b.spill_count is not None
    assert float(b.availability) == 1.0
    assert float(b.spill_fraction) == 0.0


def test_fault_none_matches_missing_spec_exactly():
    a = tsim.simulate_fork_join(SEED, 60.0, 2_000, PARAMS, chunk_size=512,
                                cluster=ClusterSpec(r=2), device=CPU)
    b = run(None, r=2, n=2_000)
    for name in SHARED[:-1]:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert b.spill_count is None and b.replica_seconds is None


# ---------------------------------------------------------------- failover

def test_outage_spills_to_survivors():
    horizon = 4_000 / 60.0
    res = run(FaultSpec(outages=((1, 0.0, horizon),)))
    assert float(res.availability) == 1.0
    assert float(res.spill_fraction) > 0.2
    assert float(res.unavail_count) == 0.0
    assert abs(float(res.spill_fraction) - 1.0 / 3.0) < 0.1


def test_all_replicas_down_counts_unavailable():
    horizon = 4_000 / 60.0
    res = run(FaultSpec(outages=tuple((j, 0.0, horizon) for j in range(3))))
    assert float(res.availability) < 0.05
    assert float(res.unavail_count) > 0


def test_jsq_masks_down_replica():
    horizon = 4_000 / 60.0
    res = run(FaultSpec(outages=((0, 0.0, horizon),)), routing="jsq")
    assert float(res.availability) == 1.0
    assert float(res.spill_fraction) > 0.2


def test_windowed_outage_only_affects_window():
    res_win = run(FaultSpec(outages=((0, 5.0, 10.0),)))
    res_always = run(FaultSpec(outages=((0, 0.0, 1e9),)))
    assert (0.0 < float(res_win.spill_fraction)
            < float(res_always.spill_fraction))


def test_mtbf_process_churns_and_repairs():
    res = run(FaultSpec(mtbf_seconds=5.0, mttr_seconds=1.0))
    assert 0.0 < float(res.spill_fraction) < 0.5
    assert float(res.availability) > 0.9


# ------------------------------------------------------------- degradation

def test_quorum_timeout_caps_join_and_counts_degraded():
    slow = dataclasses.replace(PARAMS, hit=0.0)
    spec = ClusterSpec(fault=FaultSpec(broker_timeout_seconds=0.08,
                                       quorum_k=2))
    base = tsim.simulate_fork_join(SEED, 20.0, 3_000, slow, chunk_size=512,
                                   cluster=ClusterSpec(), device=CPU)
    capped = tsim.simulate_fork_join(SEED, 20.0, 3_000, slow,
                                     chunk_size=512, cluster=spec,
                                     device=CPU)
    assert float(capped.degraded_fraction) > 0.1
    assert float(capped.mean_response) < float(base.mean_response)
    assert float(capped.quantile(0.99)) <= float(base.quantile(0.99)) + 1e-6


def test_degraded_server_slows_the_join():
    fast = run(None, n=3_000)
    slow = run(FaultSpec(degraded=((1, 4.0),)), n=3_000)
    assert float(slow.mean_response) > float(fast.mean_response)
    assert float(slow.spill_fraction) == 0.0


def test_hedging_never_hurts():
    slow = dataclasses.replace(PARAMS, hit=0.0)

    def go(fault):
        return tsim.simulate_fork_join(
            SEED, 15.0, 3_000, slow, chunk_size=512,
            cluster=ClusterSpec(r=2, fault=fault), device=CPU)

    base = go(ALL_UP)  # same random numbers; the hedge never fires
    hedged = go(dataclasses.replace(ALL_UP, hedge_after_seconds=0.05))
    assert float(hedged.quantile(0.95)) <= float(base.quantile(0.95)) + 1e-6
    assert float(hedged.mean_response) <= float(base.mean_response) + 1e-6


# ------------------------------------------------------------ plan / sweep

def test_plan_survive_faults_is_conservative():
    """The N+k plan never provisions fewer replicas, and the simulated
    cross-check records the k-down p95."""
    kw = dict(simulate=True, seed=SEED, n_queries=4_000, device=CPU)
    plan0 = tcap.plan_capacity(PARAMS, 120.0, 0.3, **kw)
    plan1 = tcap.plan_capacity(PARAMS, 120.0, 0.3, survive_faults=1, **kw)
    assert plan1.n_replicas >= plan0.n_replicas + 1
    assert plan1.survive_faults == 1
    assert plan1.response_faulted_p95_ms is not None
    assert plan0.survive_faults == 0
    assert plan0.response_faulted_p95_ms is None


def test_plan_rejects_double_injection():
    with pytest.raises(ValueError, match="fault"):
        tcap.plan_capacity(
            PARAMS, 50.0, 0.3, survive_faults=1, device=CPU,
            cluster=ClusterSpec(fault=FaultSpec(mtbf_seconds=9.0)))


def test_sweep_fault_axis_round_trips():
    faults = (None, FaultSpec(outages=((0, 0.0, 1e9),)))
    grid = tsweep.SweepGrid.build(lam=[40.0], p=[4.0], hit=[PARAMS.hit],
                                  base=PARAMS, broker_from_p=False,
                                  r=[3.0], fault=faults, device=CPU)
    assert grid.shape[-1] == 2
    res = tsweep.sweep_simulated(grid, SEED, n_queries=2_000,
                                 chunk_size=512)
    spill = res.stats.spill_fraction.flatten()
    assert float(spill[0]) == 0.0 and float(spill[1]) > 0.2
    with pytest.raises(ValueError, match="fault"):
        tsweep.sweep_analytical(grid)
    with pytest.raises(ValueError, match="6th axis|axis"):
        tsweep.SweepGrid.build(
            lam=[40.0], p=[4.0], hit=[0.5], base=PARAMS, r=[2.0],
            fault=faults, autoscale=(None,), device=CPU)


def test_faultspec_validation():
    with pytest.raises(ValueError):
        FaultSpec(outages=((0, 5.0, 5.0),))        # empty window
    with pytest.raises(ValueError):
        FaultSpec(outages=((-1, 0.0, 1.0),))       # bad index
    with pytest.raises(ValueError):
        FaultSpec(degraded=((0, 0.0),))            # factor must be > 0
    with pytest.raises(ValueError):
        FaultSpec(broker_timeout_seconds=0.0)
    with pytest.raises(ValueError):
        FaultSpec(quorum_k=0)
    with pytest.raises(ValueError):
        FaultSpec(hedge_backoff=0.5)
    with pytest.raises(TypeError):
        ClusterSpec(fault=object())                # not a FaultSpec
    with pytest.raises(TypeError):
        ClusterSpec(fault=_spec(FaultSpec()))      # the reference's type
    assert FaultSpec(broker_timeout_seconds=1.0, quorum_k=9).quorum(4) == 4
    spec = FaultSpec(hedge_after_seconds=0.1, hedge_backoff=2.0,
                     hedge_attempts=3)
    np.testing.assert_allclose(spec.hedge_delays(), (0.1, 0.3, 0.7))
    for ft in (spec, FaultSpec(outages=[[1, 2, 3]], degraded=[[0, 2]]),
               FaultSpec(mtbf_seconds=4.0)):
        ref = _spec(ft)
        assert (ft.has_outages, ft.wants_rng, ft.quorum(7),
                ft.hedge_delays(), ft.outages, ft.degraded) == (
            ref.has_outages, ref.wants_rng, ref.quorum(7),
            ref.hedge_delays(), ref.outages, ref.degraded)
        assert hash(ft) == hash(dataclasses.replace(ft))


# ------------------------------------------------------- against reference

@pytest.mark.parametrize("impl", ["fused", "masked"])
@pytest.mark.parametrize("routing", ["round_robin", "random", "jsq"])
def test_faulted_run_matches_reference(x64, routing, impl):
    """All four channels at r = 3 with the result cache, on the
    reference's draws: the same statistics and fault channels."""
    fault = FaultSpec(**ALL_FOUR)
    ref, port = both_batch(routing, cache=(0.25, 2e-3), fault=fault,
                           impl=impl)
    assert_matches_reference(port, ref, extra=_CHANNELS)
    assert float(port.spill_count.min()) > 0
    assert float(port.degraded_count.min()) > 0


def test_faulted_single_replica_matches_reference(x64):
    """r = 1 through `simulate_fork_join`: a down replica means an
    unavailable query."""
    fault = FaultSpec(**ALL_FOUR)
    key = jax.random.PRNGKey(3)
    n, chunk = 3000, 512
    ref = jsim.simulate_fork_join(key, 18.0, n, jcap.TABLE5_PARAMS,
                                  mode="cache", impl="xla", chunk_size=chunk,
                                  cluster=JCluster(fault=_spec(fault)))
    p = int(jcap.TABLE5_PARAMS.p)
    per_chunk = reference_draws(key, -(-n // chunk), 1, chunk, p,
                                jsim._vec_params(jcap.TABLE5_PARAMS),
                                "cache", r=1, routing="round_robin",
                                fault=fault)
    port = tsim.simulate_fork_join(
        3, 18.0, n, tcap.TABLE5_PARAMS, mode="cache", chunk_size=chunk,
        cluster=ClusterSpec(fault=fault), device=CPU, dtype=F64,
        draws=interop.draws_from_numpy(per_chunk, device=CPU, dtype=F64))
    assert port.count.shape == ()
    assert_matches_reference(port, ref, extra=_CHANNELS)
    assert float(port.unavail_count) > 0 and float(port.spill_count) == 0


_FAULT_AXIS = (None, FaultSpec(broker_timeout_seconds=0.05, quorum_k=3),
               FaultSpec(outages=((0, 0.0, 1e9),)),
               FaultSpec(outages=((0, 0.0, 1e9),),
                         broker_timeout_seconds=0.05, quorum_k=3))


def dispatch_draws(key, grid, cells, *, n, chunk, mode, routing):
    """{k: the reference's draws of dispatch k} of a reference grid whose
    6th axis is ``cells``: one (r, elastic, FaultSpec or None) a cell."""
    shape = grid.shape
    _, params_full = grid.broadcast_full()
    fields = {f.name: jnp.moveaxis(getattr(params_full, f.name), (1, 5),
                                   (0, 1)).reshape(shape[1], shape[5], -1)
              for f in dataclasses.fields(jq.ServerParams)}
    keys = jax.random.split(key, shape[1] * shape[5])
    s = shape[0] * shape[2] * shape[3] * shape[4]
    out = {}
    for i in range(shape[1]):
        for j, (r, elastic, fault) in enumerate(cells):
            k = i * shape[5] + j
            out[k] = reference_draws(
                keys[k], -(-n // chunk), s, chunk, int(float(grid.p[i])),
                jq.ServerParams(**{f: v[i, j] for f, v in fields.items()}),
                mode, r=r, routing=routing, elastic=elastic, fault=fault)
    return out


def test_sweep_fault_axis_matches_reference(x64):
    """A fault axis (None, quorum, outage, outage + quorum) through
    sweep_simulated, extract_frontier and plan_over_grid, on the
    reference's per-dispatch draws."""
    axes = dict(lam=np.array([30.0, 60.0], np.float32),
                p=np.array([4.0], np.float32),
                cpu=np.array([1.0, 1.5], np.float32),
                hit=np.array([0.5], np.float32),
                r=np.array([3.0], np.float32))
    jg = jsweep.SweepGrid.build(**{k: jnp.asarray(v)
                                   for k, v in axes.items()},
                                base=jq.ServerParams(**dataclasses.asdict(
                                    PARAMS)), broker_from_p=False,
                                fault=tuple(None if f is None else _spec(f)
                                            for f in _FAULT_AXIS))
    tg = tsweep.SweepGrid.build(**{k: torch.from_numpy(v)
                                   for k, v in axes.items()},
                                base=PARAMS, broker_from_p=False,
                                fault=_FAULT_AXIS, device=CPU)
    assert tg.shape == jg.shape == (2, 1, 2, 1, 1, 4)
    n, chunk, key, routing = 2048, 512, jax.random.PRNGKey(9), "random"
    kw = dict(n_queries=n, chunk_size=chunk, mode="cache")
    ref = jsweep.sweep_simulated(jg, key, cluster=JCluster(routing=routing),
                                 **kw)
    per = dispatch_draws(key, jg, [(3, False, f) for f in _FAULT_AXIS],
                         n=n, chunk=chunk, mode="cache", routing=routing)

    def draws(k):
        return interop.draws_from_numpy(per[k], device=CPU, dtype=F64)
    port = tsweep.sweep_simulated(tg, 9, cluster=ClusterSpec(
        routing=routing), draws=draws, dtype=F64, **kw)
    np.testing.assert_array_equal(port.stats.count.numpy(),
                                  np.asarray(ref.stats.count))
    for name in _SUMS + _CHANNELS:
        np.testing.assert_allclose(getattr(port.stats, name).numpy(),
                                   np.asarray(getattr(ref.stats, name)),
                                   rtol=1e-10, atol=0, err_msg=name)
    spill = port.stats.spill_fraction
    assert float(spill[..., 0].max()) == 0.0 and float(spill[..., 2].min()) > 0
    for slo in (0.06, 0.2):
        fr_ref = jsweep.extract_frontier(ref, slo)
        fr = tsweep.extract_frontier(port, slo)
        np.testing.assert_array_equal(fr.feasible.numpy(),
                                      np.asarray(fr_ref.feasible))
        assert [None if f is None else _spec(f) for f in fr.fault] == \
            list(fr_ref.fault)
        for i in range(2):
            assert fr.describe(i) == fr_ref.describe(i)
    # plan_over_grid is the sweep and its frontier: the reference's
    # plan_over_grid on this key is extract_frontier(ref) above
    _, fr_plan = tplanner.plan_over_grid(tg, 0.2, simulate=True, seed=9,
                                         cluster=ClusterSpec(
                                             routing=routing),
                                         draws=draws, dtype=F64, **kw)
    fr_ref = jsweep.extract_frontier(ref, 0.2)
    np.testing.assert_allclose(fr_plan.response.numpy(),
                               np.asarray(fr_ref.response), rtol=1e-10)
    assert [fr_plan.describe(i) for i in range(2)] == [
        fr_ref.describe(i) for i in range(2)]


def test_plan_survive_faults_matches_reference():
    """plan_capacity(survive_faults=1, simulate=True) on the reference's
    draws: the same N+k fleet and the same faulted p95."""
    n_queries, chunk, key = 12_000, 4096, jax.random.PRNGKey(10)
    routing = "jsq"
    t5 = jcap.TABLE5_PARAMS
    ref = jcap.plan_capacity(t5, 80.0, 0.9, simulate=True, key=key,
                             cluster=JCluster(routing=routing),
                             n_queries=n_queries, survive_faults=1)
    per_chunk = reference_draws(key, -(-n_queries // chunk), 1, chunk,
                                int(t5.p), jsim._vec_params(t5),
                                "exponential", r=ref.n_replicas,
                                routing=routing)
    port = tcap.plan_capacity(
        tcap.TABLE5_PARAMS, 80.0, 0.9, simulate=True, survive_faults=1,
        cluster=ClusterSpec(routing=routing), n_queries=n_queries,
        draws=interop.draws_from_numpy(per_chunk, device=CPU), device=CPU)
    assert (port.n_replicas, port.total_servers, port.survive_faults) == (
        ref.n_replicas, ref.total_servers, ref.survive_faults)
    np.testing.assert_allclose(port.response_upper_ms,
                               ref.response_upper_ms, rtol=1e-5)
    np.testing.assert_allclose(port.response_faulted_p95_ms,
                               ref.response_faulted_p95_ms, rtol=1e-3)
    np.testing.assert_allclose(port.response_simulated_ms,
                               ref.response_simulated_ms, rtol=1e-4)


# ------------------------------------------------ hypothesis: carry chaining

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    _N = 96
    _R = 4
    _SPEC = FaultSpec(outages=((0, 0.4, 1.1), (2, 2.0, 2.5)),
                      mtbf_seconds=1.5, mttr_seconds=0.4)
    _GAPS = torch.from_numpy(
        np.random.default_rng(0).exponential(0.03, (2, _N))).float()
    _T = torch.cumsum(_GAPS, dim=1)
    _U = torch.from_numpy(np.random.default_rng(1).random((2, _N, _R))
                          ).float()

    @given(st.lists(st.integers(min_value=1, max_value=_N - 1),
                    min_size=0, max_size=6, unique=True))
    @settings(max_examples=30, deadline=None)
    def test_fault_scan_chunking_invariant(cuts):
        """Splitting the stream at ANY boundaries and chaining the carry
        reproduces the monolithic per-query replica masks exactly (the
        test drives the recurrence by hand to check just that)."""
        carry0 = fault_init(  # staticcheck: disable=RPR007  (chunking under test)
            _SPEC, 2, _R, device=CPU)
        _, whole = fault_scan(  # staticcheck: disable=RPR007  (chunking under test)
            _SPEC, _R, carry0, _T, _GAPS, _U)
        bounds = [0] + sorted(cuts) + [_N]
        carry = fault_init(  # staticcheck: disable=RPR007  (chunking under test)
            _SPEC, 2, _R, device=CPU)
        parts = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            carry, m = fault_scan(  # staticcheck: disable=RPR007  (chunking under test)
                _SPEC, _R, carry, _T[:, a:b], _GAPS[:, a:b], _U[:, a:b])
            parts.append(m)
        assert torch.equal(torch.cat(parts, dim=1), whole)
else:
    @pytest.mark.skip(reason="property tests need hypothesis (see "
                      "pyproject [project.optional-dependencies].test)")
    def test_fault_scan_chunking_invariant():
        pass
