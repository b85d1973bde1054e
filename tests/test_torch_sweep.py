"""The port's what-if sweep engine held against `repro.core.sweep`.

Both packages get grids built from the same numpy axes.  Analytic
surfaces (Eq 7 / Eq 8 bounds, utilization, the quantile estimate) agree
to rtol 1e-5 in float32 and, under x64 on float64 axes, to 1e-12, with
the same cells infinite.  Frontiers choose the same configurations on
grids whose cells sit away from the SLO (ROADMAP queue 3, ill-conditioned
SLO boundary).

Simulated sweeps feed every dispatch the reference's own random numbers:
the reference gives dispatch k = i * n_r + j the key
``jax.random.split(key, n_p * n_r)[k]``, and each of its chunks draws
through ``chunk_random_draws`` and the salted side streams; the port
receives the same numbers through ``sweep_simulated(draws=...)``.  Then
the surfaces agree scenario by scenario at the tolerances of
tests/test_torch_replication.py: float64 sums to 1e-10, float32 means to
1e-4 with at most 0.5 % of the histogram mass moved.  Under x64 the
reference still scales its histogram in float32 (the grid's values), so
there bin edges agree to float32 rounding and at most 0.1 % of the mass
may move.  The port's own RNG is held to the reference's estimates by
sampling error.
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
from repro.core import sweep as jsweep
from repro.core.cluster import ClusterSpec as JCluster
from repro_torch import interop
from repro_torch.core import capacity as tcap
from repro_torch.core import sweep as tsweep
from repro_torch.core.cluster import ClusterSpec
from repro_torch.launch.elastic import AutoscalePolicy
from repro_torch.obs import TelemetrySpec

CPU = "cpu"
F64 = torch.float64
T5 = jcap.TABLE5_PARAMS
_SUMS = ("sum_response", "sumsq_response", "sum_broker", "sum_cluster",
         "sum_server")


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _grids(**axes):
    """(reference grid, port grid) built from the same numpy axes."""
    j_kw, t_kw = {}, {}
    for k, v in axes.items():
        if k in ("lam", "p", "cpu", "disk", "hit", "r"):
            v = np.asarray(v, np.float32)
            j_kw[k], t_kw[k] = jnp.asarray(v), torch.from_numpy(v)
        else:
            j_kw[k] = t_kw[k] = v
    return (jsweep.SweepGrid.build(**j_kw),
            tsweep.SweepGrid.build(device=CPU, **t_kw))


GRIDS = {
    # tests/test_sweep.py's _small_grid
    "small": dict(lam=[4.0, 16.0, 32.0], p=[50.0, 100.0], cpu=[1.0, 4.0],
                  disk=[1.0, 4.0], hit=[0.02, 0.18]),
    # a Table 6 memory column of examples/whatif_sweep.py
    "whatif_mem4": dict(lam=[16.0, 32.0, 56.0, 80.0],
                        p=[50.0, 100.0, 150.0, 200.0],
                        cpu=np.linspace(1.0, 4.0, 7),
                        disk=np.linspace(1.0, 4.0, 7), memory=4),
    # replicas with the result cache on a Table 5 base
    "replicated_cache": dict(lam=[10.0, 40.0, 120.0], p=[50.0, 100.0],
                             cpu=[1.0, 2.0], disk=[1.0, 2.0],
                             hit=np.linspace(0.05, 0.95, 4),
                             r=[1.0, 2.0, 4.0], base=T5,
                             result_cache=(0.2, 2e-3)),
    # pinned broker, tests/test_replication.py's replica grid
    "pinned_broker": dict(lam=[20.0, 70.0], p=[8.0], base=T5, hit=[0.17],
                          broker_from_p=False, r=[1.0, 3.0]),
}


def _assert_surface(port, ref, rtol):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_analytic_surfaces_match_reference(name):
    jg, tg = _grids(**GRIDS[name])
    assert tg.shape == jg.shape and tg.n_scenarios == jg.n_scenarios
    ref, port = jsweep.sweep_analytical(jg), tsweep.sweep_analytical(tg)
    for field in ("response_lower", "response_upper", "utilization"):
        _assert_surface(getattr(port, field), getattr(ref, field), 1e-5)
    for q in (0.5, 0.95, 0.99):
        _assert_surface(port.quantile(q), ref.quantile(q), 1e-5)
    np.testing.assert_allclose(float(port.feasible_fraction),
                               float(ref.feasible_fraction), rtol=1e-6)


@pytest.mark.parametrize("cache", [None, (0.2, 2e-3)])
def test_analytic_surfaces_float64(x64, cache):
    """float64 axes: the reference pins the same fields to float32 (the
    base times, the broker fit, H_p); the port mirrors every pin."""
    rng = np.random.default_rng(3)
    axes = dict(lam=np.sort(rng.uniform(5.0, 90.0, 6)),
                p=np.array([4.0, 8.0, 50.0, 100.0]),
                cpu=np.array([1.0, 1.7, 3.0]), disk=np.array([1.0, 2.5]),
                hit=np.array([0.02, 0.3, 0.8]), r=np.array([1.0, 2.0, 4.0]))
    base = jcap.scenario_params(memory=2)
    base = {f.name: float(np.asarray(getattr(base, f.name)))
            for f in dataclasses.fields(jq.ServerParams)}
    jg = jsweep.SweepGrid(**{k: jnp.asarray(v) for k, v in axes.items()},
                          base=jq.ServerParams(**base), result_cache=cache)
    tg = tsweep.SweepGrid(**{k: torch.from_numpy(v) for k, v in axes.items()},
                          base=tcap.ServerParams(**base), result_cache=cache)
    ref, port = jsweep.sweep_analytical(jg), tsweep.sweep_analytical(tg)
    for field in ("response_lower", "response_upper", "utilization"):
        assert getattr(port, field).dtype == F64
        _assert_surface(getattr(port, field), getattr(ref, field), 1e-12)
    _assert_surface(port.quantile(0.95), ref.quantile(0.95), 1e-12)


def _frontiers_equal(port, ref):
    for field in ("lam", "p", "cpu", "disk", "hit", "r"):
        np.testing.assert_array_equal(getattr(port, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(port.feasible.numpy(),
                                  np.asarray(ref.feasible))
    np.testing.assert_allclose(port.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-6)
    fin = np.asarray(ref.feasible)
    np.testing.assert_allclose(port.response.numpy()[fin],
                               np.asarray(ref.response)[fin], rtol=1e-5)
    for i in range(port.lam.shape[0]):
        assert port.describe(i) == ref.describe(i)


def _server_count_cost(p, cpu, disk, hit):
    return p + 0 * cpu * disk * hit


@pytest.mark.parametrize("name,slo,quantile", [
    ("small", 0.3, None), ("small", 0.3, 0.95), ("whatif_mem4", 0.3, None),
    ("replicated_cache", 0.5, None), ("replicated_cache", 0.9, 0.99),
    ("pinned_broker", 0.9, None)])
@pytest.mark.parametrize("cost", ["default", "servers"])
def test_frontier_matches_reference(name, slo, quantile, cost):
    jg, tg = _grids(**GRIDS[name])
    cost_fn = None if cost == "default" else _server_count_cost
    ref = jsweep.extract_frontier(jsweep.sweep_analytical(jg), slo,
                                  cost_fn=cost_fn, quantile=quantile)
    port = tsweep.extract_frontier(tsweep.sweep_analytical(tg), slo,
                                   cost_fn=cost_fn, quantile=quantile)
    _frontiers_equal(port, ref)


def test_frontier_ties_and_infeasible_rows():
    """Ties resolve to the first index; a rate with no feasible cell comes
    back with cost inf and feasible false — as the reference's."""
    jg, tg = _grids(lam=[4.0, 500.0], p=[50.0, 100.0, 150.0],
                    cpu=[1.0, 2.0], disk=[1.0, 2.0], hit=[0.02])
    flat = lambda p, cpu, disk, hit: 0 * p * cpu * disk * hit + 1.0  # noqa
    ref = jsweep.extract_frontier(jsweep.sweep_analytical(jg), 0.9,
                                  cost_fn=flat)
    port = tsweep.extract_frontier(tsweep.sweep_analytical(tg), 0.9,
                                   cost_fn=flat)
    _frontiers_equal(port, ref)
    assert bool(port.feasible[0]) and not bool(port.feasible[1])
    assert float(port.cost[1]) == float("inf")
    assert "INFEASIBLE" in port.describe(1)


def test_frontier_picks_minimal_cost_feasible():
    """tests/test_sweep.py's brute force, through the port."""
    _, grid = _grids(**GRIDS["small"])
    slo = 0.300
    res = tsweep.sweep_analytical(grid)
    fr = tsweep.extract_frontier(res, slo)
    hi = res.response_upper.numpy()
    axes = [a.numpy() for a in (grid.p, grid.cpu, grid.disk, grid.hit)]
    for il in range(grid.shape[0]):
        best_cost, best_cfg = np.inf, None
        for idx in np.ndindex(*grid.shape[1:5]):
            if hi[(il,) + idx + (0,)] <= slo:
                cfg = tuple(a[i] for a, i in zip(axes, idx))
                c = float(tsweep.default_config_cost(
                    *(torch.tensor(v) for v in cfg)))
                if c < best_cost:
                    best_cost, best_cfg = c, cfg
        assert bool(fr.feasible[il]) == (best_cfg is not None)
        if best_cfg is not None:
            np.testing.assert_allclose(float(fr.cost[il]), best_cost,
                                       rtol=1e-6)
            got = (float(fr.p[il]), float(fr.cpu[il]), float(fr.disk[il]),
                   float(fr.hit[il]))
            np.testing.assert_allclose(got, best_cfg, rtol=1e-6)
            assert float(fr.response[il]) <= slo


def test_grid_semantics():
    """tests/test_sweep.py's grid checks: the Table 6 build, the replica
    default, monotone response along lambda."""
    g = tsweep.SweepGrid.build(lam=[10.0], memory=4, device=CPU)
    s_hit, _, _, hit = tcap.MEMORY_TABLE[4]
    assert float(g.base.s_hit) == s_hit
    assert float(g.hit[0]) == np.float32(hit)
    assert g.shape == (1, 1, 1, 1, 1, 1) and g.n_scenarios == 1
    assert float(g.r[0]) == 1.0
    assert g.r.device == g.lam.device
    grid = tsweep.SweepGrid.build(
        lam=torch.linspace(1.0, 60.0, 12), p=[50.0, 100.0], cpu=[1.0, 2.0],
        disk=[1.0, 2.0], hit=[0.02, 0.18], device=CPU)
    hi = tsweep.sweep_analytical(grid).response_upper.numpy()
    with np.errstate(invalid="ignore"):  # inf - inf in saturated cells
        diffs = np.diff(hi, axis=0)
    assert np.all((diffs >= -1e-6) | np.isnan(diffs))


# ------------------------------------------------------------ simulated


def _reference_dispatch_draws(key, grid, *, n_queries, chunk, mode, routing,
                              cache, tap):
    """{k: per-chunk reference draws of dispatch k} for a reference grid,
    as numpy, each built as the reference builds it."""
    shape = grid.shape
    dtype = jnp.result_type(float)
    _, params_full = grid.broadcast_full()

    def slab(x):
        return jnp.moveaxis(x, (1, 5), (0, 1)).reshape(
            shape[1], shape[5], -1)

    fields = {f.name: slab(getattr(params_full, f.name))
              for f in dataclasses.fields(jq.ServerParams)}
    n_p, n_cfg = shape[1], shape[5]
    keys = jax.random.split(key, n_p * n_cfg)
    n_chunks = -(-n_queries // chunk)
    s = shape[0] * shape[2] * shape[3] * shape[4]
    out = {}
    for i in range(n_p):
        p = int(round(float(grid.p[i])))
        for j in range(n_cfg):
            r = int(round(float(grid.r[j])))
            k = i * n_cfg + j
            params_ij = jq.ServerParams(
                **{n: v[i, j] for n, v in fields.items()})
            per_chunk = []
            for c in range(n_chunks):
                g, b, sv = jsim.chunk_random_draws(keys[k], c, s, chunk, p,
                                                   params_ij, mode)
                kc = jax.random.fold_in(keys[k], c)
                side = {}
                if r > 1 and routing == "random":
                    side["route"] = np.asarray(jax.random.randint(
                        jax.random.fold_in(kc, jsim._ROUTE_SALT), (s, chunk),
                        0, r))
                if cache is not None:
                    kh, ks = jax.random.split(
                        jax.random.fold_in(kc, jsim._CACHE_SALT))
                    side["cache_hit"] = np.asarray(jax.random.bernoulli(
                        kh, jnp.full((s, chunk), cache[0], dtype)))
                    side["cache_unit"] = np.asarray(
                        jax.random.exponential(ks, (s, chunk)))
                if tap:
                    side["tap"] = np.asarray(jax.random.uniform(
                        jax.random.fold_in(kc, jsim._TAP_SALT), (s, chunk),
                        dtype))
                per_chunk.append((np.asarray(g), np.asarray(b),
                                  np.asarray(sv), side))
            out[k] = per_chunk
    return out


# 2 p x 2 r dispatches of 4 scenarios (lam x cpu): the flat dispatch
# index and the stacking order are exercised on both static axes
SIM_AXES = dict(lam=[12.0, 24.0], p=[4.0, 8.0], cpu=[1.0, 1.5],
                hit=[0.17], base=T5, broker_from_p=False, r=[1.0, 2.0])


def _both_simulated(routing, cache, dtype, *, mode="exponential", tap=0,
                    n=4096, chunk=1024, seed=5, **axes):
    jg, tg = _grids(**dict(SIM_AXES, result_cache=cache, **axes))
    key = jax.random.PRNGKey(seed)
    ref = jsweep.sweep_simulated(jg, key, n_queries=n, chunk_size=chunk,
                                 mode=mode, tap_size=tap,
                                 cluster=JCluster(routing=routing))
    per_dispatch = _reference_dispatch_draws(
        key, jg, n_queries=n, chunk=chunk, mode=mode, routing=routing,
        cache=cache, tap=tap > 0)
    port = tsweep.sweep_simulated(
        tg, seed, n_queries=n, chunk_size=chunk, mode=mode, tap_size=tap,
        cluster=ClusterSpec(routing=routing), dtype=dtype,
        draws=lambda k: interop.draws_from_numpy(per_dispatch[k],
                                                 device=CPU, dtype=dtype))
    return ref, port


def test_simulated_sweep_equals_reference_float64(x64):
    """Random routing, the result cache, cache-mode services and the tap,
    on the same draws in every dispatch."""
    ref, port = _both_simulated("random", (0.25, 2e-3), F64, mode="cache",
                                tap=16)
    shape = ref.grid.shape
    assert port.mean.shape == shape
    assert tuple(port.stats.hist.shape) == shape + (256,)
    assert tuple(port.sample_response.shape) == shape + (16,)
    np.testing.assert_array_equal(port.stats.count.numpy(),
                                  np.asarray(ref.stats.count))
    for name in _SUMS:
        np.testing.assert_allclose(getattr(port.stats, name).numpy(),
                                   np.asarray(getattr(ref.stats, name)),
                                   rtol=1e-10, err_msg=name)
    # the reference scales its histogram from the grid's float32 values
    # even under x64 (rates and parameters stay float32 there); the port
    # computes the scale in the run's dtype, so bin edges part by float32
    # rounding and a query on an edge may change bins
    np.testing.assert_allclose(port.stats.hist_log_lo.numpy(),
                               np.asarray(ref.stats.hist_log_lo), rtol=1e-6)
    h_ref = np.asarray(ref.stats.hist)
    moved = np.abs(port.stats.hist.numpy() - h_ref).sum(-1) / 2
    assert np.all(moved <= 1e-3 * h_ref.sum(-1)), moved
    np.testing.assert_allclose(port.quantile(0.95).numpy(),
                               np.asarray(ref.quantile(0.95)), rtol=1e-5)
    np.testing.assert_allclose(np.sort(port.sample_response.numpy(), -1),
                               np.sort(np.asarray(ref.sample_response), -1),
                               rtol=1e-10)


@pytest.fixture(scope="module")
def jsq_float32():
    """JSQ routing in float32, one dispatch (p = 8, r = 3)."""
    return _both_simulated("jsq", None, torch.float32, mode="cache",
                           lam=[12.0, 60.0], p=[8.0], r=[3.0])


def test_simulated_sweep_equals_reference_float32(jsq_float32):
    ref, port = jsq_float32
    assert tuple(port.sample_response.shape) == ref.grid.shape + (0,)
    np.testing.assert_array_equal(port.stats.count.numpy(),
                                  np.asarray(ref.stats.count))
    for prop in ("mean", "std"):
        np.testing.assert_allclose(getattr(port, prop).numpy(),
                                   np.asarray(getattr(ref, prop)),
                                   rtol=1e-4, err_msg=prop)
    h_ref = np.asarray(ref.stats.hist)
    moved = np.abs(port.stats.hist.numpy() - h_ref).sum(-1) / 2
    assert np.all(moved <= 0.005 * h_ref.sum(-1)), moved


def test_simulated_frontier_matches_reference(jsq_float32):
    """The frontier on the simulated p95 picks the reference's cells when
    both run on the same draws."""
    ref, port = jsq_float32
    # the SLO in the widest gap between the cells' p95s, so that no cell
    # sits near it
    p95 = np.sort(np.asarray(ref.quantile(0.95)).ravel())
    gap = np.argmax(p95[1:] / p95[:-1])
    slo = float(np.sqrt(p95[gap] * p95[gap + 1]))
    assert p95[gap + 1] / p95[gap] > 1.05, p95
    _frontiers_equal(tsweep.extract_frontier(port, slo, quantile=0.95),
                     jsweep.extract_frontier(ref, slo, quantile=0.95))


def test_own_rng_within_sampling_error():
    """The port's own Philox draws against the reference's threefry
    ones: the same cells, means within sampling error, both inside the
    Eq 7 band that tests/test_sweep.py uses."""
    axes = dict(lam=[10.0, 16.0, 22.0], p=[8.0], base=T5, hit=[0.17],
                broker_from_p=False)
    jg, tg = _grids(**axes)
    ref = jsweep.sweep_simulated(jg, jax.random.PRNGKey(0),
                                 n_queries=20_000)
    port = tsweep.sweep_simulated(tg, 0, n_queries=20_000)
    ana = tsweep.sweep_analytical(tg)
    m, m_ref = port.mean.numpy(), np.asarray(ref.mean)
    lo, hi = ana.response_lower.numpy(), ana.response_upper.numpy()
    assert np.all((m > lo * 0.95) & (m < hi * 1.05)), (m, lo, hi)
    assert np.all(np.abs(m / m_ref - 1.0) < 0.1), (m, m_ref)
    assert np.all(port.quantile(0.95).numpy() > m)


def test_replica_axis_and_frontier():
    """tests/test_replication.py:239 through the port: the analytic surface
    is Eq 7 at lam / r, the frontier buys replicas when one cluster
    saturates, and the simulated surface (random routing) tracks Eq 7."""
    _, grid = _grids(**GRIDS["pinned_broker"])
    assert grid.shape == (2, 1, 1, 1, 1, 2)
    ana = tsweep.sweep_analytical(grid)
    _, hi = jq.response_time_bounds(70.0 / 3.0, T5)
    np.testing.assert_allclose(float(ana.response_upper[1, 0, 0, 0, 0, 1]),
                               float(hi), rtol=1e-5)
    assert not np.isfinite(float(ana.response_upper[1, ..., 0].max()))
    assert np.isfinite(float(ana.response_upper[1, ..., 1].max()))
    fr = tsweep.extract_frontier(ana, 0.9)
    assert bool(fr.feasible[0]) and bool(fr.feasible[1])
    assert float(fr.r[0]) == 1.0 and float(fr.r[1]) == 3.0
    assert float(fr.cost[1]) == pytest.approx(3 * float(fr.cost[0]))
    assert "x3 replicas" in fr.describe(1)
    sim = tsweep.sweep_simulated(grid, 9, n_queries=40_000,
                                 cluster=ClusterSpec(routing="random"))
    m = sim.mean.numpy()
    lo, hi = ana.response_lower.numpy(), ana.response_upper.numpy()
    ok = np.isfinite(hi)
    assert np.all(m[ok] > lo[ok] * 0.95)
    assert np.all(m[ok] < hi[ok] * 1.05)


def test_sweep_replica_impl_passthrough():
    """tests/test_replication.py:375 through the port: the spec's
    replica_impl reaches every dispatch, and the fused and masked engines
    give the same surfaces over a replicated grid with the cache."""
    _, grid = _grids(lam=[30.0, 60.0], p=[4.0], cpu=[1.0], disk=[1.0],
                     hit=[0.5], r=[2.0, 3.0],
                     base=dataclasses.replace(T5, p=4),
                     result_cache=(0.2, 2e-3))
    kw = dict(n_queries=4000, chunk_size=512, dtype=F64)
    f = tsweep.sweep_simulated(grid, 13, **kw,
                               cluster=ClusterSpec(replica_impl="fused"))
    m = tsweep.sweep_simulated(grid, 13, **kw,
                               cluster=ClusterSpec(replica_impl="masked"))
    np.testing.assert_allclose(f.mean.numpy(), m.mean.numpy(), rtol=1e-9)


@pytest.mark.parametrize("what,exc,match", [
    ("autoscale", TypeError, "AutoscalePolicy"),
    ("fault", ValueError, "6th axis"),
    ("telemetry", ValueError, "same max_r"),
    ("mesh_sim", TypeError, "DeviceMesh"),
    ("mesh_analytic", TypeError, "DeviceMesh")])
def test_not_ported_inputs_raise(what, exc, match):
    """The policy and fault axes, telemetry and scenario sharding, all
    ported now, refuse what the reference refuses: a value that is not a
    policy, a policy axis and a fault axis together (both claim the 6th
    dimension), telemetry over policies whose max_r differ
    (src/repro/core/sweep.py:586), and a mesh that is not the port's
    `DeviceMesh` (tests/test_torch_sharding.py holds the 1-D rule)."""
    _, grid = _grids(lam=[10.0], p=[4.0], base=T5)
    pol = AutoscalePolicy(min_r=1, max_r=2)
    calls = {
        "autoscale": lambda: dataclasses.replace(grid, autoscale=("p",)),
        "fault": lambda: dataclasses.replace(grid, fault=(None,),
                                             autoscale=(pol,)),
        "telemetry": lambda: tsweep.sweep_simulated(
            dataclasses.replace(grid, autoscale=(
                pol, AutoscalePolicy(min_r=1, max_r=3))),
            telemetry=TelemetrySpec(n_bins=4)),
        "mesh_sim": lambda: tsweep.sweep_simulated(grid, mesh=object()),
        "mesh_analytic": lambda: tsweep.sweep_analytical(grid,
                                                         mesh=object()),
    }
    with pytest.raises(exc, match=match):
        calls[what]()


def test_bad_simulated_inputs_raise():
    _, grid = _grids(lam=[10.0], p=[4.0], base=T5,
                     result_cache=(0.2, 2e-3))
    with pytest.raises(ValueError, match="r axis"):
        tsweep.sweep_simulated(grid, cluster=ClusterSpec(r=2))
    with pytest.raises(ValueError, match="both"):
        tsweep.sweep_simulated(
            grid, cluster=ClusterSpec(result_cache=(0.1, 1e-3)))
    _, frac = _grids(lam=[10.0], p=[4.5], base=T5)
    with pytest.raises(ValueError, match="integer server"):
        tsweep.sweep_simulated(frac, n_queries=100)
