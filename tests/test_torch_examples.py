"""The port's three late entry points held against the reference's.

* `examples/torch_serve_search.py` against `examples/serve_search.py`,
  both `main()`s run under ONE virtual clock: ``time.perf_counter``
  reads it without advancing it, ``time.sleep(x)`` advances it by x, and
  each package's ``IndexServer.process`` advances it by a fixed time a
  batch.  The arrivals and the query stream are numpy in both packages
  (bit-identical), so every printed figure must be equal: the string
  compare is exact.
* `examples/torch_simulate_cluster.py`'s ``rows`` against the
  reference's loop (Eq 7 and ``simulate_fork_join(PRNGKey(p), ...)``),
  fed the reference's own draws through ``draws=``: the bounds to 1e-6,
  the means to 1e-4 (float32 scans associating differently, as in
  tests/test_torch_simulator.py), the p95 to 2e-2 (that file's
  histogram-quantile tolerance).
* `examples/torch_replicated_sweep.py`'s three frontiers against the
  reference's ``plan_over_grid`` (``feasible``, ``r`` and cost exactly,
  responses to 1e-6), and its JSQ plan and crowd run on the reference's
  draws: means to 1e-4, p95 to 1e-3 (tests/test_torch_capacity.py's).
"""

import dataclasses
import importlib.util
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import planner as jplanner
from repro.core import queueing as jq
from repro.core import simulator as jsim
from repro.core import sweep as jsweep
from repro.core.arrivals import ArrivalProcess as JArrival
from repro.core.cluster import ClusterSpec as JCluster
from repro.engine import server as jserver
from repro_torch import interop
from repro_torch.core import capacity as tcap
from repro_torch.engine import cache as tcache
from repro_torch.engine import server as tserver

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent
BOUND_RTOL = 1e-6
MEAN_RTOL = 1e-4
SIM_P95_RTOL = 2e-2
PLAN_P95_RTOL = 1e-3


def _load(name: str):
    """An example as a module (its ``main`` not run)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serve = _load("torch_serve_search")
cluster_ex = _load("torch_simulate_cluster")
replicated = _load("torch_replicated_sweep")


# -- serve_search ---------------------------------------------------------

class _VirtualClock:
    """Seconds that move only by sleeps and by the served batches."""

    def __init__(self, start: float = 1000.0):
        self.t = start

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


BATCH_SECONDS = 0.008          # the virtual time one scorer batch takes
SERVE_ARGS = ["--duration", "1.0"]


def _run_main(monkeypatch, capsys, main, argv) -> list:
    clock = _VirtualClock()
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(time, "sleep", clock.sleep)
    monkeypatch.setattr(sys, "argv", argv)
    for cls in (jserver.IndexServer, tserver.IndexServer):
        original = cls.__dict__["process"]

        def process(self, query_terms, _original=original):
            out = _original(self, query_terms)
            clock.t += BATCH_SECONDS
            return out
        monkeypatch.setattr(cls, "process", process)
    capsys.readouterr()
    main()
    lines = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    return lines


def test_serve_open_loop_matches_reference_under_virtual_clock(
        monkeypatch, capsys):
    ref = _run_main(monkeypatch, capsys, _load("serve_search").main,
                    ["serve_search.py"] + SERVE_ARGS)
    port = _run_main(monkeypatch, capsys, serve.main,
                     ["torch_serve_search.py", "--device", CPU]
                     + SERVE_ARGS)
    assert len(port) == len(ref) + 1
    # S_query / capacity / rate, model, served and hit ratio, latencies
    assert port[:len(ref)] == ref
    assert "measured S_query=0.250 ms" in ref[1]
    served = int(ref[4].split()[1])
    assert served > 1000
    assert "batches started behind schedule" in port[-1]


def test_serve_open_loop_counts_backlog_and_drift():
    """A scorer slower than the arrivals: every batch after the first
    starts behind, the last second waits longer than the first, and no
    request is admitted before it arrives."""
    clock = _VirtualClock(0.0)
    arrivals = np.arange(400) * 0.01            # 100 qps for 4 s
    qids = np.arange(400)                        # no repeats: no hits
    qterms = np.zeros((400, 3), np.int32)
    calls = []

    def process(qt):
        calls.append(qt.copy())
        clock.t += 0.5                           # 64 qps at batch 32
        return torch.zeros((32, 1)), None

    run = serve.serve_open_loop(
        process, arrivals, qids, qterms, batch=32, window_s=0.02,
        cache=tcache.ResultCache(0), clock=clock.perf_counter,
        sleep=clock.sleep)
    assert run.served == 400 and run.cache_hits == 0
    assert (run.latencies >= 0).all()
    assert run.batches == len(calls) and run.behind == run.batches - 1
    assert all(c.shape == (32, 3) for c in calls)
    first, last = run.drift()
    assert last > 2.0 * first > 0


# -- simulate_cluster -----------------------------------------------------

CLUSTER_QUERIES = 3000
CLUSTER_LAM = 15.0


def _cluster_draws(p: int, mode: str):
    """The reference's one-chunk draws of ``PRNGKey(p)``, as numpy."""
    pr = jsim._vec_params(dataclasses.replace(jcap.TABLE5_PARAMS, p=p))
    return [tuple(np.asarray(x) for x in jsim.chunk_random_draws(
        jax.random.PRNGKey(p), 0, 1, CLUSTER_QUERIES, p, pr, mode))]


@pytest.mark.parametrize("p", [8, 32])
def test_cluster_rows_match_reference_on_its_draws(p):
    got, = cluster_ex.rows(
        [p], CLUSTER_LAM, CLUSTER_QUERIES, device=CPU,
        draws=lambda p_, mode: interop.draws_from_numpy(
            _cluster_draws(p_, mode), device=CPU))
    pr = dataclasses.replace(jcap.TABLE5_PARAMS, p=p)
    lo, hi = jq.response_time_bounds(CLUSTER_LAM, pr)
    np.testing.assert_allclose(got["lower"], float(lo), rtol=BOUND_RTOL)
    np.testing.assert_allclose(got["upper"], float(hi), rtol=BOUND_RTOL)
    assert set(got["mean"]) == set(cluster_ex.MODES)
    for mode in cluster_ex.MODES:
        ref = jsim.simulate_fork_join(jax.random.PRNGKey(p), CLUSTER_LAM,
                                      CLUSTER_QUERIES, pr, mode=mode)
        np.testing.assert_allclose(got["mean"][mode],
                                   float(ref.mean_response),
                                   rtol=MEAN_RTOL, err_msg=mode)
        np.testing.assert_allclose(got["p95"][mode],
                                   float(ref.quantile(0.95)),
                                   rtol=SIM_P95_RTOL, err_msg=mode)
    assert got["mean"]["balanced"] <= got["mean"]["exponential"]


# -- replicated_sweep -----------------------------------------------------

def _reference_frontier(name: str):
    kw = dict(lam=jnp.asarray(replicated.LAM), p=[100.0],
              r=jnp.arange(1.0, 13.0))
    grid = {
        "replicate memory-1x": lambda: jsweep.SweepGrid.build(memory=1,
                                                              **kw),
        "upgrade to memory-4x": lambda: jsweep.SweepGrid.build(memory=4,
                                                               **kw),
        "memory-1x + result cache": lambda: jsweep.SweepGrid.build(
            memory=1, result_cache=(0.3, 2e-3), **kw),
    }[name]()
    return jplanner.plan_over_grid(grid, replicated.SLO)[1]


@pytest.fixture(scope="module")
def port_frontiers():
    return replicated.frontiers(CPU)


@pytest.mark.parametrize("name", ["replicate memory-1x",
                                  "upgrade to memory-4x",
                                  "memory-1x + result cache"])
def test_replicated_frontiers_match_reference(port_frontiers, name):
    got, ref = port_frontiers[name], _reference_frontier(name)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(ref.feasible))
    np.testing.assert_array_equal(got.r.numpy(), np.asarray(ref.r))
    np.testing.assert_array_equal(got.cost.numpy(), np.asarray(ref.cost))
    fin = np.asarray(ref.feasible)
    np.testing.assert_allclose(got.response.numpy()[fin],
                               np.asarray(ref.response)[fin],
                               rtol=BOUND_RTOL)
    for i in range(len(replicated.LAM)):
        assert got.describe(i) == ref.describe(i)
    costs, best = replicated.head_to_head(port_frontiers)[-1]
    assert best == "upgrade to memory-4x"
    assert costs["replicate memory-1x"] == float("inf")


PLAN_QUERIES = 4096
CROWD_QUERIES = 2 * replicated.CROWD_CHUNK
J_PARAMS4 = jcap.scenario_params(memory=4, p=100)


def _reference_draws(key, n_queries, chunk):
    """One scenario's per-chunk draws (JSQ reads no side stream)."""
    vp = jsim._vec_params(J_PARAMS4)
    return [tuple(np.asarray(x) for x in jsim.chunk_random_draws(
        key, c, 1, chunk, 100, vp, "exponential"))
        for c in range(-(-n_queries // chunk))]


def test_replicated_plan_matches_reference_on_its_draws():
    key = jax.random.PRNGKey(0)
    ref = jcap.plan_capacity(J_PARAMS4, replicated.TARGET, replicated.SLO,
                             simulate=True, cluster=JCluster(routing="jsq"),
                             key=key, n_queries=PLAN_QUERIES)
    _, got = replicated.cross_check(
        CPU, n_queries=PLAN_QUERIES, draws=interop.draws_from_numpy(
            _reference_draws(key, PLAN_QUERIES, jsim.DEFAULT_CHUNK),
            device=CPU))
    assert (got.n_replicas, got.servers_per_replica) == (4, 100)
    assert (got.n_replicas, got.servers_per_replica, got.routing) == (
        ref.n_replicas, ref.servers_per_replica, ref.routing)
    for name in ("utilization", "response_upper_ms", "response_lower_ms"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=BOUND_RTOL, err_msg=name)
    np.testing.assert_allclose(got.response_simulated_ms,
                               ref.response_simulated_ms, rtol=MEAN_RTOL)
    np.testing.assert_allclose(got.response_simulated_p95_ms,
                               ref.response_simulated_p95_ms,
                               rtol=PLAN_P95_RTOL)


def test_replicated_crowd_run_matches_reference_on_its_draws():
    """The peak-provisioned crowd run (r = 3 x 4), two chunks."""
    r, key = 12, jax.random.PRNGKey(1)
    crowd = JArrival.flash_crowd(replicated.TARGET, **replicated.CROWD)
    ref = jsim.simulate_fork_join(
        key, crowd, CROWD_QUERIES, J_PARAMS4,
        cluster=JCluster(r=r, routing="jsq"),
        chunk_size=replicated.CROWD_CHUNK)
    params = tcap.scenario_params(memory=4, p=100, device=CPU)
    got = replicated.crowd_run(
        params, r, CPU, n_queries=CROWD_QUERIES,
        draws=interop.draws_from_numpy(_reference_draws(
            key, CROWD_QUERIES, replicated.CROWD_CHUNK), device=CPU))
    np.testing.assert_allclose(float(got.mean_response),
                               float(ref.mean_response), rtol=MEAN_RTOL)
    np.testing.assert_allclose(float(got.quantile(0.95)),
                               float(ref.quantile(0.95)),
                               rtol=PLAN_P95_RTOL)
