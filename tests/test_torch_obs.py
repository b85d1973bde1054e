"""The port's observability layer (`repro_torch.obs`) held against
`repro.obs` and the reference engine's telemetry.

Mirrors tests/test_obs.py case for case on the port's own random
numbers: ``telemetry=None`` leaves no timeline and the base statistics
bitwise as they were (port against port, at r = 1 and 2, with and
without the result cache); counts are conserved across chunkings and
totals across bin counts; the fused and masked engines' timelines
agree; ``slo_seconds=0`` counts everything; the operational laws hold
per bin (identities) and statistically; the sweep threads telemetry
(and refuses mixed ``max_r``, tests/test_torch_sweep.py); Chrome traces
round-trip the validator, which rejects tampered ones; `ProfileRecord`
round-trips JSON; `profile_kernels` names its records; the dashboard's
sparkline and timeline panel render; the spec validates and its horizon
override holds.

Against the reference, on its draws (the canonical chunk draws and its
salted side streams through ``draws=``; the helpers in
tests/test_torch_faults.py and tests/test_torch_sweep.py) in float64:
the timelines of `simulate_fork_join_batch` at r = 1 with and without
the cache, at r = 2 fused and masked, and of `sweep_simulated`;
`timeline_from_trace` and `spans_from_trace` on the reference's trace
arrays; `simulate_spans` on the reference's four streams.  The
autoscaled and faulted timelines are in tests/test_torch_autoscale.py
and tests/test_torch_faults.py.

Tolerance: per-bin counts exact; per-bin float sums within rtol of the
reference's bin, with an absolute floor of rtol times the largest bin
(1e-5 in float32, 1e-12 in float64): the two sides sum in different
orders (the port one cumulative sum a chunk, the reference block sums),
so bitwise agreement is not expected.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import sweep as jsweep
from repro.core.cluster import ClusterSpec as JCluster
from repro.obs import TelemetrySpec as JTelemetry
from repro.obs import timeline as j_timeline
from repro.obs import trace_export as j_trace
from repro_torch import interop
from repro_torch.calibrate.measure import TraceRecord
from repro_torch.core import capacity, simulator, sweep
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.queueing import service_time_server
from repro_torch.obs import DEFAULT_TIMELINE_BINS, TelemetrySpec, Timeline
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace_export
from repro_torch.obs.timeline import timeline_from_trace
from test_torch_faults import both_batch
from test_torch_sweep import _grids, _reference_dispatch_draws

CPU = "cpu"
F64 = torch.float64
PARAMS = capacity.TABLE5_PARAMS
SEED = 0
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}

_BASE = ("count", "sum_response", "sumsq_response", "sum_broker",
         "sum_cluster", "sum_server", "hist", "tap_response")
_FLOAT_BINS = ("resp_sum", "busy_broker", "busy_server", "hit_count",
               "slo_count", "active_sum", "up_sum", "spill_sum",
               "degraded_sum")


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def assert_timelines_match(port: Timeline, ref, dtype=F64):
    """The port's timeline against the reference's: every field present
    on both or neither, counts exact, float sums to RTOL (see above)."""
    rtol = RTOL[dtype]
    for f in dataclasses.fields(Timeline):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        if f.name in ("count", "replica_count"):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            floor = rtol * float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=rtol, atol=floor,
                                       err_msg=f.name)


def _run(lam=20.0, n=4_000, *, cluster=None, telemetry=None, chunk=512,
         **kw):
    return simulator.simulate_fork_join(
        SEED, lam, n, PARAMS, chunk_size=chunk, cluster=cluster,
        telemetry=telemetry, device=CPU, **kw)


# --------------------------------------------------------------------------
# zero-cost opt-out (port against port)
# --------------------------------------------------------------------------

def test_telemetry_none_returns_no_timeline():
    assert _run(n=2_000).timeline is None


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(cluster=ClusterSpec(result_cache=(0.2, 2e-3)), tap_size=8),
    dict(cluster=ClusterSpec(r=2, routing="round_robin"), tap_size=8),
    dict(cluster=ClusterSpec(r=2, routing="jsq", result_cache=(0.2, 2e-3))),
    dict(cluster=ClusterSpec(r=3, routing="random",
                             result_cache=(0.2, 2e-3))),
])
def test_telemetry_leaves_base_stats_bitwise_identical(kwargs):
    """Telemetry on or off: the same draws and bit-identical base
    statistics."""
    plain = _run(24.0, 4_096, **kwargs)
    teled = _run(24.0, 4_096,
                 telemetry=TelemetrySpec(n_bins=16, slo_seconds=0.5),
                 **kwargs)
    for f in _BASE:
        assert torch.equal(getattr(plain, f), getattr(teled, f)) or (
            f == "tap_response" and torch.equal(
                getattr(plain, f).nan_to_num(-1.0),
                getattr(teled, f).nan_to_num(-1.0))), f
    assert plain.timeline is None and teled.timeline is not None


# --------------------------------------------------------------------------
# conservation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 1000, 4096])
def test_counts_conserved_across_chunkings(chunk):
    n_q = 4_000
    tl = _run(30.0, n_q, chunk=chunk, cluster=ClusterSpec(r=2),
              telemetry=TelemetrySpec(n_bins=12)).timeline
    assert float(tl.count.sum()) == float(n_q)
    assert float(tl.replica_count.sum()) == float(n_q)


def test_totals_independent_of_n_bins():
    """Same chunking, different bin counts: every total is conserved
    (float32 re-summation only)."""
    def totals(n_bins):
        tl = _run(24.0, 4_096, chunk=512,
                  cluster=ClusterSpec(r=2, routing="jsq",
                                      result_cache=(0.2, 2e-3)),
                  telemetry=TelemetrySpec(n_bins=n_bins, slo_seconds=0.3)
                  ).timeline
        return {f: float(getattr(tl, f).double().sum())
                for f in ("count", "resp_sum", "busy_broker",
                          "busy_server", "replica_count", "hit_count",
                          "slo_count")}

    a, b = totals(4), totals(64)
    for f in a:
        np.testing.assert_allclose(a[f], b[f], rtol=1e-5, err_msg=f)


class _Record:
    """A measured trace record's arrays: 2,000 queries at ~15 qps over
    p = 4 servers, float32, from a seed."""

    def __init__(self, n=2_000, p=4, seed=3):
        rng = np.random.default_rng(seed)
        f32 = np.float32
        self.arrival = (100.0 + np.cumsum(rng.exponential(1 / 15.0, n))
                        ).astype(f32)
        self.broker_busy = rng.exponential(5e-4, n).astype(f32)
        self.server_busy = rng.exponential(0.02, (n, p)).astype(f32)
        self.server_hit = (rng.random((n, p)) < 0.3).astype(f32)
        self.response = (self.broker_busy + self.server_busy.max(1)
                         + rng.exponential(0.01, n)).astype(f32)
        self.n_queries = n

    def as_torch(self) -> TraceRecord:
        return TraceRecord(**{
            k: torch.from_numpy(getattr(self, k)) for k in (
                "arrival", "response", "broker_busy", "server_busy",
                "server_hit")})


@pytest.fixture(scope="module")
def ref_trace():
    return _Record()


def test_trace_binned_busy_equals_trace_totals(ref_trace):
    """timeline_from_trace conserves the trace's busy and response totals
    for any bin count, and equals the reference's binning of the same
    arrays (as `TraceRecord.to_timeline` calls it)."""
    tr = ref_trace
    arrs = {k: getattr(tr, k).copy()
            for k in ("arrival", "response", "broker_busy", "server_busy",
                      "server_hit")}
    arrs["arrival"] = arrs["arrival"] - arrs["arrival"][0]
    for n_bins in (1, 7, 64):
        spec = TelemetrySpec(n_bins=n_bins)
        tl = timeline_from_trace(
            torch.from_numpy(arrs["arrival"]),
            torch.from_numpy(arrs["response"]), spec,
            broker_busy=torch.from_numpy(arrs["broker_busy"]),
            server_busy=torch.from_numpy(arrs["server_busy"]),
            server_hit=torch.from_numpy(arrs["server_hit"]))
        assert isinstance(tl, Timeline)
        for got, want in ((tl.busy_server, arrs["server_busy"]),
                          (tl.busy_broker, arrs["broker_busy"]),
                          (tl.resp_sum, arrs["response"])):
            np.testing.assert_allclose(float(got.double().sum()),
                                       float(want.sum()), rtol=1e-5)
        assert float(tl.count.sum()) == float(tr.n_queries)
        ref = j_timeline.timeline_from_trace(
            jnp.asarray(arrs["arrival"]), jnp.asarray(arrs["response"]),
            JTelemetry(n_bins=n_bins),
            broker_busy=jnp.asarray(arrs["broker_busy"]),
            server_busy=jnp.asarray(arrs["server_busy"]),
            server_hit=jnp.asarray(arrs["server_hit"]))
        assert_timelines_match(tl, ref, torch.float32)


def test_timeline_from_trace_routed_matches_reference(x64):
    """Replica-resolved binning (``assign``, r = 3) with an SLO and a
    horizon, on the same numpy arrays in float64."""
    rng = np.random.default_rng(7)
    n, p, r = 600, 3, 3
    arrival = np.cumsum(rng.random(n) * 0.1)
    kw = dict(broker_busy=rng.random(n) * 0.01,
              server_busy=rng.random((n, p)) * 0.05,
              server_hit=(rng.random(n) < 0.3).astype(np.float64),
              assign=rng.integers(0, r, n), r=r)
    response = rng.random(n)
    for spec in (TelemetrySpec(n_bins=9, slo_seconds=0.5),
                 TelemetrySpec(n_bins=5, horizon_seconds=20.0)):
        ref = j_timeline.timeline_from_trace(
            jnp.asarray(arrival), jnp.asarray(response),
            JTelemetry(**dataclasses.asdict(spec)),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        port = timeline_from_trace(
            torch.from_numpy(arrival), torch.from_numpy(response), spec,
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        assert_timelines_match(port, ref)


def test_fused_and_masked_engines_agree_on_timelines():
    spec = TelemetrySpec(n_bins=8, slo_seconds=0.4)
    tf = _run(20.0, 4_000, telemetry=spec,
              cluster=ClusterSpec(r=2, replica_impl="fused")).timeline
    tm = _run(20.0, 4_000, telemetry=spec,
              cluster=ClusterSpec(r=2, replica_impl="masked")).timeline
    for f in ("count", "resp_sum", "busy_broker", "busy_server",
              "replica_count", "slo_count"):
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   getattr(tm, f).numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f)


def test_slo_zero_counts_everything():
    tl = _run(20.0, 4_000,
              telemetry=TelemetrySpec(n_bins=8, slo_seconds=0.0)).timeline
    assert torch.equal(tl.slo_count, tl.count)


# --------------------------------------------------------------------------
# against the reference, on its draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r,routing,cache,impl", [
    (1, "round_robin", (0.2, 2e-3), "fused"),
    (2, "jsq", (0.2, 2e-3), "fused"),
    (2, "random", None, "masked")])
def test_timeline_matches_reference(x64, r, routing, cache, impl):
    """`simulate_fork_join_batch(telemetry=)` against the reference's on
    its draws: r = 1 with the cache, r = 2 fused (JSQ, the cache) and
    masked (random)."""
    spec = TelemetrySpec(n_bins=7, slo_seconds=0.3)
    ref, port = both_batch(routing, r=r, cache=cache, impl=impl,
                           telemetry=spec, n=2_048, chunk=256, tap=0)
    assert_timelines_match(port.timeline, ref.timeline)
    for f in ("count", "sum_response"):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-10)


# --------------------------------------------------------------------------
# operational laws
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stationary():
    """A stationary run at 60 % server utilization, 16 bins."""
    lam = 0.6 / float(service_time_server(PARAMS, device=CPU))
    tl = simulator.simulate_fork_join(
        SEED, lam, 24_000, PARAMS, chunk_size=2048,
        telemetry=TelemetrySpec(n_bins=16), device=CPU).timeline
    return lam, tl


def test_oplaw_identities_per_bin(stationary):
    """U = X*S and L = lambda*W recomputed from the accumulators are
    identities (rounding only)."""
    report, worst = obs_report.oplaw_check(stationary[1])
    assert worst < 1e-6, report


def test_utilization_law_statistical_mmc(stationary):
    """Mid-horizon per-server utilization matches U = lambda * S."""
    util = stationary[1].utilization.numpy()[..., 0, :]       # (B, p)
    np.testing.assert_allclose(util[3:-3].mean(), 0.6, rtol=0.15)


def test_littles_law_statistical(stationary):
    """L = lambda * W with L and W measured per bin."""
    lam, tl = stationary
    depth = tl.queue_depth.numpy()[3:-3]
    lam_w = (tl.throughput * tl.mean_response).numpy()[3:-3]
    np.testing.assert_allclose(depth, lam_w, rtol=1e-5)
    w = tl.mean_response.numpy()[3:-3].mean()
    np.testing.assert_allclose(depth.mean(), lam * w, rtol=0.2)


def test_sweep_simulated_threads_telemetry(x64):
    """Timelines come back with the grid's shape in front, each dispatch
    equal to the reference's on its draws; without a spec the sweep has
    none."""
    axes = dict(lam=[15.0, 25.0], p=[4.0], r=[2.0],
                base=dataclasses.replace(jcap.TABLE5_PARAMS, p=4),
                broker_from_p=False)
    jg, tg = _grids(**axes)
    n, chunk, key = 2_048, 512, jax.random.PRNGKey(4)
    spec = TelemetrySpec(n_bins=6, slo_seconds=0.2)
    ref = jsweep.sweep_simulated(jg, key, n_queries=n, chunk_size=chunk,
                                 cluster=JCluster(routing="jsq"),
                                 telemetry=JTelemetry(
                                     **dataclasses.asdict(spec)))
    per_dispatch = _reference_dispatch_draws(
        key, jg, n_queries=n, chunk=chunk, mode="exponential",
        routing="jsq", cache=None, tap=False)
    res = sweep.sweep_simulated(
        tg, 4, n_queries=n, chunk_size=chunk,
        cluster=ClusterSpec(routing="jsq"), telemetry=spec, dtype=F64,
        draws=lambda k: interop.draws_from_numpy(per_dispatch[k],
                                                 device=CPU, dtype=F64))
    tl = res.stats.timeline
    assert tuple(tl.count.shape) == (2, 1, 1, 1, 1, 1, 6)
    assert tuple(tl.busy_server.shape) == (2, 1, 1, 1, 1, 1, 6, 2, 4)
    assert tuple(tl.bin_seconds.shape) == (2, 1, 1, 1, 1, 1)
    np.testing.assert_array_equal(tl.count.sum(-1).numpy().ravel(),
                                  np.full(2, float(n)))
    assert_timelines_match(tl, ref.stats.timeline)
    plain = sweep.sweep_simulated(tg, 4, n_queries=512, chunk_size=512)
    assert plain.stats.timeline is None


def test_sweep_fault_axis_fills_the_baseline_timeline():
    """A fault axis's fault-free cell carries the channels' neutral
    values (every replica up for every arrival, nothing spilled or
    degraded), so its timeline stacks with the faulted cell's."""
    from repro_torch.core.faults import FaultSpec
    grid = sweep.SweepGrid.build(
        lam=[20.0], p=[4.0], r=[2.0], base=dataclasses.replace(PARAMS, p=4),
        broker_from_p=False, device=CPU,
        fault=(None, FaultSpec(outages=((0, 5.0, 30.0),),
                               broker_timeout_seconds=0.2, quorum_k=3)))
    res = sweep.sweep_simulated(grid, 1, n_queries=2_048, chunk_size=512,
                                telemetry=TelemetrySpec(n_bins=4))
    tl = res.stats.timeline
    assert tuple(tl.up_sum.shape) == (1, 1, 1, 1, 1, 2, 4)
    base, hit = (tl.map(lambda x, j=j: x[:, :, :, :, :, j]) for j in (0, 1))
    assert torch.equal(base.up_sum, 2.0 * base.count)
    assert float(base.spill_sum.abs().sum()) == 0.0
    assert float(base.degraded_sum.abs().sum()) == 0.0
    assert float(hit.up_sum.sum()) < 2.0 * float(hit.count.sum())
    assert float(hit.spill_sum.sum()) > 0.0


# --------------------------------------------------------------------------
# span traces
# --------------------------------------------------------------------------

def _flash(**kw):
    return ArrivalProcess.flash_crowd(
        20.0, burst_starts=5.0, burst_seconds=4.0, burst_multiplier=4.0,
        period_seconds=20.0, bin_seconds=1.0, **kw)


N_SPAN, R_SPAN = 400, 3


@pytest.fixture(scope="module")
def span_draws():
    """simulate_spans' four streams for 400 queries, from numpy."""
    rng = np.random.default_rng(11)
    return {"arrival": rng.exponential(size=N_SPAN),
            "broker": rng.exponential(size=N_SPAN),
            "server": rng.exponential(size=(N_SPAN, int(PARAMS.p))),
            "route": rng.integers(0, R_SPAN, N_SPAN)}


@pytest.fixture(scope="module")
def flash_spans(span_draws):
    """The flash-crowd spans (r = 3, JSQ) on the numpy draws."""
    return trace_export.simulate_spans(
        SEED, _flash(device=CPU), N_SPAN, PARAMS, r=R_SPAN, routing="jsq",
        draws=span_draws, device=CPU)


@pytest.mark.parametrize("routing", ["round_robin", "random", "jsq"])
def test_simulate_spans_replays_its_draws(span_draws, routing):
    """The reference's construction, step by step, on the given draws:
    per-query piecewise arrivals (the gap at the rate in force at the
    previous arrival), scaled services, the routing (JSQ by the plain
    loop on the drained tracker), and each replica's FCFS broker and
    servers: the spans equal it exactly (one order of operations)."""
    from repro_torch.kernels.jsq_route import ref as jsq_ref
    d = {k: torch.from_numpy(v) for k, v in span_draws.items()}
    proc = _flash(device=CPU)
    port = trace_export.simulate_spans(
        SEED, proc, N_SPAN, PARAMS, r=R_SPAN, routing=routing,
        draws=span_draws, device=CPU)
    u = d["arrival"].float()
    t, arr = torch.zeros(()), []
    for i in range(N_SPAN):
        t = t + u[i] / torch.clamp_min(proc.rate_at(t), 1e-30)
        arr.append(t)
    arr = torch.stack(arr)
    brk = d["broker"].float() * PARAMS.s_broker
    srv = d["server"].float() * service_time_server(PARAMS, device=CPU)
    if routing == "round_robin":
        asg = torch.arange(N_SPAN) % R_SPAN
    elif routing == "random":
        asg = d["route"]
    else:
        gaps = torch.diff(arr, prepend=arr[:1] * 0.0)
        asg = jsq_ref.jsq_route_ref(
            torch.zeros((1, R_SPAN, int(PARAMS.p))), gaps[None], srv.T[None],
            torch.ones((1, N_SPAN)))[0][0]
    np.testing.assert_array_equal(port.assign, asg.numpy())
    np.testing.assert_array_equal(port.arrival, arr.numpy())
    np.testing.assert_array_equal(port.broker_busy, brk.numpy())
    for k in range(R_SPAN):
        mine = asg == k
        done = simulator.fcfs_completion_times(arr[mine], brk[mine])
        np.testing.assert_array_equal(port.broker_done[mine.numpy()],
                                      done.numpy())
        comp = simulator.fcfs_completion_times(
            done[None].expand(int(PARAMS.p), -1), srv[mine].T)
        np.testing.assert_array_equal(port.completions[:, mine.numpy()],
                                      comp.numpy())
    np.testing.assert_array_equal(
        port.response, (port.completions.max(0) - port.arrival))
    assert len(set(port.assign.tolist())) == R_SPAN
    # an integer seed draws its own streams, the same ones every time
    a = trace_export.simulate_spans(5, proc, 64, PARAMS, r=R_SPAN,
                                    routing=routing, device=CPU)
    b = trace_export.simulate_spans(5, proc, 64, PARAMS, r=R_SPAN,
                                    routing=routing, device=CPU)
    np.testing.assert_array_equal(a.response, b.response)


def test_chrome_trace_roundtrip_validates(flash_spans, tmp_path):
    spans = flash_spans
    path = trace_export.export_chrome_trace(spans, tmp_path / "t.json")
    counts = trace_export.validate_chrome_trace(path)
    # every query: 1 broker span + p server spans, one b/e pair
    p = int(PARAMS.p)
    assert counts["X"] == spans.n_queries * (p + 1)
    assert counts["b"] == counts["e"] == spans.n_queries
    assert counts["async_pairs"] == spans.n_queries
    assert counts["lanes"] <= 3 * (p + 1)
    obj = json.loads((tmp_path / "t.json").read_text())
    assert obj["displayTimeUnit"] == "ms"


def test_validator_rejects_tampered_traces():
    events = trace_export.simulate_spans(
        SEED, _flash(device=CPU), 50, PARAMS, r=1, device=CPU).to_events()
    broken = [e for e in events if not (e["ph"] == "e"
                                        and e.get("id") == 0)]
    with pytest.raises(ValueError, match="unbalanced"):
        trace_export.validate_chrome_trace({"traceEvents": broken})
    lanes = [e for e in events if e["ph"] == "X"]
    clone = dict(lanes[0])
    clone["ts"] = lanes[0]["ts"] - (lanes[0]["dur"] + 10_000.0)
    clone["dur"] = 10 * (lanes[0]["dur"] + 10_000.0)
    with pytest.raises(ValueError, match="overlap"):
        trace_export.validate_chrome_trace(
            {"traceEvents": events + [clone]})
    with pytest.raises(ValueError, match="traceEvents"):
        trace_export.validate_chrome_trace({"events": []})


def test_spans_from_trace_bridges_measured_records(ref_trace):
    """A measured record's arrays through the port's `spans_from_trace`
    and the reference's: the same spans (float32 rounding of the
    replay's sums), and a valid trace."""
    spans = trace_export.spans_from_trace(ref_trace.as_torch())
    ref = j_trace.spans_from_trace(ref_trace)
    assert spans.n_queries == ref_trace.n_queries and spans.p == 4
    for f in ("arrival", "response", "broker_busy", "server_busy",
              "broker_done", "completions", "assign"):
        np.testing.assert_allclose(getattr(spans, f),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-5, err_msg=f)
    trace_export.validate_chrome_trace({"traceEvents": spans.to_events()})


# --------------------------------------------------------------------------
# profiling hooks
# --------------------------------------------------------------------------

def test_profile_jit_records_cost_and_memory():
    a = torch.ones((64, 64))
    rec = obs_profile.profile_jit(lambda x, y: x @ y, a, a, name="matmul",
                                  n_runs=2)
    assert rec.name == "matmul"
    assert rec.compile_s > 0.0 and rec.run_s > 0.0
    assert rec.flops == 2.0 * 64 ** 3
    assert rec.argument_bytes == 2 * 64 * 64 * 4
    assert rec.output_bytes == 64 * 64 * 4
    assert rec.peak_bytes > 0.0 and rec.temp_bytes == 0.0
    d = rec.to_json()
    rt = obs_profile.ProfileRecord.from_json(d)
    assert rt == rec and d["peak_bytes"] == rec.peak_bytes


def test_profile_jit_n_runs_zero_skips_execution():
    rec = obs_profile.profile_jit(lambda x: x * 2.0, torch.ones(8),
                                  n_runs=0)
    assert rec.run_s == 0.0 and rec.compile_s > 0.0


def test_profile_kernels_records():
    recs = obs_profile.profile_kernels(rows=8, cols=256, n_runs=0,
                                       device=CPU)
    assert [r.name for r in recs] == ["maxplus_scan",
                                      "maxplus_segment_scan"]
    moved = 4 * 8 * 256 * 4
    assert [r.bytes_accessed for r in recs] == [moved, moved + 256]
    assert all(r.argument_bytes > 0 and r.flops == 0.0 for r in recs)
    table = obs_report.render_profiles(recs)
    for r in recs:
        assert r.name in table


# --------------------------------------------------------------------------
# dashboard helpers
# --------------------------------------------------------------------------

def test_report_renders_and_sparkline_handles_nan():
    assert obs_report.sparkline([0.0, float("nan"), 1.0]) == "▁ █"
    assert obs_report.sparkline(torch.tensor([0.0, float("nan"), 1.0])) \
        == "▁ █"
    tl = _run(20.0, 3_000, cluster=ClusterSpec(r=2,
                                               result_cache=(0.3, 1e-3)),
              telemetry=TelemetrySpec(n_bins=8, slo_seconds=0.2)).timeline
    panel = obs_report.render_timeline(tl, "unit")
    for needle in ("throughput", "imbalance", "cache hits",
                   "SLO viol frac"):
        assert needle in panel
    prof = obs_report.render_profiles(
        [obs_profile.ProfileRecord("k", 1.0, 0.1, 1e6, 1e6, 1.0, 2.0,
                                   3.0)])
    assert "k" in prof


def test_report_cli_runs_on_the_cpu(capsys):
    assert obs_report.main(["--device", "cpu", "--scenario", "stationary",
                            "--n-queries", "1000", "--bins", "8",
                            "--no-profile"]) == 0
    out = capsys.readouterr().out
    assert "operational-law self-checks" in out and "throughput" in out


def test_telemetry_spec_validation_and_defaults():
    assert TelemetrySpec().n_bins == DEFAULT_TIMELINE_BINS
    with pytest.raises(ValueError, match="at least one bin"):
        TelemetrySpec(n_bins=0)
    assert hash(TelemetrySpec()) == hash(TelemetrySpec())


def test_telemetry_horizon_override():
    spec = TelemetrySpec(n_bins=10, horizon_seconds=100.0)
    tl = _run(20.0, 1_000, telemetry=spec).timeline
    np.testing.assert_allclose(float(tl.bin_seconds), 10.0)
    assert float(tl.count.sum()) == 1_000.0


# --------------------------------------------------------------------------
# hypothesis properties
# --------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @given(n_bins=st.integers(1, 97), seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=20, deadline=None)
    def test_property_binned_totals_conserved(n_bins, seed):
        """Binning is a partition: per-bin sums add back to the trace
        total for any bin count."""
        rng = np.random.default_rng(seed)
        n, p = 257, 3
        arrival = np.cumsum(rng.random(n).astype(np.float32) * 0.1)
        response = rng.random(n).astype(np.float32)
        server_busy = rng.random((n, p)).astype(np.float32) * 0.05
        broker_busy = rng.random(n).astype(np.float32) * 0.01
        tl = timeline_from_trace(
            torch.from_numpy(arrival - arrival[0]),
            torch.from_numpy(response), TelemetrySpec(n_bins=n_bins),
            broker_busy=torch.from_numpy(broker_busy),
            server_busy=torch.from_numpy(server_busy))
        assert float(tl.count.sum()) == float(n)
        for got, want in ((tl.resp_sum, response),
                          (tl.busy_server, server_busy),
                          (tl.busy_broker, broker_busy)):
            np.testing.assert_allclose(float(got.sum()), want.sum(),
                                       rtol=1e-4)

    @given(n_bins=st.integers(2, 64), seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=20, deadline=None)
    def test_property_oplaws_hold_for_any_binning(n_bins, seed):
        """U = X*S and L = lambda*W are identities of the binned
        accumulators for any bin count."""
        rng = np.random.default_rng(seed)
        n = 211
        arrival = np.cumsum(rng.random(n).astype(np.float32) * 0.2)
        response = rng.random(n).astype(np.float32)
        server_busy = rng.random((n, 2)).astype(np.float32) * 0.05
        tl = timeline_from_trace(
            torch.from_numpy(arrival - arrival[0]),
            torch.from_numpy(response), TelemetrySpec(n_bins=n_bins),
            broker_busy=torch.zeros(n), server_busy=torch.from_numpy(
                server_busy))
        _, worst = obs_report.oplaw_check(tl)
        assert worst < 1e-5
else:
    @pytest.mark.skip(reason="property tests need hypothesis (see "
                      "pyproject [project.optional-dependencies].test)")
    def test_property_binned_totals_conserved():
        pass

    @pytest.mark.skip(reason="property tests need hypothesis (see "
                      "pyproject [project.optional-dependencies].test)")
    def test_property_oplaws_hold_for_any_binning():
        pass
