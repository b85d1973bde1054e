"""The port's calibration loop (`repro_torch.calibrate`) held against
`repro.calibrate`.

Reference comparisons run in float64 (the reference under x64): both
sides then agree to summation-order noise, and the (max,+) replay has no
ties between an arrival and its server going idle.  `simulate_trace`
takes the reference's six split-key streams as numpy through
``draws=``; the validation simulator takes the reference's per-chunk
draws through ``validate(draws=)``.  Tolerances: trace fields 1e-6,
window statistics and `fit_moments` 1e-10, alpha and s_scale (analytic
and "maxplus") 1e-5, the calibrated column 1e-6, the simulated column
1e-6, the scan's tangent 1e-12 on tie-free inputs.  In float32 the
per-query arrival recurrence is bitwise the reference's.

The port's own RNG runs the statistical acceptance of
tests/test_calibrate.py at a smaller size: parameters back within 5 %,
0 < alpha < 1.  The card holds its fit against the CPU in
tests/test_torch_gpu.py and chip_smoke.py phase 19.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calibrate import fit as j_fit
from repro.calibrate import plan_from_trace as j_plan_from_trace
from repro.calibrate import measure as j_measure
from repro.calibrate.validate import _vec_params as j_vec_params
from repro.calibrate.validate import calibrate_and_validate as j_cav
from repro.calibrate.validate import validate as j_validate
from repro.core import capacity as j_cap
from repro.core import simulator as j_sim
from repro.core.arrivals import ArrivalProcess as JArrival
from repro.engine import cache as j_cache
from repro.obs import TelemetrySpec as JTelemetry
from repro_torch import interop
from repro_torch.calibrate import (TraceRecord, calibrate,
                                   calibrate_and_validate, concat_traces,
                                   fit_alpha, fit_moments,
                                   measure_engine_trace, plan_from_trace,
                                   refine, simulate_trace, trace_from_tap,
                                   validate, window_stats)
from repro_torch.calibrate import measure
from repro_torch.calibrate.validate import _holdout_split
from repro_torch.core import capacity, simulator
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec
from repro_torch.engine import corpus as corpus_lib
from repro_torch.engine import partition, server
from repro_torch.obs import TelemetrySpec

CPU = "cpu"
F64 = torch.float64
ROOT = pathlib.Path(__file__).resolve().parent.parent
TRUE_J = dataclasses.replace(j_cap.TABLE5_PARAMS, p=4)
TRUE = dataclasses.replace(capacity.TABLE5_PARAMS, p=4)
_FIT_FIELDS = ("s_broker", "s_hit", "s_miss", "s_disk", "hit")
RATES = (10.0, 22.0, 14.0)
N_TRACE = 5_000


class _X64:
    def __enter__(self):
        self.old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self.old)


@pytest.fixture
def x64():
    with _X64():
        yield


def _ref_draws(key, n, p, hit):
    """The reference's six split-key streams, as `simulate_trace` draws
    them (x64 on)."""
    ks = jax.random.split(key, 6)
    f = jnp.float64
    exp = [np.asarray(jax.random.exponential(k, shape, f))
           for k, shape in ((ks[0], (n,)), (ks[1], (n,)), (ks[3], (n, p)),
                            (ks[4], (n, p)), (ks[5], (n, p)))]
    return dict(arrival=exp[0], broker=exp[1],
                hit=np.asarray(jax.random.bernoulli(
                    ks[2], jnp.asarray(hit, f), (n, p))),
                s_hit=exp[2], s_miss=exp[3], s_disk=exp[4])


def _crowd_j():
    return JArrival.flash_crowd(10.0, burst_starts=[120.0],
                                burst_seconds=90.0, burst_multiplier=2.2,
                                period_seconds=360.0, bin_seconds=60.0)


def _crowd_t(dtype=F64):
    return ArrivalProcess.flash_crowd(
        10.0, burst_starts=[120.0], burst_seconds=90.0,
        burst_multiplier=2.2, period_seconds=360.0, bin_seconds=60.0,
        device=CPU, dtype=dtype)


def _pair(i, lam, n=N_TRACE, crowd=False):
    """(reference trace, port trace) from the reference's draws."""
    key = jax.random.PRNGKey(i)
    ref = j_measure.simulate_trace(key, _crowd_j() if crowd else lam, n,
                                   TRUE_J)
    port = simulate_trace(0, _crowd_t() if crowd else lam, n, TRUE,
                          draws=_ref_draws(key, n, 4, TRUE_J.hit),
                          device=CPU, dtype=F64)
    return ref, port


@pytest.fixture(scope="module")
def pairs():
    """Three stationary runs, light to heavy, on both sides."""
    with _X64():
        both = [_pair(i, lam) for i, lam in enumerate(RATES)]
    return [r for r, _ in both], [p for _, p in both]


def _to_ref(tr: TraceRecord) -> j_measure.TraceRecord:
    return j_measure.TraceRecord(**{
        f.name: None if getattr(tr, f.name) is None
        else jnp.asarray(getattr(tr, f.name).numpy())
        for f in dataclasses.fields(TraceRecord)})


def _close(port, ref, rtol, what=""):
    np.testing.assert_allclose(torch.as_tensor(port).numpy(),
                               np.asarray(ref), rtol=rtol, err_msg=what)


def _same_params(port, ref, rtol):
    for f in _FIT_FIELDS:
        _close(getattr(port, f), getattr(ref, f), rtol, f)


@pytest.mark.parametrize("crowd", [False, True], ids=["stationary",
                                                      "flash_crowd"])
def test_simulate_trace_on_reference_draws(x64, crowd):
    ref, port = _pair(7, 18.0, n=3_000, crowd=crowd)
    assert port.n_queries == ref.n_queries and port.p == 4
    for f in dataclasses.fields(TraceRecord):
        _close(getattr(port, f.name), getattr(ref, f.name), 1e-6, f.name)
    _close(port.observed_rate, ref.observed_rate, 1e-12)


def test_sample_arrivals_float32_bitwise():
    """The per-query piecewise recurrence rounds as the reference's
    float32 scan does: the same timestamps, bit for bit."""
    key = jax.random.PRNGKey(3)
    ref = j_measure._sample_arrivals(key, _crowd_j(), 4_000)
    u = jax.random.exponential(key, (4_000,), jnp.float32)
    port = measure._sample_arrivals(torch.tensor(np.asarray(u)),
                                    _crowd_t(torch.float32))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_simulate_trace_own_rng_and_checks():
    """The port's own streams: reproducible from the seed, warmup
    dropped, and a multi-scenario profile refused."""
    a = simulate_trace(5, 15.0, 2_000, TRUE, device=CPU)
    b = simulate_trace(5, 15.0, 2_000, TRUE, device=CPU)
    assert a.n_queries == 1_800 and a.response.dtype == torch.float32
    torch.testing.assert_close(a.response, b.response, rtol=0, atol=0)
    assert bool((a.response > 0).all())
    two = ArrivalProcess.piecewise([[5.0, 6.0], [7.0, 8.0]], 60.0,
                                   device=CPU)
    with pytest.raises(ValueError, match="single-scenario"):
        simulate_trace(5, two, 100, TRUE, device=CPU)


def test_window_plan_and_stats_match_reference(x64, pairs):
    refs, ports = pairs
    for n_windows in (6, 8, 13):
        assert (measure.window_plan(ports, n_windows)
                == j_measure.window_plan(refs, n_windows))
        for p_, r_ in zip(window_stats(ports, n_windows),
                          j_measure.window_stats(refs, n_windows)):
            _close(p_, r_, 1e-10)


@pytest.mark.parametrize("disk", [True, False], ids=["disk", "no_disk"])
def test_fit_moments_matches_reference(x64, pairs, disk):
    refs, ports = pairs
    if not disk:
        refs = [dataclasses.replace(tr, server_disk=None) for tr in refs]
        ports = [dataclasses.replace(tr, server_disk=None) for tr in ports]
    fitted = fit_moments(ports)
    assert fitted.p == 4
    _same_params(fitted, j_fit.fit_moments(refs), 1e-10)
    if not disk:       # convention: the larger miss component is disk
        assert float(fitted.s_disk) > float(fitted.s_miss)


def test_fit_moments_invariant_to_chunking(pairs):
    _, ports = pairs
    whole = fit_moments(ports[0])
    for n_batches in (2, 5, 13):
        _same_params(fit_moments(ports[0].split(n_batches)), whole, 1e-10)


def test_split_and_concat_round_trip(pairs):
    _, ports = pairs
    parts = ports[1].split(4)
    assert sum(tr.n_queries for tr in parts) == ports[1].n_queries
    back = concat_traces(parts)
    for f in dataclasses.fields(TraceRecord):
        assert torch.equal(getattr(back, f.name), getattr(ports[1], f.name))
    bare = dataclasses.replace(ports[0], server_disk=None)
    assert concat_traces(bare.split(3)).server_disk is None


def test_fit_alpha_matches_reference(x64, pairs):
    refs, ports = pairs
    lam, r_obs, _ = window_stats(ports, 9)
    jlam, jr, _ = j_measure.window_stats(refs, 9)
    base = fit_moments(ports)
    _close(fit_alpha(base, lam, r_obs),
           j_fit.fit_alpha(j_fit.fit_moments(refs), jlam, jr), 1e-10)


@pytest.mark.parametrize("fit_scale", [False, True])
def test_refine_analytic_matches_reference(x64, pairs, fit_scale):
    refs, ports = pairs
    lam, r_obs, cnt = window_stats(ports, 9)
    jlam, jr, jc = j_measure.window_stats(refs, 9)
    port = refine(fit_moments(ports), lam, r_obs, cnt, n_iters=8,
                  fit_scale=fit_scale)
    ref = j_fit.refine(j_fit.fit_moments(refs), jlam, jr, jc, n_iters=8,
                       fit_scale=fit_scale)
    for p_, r_, what in zip(port, ref, ("s_scale", "alpha", "rms")):
        _close(p_, r_, 1e-5, what)


def test_calibrate_maxplus_matches_reference(x64, pairs):
    """The (max,+) replay residual through the scan's forward-mode rule:
    a trace whose busy times read 10 % low against its responses fits
    s_scale ~ 1.1, and alpha and s_scale equal the reference's."""
    refs, ports = pairs

    def low(tr):
        return dataclasses.replace(tr, server_busy=tr.server_busy / 1.1,
                                   server_disk=tr.server_disk / 1.1)
    port = calibrate([low(tr) for tr in ports[:2]], n_windows=6,
                     residual="maxplus", n_iters=4)
    ref = j_fit.calibrate([low(tr) for tr in refs[:2]], n_windows=6,
                          residual="maxplus", n_iters=4)
    assert abs(float(port.s_scale) - 1.1) <= 0.03
    _close(port.s_scale, ref.s_scale, 1e-5, "s_scale")
    _close(port.alpha, ref.alpha, 1e-5, "alpha")
    assert abs(float(port.residual_rms) - float(ref.residual_rms)) <= 1e-9
    _same_params(port.params, ref.params, 1e-5)
    with pytest.raises(ValueError, match="n_windows"):
        lam, r_obs, cnt = window_stats(ports, 6)
        refine(fit_moments(ports), lam, r_obs, cnt, residual="maxplus",
               traces=ports, n_windows=4)


def test_calibrate_without_refine_matches_reference(x64, pairs):
    refs, ports = pairs
    port = calibrate(ports, n_windows=9, do_refine=False)
    ref = j_fit.calibrate(refs, n_windows=9, do_refine=False)
    _close(port.alpha, ref.alpha, 1e-10)
    _close(port.residual_rms, ref.residual_rms, 1e-10)
    assert float(port.s_scale) == 1.0


def test_roundtrip_parameter_recovery():
    """ACCEPTANCE on the port's own RNG (float32): Eq-1 parameters back
    within 5 %, 0 < alpha < 1."""
    traces = [simulate_trace(i, lam, 12_000, TRUE, device=CPU)
              for i, lam in enumerate((10.0, 22.0, 14.0, 18.0))]
    cal = calibrate(traces, n_windows=12)
    for f in _FIT_FIELDS:
        got, want = float(getattr(cal.params, f)), float(getattr(TRUE, f))
        assert abs(got - want) <= 0.05 * want, f
    assert 0.0 < float(cal.alpha) < 1.0


def _validation_draws(key, lam_h, cal_j, n):
    """The reference validate's per-chunk draws for its simulator column."""
    vp = j_vec_params(cal_j.to_server_params(), lam_h.shape[0])
    chunk = min(j_sim.DEFAULT_CHUNK, n)
    per_chunk = []
    for c in range(-(-n // chunk)):
        g, b, sv = j_sim.chunk_random_draws(key, c, lam_h.shape[0], chunk,
                                            4, vp, "cache")
        per_chunk.append((np.asarray(g), np.asarray(b), np.asarray(sv)))
    return interop.draws_from_numpy(per_chunk, device=CPU, dtype=F64)


def test_validate_matches_reference(x64, pairs):
    """The calibrated column within 1e-6 of the reference's; the
    simulated column on the reference's draws within 1e-6."""
    refs, ports = pairs
    cal = calibrate(ports, n_windows=9)
    cal_j = j_fit.calibrate(refs, n_windows=9)
    key = jax.random.PRNGKey(4)
    n_sim = 6_000
    lam_h = j_measure.window_stats(refs, 6)[0][-3:]
    port = validate(ports, cal, n_windows=6, holdout_fraction=0.5,
                    simulator_queries=n_sim,
                    draws=_validation_draws(key, lam_h, cal_j, n_sim))
    ref = j_validate(refs, cal_j, n_windows=6,
                              holdout_fraction=0.5, key=key,
                              simulator_queries=n_sim)
    for f in ("lam", "r_observed", "r_calibrated", "r_simulated"):
        _close(getattr(port, f), getattr(ref, f), 1e-6, f)
    assert port.r_sim_replicated is None and port.replicas == 1
    assert abs(port.mean_rel_err - ref.mean_rel_err) <= 1e-6
    assert "held-out windows" in port.summary()


def test_validate_replicated_column():
    """cluster=ClusterSpec(r=2, routing="jsq") adds the replicated column
    (the router and the segmented scan) beside the single-cluster one."""
    traces = [simulate_trace(i, lam, 4_000, TRUE, device=CPU)
              for i, lam in enumerate((12.0, 20.0))]
    cal = calibrate(traces, n_windows=6, n_iters=4)
    rep = validate(traces, cal, n_windows=6, simulator_queries=4_000,
                   cluster=ClusterSpec(r=2, routing="jsq"))
    assert rep.replicas == 2 and rep.r_sim_replicated.shape == (6,)
    assert bool(torch.isfinite(rep.r_sim_replicated).all())
    assert bool((torch.diff(rep.lam) >= 0).all())
    assert float(torch.max(rep.rel_err_replicated)) < 0.5
    assert "x2-replicated" in rep.summary()


def test_calibrate_and_validate_matches_reference(x64, pairs):
    """The time split (at most one batch cut in two) and the fit on its
    head equal the reference's; the report's observed and calibrated
    columns too."""
    refs, ports = pairs
    train, held = _holdout_split(ports, 0.4)      # 4,500 queries a run
    assert [t.n_queries for t in train] == [4_500, 3_600]
    assert [t.n_queries for t in held] == [900, 4_500]
    torch.testing.assert_close(held[0].arrival, ports[1].arrival[3_600:])
    cal, report = calibrate_and_validate(ports, n_windows=12,
                                         holdout_fraction=0.4, n_iters=6,
                                         simulator_queries=4_000)
    cal_j, rep_j = j_cav(
        refs, n_windows=12, holdout_fraction=0.4, n_iters=6,
        simulator_queries=4_000)
    _same_params(cal.params, cal_j.params, 1e-5)
    _close(cal.alpha, cal_j.alpha, 1e-5)
    for f in ("lam", "r_observed", "r_calibrated"):
        _close(getattr(report, f), getattr(rep_j, f), 1e-6, f)
    with pytest.raises(ValueError, match="no training data"):
        calibrate_and_validate(ports[0], holdout_fraction=1.0)


def test_plan_from_trace_matches_reference(x64, pairs):
    refs, ports = pairs
    cal, plan = plan_from_trace(ports, 100.0, 0.300, n_windows=9)
    cal_j, plan_j = j_plan_from_trace(refs, 100.0, 0.300, n_windows=9)
    assert plan.n_replicas == plan_j.n_replicas
    assert plan.servers_per_replica == plan_j.servers_per_replica
    assert abs(plan.response_upper_ms - plan_j.response_upper_ms) <= (
        1e-6 * plan_j.response_upper_ms)
    assert plan.response_upper_ms <= 300.0


def test_trace_from_tap_on_a_port_tap():
    """Reservoir samples of the port's engine -> (lam, mean) points,
    the reference's reduction of the same array; they feed fit_alpha."""
    res = simulator.simulate_fork_join_batch(
        3, torch.tensor([10.0, 16.0, 22.0]),
        simulator._vec_params(TRUE, torch.device(CPU), torch.float32),
        20_000, p=4, mode="cache", tap_size=256, device=CPU)
    tap = res.tap_response
    lam, mean = trace_from_tap(tap, torch.tensor([10.0, 16.0, 22.0]))
    jlam, jmean = j_measure.trace_from_tap(jnp.asarray(tap.numpy()),
                                           jnp.asarray([10.0, 16.0, 22.0]))
    _close(lam, jlam, 0)
    _close(mean, jmean, 1e-6)
    alpha = fit_alpha(TRUE, lam, mean)
    assert 0.0 < float(alpha) < 1.0


def test_scan_jvp_matches_reference_float64(x64):
    """torch.func.jvp through fcfs_completion_times (the scan's
    forward-mode rule) against jax.jvp of the reference's, on tie-free
    float64 inputs, along the service scale and along the arrivals."""
    rng = np.random.default_rng(0)
    arr = np.cumsum(rng.exponential(0.05, (3, 2_000)), -1)
    svc = rng.exponential(0.04, (3, 2_000))
    d_arr = rng.normal(size=arr.shape)
    ta, ts = torch.from_numpy(arr), torch.from_numpy(svc)

    def port(s, da):
        return simulator.fcfs_completion_times(ta + da, ts * s)

    def ref(s, da):
        return j_sim.fcfs_completion_times(jnp.asarray(arr) + da,
                                           jnp.asarray(svc) * s)

    one = np.float64(1.3)
    for tangent in ((1.0, np.zeros_like(arr)), (0.0, d_arr)):
        po, pt = torch.func.jvp(port, (torch.tensor(one), torch.zeros_like(
            ta)), (torch.tensor(tangent[0], dtype=F64),
                   torch.from_numpy(tangent[1])))
        ro, rt = jax.jvp(ref, (one, jnp.zeros_like(arr)),
                         (np.float64(tangent[0]), jnp.asarray(tangent[1])))
        _close(po, ro, 1e-12)
        _close(pt, rt, 1e-12, "tangent")


def test_scan_jvp_splits_ties():
    """A tie (an arrival the instant its server goes idle) splits the
    tangent 0.5 / 0.5, as jnp.maximum's JVP does."""
    from repro_torch.kernels.maxplus_scan import autodiff
    a = torch.tensor([1.0, 2.0, 3.0, 7.0])
    b = torch.tensor([0.0, 1.0, 1.0, 1.0])
    out, tan = torch.func.jvp(
        lambda x: autodiff.maxplus_scan_a(x, b), (a,),
        (torch.tensor([1.0, 0.0, 0.0, 0.0]),))
    torch.testing.assert_close(out, a)
    torch.testing.assert_close(tan, torch.tensor([1.0, 0.5, 0.25, 0.0]))
    rt = jax.jvp(lambda x: jnp.maximum(x, 1.0), (1.0,), (1.0,))[1]
    assert float(rt) == 0.5
    _, tb = torch.func.jvp(lambda y: autodiff.maxplus_scan_a(a, y), (b,),
                           (torch.ones(4),))
    torch.testing.assert_close(tb, torch.tensor([0.0, 0.5, 0.75, 0.0]))


def test_measure_engine_trace_matches_reference_replay(x64):
    """The instrumented engine on a tiny 2-shard index: hits and disk
    equal the reference's cache replay, and the responses equal the
    reference's FCFS replay of the recorded busy times."""
    corp = corpus_lib.generate_corpus(corpus_lib.CorpusConfig(
        n_docs=1500, vocab_size=1000, mean_doc_len=30, seed=0))
    parts = partition.partition_documents(corp, 2)
    shards = [server.IndexServer(ix, k_local=5, device=CPU)
              for ix in parts.shards]
    rng = np.random.default_rng(2)
    qterms = np.full((256, 3), -1, np.int32)
    qterms[:, :2] = rng.integers(0, 200, (256, 2))
    arrivals = np.sort(rng.uniform(0.0, 10.0, 256))
    cache_bytes = 20_000
    tr = measure_engine_trace(shards, qterms, arrivals,
                              cache_bytes=cache_bytes, batch=64,
                              dtype=F64)
    assert tr.n_queries == 256 and tr.p == 2
    for s, shard in enumerate(parts.shards):
        _, hits, disk = j_cache.measure_cache_behavior(
            qterms, shard.list_bytes(), cache_bytes, warmup=0)
        np.testing.assert_array_equal(tr.server_hit[:, s].numpy(), hits)
        np.testing.assert_array_equal(tr.server_disk[:, s].numpy(),
                                      np.where(hits, 0.0, disk))
    done = j_sim.fcfs_completion_times(jnp.asarray(tr.arrival.numpy()),
                                       jnp.asarray(tr.broker_busy.numpy()))
    comp = j_sim.fcfs_completion_times(
        jnp.broadcast_to(done[None], (2, 256)),
        jnp.asarray(tr.server_busy.numpy().T))
    _close(tr.response, jnp.max(comp, 0) - tr.arrival.numpy(), 1e-10)
    assert bool((tr.broker_busy > 0).all())
    with pytest.raises(ValueError, match="full batch"):
        measure_engine_trace(shards, qterms[:10], arrivals[:10],
                             cache_bytes=cache_bytes)


def test_to_timeline_matches_reference(x64, pairs):
    """TraceRecord.to_timeline bins as the reference's: counts exact,
    busy and response sums 1e-12, and conserving the record's totals."""
    refs, ports = pairs
    for n_bins in (1, 7, 64):
        tl = ports[0].to_timeline(TelemetrySpec(n_bins=n_bins))
        ref = refs[0].to_timeline(JTelemetry(n_bins=n_bins))
        np.testing.assert_array_equal(tl.count.numpy(),
                                      np.asarray(ref.count))
        for f in ("resp_sum", "busy_broker", "busy_server", "hit_count"):
            _close(getattr(tl, f), getattr(ref, f), 1e-12, f)
        _close(tl.busy_server.sum(), ports[0].server_busy.sum(), 1e-12)
        assert float(tl.count.sum()) == ports[0].n_queries


def test_calibrate_smoke_example_runs():
    """examples/torch_calibrate_smoke.py's `run_smoke`, on the CPU."""
    path = ROOT / "examples" / "torch_calibrate_smoke.py"
    spec = importlib.util.spec_from_file_location("torch_cal_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cal, report = mod.run_smoke(device=CPU, verbose=False)
    assert report.lam.shape[0] >= 1 and 0.0 < float(cal.alpha) < 1.0


# ----- hypothesis property: chunking invariance under ANY split sizes ----
# Guarded as tests/test_calibrate.py guards it, so the rest of the module
# still runs without hypothesis.

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @given(splits=st.lists(st.integers(1, 4000), min_size=1, max_size=8))
    @settings(max_examples=20, deadline=None)
    def test_fit_invariant_to_arbitrary_chunking(splits):
        """PROPERTY: moment fitting sees only accumulated sufficient
        statistics, so ANY contiguous re-batching of a trace fits the
        same parameters (float-accumulation noise only)."""
        trace = _PROPERTY_TRACE
        n = trace.n_queries
        edges = sorted({min(s, n - 1) for s in splits})
        bounds = [0] + edges + [n]
        batches = [trace.map(lambda x: x[lo:hi])
                   for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
        _same_params(fit_moments(batches), fit_moments(trace), 1e-3)

    _PROPERTY_TRACE = simulate_trace(99, 15.0, 8_000, TRUE, device=CPU)
else:
    @pytest.mark.skip(reason="property tests need hypothesis (see "
                      "pyproject [project.optional-dependencies].test)")
    def test_fit_invariant_to_arbitrary_chunking():
        pass
