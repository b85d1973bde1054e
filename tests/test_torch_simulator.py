"""The port's streaming engine held against `repro.core.simulator`.

Path tests feed both engines the SAME random numbers: the reference's
canonical `chunk_random_draws` are materialized with numpy and handed to
the port through `repro_torch.interop.draws_from_numpy` (threefry and
Philox never agree draw for draw).  Parameters and load cross the same
way, as numpy arrays.  In float64 (the reference under x64) the runs
must agree to association-order noise: exact counts, sums to 1e-10 and
identical histograms.  In float32 the scans associate differently, so
means and spread are held to 1e-4 and at most 0.5 % of the histogram
mass may change bins.

Statistical tests run the port's own RNG and mirror
tests/test_simulator.py: Eq 7 bounds, M/M/1 and Erlang-C theory.
"""

import ast
import dataclasses
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import queueing as jq
from repro.core import simulator as jsim
from repro.core.arrivals import ArrivalProcess as JArrival
from repro_torch import interop
from repro_torch.core import capacity as tcap
from repro_torch.core import queueing as tq
from repro_torch.core import simulator as tsim
from repro_torch.core.arrivals import ArrivalProcess as TArrival

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def x64():
    """Temporarily enable float64 so association-order noise vanishes."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _params_np(s, p):
    """(S,) Table-5-like parameters, one variant per scenario."""
    base = jcap.TABLE5_PARAMS
    f = np.linspace(1.0, 1.3, s)
    return dict(p=np.full(s, p), s_broker=base.s_broker * f,
                s_hit=base.s_hit * f, s_miss=base.s_miss * f,
                s_disk=base.s_disk / f, hit=np.full(s, base.hit))


def _load(kind, s):
    """The reference ArrivalProcess for a load kind, S scenarios."""
    rates = np.linspace(16.0, 22.0, s)
    if kind == "stationary":
        return JArrival.stationary(jnp.asarray(rates))
    if kind == "piecewise":
        return JArrival.piecewise(
            jnp.asarray(np.stack([rates * 0.5, rates * 1.5], -1)), 60.0)
    if kind == "flash_crowd":
        return JArrival.flash_crowd(jnp.asarray(rates * 0.8),
                                    burst_starts=[90.0], burst_seconds=45.0,
                                    burst_multiplier=1.6,
                                    period_seconds=240.0, bin_seconds=60.0)
    ts = np.cumsum(np.random.default_rng(7).exponential(1.0 / 19.0, 9000))
    return JArrival.from_trace(jnp.asarray(ts))


def _both(kind, mode, dtype, n=6000, s=2, p=4, chunk=2048, seed=0):
    """Run the reference and the port on the same draws; (ref, port)."""
    pj = _params_np(s, p)
    params_j = jq.ServerParams(**{k: jnp.asarray(v) for k, v in pj.items()})
    proc_j = _load(kind, s)
    if proc_j.rates.shape[0] != s:        # a trace drives every scenario
        proc_j = dataclasses.replace(
            proc_j, rates=jnp.broadcast_to(proc_j.rates, (s, 1)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # the profile clamp
        chunk = jsim._clamp_chunk_for_profile(proc_j, chunk)
    key = jax.random.PRNGKey(seed)
    ref = jsim.simulate_fork_join_batch(key, proc_j, params_j, n, p=p,
                                        mode=mode, impl="xla",
                                        chunk_size=chunk)
    has_trace = proc_j.trace_gaps is not None
    per_chunk = []
    for c in range(-(-n // chunk)):
        g, b, sv = jsim.chunk_random_draws(key, c, s, chunk, p, params_j,
                                           mode, with_gaps=not has_trace)
        per_chunk.append((None if g is None else np.asarray(g),
                          np.asarray(b), np.asarray(sv)))
    proc_t = interop.arrival_process_from_numpy(
        np.asarray(proc_j.rates), np.asarray(proc_j.bin_seconds),
        None if not has_trace else np.asarray(proc_j.trace_gaps),
        device=CPU, dtype=dtype)
    port = tsim.simulate_fork_join_batch(
        seed, proc_t, interop.server_params_from_numpy(
            pj, device=CPU, dtype=dtype), n, p=p, mode=mode,
        chunk_size=chunk, device=CPU, dtype=dtype,
        draws=interop.draws_from_numpy(per_chunk, device=CPU, dtype=dtype))
    return ref, port


_CASES = [("stationary", "exponential"), ("piecewise", "cache"),
          ("trace", "balanced"), ("flash_crowd", "exponential"),
          ("stationary", "cache"), ("stationary", "balanced")]
_SUMS = ("sum_response", "sumsq_response", "sum_broker", "sum_cluster",
         "sum_server")


@pytest.mark.parametrize("kind,mode", _CASES)
def test_path_equality_float64(x64, kind, mode):
    ref, port = _both(kind, mode, torch.float64)
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    for name in _SUMS:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, err_msg=name)
    np.testing.assert_allclose(port.hist_log_lo.numpy(),
                               np.asarray(ref.hist_log_lo), rtol=1e-12)
    np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))


@pytest.mark.parametrize("kind,mode", _CASES[:4])
def test_path_equality_float32(kind, mode):
    ref, port = _both(kind, mode, torch.float32)
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    for prop in ("mean_response", "std_response", "mean_broker_residence",
                 "mean_cluster_residence", "mean_server_residence"):
        np.testing.assert_allclose(getattr(port, prop).numpy(),
                                   np.asarray(getattr(ref, prop)),
                                   rtol=1e-4, err_msg=prop)
    h_ref = np.asarray(ref.hist)
    moved = np.abs(port.hist.numpy() - h_ref).sum(-1) / 2
    assert np.all(moved <= 0.005 * h_ref.sum(-1)), moved
    for q in (0.5, 0.95):
        np.testing.assert_allclose(port.quantile(q).numpy(),
                                   np.asarray(ref.quantile(q)), rtol=2e-2)


def test_single_scenario_entry_point_matches_batch(x64):
    """simulate_fork_join is the S = 1 batch with 0-dim fields."""
    pr = jcap.TABLE5_PARAMS
    key = jax.random.PRNGKey(3)
    n, chunk = 5000, 1024
    ref = jsim.simulate_fork_join(key, 20.0, n, pr, impl="xla",
                                  chunk_size=chunk)
    vp = jsim._vec_params(pr)
    per_chunk = [tuple(np.asarray(x) for x in jsim.chunk_random_draws(
        key, c, 1, chunk, 8, vp, "exponential")) for c in range(5)]
    port = tsim.simulate_fork_join(
        0, 20.0, n, tcap.TABLE5_PARAMS, chunk_size=chunk, device=CPU,
        dtype=torch.float64,
        draws=interop.draws_from_numpy(per_chunk, device=CPU,
                                       dtype=torch.float64))
    assert port.mean_response.shape == ()
    np.testing.assert_allclose(float(port.mean_response),
                               float(ref.mean_response), rtol=1e-10)
    np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))


@pytest.mark.parametrize("n", [2048, 6144, 10_000])
def test_chunk_count_does_not_move_the_estimate(n):
    """Carry-seeded chunking is exact: the port's own draws scanned in
    chunks equal the same draws scanned monolithically (float64)."""
    params = dataclasses.replace(tcap.TABLE5_PARAMS, p=4)
    chunk, lam, dt = 2048, 18.0, torch.float64
    res = tsim.simulate_fork_join(5, lam, n, params, chunk_size=chunk,
                                  device=CPU, dtype=dt)
    vp = tsim._vec_params(params, torch.device(CPU), dt)
    draws = [tsim.chunk_random_draws(5, c, 1, chunk, 4, vp, "exponential",
                                     device=CPU, dtype=dt)
             for c in range(-(-n // chunk))]
    ug = torch.cat([d[0] for d in draws], -1)[:, :n]
    ub = torch.cat([d[1] for d in draws], -1)[:, :n]
    sv = torch.cat([d[2] for d in draws], -1)[:, :, :n]
    arrivals = torch.cumsum(ug / lam, -1)
    broker = tsim.fcfs_completion_times(arrivals,
                                        ub * params.s_broker)
    comp = tsim.fcfs_completion_times(broker[:, None, :], sv)
    resp = (comp.amax(1) - arrivals)[0, int(n * 0.1):]
    np.testing.assert_allclose(float(res.mean_response),
                               float(resp.mean()), rtol=1e-10)


def test_chunk_size_invariance_with_injected_draws():
    """One draw sequence cut into 1000- or 3000-query chunks: same stats."""
    rng = np.random.default_rng(11)
    n, p, dt = 6000, 4, torch.float64
    ug = rng.exponential(size=(1, n))
    ub = rng.exponential(size=(1, n))
    sv = rng.exponential(size=(1, p, n)) * 0.03
    params = dataclasses.replace(tcap.TABLE5_PARAMS, p=p)
    stats = []
    for chunk in (1000, 3000):
        per_chunk = [(ug[:, i:i + chunk], ub[:, i:i + chunk],
                      sv[:, :, i:i + chunk]) for i in range(0, n, chunk)]
        res = tsim.simulate_fork_join(
            0, 20.0, n, params, chunk_size=chunk, device=CPU, dtype=dt,
            draws=interop.draws_from_numpy(per_chunk, device=CPU, dtype=dt))
        stats.append(res)
    for name in _SUMS:
        np.testing.assert_allclose(float(getattr(stats[0], name)),
                                   float(getattr(stats[1], name)),
                                   rtol=1e-10)
    np.testing.assert_array_equal(stats[0].hist.numpy(),
                                  stats[1].hist.numpy())


def test_fcfs_recurrence_definition():
    rng = np.random.default_rng(0)
    a = np.sort(rng.random(200) * 10)
    s = rng.random(200) * 0.5
    c = tsim.fcfs_completion_times(torch.from_numpy(a), torch.from_numpy(s))
    expect = np.zeros(200)
    prev = 0.0
    for i in range(200):
        prev = max(a[i], prev) + s[i]
        expect[i] = prev
    np.testing.assert_allclose(c.numpy(), expect, rtol=1e-12)


# -- statistical: the port's own RNG ----------------------------------------

MM1 = tq.ServerParams(p=1, s_broker=1e-9, s_hit=1.0, s_miss=1.0,
                      s_disk=0.0, hit=1.0)


def test_fork_join_within_paper_bounds():
    pr = tcap.TABLE5_PARAMS
    res = tsim.simulate_fork_join(1, 28.0, 150_000, pr, device=CPU)
    lo, hi = tq.response_time_bounds(28.0, pr, device=CPU)
    m = float(res.mean_response)
    assert float(lo) < m < float(hi) * 1.02
    assert m > 0.6 * float(hi)


def test_balanced_mode_matches_lower_bound():
    pr = tcap.TABLE5_PARAMS
    res = tsim.simulate_fork_join(2, 20.0, 100_000, pr, mode="balanced",
                                  device=CPU)
    lo, hi = tq.response_time_bounds(20.0, pr, device=CPU)
    assert abs(float(res.mean_response) - float(lo)) < 0.25 * (
        float(hi) - float(lo))


def test_cache_mode_between_bounds():
    pr = tcap.TABLE5_PARAMS
    res = tsim.simulate_fork_join(3, 20.0, 100_000, pr, mode="cache",
                                  device=CPU)
    lo, hi = tq.response_time_bounds(20.0, pr, device=CPU)
    assert float(lo) * 0.95 < float(res.mean_response) < float(hi) * 1.05


@pytest.mark.parametrize("rho", [0.3, 0.6])
def test_mm1_mean_response_matches_theory(rho):
    res = tsim.simulate_fork_join(0, rho, 120_000, MM1, device=CPU)
    expect = 1.0 / (1.0 - rho)
    assert abs(float(res.mean_response) - expect) / expect < 0.06


def test_response_grows_with_p():
    means = []
    for p in (2, 4, 8, 16):
        pr = dataclasses.replace(tcap.TABLE5_PARAMS, p=p)
        res = tsim.simulate_fork_join(4, 15.0, 60_000, pr, device=CPU)
        means.append(float(res.mean_response))
    assert means == sorted(means)


def test_diurnal_process_raises_mean_over_stationary():
    pr = tcap.TABLE5_PARAMS
    proc = TArrival.piecewise([10.0, 30.0], 60.0, device=CPU)
    with pytest.warns(UserWarning, match="clamped"):
        diurnal = tsim.simulate_fork_join(3, proc, 80_000, pr, device=CPU)
    flat = tsim.simulate_fork_join(3, 20.0, 80_000, pr, device=CPU)
    assert float(diurnal.mean_response) > 1.2 * float(flat.mean_response)


def test_trace_replay_matches_stationary_statistics():
    pr = dataclasses.replace(tcap.TABLE5_PARAMS, p=4)
    lam, n = 18.0, 60_000
    gaps = np.random.default_rng(0).exponential(1.0 / lam, n)
    trace = TArrival.from_trace(np.cumsum(gaps), device=CPU)
    res = tsim.simulate_fork_join(4, trace, n, pr, device=CPU)
    lo, hi = tq.response_time_bounds(lam, pr, device=CPU)
    assert float(lo) * 0.95 < float(res.mean_response) < float(hi) * 1.05


def test_trace_shorter_than_horizon_raises():
    trace = TArrival.from_trace(np.arange(100.0), device=CPU)
    with pytest.raises(ValueError, match="trace has"):
        tsim.simulate_fork_join(0, trace, 200, tcap.TABLE5_PARAMS,
                                device=CPU)


def test_mmc_matches_erlang_c_mean():
    lam, s, c = 2.1, 1.0, 3
    analytic = float(tq.mmc_residence_time(lam, s, c, device=CPU))
    rng = np.random.default_rng(12)
    arr = torch.from_numpy(np.cumsum(rng.exponential(1.0 / lam, 100_000)))
    svc = torch.from_numpy(rng.exponential(s, 100_000))
    sim = float(tsim.simulate_mmc(arr, svc, c=c)[10_000:].mean())
    assert abs(sim - analytic) / analytic < 0.06, (sim, analytic)


def test_mmc_equals_reference_on_same_inputs(x64):
    rng = np.random.default_rng(13)
    arr = np.cumsum(rng.exponential(1.0 / 1.5, 3000))
    svc = rng.exponential(1.0, 3000)
    ref = jsim.simulate_mmc(jnp.asarray(arr), jnp.asarray(svc), c=2)
    port = tsim.simulate_mmc(torch.from_numpy(arr), torch.from_numpy(svc),
                             c=2)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-12)


def test_bad_mode_and_impl_raise():
    with pytest.raises(ValueError, match="service mode"):
        tsim.simulate_fork_join(0, 10.0, 100, tcap.TABLE5_PARAMS,
                                mode="nope", device=CPU)
    with pytest.raises(ValueError, match="scan impl"):
        tsim.simulate_fork_join(0, 10.0, 100, tcap.TABLE5_PARAMS,
                                impl="pallas", device=CPU)


def test_port_imports_neither_jax_nor_repro():
    """repro_torch stands alone: no module under it, and no example of the
    port (examples/torch_*.py), imports jax or repro."""
    bad = []
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) >= 3
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
            examples:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, "\n".join(bad)
    assert (ROOT / "chip_smoke.py").exists()
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module or ""])
            assert all(m.split(".")[0] not in ("jax", "jaxlib", "repro")
                       for m in mods), mods
