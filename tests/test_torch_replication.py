"""The port's replicated cluster held against `repro.core.simulator`.

Path tests feed both engines the SAME random numbers: the reference's
canonical `chunk_random_draws` and its salted side streams (random
routing, result-cache hits and services, tap priorities), each built as
the reference builds it, ``fold_in(fold_in(key, c), SALT)``, and handed to
the port as numpy arrays through `repro_torch.interop.draws_from_numpy`.
In float64 the runs must agree to association-order noise: exact counts,
sums to 1e-10, identical histograms and the same tap sample.  In float32
means are held to 1e-4 and at most 0.5 % of the histogram mass may move.

Port-against-port tests mirror tests/test_replication.py: fused equals
masked, r = 1 and hit_r = 0 are bit-identical to the simpler programs,
the round-robin subsequence reference, and the routing order.
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
from repro.core.arrivals import ArrivalProcess as JArrival
from repro.core.cluster import ClusterSpec as JCluster
from repro_torch import interop
from repro_torch.core import capacity as tcap
from repro_torch.core import queueing as tq
from repro_torch.core import simulator as tsim
from repro_torch.core.cluster import ClusterSpec
from repro_torch.kernels.jsq_route import ops as jsq_ops
from repro_torch.launch.elastic import AutoscalePolicy

CPU = "cpu"
F64 = torch.float64
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


def _params_np(s, p):
    base = jcap.TABLE5_PARAMS
    f = np.linspace(1.0, 1.3, s)
    return dict(p=np.full(s, p), s_broker=base.s_broker * f,
                s_hit=base.s_hit * f, s_miss=base.s_miss * f,
                s_disk=base.s_disk / f, hit=np.full(s, base.hit))


def _reference_draws(key, n_chunks, s, chunk, p, params_j, mode, *, r,
                     routing, cache, tap):
    """The reference's per-chunk draws, side streams included, as numpy."""
    dtype = jnp.result_type(float)
    per_chunk = []
    for c in range(n_chunks):
        g, b, sv = jsim.chunk_random_draws(key, c, s, chunk, p, params_j,
                                           mode)
        kc = jax.random.fold_in(key, c)
        side = {}
        if r > 1 and routing == "random":
            side["route"] = np.asarray(jax.random.randint(
                jax.random.fold_in(kc, jsim._ROUTE_SALT), (s, chunk), 0, r))
        if cache is not None:
            kh, ks = jax.random.split(jax.random.fold_in(kc,
                                                         jsim._CACHE_SALT))
            hit = jnp.full((s, chunk), cache[0], dtype)
            side["cache_hit"] = np.asarray(jax.random.bernoulli(kh, hit))
            side["cache_unit"] = np.asarray(
                jax.random.exponential(ks, (s, chunk)))
        if tap:
            side["tap"] = np.asarray(jax.random.uniform(
                jax.random.fold_in(kc, jsim._TAP_SALT), (s, chunk), dtype))
        per_chunk.append((np.asarray(g), np.asarray(b), np.asarray(sv),
                          side))
    return per_chunk


def _both(routing, r, cache, dtype, *, n=6000, s=2, p=4, chunk=1024,
          mode="cache", tap=32, seed=0):
    """Reference and port on the same draws; (ref, port)."""
    pj = _params_np(s, p)
    params_j = jq.ServerParams(**{k: jnp.asarray(v) for k, v in pj.items()})
    rates = r * np.linspace(16.0, 22.0, s)
    key = jax.random.PRNGKey(seed)
    ref = jsim.simulate_fork_join_batch(
        key, JArrival.stationary(jnp.asarray(rates)), params_j, n, p=p,
        mode=mode, impl="xla", chunk_size=chunk, tap_size=tap,
        cluster=JCluster(r=r, routing=routing, result_cache=cache))
    per_chunk = _reference_draws(key, -(-n // chunk), s, chunk, p, params_j,
                                 mode, r=r, routing=routing, cache=cache,
                                 tap=tap > 0)
    port = tsim.simulate_fork_join_batch(
        seed, torch.tensor(rates, dtype=dtype),
        interop.server_params_from_numpy(pj, device=CPU, dtype=dtype), n,
        p=p, mode=mode, chunk_size=chunk, tap_size=tap,
        cluster=ClusterSpec(r=r, routing=routing, result_cache=cache),
        device=CPU, dtype=dtype,
        draws=interop.draws_from_numpy(per_chunk, device=CPU, dtype=dtype))
    return ref, port


_ROUTES = [("round_robin", 2), ("round_robin", 3), ("random", 3),
           ("jsq", 3)]


@pytest.mark.parametrize("cache", [None, (0.25, 2e-3)])
@pytest.mark.parametrize("routing,r", _ROUTES)
def test_path_equality_float64(x64, routing, r, cache):
    ref, port = _both(routing, r, cache, F64)
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    for name in _SUMS:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, err_msg=name)
    np.testing.assert_allclose(port.hist_log_lo.numpy(),
                               np.asarray(ref.hist_log_lo), rtol=1e-12)
    np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))
    np.testing.assert_allclose(np.sort(port.tap_response.numpy()),
                               np.sort(np.asarray(ref.tap_response)),
                               rtol=1e-10)


@pytest.mark.parametrize("routing,r,cache", [
    ("round_robin", 3, (0.25, 2e-3)), ("random", 3, None),
    ("jsq", 3, (0.25, 2e-3))])
def test_path_equality_float32(routing, r, cache):
    ref, port = _both(routing, r, cache, torch.float32)
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    for prop in ("mean_response", "std_response", "mean_broker_residence",
                 "mean_cluster_residence", "mean_server_residence"):
        np.testing.assert_allclose(getattr(port, prop).numpy(),
                                   np.asarray(getattr(ref, prop)),
                                   rtol=1e-4, err_msg=prop)
    h_ref = np.asarray(ref.hist)
    moved = np.abs(port.hist.numpy() - h_ref).sum(-1) / 2
    assert np.all(moved <= 0.005 * h_ref.sum(-1)), moved


def test_hit0_cache_matches_reference_to_tolerance(x64):
    """hit_r = 0 against the reference on the same draws.  The reference
    is not bitwise its own cache-less run (ROADMAP queue 3), so the port
    is held to it by tolerance; bit identity is asserted port vs port."""
    ref, port = _both("random", 3, (0.0, 1e-3), F64, tap=0)
    for name in _SUMS:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, err_msg=name)
    np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))


def test_routed_fcfs_matches_reference(x64):
    rng = np.random.default_rng(0)
    shape, r = (3, 500), 4
    arr = np.cumsum(rng.exponential(size=shape), -1)
    svc = rng.exponential(size=shape) * 2.0
    asg = rng.integers(0, r, size=shape)
    asg[1] = np.where(asg[1] == 2, 1, asg[1])          # an empty queue
    carry = rng.normal(size=shape[:-1] + (r,)) * 5.0
    ref_done, ref_carry = jsim.fcfs_completion_times_routed(
        jnp.asarray(arr), jnp.asarray(svc), jnp.asarray(asg), r, impl="xla",
        carry=jnp.asarray(carry))
    done, new_carry = tsim.fcfs_completion_times_routed(
        torch.from_numpy(arr), torch.from_numpy(svc), torch.from_numpy(asg),
        r, carry=torch.from_numpy(carry))
    np.testing.assert_allclose(done.numpy(), np.asarray(ref_done),
                               rtol=1e-12)
    np.testing.assert_allclose(new_carry.numpy(), np.asarray(ref_carry),
                               rtol=1e-12)
    assert new_carry[1, 2] == carry[1, 2]      # the empty queue keeps it


@pytest.mark.parametrize("with_hits", [False, True])
def test_jsq_plain_loop_matches_reference(x64, with_hits):
    rng = np.random.default_rng(1)
    s, r, p, n = 3, 4, 5, 300
    w = rng.exponential(size=(s, r, p)) * 0.5
    w[0] = 0.0                                  # idle: ties everywhere
    gaps = rng.exponential(size=(s, n)) * 0.3
    svc = rng.exponential(size=(s, p, n))
    live = ((rng.random((s, n)) > 0.3) if with_hits
            else np.ones((s, n))).astype(np.float64)
    ref_choice, ref_w = jsim._jsq_route(
        jnp.asarray(w), jnp.asarray(gaps), jnp.asarray(svc),
        jnp.asarray(live), r, jnp.float64)
    choice, w_new = jsq_ops.jsq_route(
        torch.from_numpy(w), torch.from_numpy(gaps), torch.from_numpy(svc),
        torch.from_numpy(live))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(ref_choice))
    np.testing.assert_allclose(w_new.numpy(), np.asarray(ref_w), rtol=1e-12)


# -- port against port -------------------------------------------------------

def _own(cluster, *, n=6000, tap=32, lam=50.0, **kw):
    params = dataclasses.replace(tcap.scenario_params(memory=1, p=4,
                                                      device=CPU), p=4)
    kw = dict(dict(p=4, chunk_size=1024, mode="cache"), **kw)
    return tsim.simulate_fork_join(11, lam, n, params, tap_size=tap,
                                   cluster=cluster, device=CPU, dtype=F64,
                                   **kw)


@pytest.mark.parametrize("cache", [None, (0.25, 2e-3)])
@pytest.mark.parametrize("routing,r", _ROUTES)
def test_fused_matches_masked(routing, r, cache):
    fused, masked = (_own(ClusterSpec(r=r, routing=routing,
                                      result_cache=cache, replica_impl=impl))
                     for impl in ("fused", "masked"))
    for name in ("count",) + _SUMS:
        np.testing.assert_allclose(getattr(fused, name).numpy(),
                                   getattr(masked, name).numpy(), rtol=1e-9,
                                   err_msg=name)
    np.testing.assert_array_equal(fused.hist.numpy(), masked.hist.numpy())
    np.testing.assert_allclose(np.sort(fused.tap_response.numpy()),
                               np.sort(masked.tap_response.numpy()),
                               rtol=1e-9)


@pytest.mark.parametrize("routing", ["random", "jsq"])
def test_fused_engine_scans_out_a_only(monkeypatch, routing):
    """The fused engine's segmented scans ask for out_a alone, so on the
    card out_b is neither allocated nor written; the results are those of
    the masked engine, as above."""
    calls = []
    scan = tsim.mp_ops.maxplus_segment_scan

    def spy(*args, **kw):
        calls.append(kw.get("with_b", True))
        return scan(*args, **kw)

    monkeypatch.setattr(tsim.mp_ops, "maxplus_segment_scan", spy)
    cluster = ClusterSpec(r=3, routing=routing, result_cache=(0.25, 2e-3))
    fused = _own(cluster, n=3000)
    assert calls and not any(calls)
    monkeypatch.setattr(tsim.mp_ops, "maxplus_segment_scan", scan)
    masked = _own(dataclasses.replace(cluster, replica_impl="masked"),
                  n=3000)
    for name in ("count",) + _SUMS:
        np.testing.assert_allclose(getattr(fused, name).numpy(),
                                   getattr(masked, name).numpy(), rtol=1e-9,
                                   err_msg=name)


def _assert_bit_identical(a, b):
    for f in dataclasses.fields(tsim.SimResult):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        assert torch.equal(x.nan_to_num(-7.0), y.nan_to_num(-7.0)), f.name


def test_r1_fused_and_masked_bit_identical():
    cache = (0.2, 2e-3)
    a, b = (_own(ClusterSpec(result_cache=cache, replica_impl=impl),
                 n=20_000, chunk_size=2048) for impl in ("fused", "masked"))
    _assert_bit_identical(a, b)


@pytest.mark.parametrize("routing,r", [("round_robin", 1), ("random", 3),
                                       ("jsq", 3)])
def test_hit0_cache_bit_identical_to_no_cache(routing, r):
    """hit_r = 0 runs the cache path but reproduces the cache-less engine
    bit for bit: the cache streams are salted and no hit changes a value."""
    base = _own(ClusterSpec(r=r, routing=routing), n=10_000)
    zero = _own(ClusterSpec(r=r, routing=routing, result_cache=(0.0, 1e-3)),
                n=10_000)
    _assert_bit_identical(base, zero)


def test_round_robin_equals_subsequence_reference():
    """The engine IS per-replica FCFS on the routed subsequences: round-
    robin r = 2 on the port's own draws, sample paths rebuilt replica by
    replica."""
    lam, n, chunk, p, r = 40.0, 20_000, 4096, 8, 2
    params = tcap.TABLE5_PARAMS
    vp = tsim._vec_params(params, torch.device(CPU), F64)
    draws = [tsim.chunk_random_draws(0, c, 1, chunk, p, vp, "exponential",
                                     device=CPU, dtype=F64)
             for c in range(-(-n // chunk))]
    arrivals = torch.cumsum(torch.cat([d[0] for d in draws], -1)[:, :n]
                            / lam, -1)
    s_brk = torch.cat([d[1] for d in draws], -1)[:, :n] * params.s_broker
    sv = torch.cat([d[2] for d in draws], -1)[:, :, :n]
    response = torch.zeros(n, dtype=F64)
    for k in range(r):
        idx = torch.arange(k, n, r)
        brk = tsim.fcfs_completion_times(arrivals[:, idx], s_brk[:, idx])
        comp = tsim.fcfs_completion_times(brk[:, None, :], sv[:, :, idx])
        response[idx] = (comp.amax(1) - arrivals[:, idx])[0]
    ref_mean = float(response[int(n * 0.1):].mean())
    res = tsim.simulate_fork_join(0, lam, n, params, chunk_size=chunk,
                                  cluster=ClusterSpec(r=r), device=CPU,
                                  dtype=F64)
    np.testing.assert_allclose(float(res.mean_response), ref_mean,
                               rtol=1e-9)


def test_routing_ordering_under_imbalanced_service():
    """JSQ <= round-robin <= random in mean response under highly variable
    (cache-mode) service: round-robin's Erlang-r interarrivals beat random
    thinning, and the load-aware JSQ beats both."""
    params = dataclasses.replace(tcap.scenario_params(memory=1, p=4,
                                                      device=CPU), p=4)
    lam = 3 * 0.75 / float(tq.service_time_server(params))
    means = {}
    for routing in tsim.ROUTING_POLICIES:
        res = tsim.simulate_fork_join(5, lam, 60_000, params, p=4,
                                      mode="cache",
                                      cluster=ClusterSpec(r=3,
                                                          routing=routing),
                                      device=CPU)
        means[routing] = float(res.mean_response)
    assert means["jsq"] <= means["round_robin"] * 1.02, means
    assert means["round_robin"] <= means["random"] * 1.02, means
    assert means["jsq"] <= means["random"] * 0.95, means


def test_low_utilization_matches_analytic_prediction():
    """At low per-replica load the r-replica mean sits at the Eq 7 upper
    bound evaluated at lam / r (random routing thins Poisson exactly)."""
    lam, r = 9.0, 3
    _, hi = tq.response_time_bounds(lam / r, tcap.TABLE5_PARAMS, device=CPU)
    res = tsim.simulate_fork_join(2, lam, 120_000, tcap.TABLE5_PARAMS,
                                  cluster=ClusterSpec(r=r, routing="random"),
                                  device=CPU)
    rel = abs(float(res.mean_response) - float(hi)) / float(hi)
    assert rel <= 0.10, (float(res.mean_response), float(hi), rel)


def test_tap_pads_with_nan_when_short():
    """Fewer post-warmup queries than tap slots: the unfilled slots stay
    NaN (warmup responses never enter, even on priority ties at -inf)."""
    res = _own(ClusterSpec(r=3, routing="random"), n=500, tap=600,
               chunk_size=128)
    tap = res.tap_response.numpy()
    n_valid = int(res.count)
    assert n_valid == 450
    assert np.isnan(tap).sum() == 600 - n_valid
    assert np.all(np.isfinite(tap[:n_valid]))


def test_cluster_spec_validation():
    with pytest.raises(ValueError, match="routing"):
        ClusterSpec(routing="nope")
    with pytest.raises(ValueError, match="replica"):
        ClusterSpec(r=0)
    # the reference's refusals of what is not a policy / a FaultSpec, and
    # of a replica count beside a policy (which provisions max_r)
    with pytest.raises(TypeError, match="AutoscalePolicy"):
        ClusterSpec(autoscale=object())
    with pytest.raises(TypeError, match="FaultSpec"):
        ClusterSpec(fault=object())
    with pytest.raises(ValueError, match="leave r at its default"):
        ClusterSpec(r=2, autoscale=AutoscalePolicy(min_r=1, max_r=4))
    assert ClusterSpec(result_cache=(1, 2)).result_cache == (1.0, 2.0)
    with pytest.raises(TypeError, match="ClusterSpec"):
        tsim.simulate_fork_join(0, 10.0, 100, tcap.TABLE5_PARAMS,
                                cluster=JCluster(r=2), device=CPU)


def test_draws_without_a_needed_side_stream_raise():
    rng = np.random.default_rng(2)
    per_chunk = [(rng.exponential(size=(1, 64)), rng.exponential(size=(1, 64)),
                  rng.exponential(size=(1, 4, 64)) * 0.01)]
    with pytest.raises(ValueError, match="route"):
        tsim.simulate_fork_join(
            0, 10.0, 64, dataclasses.replace(tcap.TABLE5_PARAMS, p=4),
            chunk_size=64, cluster=ClusterSpec(r=2, routing="random"),
            device=CPU, draws=interop.draws_from_numpy(per_chunk,
                                                       device=CPU))
