"""The simulator's layer spans (`repro_torch.obs.profile.layer_span`).

Off the profiler a dispatch enters no profiler scope at all.  Under a
``torch.profiler`` session (CPU activity) a batch call shows one
``repro_torch.sim.dispatch`` span holding one ``setup`` span and one
``chunk`` span a chunk; the leaf spans open a known number of times a
chunk, nest in their chunk, and hold every top-level ``aten::`` operator
the chunk runs.  The results are bitwise the same with the profiler on
and off.  All at p = 8, 1,024 queries in chunks of 256, on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import simulator as tsim
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.queueing import ServerParams
from repro_torch.launch.elastic import AutoscalePolicy
from repro_torch.obs import profile as obs_profile
from repro_torch.obs.timeline import TelemetrySpec

CPU = "cpu"
P, N_QUERIES, CHUNK, N_SCEN = 8, 1024, 256, 4
N_CHUNKS = N_QUERIES // CHUNK
SEED = 2**31 + 977
PREFIX = "repro_torch.sim."
TOP = {"dispatch", "setup", "chunk"}
PARAMS = ServerParams(p=P, s_broker=0.004, s_hit=0.0125, s_miss=0.05,
                      s_disk=0.04, hit=0.5)

# name -> (cluster, tap_size, telemetry); the per-replica load stays
# near rho 0.5 of the 0.05125 s mean server time
TOPOLOGIES = {
    "r1": (ClusterSpec(), 0, None),
    "r4_jsq_cache": (ClusterSpec(r=4, routing="jsq",
                                 result_cache=(0.2, 0.002)), 0, None),
    "r1_cache_tap_telemetry": (ClusterSpec(result_cache=(0.3, 0.002)), 16,
                               TelemetrySpec(n_bins=8, slo_seconds=0.3)),
    "r4_round_robin_cache": (ClusterSpec(r=4, result_cache=(0.2, 0.002)),
                             0, None),
    "r2_random_masked_cache": (ClusterSpec(r=2, routing="random",
                                           result_cache=(0.2, 0.002),
                                           replica_impl="masked"), 8, None),
    "r3_jsq_faults_telemetry": (ClusterSpec(
        r=3, routing="jsq", fault=FaultSpec(
            outages=((0, 2.0, 6.0),), mtbf_seconds=5.0, mttr_seconds=1.0,
            degraded=((1, 2.0),), broker_timeout_seconds=0.05, quorum_k=6,
            hedge_after_seconds=0.04, hedge_attempts=2)), 8,
        TelemetrySpec(n_bins=8)),
    "r3_autoscale_round_robin": (ClusterSpec(autoscale=AutoscalePolicy(
        min_r=1, max_r=3, target_utilization=0.5,
        decision_interval_seconds=0.3, stabilization_intervals=2)), 0,
        None),
}

# leaf spans a chunk of the benchmark's two topologies
LEAVES_A_CHUNK = {
    "r1": {"draws": 1, "arrivals": 1, "fcfs.broker": 1, "fcfs.servers": 1,
           "join": 1, "stats": 1},
    # arrivals twice (the miss masks in replica order), compact six times
    # (sort and gathers, the cache's services, its carries, the carries
    # at the segment ends, the hit flags, the warm-up mask)
    "r4_jsq_cache": {"draws": 1, "arrivals": 2, "route": 1, "compact": 6,
                     "fcfs.cache": 1, "fcfs.broker": 1, "fcfs.servers": 1,
                     "join": 1, "stats": 2},
}


def _dispatch(name: str) -> tsim.SimResult:
    cluster, tap_size, telemetry = TOPOLOGIES[name]
    r = cluster.engine_r
    lam = torch.linspace(8.0, 12.0, N_SCEN, dtype=torch.float64) * r
    return tsim.simulate_fork_join_batch(
        SEED, lam, PARAMS, N_QUERIES, p=P, chunk_size=CHUNK,
        tap_size=tap_size, cluster=cluster, telemetry=telemetry, device=CPU)


def _profiled(name: str):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _dispatch(name)
    return res, list(prof.events())


def _spans(events, leaf: str):
    return [e for e in events if e.name == PREFIX + leaf]


def _inside(e, outer) -> bool:
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def _program_parent(e):
    """The innermost program span above ``e``, by the profiler's tree."""
    up = e.cpu_parent
    while up is not None and not up.name.startswith(PREFIX):
        up = up.cpu_parent
    return up


def _leaf_names(events) -> set:
    return {e.name[len(PREFIX):] for e in events
            if e.name.startswith(PREFIX)} - TOP


def _fields(res: tsim.SimResult) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif v is not None and dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                if isinstance(w, torch.Tensor):
                    out[f"{f.name}.{g.name}"] = w
    return out


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_no_profiler_enters_no_scope(monkeypatch, name):
    """Off the profiler no span object is ever made."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler scope was entered")

    monkeypatch.setattr(obs_profile, "_RecordFunction", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse,
                        raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert torch.isfinite(_dispatch(name).mean_response).all()


@pytest.mark.parametrize("flags", [torch.autograd.profiler,
                                   types.SimpleNamespace()],
                         ids=["module_flag", "c_query"])
def test_recording_reader_follows_the_profiler(flags):
    """The flag's reader, and its fallback where a torch lacks the
    module flag, are true exactly while a profiler records."""
    recording = obs_profile._reader(flags)
    assert recording() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert recording() is True
    assert recording() is False


def test_layer_span_off_is_one_shared_nullcontext():
    a, b = obs_profile.layer_span("x"), obs_profile.layer_span("y")
    assert a is b and isinstance(a, contextlib.nullcontext)


def test_layer_span_on_is_no_user_annotation():
    """Spans are host operators, not user annotations: the profiler
    mirrors none of them onto the device's timeline."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_profile.layer_span(PREFIX + "probe"):
            torch.ones(4).sum()
    (ev,) = [e for e in prof.events() if e.name == PREFIX + "probe"]
    assert not ev.is_user_annotation
    assert any(e.name == "aten::sum" and _inside(e, ev)
               for e in prof.events())


def test_layer_spans_close_on_error():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            with obs_profile.LayerSpans("t.") as spans:
                for i in spans.chunks(3):
                    spans.open("a")
                    if i == 1:
                        raise RuntimeError("mid-chunk")
                    spans.open("b")
    names = [e.name for e in prof.events()]
    assert names.count("t.chunk") == 2
    assert names.count("t.a") == 2 and names.count("t.b") == 1


@pytest.mark.parametrize("name", sorted(LEAVES_A_CHUNK))
def test_span_counts(name):
    _, events = _profiled(name)
    assert len(_spans(events, "dispatch")) == 1
    assert len(_spans(events, "setup")) == 1
    chunks = _spans(events, "chunk")
    assert len(chunks) == N_CHUNKS
    want = LEAVES_A_CHUNK[name]
    assert _leaf_names(events) == set(want)
    for chunk in chunks:
        got = {leaf: sum(_inside(e, chunk) for e in _spans(events, leaf))
               for leaf in want}
        assert got == want


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_spans_nest_and_cover_the_chunk(name):
    _, events = _profiled(name)
    (dispatch,) = _spans(events, "dispatch")
    (setup,) = _spans(events, "setup")
    chunks = _spans(events, "chunk")
    assert len(chunks) == N_CHUNKS
    assert _inside(setup, dispatch)
    assert setup.time_range.end <= min(c.time_range.start for c in chunks)
    assert all(_inside(c, dispatch) for c in chunks)
    leaves = [e for e in events if e.name.startswith(PREFIX)
              and e.name[len(PREFIX):] not in TOP]
    assert leaves
    for leaf in leaves:
        assert sum(_inside(leaf, c) for c in chunks) == 1, leaf.name
        assert _program_parent(leaf).name == PREFIX + "chunk", leaf.name
    # every top-level aten operator of a chunk sits in a leaf span
    n_ops = 0
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith("aten::"):
            up = up.cpu_parent
        if up is not None or not any(_inside(e, c) for c in chunks):
            continue
        n_ops += 1
        owner = _program_parent(e)
        assert owner is not None and owner.name[len(PREFIX):] not in TOP, \
            (e.name, None if owner is None else owner.name)
    assert n_ops > 10 * N_CHUNKS


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_results_bitwise_with_profiler_on_and_off(name):
    off = _fields(_dispatch(name))
    on, _ = _profiled(name)
    on = _fields(on)
    assert off.keys() == on.keys()
    for key, v in off.items():
        torch.testing.assert_close(on[key], v, rtol=0, atol=0,
                                   equal_nan=True, msg=key)
