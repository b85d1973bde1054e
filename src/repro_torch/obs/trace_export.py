"""Span traces: a fork-join sample path as Chrome-trace/Perfetto JSON.

PyTorch port of `repro.obs.trace_export`.  Timelines
(`repro_torch.obs.timeline`) aggregate; span traces *show the queries*.
This module materializes a routed sample path — per query: dispatch,
broker service, each index server's service, the join — and renders it
in the Trace Event Format that chrome://tracing and ui.perfetto.dev load
natively:

  * one *process* per replica (pid = replica index),
  * one *thread* per FCFS queue (tid 0 = broker, tid 1..p = servers),
  * ``ph: "X"`` complete spans for service intervals — FCFS makes them
    disjoint per queue, which :func:`validate_chrome_trace` checks,
  * ``ph: "b"/"e"`` async events spanning each query's whole
    arrival -> join lifetime.

Span export materializes O(n_queries) state by design: it is the
microscope for bounded windows, not the streaming telescope.

Two front doors: :func:`simulate_spans` re-runs the simulator's topology
with full per-query recording (any r / routing; the routing and the
queues run through the port's kernels on the card: the JSQ router and
the segmented (max,+) scan), and :func:`spans_from_trace` renders a
measured single-replica trace record (the plain (max,+) scan) — same
event schema either way.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional, Union

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.queueing import ServerParams, service_time_server
from repro_torch.core.simulator import (
    ROUTING_POLICIES,
    _mix,
    fcfs_completion_times,
    fcfs_completion_times_routed,
)
from repro_torch.kernels.jsq_route import ops as jsq_ops

Tensor = torch.Tensor

__all__ = ["SpanTrace", "simulate_spans", "spans_from_trace",
           "export_chrome_trace", "validate_chrome_trace"]

_US = 1e6                       # trace-event timestamps are microseconds
# the streams of `simulate_spans`, as the reference splits its key four
# ways: arrivals, broker services, server services, random routing
_STREAMS = ("arrival", "broker", "server", "route")


@dataclasses.dataclass(frozen=True)
class SpanTrace:
    """A materialized routed sample path, ready for event rendering
    (numpy arrays on the host).

    arrival/response: (n,) seconds; broker_busy: (n,); server_busy
    (n, p); broker_done: (n,) broker-queue completion; completions:
    (p, n) server-queue completions; assign: (n,) replica per query.
    """

    arrival: np.ndarray
    response: np.ndarray
    broker_busy: np.ndarray
    server_busy: np.ndarray
    broker_done: np.ndarray
    completions: np.ndarray
    assign: np.ndarray
    r: int

    @property
    def n_queries(self) -> int:
        return self.arrival.shape[0]

    @property
    def p(self) -> int:
        return self.server_busy.shape[1]

    def to_events(self) -> list[dict]:
        """Render as Trace Event Format event dicts (microseconds)."""
        events = []
        for k in range(self.r):
            events.append({"ph": "M", "name": "process_name", "pid": k,
                           "tid": 0,
                           "args": {"name": f"replica {k}"}})
            events.append({"ph": "M", "name": "thread_name", "pid": k,
                           "tid": 0, "args": {"name": "broker"}})
            for j in range(self.p):
                events.append({"ph": "M", "name": "thread_name",
                               "pid": k, "tid": 1 + j,
                               "args": {"name": f"server {j}"}})
        arr, resp = self.arrival, self.response
        brk_b, brk_d = self.broker_busy, self.broker_done
        srv_b, comp = self.server_busy, self.completions
        asg = self.assign
        for i in range(self.n_queries):
            pid = int(asg[i])
            events.append({"ph": "b", "cat": "query", "id": i,
                           "name": f"q{i}", "pid": pid, "tid": 0,
                           "ts": float(arr[i]) * _US})
            events.append({"ph": "X", "name": "broker",
                           "cat": "service", "pid": pid, "tid": 0,
                           "ts": float(brk_d[i] - brk_b[i]) * _US,
                           "dur": float(brk_b[i]) * _US,
                           "args": {"query": i}})
            for j in range(self.p):
                events.append({"ph": "X", "name": f"server {j}",
                               "cat": "service", "pid": pid,
                               "tid": 1 + j,
                               "ts": float(comp[j, i]
                                           - srv_b[i, j]) * _US,
                               "dur": float(srv_b[i, j]) * _US,
                               "args": {"query": i}})
            events.append({"ph": "e", "cat": "query", "id": i,
                           "name": f"q{i}", "pid": pid, "tid": 0,
                           "ts": float(arr[i] + resp[i]) * _US})
        return events


def _stream(seed, k: int, device: torch.device) -> torch.Generator:
    """The generator of stream ``k``: its own, hashed from an integer
    seed, or the caller's generator (drawn in stream order)."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(int(seed), k))
    return gen


def simulate_spans(
    seed: Union[int, torch.Generator],
    arrival: Union[ArrivalProcess, float],
    n_queries: int,
    params: ServerParams,
    *,
    r: int = 1,
    routing: str = "round_robin",
    impl: str = "auto",
    draws: Optional[dict] = None,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> SpanTrace:
    """Materialize a routed fork-join sample path for span export.

    Same topology as the streaming engine — a dispatcher routes each
    query to one of ``r`` replicas (``routing`` in "round_robin" |
    "random" | "jsq"), each a broker + p-server fork-join over
    exponential services — but every interval is kept.  Arrival gaps
    come per query from the profile.

    ``seed`` (for the reference's ``key``) is an integer, hashed into one
    generator a stream, or a ``torch.Generator`` on ``device``.
    ``draws`` replaces the random numbers: a dict of ``"arrival"`` (n,)
    and ``"broker"`` (n,) unit exponentials, ``"server"`` (n, p) unit
    exponentials and, for random routing, ``"route"`` (n,) replica
    indices — tests hand over the reference's.
    """
    if routing not in ROUTING_POLICIES:
        raise ValueError(f"unknown routing policy {routing!r}; choose "
                         f"one of {ROUTING_POLICIES}")
    dev = torch.device(device)
    p = int(params.p)
    proc = (arrival.to(dev, dtype) if isinstance(arrival, ArrivalProcess)
            else ArrivalProcess.stationary(float(arrival), device=dev,
                                           dtype=dtype))
    if draws is None:
        def exp(k, shape):
            return torch.empty(shape, dtype=dtype, device=dev).exponential_(
                generator=_stream(seed, k, dev))
        draws = {"arrival": exp(0, (n_queries,)),
                 "broker": exp(1, (n_queries,)),
                 "server": exp(2, (n_queries, p))}
        if r > 1 and routing == "random":
            draws["route"] = torch.randint(
                0, r, (n_queries,), generator=_stream(seed, 3, dev),
                device=dev)
    from repro_torch.calibrate.measure import _sample_arrivals
    d = {k: torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v,
                            device=dev) for k, v in draws.items()}
    arr = _sample_arrivals(d["arrival"].to(dtype), proc)
    brk = d["broker"].to(dtype) * torch.as_tensor(
        params.s_broker, device=dev).to(dtype)
    srv = d["server"].to(dtype) * service_time_server(
        params, device=dev, dtype=dtype).to(dtype)

    if r == 1 or routing == "round_robin":
        asg = torch.arange(n_queries, device=dev) % r
    elif routing == "random":
        asg = d["route"].to(torch.int64)
    else:                                            # jsq
        gaps = torch.diff(arr, prepend=arr[:1] * 0.0)
        asg, _ = jsq_ops.jsq_route(
            torch.zeros((1, r, p), dtype=dtype, device=dev), gaps[None, :],
            srv.T[None].contiguous(),
            torch.ones((1, n_queries), dtype=dtype, device=dev), impl=impl)
        asg = asg[0]

    broker_done, _ = fcfs_completion_times_routed(arr, brk, asg, r,
                                                  impl=impl)
    fork = broker_done[None, :].expand(p, n_queries)
    completions, _ = fcfs_completion_times_routed(
        fork, srv.T, asg[None, :].expand(p, n_queries), r, impl=impl)
    response = torch.amax(completions, dim=0) - arr

    def host(x):
        return x.cpu().numpy()
    return SpanTrace(
        arrival=host(arr), response=host(response), broker_busy=host(brk),
        server_busy=host(srv), broker_done=host(broker_done),
        completions=host(completions),
        assign=host(asg.to(torch.int32)), r=r)


def spans_from_trace(trace, *, impl: str = "auto") -> SpanTrace:
    """Span-render a measured single-replica trace record.

    ``trace`` is a `repro_torch.calibrate.measure.TraceRecord` (fields
    read: ``arrival`` and ``response`` (n,), ``broker_busy`` (n,) and
    ``server_busy`` (n, p)).  The queue completions are the (max,+)
    replay of the busy times on the record's device, so the spans are
    exactly the measured system's reconstruction.
    """
    srv = torch.as_tensor(trace.server_busy)
    dev = srv.device
    arrival = torch.as_tensor(trace.arrival, device=dev)
    arr = arrival - arrival[0]
    brk = torch.as_tensor(trace.broker_busy, device=dev)
    n, p = srv.shape
    broker_done = fcfs_completion_times(arr, brk, impl=impl)
    fork = broker_done[None, :].expand(p, n).contiguous()
    completions = fcfs_completion_times(fork, srv.T.contiguous(), impl=impl)

    def host(x):
        return torch.as_tensor(x).cpu().numpy()
    return SpanTrace(
        arrival=host(arr), response=host(trace.response),
        broker_busy=host(brk), server_busy=host(srv),
        broker_done=host(broker_done), completions=host(completions),
        assign=np.zeros((n,), np.int32), r=1)


def export_chrome_trace(
    spans_or_events: Union[SpanTrace, list],
    path: Union[str, pathlib.Path],
) -> pathlib.Path:
    """Write Trace Event Format JSON loadable by chrome://tracing.

    The JSON object form (``{"traceEvents": [...]}``) with
    ``displayTimeUnit: "ms"`` — Perfetto and Chrome both accept it.
    """
    events = (spans_or_events.to_events()
              if isinstance(spans_or_events, SpanTrace)
              else list(spans_or_events))
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


def validate_chrome_trace(
    source: Union[str, pathlib.Path, dict],
    *,
    check_overlap: bool = True,
) -> dict:
    """Schema-check a Chrome-trace JSON; raise ValueError on violations.

    Checks the Trace Event Format contract this exporter relies on: the
    ``traceEvents`` envelope; per-phase required keys; nonnegative
    durations; balanced ``b``/``e`` async pairs per (cat, id); and —
    because FCFS queues serve one query at a time — that no two ``X``
    spans on the same (pid, tid) lane overlap (``check_overlap``).
    Returns summary counts for dashboards and logs.
    """
    if isinstance(source, (str, pathlib.Path)):
        with open(source) as f:
            obj = json.load(f)
    else:
        obj = source
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")

    counts: dict = {"X": 0, "b": 0, "e": 0, "M": 0}
    lanes: dict = {}
    asyncs: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: not a dict with 'ph'")
        ph = ev["ph"]
        if ph not in counts:
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        counts[ph] += 1
        if "pid" not in ev:
            raise ValueError(f"event {i}: missing 'pid'")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"event {i}: 'ts' must be a number")
        if ph == "X":
            if "name" not in ev:
                raise ValueError(f"event {i}: X span missing 'name'")
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X span needs dur >= 0")
            lanes.setdefault((ev["pid"], ev.get("tid")), []).append(
                (float(ev["ts"]), float(dur)))
        else:                                          # "b" / "e"
            if "id" not in ev or "cat" not in ev:
                raise ValueError(
                    f"event {i}: async {ph!r} needs 'cat' and 'id'")
            asyncs[(ev["cat"], ev["id"])] = \
                asyncs.get((ev["cat"], ev["id"]), 0) + (
                    1 if ph == "b" else -1)
    unbalanced = {k: v for k, v in asyncs.items() if v != 0}
    if unbalanced:
        raise ValueError(f"unbalanced async b/e pairs: "
                         f"{sorted(unbalanced)[:5]}")
    if check_overlap:
        for (pid, tid), spans in lanes.items():
            spans.sort()
            end = -np.inf
            for ts, dur in spans:
                # FCFS lanes are disjoint up to float32 rounding of the
                # absolute clock (ulp grows with ts)
                tol = 0.5 + 4e-7 * abs(ts)
                if ts < end - tol:
                    raise ValueError(
                        f"overlapping X spans on lane pid={pid} "
                        f"tid={tid} at ts={ts}")
                end = max(end, ts + dur)
    counts["lanes"] = len(lanes)
    counts["async_pairs"] = len(asyncs)
    return counts
