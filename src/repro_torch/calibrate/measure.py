"""Measurement harness: every trace the calibration layer consumes.

PyTorch port of `repro.calibrate.measure`.  The paper's model earns its
keep by being *tuned from measurements* (Secs. 4-6): Tables 5-6 come
from instrumented runs, and accuracy is judged predicted-vs-measured.
This module is the instrumented run.  All trace ingestion goes through
one record type:

:class:`TraceRecord` — per-query arrival time, response time, broker busy
time, per-(query, server) busy time and cache hit/miss split, a frozen
dataclass of tensors (`split`, `concat_traces` and the holdout cut map
over its fields).

Three trace sources feed it:

  * :func:`simulate_trace` — a materializing fork-join sample path with
    known ground-truth :class:`ServerParams` (the round-trip test bed).
    Calibration traces are bounded (tens of thousands of queries), so
    materializing is the right trade here.
  * :func:`measure_engine_trace` — the instrumented toy search engine:
    per-shard busy times from the timed scorer
    (`engine.server.measure_busy_trace`) + LRU cache replay, broker busy
    time from the timed top-k merge (`engine.broker.timed_merge_topk`).
    Response times come from replaying the measured busy times against
    the arrival sequence through the (max,+) FCFS recurrence — the
    paper's methodology of measuring service at the servers and deriving
    response from the queueing structure.
  * :func:`trace_from_tap` — the streaming simulator's bounded reservoir
    tap (`SimResult.tap_response`): response-only samples, which support
    alpha/validation fitting (`fit.fit_alpha`) but not the Eq-1 moment
    decomposition.

Both replays go through `core.simulator.fcfs_completion_times`, so on
the card they run the CUDA (max,+) scan.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike, from_host
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.queueing import ServerParams
from repro_torch.core.simulator import (_mix, _unit_exponential,
                                        _unit_uniform, fcfs_completion_times)

Tensor = torch.Tensor

__all__ = [
    "TraceRecord",
    "simulate_trace",
    "measure_engine_trace",
    "trace_from_tap",
    "concat_traces",
    "window_plan",
    "window_stats",
]


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One batch of per-query measurements (the calibration currency).

    arrival:     (n,) absolute arrival timestamps, nondecreasing.
    response:    (n,) end-to-end response times (join - arrival).
    broker_busy: (n,) broker service time actually spent per query.
    server_busy: (n, p) busy time at each index server.
    server_hit:  (n, p) 1.0 where the server answered fully from cache.
    server_disk: (n, p) disk component of the busy time (0 on hits), or
                 None when the instrumentation cannot split CPU from disk
                 (fitting then falls back to moment matching).
    """

    arrival: Tensor
    response: Tensor
    broker_busy: Tensor
    server_busy: Tensor
    server_hit: Tensor
    server_disk: Optional[Tensor] = None

    @property
    def n_queries(self) -> int:
        return self.arrival.shape[0]

    @property
    def p(self) -> int:
        return self.server_busy.shape[1]

    @property
    def observed_rate(self) -> Tensor:
        """Mean arrival rate over the record's span (qps)."""
        span = torch.clamp_min(self.arrival[-1] - self.arrival[0], 1e-9)
        return (self.n_queries - 1) / span

    def map(self, fn: Callable[[Tensor], Tensor]) -> "TraceRecord":
        """``fn`` applied to every field that is not None."""
        return _map_fields(fn, [self])

    def to_timeline(self, spec=None):
        """Bin this trace into a `repro_torch.obs.timeline.Timeline`.

        Measured engines and streaming-simulated ones render on the same
        dashboard (``python -m repro_torch.obs.report``) and obey the same
        per-bin conservation checks.  ``spec`` is a
        :class:`repro_torch.obs.timeline.TelemetrySpec` (default: the
        default bin count over the record's own span).
        """
        from repro_torch.obs.timeline import TelemetrySpec, timeline_from_trace
        if spec is None:
            spec = TelemetrySpec()
        return timeline_from_trace(
            self.arrival - self.arrival[0], self.response, spec,
            broker_busy=self.broker_busy, server_busy=self.server_busy,
            server_hit=self.server_hit)

    def split(self, n_batches: int) -> list["TraceRecord"]:
        """Split into ``n_batches`` contiguous batches (last takes the
        remainder) — fitting is invariant to this chunking."""
        n = self.n_queries
        size = max(1, n // n_batches)
        edges = [i * size for i in range(n_batches)] + [n]
        return [self.map(lambda x: x[lo:hi])
                for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def _map_fields(fn, traces: Sequence[TraceRecord]) -> TraceRecord:
    """A record whose each field is ``fn`` of the traces' fields (None
    where the first trace's field is None)."""
    out = {}
    for f in dataclasses.fields(TraceRecord):
        xs = [getattr(tr, f.name) for tr in traces]
        out[f.name] = None if xs[0] is None else fn(*xs)
    return TraceRecord(**out)


def concat_traces(traces: Sequence[TraceRecord]) -> TraceRecord:
    """Concatenate trace batches along the query axis.

    Only for batches that continue one clock (arrivals stay monotone) —
    e.g. the chunks of a single measurement run.  Independent runs (each
    restarting at t=0) must stay a *list*: every consumer here accepts
    one, and windowing never straddles list entries, so mixed-rate trace
    sets keep their per-run rate structure intact.
    """
    traces = list(traces)
    if len(traces) == 1:
        return traces[0]
    return _map_fields(lambda *xs: torch.cat(xs, dim=0), traces)


def as_trace_list(traces: Union[TraceRecord, Sequence[TraceRecord]]
                  ) -> list[TraceRecord]:
    return [traces] if isinstance(traces, TraceRecord) else list(traces)


def window_plan(
    traces: Union[TraceRecord, Sequence[TraceRecord]],
    n_windows: int,
) -> list[tuple[int, int]]:
    """Per-batch (n_windows, window_size) so windows NEVER straddle
    batches — independent runs restart the clock, and a straddling
    window's interarrival span would be garbage.  Shared by
    :func:`window_stats` and the (max,+) replay residual path so both
    see identical windows."""
    batches = as_trace_list(traces)
    per_batch = max(1, n_windows // len(batches))
    plan = []
    for tr in batches:
        w = max(2, tr.n_queries // per_batch)
        plan.append((tr.n_queries // w, w))
    return plan


def window_stats(
    traces: Union[TraceRecord, Sequence[TraceRecord]],
    n_windows: int,
) -> tuple[Tensor, Tensor, Tensor]:
    """Per-window (observed rate, mean response, query count).

    Windows are equal-count contiguous slices *per trace batch* (see
    :func:`window_plan`).  The observed rate is the within-window
    interarrival-based estimate — the lambda the analytical model is
    asked to reproduce.
    """
    lams, means, counts = [], [], []
    batches = as_trace_list(traces)
    for tr, (k, w) in zip(batches, window_plan(batches, n_windows)):
        if k == 0:
            continue
        arr = tr.arrival[: k * w].reshape(k, w)
        resp = tr.response[: k * w].reshape(k, w)
        span = torch.clamp_min(arr[:, -1] - arr[:, 0], 1e-9)
        lams.append((w - 1) / span)
        means.append(torch.mean(resp, dim=1))
        counts.append(torch.full((k,), float(w), dtype=resp.dtype,
                                 device=resp.device))
    return torch.cat(lams), torch.cat(means), torch.cat(counts)


def _sample_arrivals(u: Tensor, proc: ArrivalProcess) -> Tensor:
    """Arrival timestamps from unit exponentials ``u`` (n,) and a
    single-scenario arrival process.

    Piecewise profiles draw each gap at the rate in force at the previous
    arrival — per-query granularity, finer than the streaming engine's
    rate-per-chunk read, which is what a calibration trace wants (flash
    crowds shorter than a chunk still show up).  That recurrence is
    host-side data generation: one step a query in numpy scalars of
    ``u``'s dtype (each operation rounds as the tensor one would), the
    result moved to ``u``'s device."""
    n = u.shape[0]
    if proc.trace_gaps is not None:
        return torch.cumsum(proc.trace_gaps[:n].to(u), dim=0)
    if proc.rates.ndim != 1:
        raise ValueError("the trace is single-scenario; rates must be 1-D, "
                         f"got {tuple(proc.rates.shape)}")
    if proc.n_bins == 1:
        return torch.cumsum(
            u / torch.clamp_min(proc.rates[0].to(u), 1e-30), dim=0)
    host = proc.to("cpu", u.dtype)
    rates = host.rates.numpy()
    uh = u.cpu().numpy()
    dt = uh.dtype.type
    bin_s = host.bin_seconds.numpy()[()]
    period = host.period_seconds.numpy()[()]
    tiny = dt(1e-30)
    last = proc.n_bins - 1
    t = dt(0.0)
    out = np.empty_like(uh)
    for i in range(n):
        idx = min(max(int(np.floor(np.remainder(t, period) / bin_s)), 0),
                  last)
        t = t + uh[i] / max(rates[idx], tiny)
        out[i] = t
    return torch.from_numpy(out).to(u.device)


# the six streams of `simulate_trace`, as the reference splits its key
_STREAMS = ("arrival", "broker", "hit", "s_hit", "s_miss", "s_disk")


def simulate_trace(
    seed: int,
    arrival: Union[ArrivalProcess, float],
    n_queries: int,
    params: ServerParams,
    *,
    impl: str = "auto",
    warmup_fraction: float = 0.1,
    draws: Optional[dict] = None,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> TraceRecord:
    """Ground-truth fork-join trace from known Eq-1 parameters.

    The service mechanism is the paper's Sec 3.4 "cache" regime — per
    (query, server) Bernoulli(hit) between Exp(s_hit) and
    Exp(s_miss)+Exp(s_disk) — because that is the only regime whose trace
    identifies the full Eq-1 decomposition.  The hit flag and the disk
    component are recorded, so moment fitting can recover every parameter
    (the round-trip test).  The first ``warmup_fraction`` of queries is
    dropped from the record (queue fill-up transient).

    ``seed`` (for the reference's ``key``) seeds one generator a stream,
    ``_mix(seed, k)``.  ``draws`` replaces the random numbers: a dict of
    ``"arrival"`` and ``"broker"`` (n,) unit exponentials, ``"hit"`` (n,
    p) bool, and ``"s_hit"``, ``"s_miss"``, ``"s_disk"`` (n, p) unit
    exponentials (tensors or arrays) — tests hand over the reference's.
    Both FCFS recurrences run through `fcfs_completion_times` (``impl``
    as there: the CUDA scan on the card).
    """
    dev = torch.device(device)
    proc = (arrival.to(dev, dtype) if isinstance(arrival, ArrivalProcess)
            else ArrivalProcess.stationary(float(arrival), device=dev,
                                           dtype=dtype))
    p = int(params.p)
    n = n_queries
    if draws is None:
        shapes = ((n,), (n,), (n, p), (n, p), (n, p), (n, p))
        draws = {k: (_unit_uniform if k == "hit" else _unit_exponential)(
            _mix(seed, i), shape, dev, dtype)
            for i, (k, shape) in enumerate(zip(_STREAMS, shapes))}
        draws["hit"] = draws["hit"] < from_host(params.hit, dev, dtype)
    d = {k: from_host(v, dev, dtype) for k, v in draws.items()}

    def scaled(stream, mean):
        return d[stream] * from_host(mean, dev, dtype)

    arrivals = _sample_arrivals(d["arrival"], proc)
    broker_busy = scaled("broker", params.s_broker)
    is_hit = d["hit"].to(torch.bool)
    server_disk = torch.where(is_hit, 0.0, scaled("s_disk", params.s_disk))
    server_busy = torch.where(is_hit, scaled("s_hit", params.s_hit),
                              scaled("s_miss", params.s_miss)) + server_disk

    broker_done = fcfs_completion_times(arrivals, broker_busy, impl=impl)
    fork = broker_done[None, :].expand(p, n)
    completions = fcfs_completion_times(fork, server_busy.T, impl=impl)
    response = torch.amax(completions, dim=0) - arrivals

    rec = TraceRecord(
        arrival=arrivals, response=response, broker_busy=broker_busy,
        server_busy=server_busy, server_hit=is_hit.to(dtype),
        server_disk=server_disk)
    n_warm = int(n * warmup_fraction)
    return rec.map(lambda x: x[n_warm:])


def measure_engine_trace(
    shards,
    query_terms: np.ndarray,
    arrivals: np.ndarray,
    *,
    cache_bytes: int,
    batch: int = 64,
    warmup_batches: int = 2,
    disk_bw: float = 50e6,
    disk_seek: float = 8e-3,
    k_merge: int = 10,
    impl: str = "auto",
    dtype: torch.dtype = torch.float32,
) -> TraceRecord:
    """Instrumented run of the toy engine -> a calibration trace.

    shards:      list of `repro_torch.engine.server.IndexServer` (one per
                 index partition; the fork-join's p servers), on one
                 device: the trace lies there.
    query_terms: (n, L) padded term ids (`workloadgen.querygen` stream).
    arrivals:    (n,) arrival timestamps (`workloadgen.loadgen`).

    Per shard, `engine.server.measure_busy_trace` times the scorer
    batch-by-batch and replays the LRU disk cache for the hit/miss/disk
    split; `engine.broker.timed_merge_topk` times the join merge.
    Response times are the (max,+) replay of those measured busy times
    over the arrival sequence (measure service, derive response — Sec
    4.3's low-load instrumentation discipline).
    """
    from repro_torch.engine import broker as broker_lib
    from repro_torch.engine import server as server_lib

    n = min(query_terms.shape[0], len(arrivals))
    n = (n // batch) * batch
    if n == 0:
        raise ValueError("need at least one full batch of queries")
    query_terms = np.asarray(query_terms[:n])
    arrivals = np.sort(np.asarray(arrivals[:n], dtype=np.float64))
    dev = shards[0].device

    busy, hit, disk = [], [], []
    partial_s, partial_d = [], []
    for srv in shards:
        b, h, d, scores, docs = server_lib.measure_busy_trace(
            srv, query_terms, cache_bytes, batch=batch,
            warmup_batches=warmup_batches, disk_bw=disk_bw,
            disk_seek=disk_seek)
        busy.append(b)
        hit.append(h)
        disk.append(d)
        partial_s.append(scores)
        partial_d.append(docs)

    # broker: timed top-k merge over the same batches
    ps = torch.as_tensor(np.stack(partial_s), device=dev)   # (p, n, k)
    pd = torch.as_tensor(np.stack(partial_d), device=dev)
    broker_busy = np.zeros(n, dtype=np.float64)
    broker_lib.timed_merge_topk(ps[:, :batch], pd[:, :batch],
                                k=k_merge)                   # warm
    for i in range(0, n, batch):
        (_, _), dt = broker_lib.timed_merge_topk(
            ps[:, i:i + batch], pd[:, i:i + batch], k=k_merge)
        broker_busy[i:i + batch] = dt / batch

    def put(x):
        return from_host(x, dev, dtype)
    arr = put(arrivals)
    brk = put(broker_busy)
    sb = put(np.stack(busy, axis=1))                      # (n, p)
    broker_done = fcfs_completion_times(arr, brk, impl=impl)
    fork = broker_done[None, :].expand(len(shards), n)
    completions = fcfs_completion_times(fork, sb.T, impl=impl)
    response = torch.amax(completions, dim=0) - arr

    return TraceRecord(
        arrival=arr, response=response, broker_busy=brk, server_busy=sb,
        server_hit=put(np.stack(hit, axis=1)),
        server_disk=put(np.stack(disk, axis=1)))


def trace_from_tap(
    tap_response,
    lam,
) -> tuple[Tensor, Tensor]:
    """(lam, mean response) points from reservoir-tap samples.

    ``tap_response`` is `SimResult.tap_response` (one scenario, (k,)) or
    any leading-scenario-shaped stack of taps ((S, k)); ``lam`` the
    matching scenario rates.  NaN padding (scenarios with fewer
    post-warmup queries than the tap) is ignored.  The result feeds
    `fit.fit_alpha` — response-only traces cannot drive the Eq-1 moment
    decomposition.
    """
    tap = torch.as_tensor(tap_response)
    lam = torch.broadcast_to(
        torch.as_tensor(lam, dtype=tap.dtype, device=tap.device),
        tap.shape[:-1])
    return lam, torch.nanmean(tap, dim=-1)
