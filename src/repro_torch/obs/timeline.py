"""Streaming telemetry timelines for the fork-join simulator.

PyTorch port of `repro.obs.timeline`.  The streaming engine of
`repro_torch.core.simulator` emits end-of-run aggregates only, so a
saturating replica, a JSQ-vs-round-robin gap, or a flash crowd blowing
the SLO all vanish into one mean.  This module adds the time axis back
without giving up the streaming-memory guarantee.

:class:`TelemetrySpec` is an opt-in knob on ``simulate_fork_join(_batch)``
/ ``sweep_simulated``: a frozen, hashable dataclass, and
``telemetry=None`` (the default) runs the pre-telemetry program op for
op.

:class:`Timeline` is what comes back, on ``SimResult.timeline``: per
time-bin counts and busy-seconds accumulated chunk by chunk (O(n_bins)
state, never O(horizon)).  Queries are binned by ARRIVAL time on the
absolute simulation clock; warmup queries are included by design.
Derived views are the operational-analysis quantities, which obey exact
laws the tests self-check:

    utilization  U = busy / bin_width      (and U = X * S, Eq 3)
    queue depth  L = resp_sum / bin_width  (Little: L = lambda * W)

:func:`timeline_from_trace` bins a materialized sample path with the same
conventions.  It duck-types a trace record (tensors or arrays in), so
this module imports nothing of the simulator.  Its per-bin sums are an
ordered reduction (a stable sort by bin, one cumulative sum, differences
at the bin edges): a float ``index_add_`` on the card is atomic and
unordered, and would not give the same bits run to run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor

__all__ = ["TelemetrySpec", "Timeline", "timeline_from_trace",
           "DEFAULT_TIMELINE_BINS", "segment_sums"]

DEFAULT_TIMELINE_BINS = 64


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Static description of the timeline a simulation should record.

    n_bins: time bins over the horizon.  State and output are O(n_bins).
    horizon_seconds: wall-clock span covered by the bins.  Default None
        derives it per scenario as ``n_queries / mean_rate`` (the
        expected makespan); arrivals past the horizon clamp into the
        last bin.
    slo_seconds: response-time objective for the per-bin violation
        count.  None disables the SLO tally (the field stays zero).
    """

    n_bins: int = DEFAULT_TIMELINE_BINS
    horizon_seconds: Optional[float] = None
    slo_seconds: Optional[float] = None

    def __post_init__(self):
        if self.n_bins < 1:
            raise ValueError(f"need at least one bin; got {self.n_bins}")


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Per-time-bin telemetry of a fork-join run (a dataclass of tensors).

    Every field carries the run's scenario shape ``(...)`` in front, then
    the bin axis B; replica-resolved fields add ``r`` (and ``p``).
    Queries land in the bin of their ARRIVAL time; busy-seconds land in
    the bin of the query that generated them (the busy totals equal the
    summed service times).

    bin_seconds:   (...,)          width of one bin
    count:         (..., B)        arrivals per bin (warmup included)
    resp_sum:      (..., B)        summed response seconds per bin
    busy_broker:   (..., B, r)     broker busy-seconds per replica
    busy_server:   (..., B, r, p)  index-server busy-seconds
    replica_count: (..., B, r)     queries routed to each replica
    hit_count:     (..., B)        result-cache hits (zeros, no cache)
    slo_count:     (..., B)        responses above the SLO (zeros if
                                   the spec carried no slo_seconds)
    active_sum:    (..., B)        summed active-replica counts of each
                                   bin's arrivals (autoscaled runs only;
                                   None otherwise)
    up_sum:        (..., B)        summed up-replica counts of each bin's
                                   arrivals (fault-injected runs only)
    spill_sum:     (..., B)        arrivals failed over to a non-primary
                                   replica, per bin (fault + r > 1 only)
    degraded_sum:  (..., B)        partial-quorum (degraded) responses,
                                   per arrival bin (fault + broker
                                   timeout only)
    """

    bin_seconds: Tensor
    count: Tensor
    resp_sum: Tensor
    busy_broker: Tensor
    busy_server: Tensor
    replica_count: Tensor
    hit_count: Tensor
    slo_count: Tensor
    active_sum: Optional[Tensor] = None
    up_sum: Optional[Tensor] = None
    spill_sum: Optional[Tensor] = None
    degraded_sum: Optional[Tensor] = None

    def map(self, fn: Callable[[Tensor], Tensor]) -> "Timeline":
        """A timeline with ``fn`` applied to every field that is set."""
        return Timeline(**{  # staticcheck: disable=RPR005  (copies output)  # staticcheck-torch: disable=RPT005 (copies output)
            f.name: None if getattr(self, f.name) is None
            else fn(getattr(self, f.name))
            for f in dataclasses.fields(self)})

    @property
    def n_bins(self) -> int:
        return self.count.shape[-1]

    @property
    def _n(self) -> Tensor:
        return torch.clamp_min(self.count, 1.0)

    @property
    def throughput(self) -> Tensor:
        """(..., B) arrivals per second — operational X per bin."""
        return self.count / self.bin_seconds[..., None]

    @property
    def utilization(self) -> Tensor:
        """(..., B, r, p) server utilization U = busy / bin width."""
        return self.busy_server / self.bin_seconds[..., None, None, None]

    @property
    def broker_utilization(self) -> Tensor:
        """(..., B, r) broker utilization per replica."""
        return self.busy_broker / self.bin_seconds[..., None, None]

    @property
    def mean_response(self) -> Tensor:
        """(..., B) mean response of the queries arriving in each bin."""
        return self.resp_sum / self._n

    @property
    def queue_depth(self) -> Tensor:
        """(..., B) time-average population by Little's law.

        L = lambda * W = (count / bin) * (resp_sum / count)
          = resp_sum / bin_seconds — response-seconds are
        population-seconds, attributed to the arrival bin.
        """
        return self.resp_sum / self.bin_seconds[..., None]

    @property
    def hit_fraction(self) -> Tensor:
        """(..., B) result-cache hit share of each bin's arrivals."""
        return self.hit_count / self._n

    @property
    def slo_violation_fraction(self) -> Tensor:
        """(..., B) share of each bin's arrivals breaking the SLO."""
        return self.slo_count / self._n

    @property
    def imbalance_share(self) -> Tensor:
        """(..., B) largest single-replica share of each bin's arrivals.

        1/r is perfect balance; 1.0 means one replica took everything.
        """
        return torch.amax(self.replica_count, dim=-1) / self._n

    @property
    def active_replicas(self) -> Tensor:
        """(..., B) mean active replica count over each bin's arrivals
        (autoscaled runs only)."""
        if self.active_sum is None:
            raise ValueError("no active-replica channel: this timeline "
                             "came from a run without autoscale")
        return self.active_sum / self._n

    @property
    def up_replicas(self) -> Tensor:
        """(..., B) mean up-replica count over each bin's arrivals
        (fault-injected runs only)."""
        if self.up_sum is None:
            raise ValueError("no up-replica channel: this timeline came "
                             "from a run without fault injection")
        return self.up_sum / self._n

    @property
    def spill_fraction(self) -> Tensor:
        """(..., B) share of each bin's arrivals failed over to a
        surviving replica (fault-injected runs with r > 1)."""
        if self.spill_sum is None:
            raise ValueError("no spill channel: this timeline came from "
                             "a run without fault injection (or r == 1)")
        return self.spill_sum / self._n

    @property
    def degraded_fraction(self) -> Tensor:
        """(..., B) share of each bin's arrivals answered with a
        partial-quorum (k-of-p) result (runs with a broker timeout)."""
        if self.degraded_sum is None:
            raise ValueError("no degraded channel: this timeline came "
                             "from a run without a broker timeout")
        return self.degraded_sum / self._n

    @property
    def mean_service_per_query(self) -> Tensor:
        """(..., B) busy-seconds per arrival, summed over servers.

        The S in the per-bin operational check U = X * S.
        """
        return (torch.sum(self.busy_server, dim=(-2, -1))
                + torch.sum(self.busy_broker, dim=-1)) / self._n


def segment_sums(w: Tensor, pos: Tensor) -> Tensor:
    """Sums of contiguous runs: ``w`` (..., n) weights in run order,
    ``pos`` (..., k + 1) nondecreasing run edges (broadcasting against
    w's leading axes) -> (..., k) sums of w[pos[j]:pos[j + 1]].

    One cumulative sum and differences at the edges: an ordered
    reduction, the same bits run to run on the card."""
    cs = torch.cumsum(w, dim=-1)
    idx = pos.expand(w.shape[:-1] + pos.shape[-1:])
    take = torch.gather(cs, -1, torch.clamp_min(idx - 1, 0))
    take = torch.where(idx > 0, take, 0.0)      # the empty prefix
    return take[..., 1:] - take[..., :-1]


def timeline_from_trace(
    arrival,
    response,
    spec: TelemetrySpec,
    *,
    broker_busy=None,
    server_busy=None,
    server_hit=None,
    assign=None,
    r: int = 1,
) -> Timeline:
    """Bin a materialized sample path into a :class:`Timeline`.

    arrival/response: (n,) per-query seconds; broker_busy: (n,) broker
    service seconds; server_busy: (n, p) per-server service seconds;
    server_hit: (n,) or (n, p) cache-hit indicator; assign: (n,) replica
    of each query (defaults to replica 0).  Tensors or arrays; the result
    lies on ``response``'s device in its dtype.  Binning conventions match
    the streaming engine: bin by arrival time, clamp past-horizon
    arrivals into the last bin, include everything.  A measured
    `repro_torch.calibrate.measure.TraceRecord` bins through here with
    ``TraceRecord.to_timeline``.
    """
    response = torch.as_tensor(response)
    dtype, device = response.dtype, response.device
    arrival = torch.as_tensor(arrival, device=device)
    n = arrival.shape[0]
    B = spec.n_bins
    horizon = (spec.horizon_seconds if spec.horizon_seconds is not None
               else float(torch.max(arrival)) * (1.0 + 1e-6) + 1e-30)
    bin_w = torch.tensor(horizon / B, dtype=dtype, device=device)
    bins = torch.clamp((arrival / bin_w).to(torch.int32), 0, B - 1)
    asg = (torch.zeros((n,), dtype=torch.int32, device=device)
           if assign is None
           else torch.as_tensor(assign, device=device).to(torch.int32))
    # every (bin, replica) a contiguous run: a stable sort by the key,
    # then run edges by searchsorted
    key = bins.to(torch.int64) * r + asg.to(torch.int64)
    order = torch.argsort(key, stable=True)
    edges = torch.searchsorted(
        key[order], torch.arange(B * r + 1, device=device))

    def sums(w: Tensor) -> Tensor:
        """(n, ...) -> (B, r, ...) per-(bin, replica) sums."""
        w = torch.as_tensor(w, device=device).to(dtype)
        wt = w[order].movedim(0, -1)                    # (..., n)
        out = segment_sums(wt, edges)                  # (..., B r)
        return out.movedim(-1, 0).reshape((B, r) + w.shape[1:])

    one = torch.ones((n,), dtype=dtype, device=device)
    replica_count = sums(one)
    count = replica_count.sum(dim=1)
    resp_sum = sums(response).sum(dim=1)
    busy_broker = (sums(broker_busy) if broker_busy is not None
                   else torch.zeros((B, r), dtype=dtype, device=device))
    busy_server = (sums(server_busy) if server_busy is not None
                   else torch.zeros((B, r, 0), dtype=dtype, device=device))
    if server_hit is not None:
        hit = torch.as_tensor(server_hit, device=device).to(dtype)
        if hit.ndim > 1:            # per-(query, server) -> per-query mean
            hit = torch.mean(hit, dim=-1)
        hit_count = sums(hit).sum(dim=1)
    else:
        hit_count = torch.zeros((B,), dtype=dtype, device=device)
    if spec.slo_seconds is not None:
        slo_count = sums((response > spec.slo_seconds).to(dtype)).sum(dim=1)
    else:
        slo_count = torch.zeros((B,), dtype=dtype, device=device)
    return Timeline(  # staticcheck: disable=RPR005  (the trace binner itself)  # staticcheck-torch: disable=RPT005 (the trace binner itself)
        bin_seconds=bin_w, count=count, resp_sum=resp_sum,
        busy_broker=busy_broker, busy_server=busy_server,
        replica_count=replica_count, hit_count=hit_count,
        slo_count=slo_count)
