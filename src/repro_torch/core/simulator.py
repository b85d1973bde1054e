"""Streaming max-plus discrete-event simulator for fork-join search clusters.

PyTorch port of `repro.core.simulator`: the single-replica engine, the
replicated cluster (r > 1 routing, the result cache), the reservoir tap,
elastic autoscaling and fault injection.

FCFS queueing is a linear recurrence in the (max, +) semiring.  With
arrival times A_i (sorted) and service times S_i, the completion time

    C_i = S_i + max(A_i, C_{i-1})  =  max(a_i, C_{i-1} + b_i),
          a_i = A_i + S_i,  b_i = S_i

and the affine maps c -> max(a, c + b) compose associatively, so a whole
sample path is one scan — and FCFS state *streams*: the engine walks
fixed-size query chunks in a Python loop, carrying only the per-(scenario,
replica, server) last completion times plus running statistics (count,
sum, sum of squares and a fixed-bin log histogram of response times for
quantiles).  Peak memory is S x p x chunk values whatever the query count
and whatever r.  Each chunk's queues run through
`repro_torch.kernels.maxplus_scan`: the hand-written CUDA kernels on the
card, the plain PyTorch scans on the CPU.

Simulated system (paper Fig 8): broker FCFS queue -> fork to p index-server
FCFS queues -> join (max over servers) -> response = join - arrival.

Replication (paper Sec 6): with ``cluster=ClusterSpec(r > 1, routing=...)``
a dispatcher routes each query to ONE of r identical replicas:

  * "round_robin" — query i goes to replica i mod r (global index);
  * "random"      — iid uniform replica choice (Poisson thinning);
  * "jsq"         — join-shortest-queue on carried per-replica work
    (`repro_torch.kernels.jsq_route`: a CUDA kernel on the card).

The replicated network runs FUSED by default: each chunk is compacted so
every replica's queries are contiguous (a pure reshape for round-robin
when chunk % r == 0; a stable sort otherwise), and ONE segmented (max, +)
scan per queue level covers all r replicas, so per-chunk work is
S x p x chunk elements independent of r.  ``replica_impl="masked"`` keeps
the reference's oracle: every replica re-scans the full stream with
zero-service phantoms for queries routed elsewhere.

An optional result cache (``result_cache=(hit_r, s_cache)``) sends each
query, with probability hit_r, to its replica's broker-cache FCFS queue
with Exp(s_cache) service instead of the index servers (Eq 8).

Elastic autoscaling (``ClusterSpec(autoscale=AutoscalePolicy(...))``)
makes the ACTIVE replica count time-varying: the engine provisions
``max_r`` replicas and the HPA-shaped controller of
`repro_torch.launch.elastic` rides the chunk carry.  Routing targets
active replicas only (round-robin wraps at n_active, random thins over
n_active, JSQ masks the rest out of its argmin); scale-out replicas start
cold and scale-in replicas drain.  The result gains the cost integral
``replica_seconds`` / ``elapsed_seconds``.

Fault injection (``ClusterSpec(fault=FaultSpec(...))``, see
`repro_torch.core.faults`): replica-up masks (outage windows and the
MTBF/MTTR chain) route around down replicas (failover spills to the next
survivor, JSQ masks them out), degraded servers rescale the service
draws, a broker timeout turns the join into a k-of-p order statistic,
and hedged duplicates race the straggling join.  The result gains
``spill_count`` / ``unavail_count`` / ``degraded_count``.  Both features
run their per-query recurrences in one launch a chunk, the fleet scan
(`repro_torch.kernels.fleet_scan`).

Service-time generators cover three regimes:

  * "exponential" — iid Exp(S_server) per (query, server);
  * "cache"       — per-(query, server) Bernoulli(hit) mixture of
    Exp(s_hit) vs Exp(s_miss)+Exp(s_disk) (Sec 3.4);
  * "balanced"    — one service time shared by all servers per query.

RNG plan: all randomness for chunk c comes from generators seeded by a
hash of (seed, c) (`chunk_random_draws`), mirroring the reference's
``fold_in(key, c)``; the side streams (random routing, cache hits and
services, tap priorities) hash a salt on top (`chunk_side_draws`), so
switching a feature on never perturbs the canonical draws.  Torch's
Philox and JAX's threefry never agree draw for draw, so the engine also
takes ``draws=``, a callable ``chunk_idx -> (u_gaps, u_broker, services)``
or, when a side feature is on, ``(u_gaps, u_broker, services, side)``
with ``side`` a dict holding the enabled streams (see
`chunk_side_draws`); tests feed the reference's own draws through it
(`repro_torch.interop.draws_from_numpy`).

Telemetry (``telemetry=TelemetrySpec(...)``, see `repro_torch.obs`)
bins every query by its arrival time on the absolute clock and tallies,
per bin, arrivals, response-seconds, broker and server busy-seconds per
replica, routing counts, cache hits, SLO misses and, under change, the
active, up, spilled and degraded counts; the result gains ``timeline``.
It draws no random numbers, so ``telemetry=None`` runs the program
without it op for op.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike, from_host
from repro_torch.core import queueing
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ROUTING_POLICIES, ClusterSpec
from repro_torch.core.faults import FaultSpec, fault_init
from repro_torch.core.queueing import ServerParams, service_time_server
from repro_torch.kernels.fleet_scan import ops as fleet_ops
from repro_torch.kernels.jsq_route import ops as jsq_ops
from repro_torch.launch.elastic import AutoscalePolicy, autoscale_init
from repro_torch.kernels.maxplus_scan import autodiff as mp_autodiff
from repro_torch.kernels.maxplus_scan import ops as mp_ops
from repro_torch.kernels.maxplus_scan.ref import maxplus_combine
from repro_torch.obs.timeline import TelemetrySpec, Timeline, segment_sums

Tensor = torch.Tensor
Draws = Callable[[int], tuple]

__all__ = [
    "maxplus_combine",
    "fcfs_completion_times",
    "fcfs_completion_times_routed",
    "ArrivalProcess",
    "ClusterSpec",
    "AutoscalePolicy",
    "FaultSpec",
    "TelemetrySpec",
    "Timeline",
    "SimResult",
    "simulate_fork_join",
    "simulate_fork_join_batch",
    "simulate_mmc",
    "sample_service_times_batch",
    "chunk_random_draws",
    "chunk_side_draws",
    "DEFAULT_CHUNK",
    "DEFAULT_HIST_BINS",
    "ROUTING_POLICIES",
]

DEFAULT_CHUNK = 4096
DEFAULT_HIST_BINS = 256
# salts of the side streams, hashed on top of (seed, chunk) so enabling
# the tap, random routing or the result cache never perturbs the
# canonical gap/broker/service draws (the reference's values)
_TAP_SALT = 0x7EE5
_ROUTE_SALT = 0x2077
_CACHE_SALT = 0xCA8E
_FAULT_SALT = 0xFA17
# log-histogram span, in decades around the per-scenario analytic scale
_HIST_DECADES_BELOW = 3.0
_HIST_DECADES_TOTAL = 6.0
_MIN_PROFILE_CHUNK = 64


def fcfs_completion_times(arrivals: Tensor, services: Tensor,
                          impl: str = "auto",
                          carry: Optional[Tensor] = None) -> Tensor:
    """Completion times of an FCFS single-server queue.

    arrivals: (..., n) nondecreasing along the last axis.
    services: (..., n) positive.
    impl: "auto" (the CUDA kernel for CUDA tensors, the plain scan for CPU
    tensors), "cuda" or "torch"; see
    `repro_torch.kernels.maxplus_scan.ops.resolve_scan_impl`.
    carry: optional (...,) completion time of the work *before* this
    block, which is how the streaming engine chains chunks.

    Without a carry the scan has a forward-mode derivative
    (`repro_torch.kernels.maxplus_scan.autodiff`): `torch.func.jvp`
    through this call still runs the kernel ``impl`` picks.
    """
    a = arrivals + services
    b = services
    if carry is None:
        return mp_autodiff.maxplus_scan_a(a, b, impl=impl)
    out_a, _ = mp_ops.maxplus_scan_seeded(a, b, carry, impl=impl,
                                          with_b=False)
    return out_a


def _compact(assign: Tensor, r: int):
    """Stable-sort compaction of routed queries into per-queue segments.

    assign: (..., n) queue indices in [0, r).  Returns ``(order, flags,
    counts, heads, ends)``: the stable sort order (each queue's queries
    become one contiguous run, still in arrival order), the segment-head
    flags of the sorted layout, the (..., r) queue sizes, each queue's
    head position (-1 for an empty queue) and last position (clamped
    at 0).
    """
    order = torch.argsort(assign, dim=-1, stable=True)
    asg_s = torch.gather(assign, -1, order)
    flags = torch.ones(asg_s.shape, dtype=torch.bool, device=asg_s.device)
    flags[..., 1:] = asg_s[..., 1:] != asg_s[..., :-1]
    counts = torch.sum(
        assign[..., None, :] == torch.arange(r, device=assign.device)[:, None],
        dim=-1)
    ends = torch.cumsum(counts, dim=-1)
    heads = torch.where(counts > 0, ends - counts, -1)
    return order, flags, counts, heads, torch.clamp_min(ends - 1, 0)


def _fcfs_segmented(arrivals: Tensor, services: Tensor, flags: Tensor,
                    heads: Tensor, carry: Tensor, impl: str) -> Tensor:
    """FCFS completions of many queues packed as contiguous segments.

    ``flags`` marks each segment's first element and broadcasts against
    the (..., n) queue arrays (one (S, n) layout serves all p server rows
    of a scenario).  ``carry`` (..., r) holds each queue's prior
    completion time, and ``heads`` (broadcasting against it) each queue's
    head position, -1 where the queue is empty.  The carry is
    pre-composed at the heads, as the reference does: seeding a head and
    resetting there is exactly seeding the whole segment.  Only the r
    heads of a row are touched, so no per-element carry array is built.
    Then ONE segmented (max, +) scan computes every queue's sample path.
    """
    a = arrivals + services
    b = services.expand(a.shape)
    idx = torch.clamp_min(heads, 0).expand(carry.shape)
    a_h = torch.gather(a, -1, idx)
    seeded = torch.where(heads >= 0,
                         torch.maximum(a_h, carry + torch.gather(b, -1, idx)),
                         -math.inf)
    # distinct non-empty queues have distinct heads; an empty queue's
    # -inf cannot raise the value it may share a slot with
    a.scatter_reduce_(-1, idx, seeded, reduce="amax", include_self=True)
    out_a, _ = mp_ops.maxplus_segment_scan(a, b, flags, impl=impl,
                                           with_b=False)
    return out_a


def fcfs_completion_times_routed(
    arrivals: Tensor, services: Tensor, assign: Tensor, r: int,
    *, impl: str = "auto", carry: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Completions of r parallel FCFS queues with per-query routing.

    arrivals: (..., n) nondecreasing; services: (..., n) positive;
    assign: (..., n) integers in [0, r) — each query joins the FCFS queue
    of its assigned replica, in arrival order.  carry: optional (..., r)
    completion time of each queue's prior work.

    Fused route-compaction: stable-sort by assignment so each queue is a
    contiguous segment, seed segment heads from the carry, run one
    segmented (max, +) scan, and scatter completions back to arrival
    order.  Returns ``(completions (..., n), new_carry (..., r))`` where
    empty queues keep their old carry.
    """
    if r < 1:
        raise ValueError(f"need at least one queue; got r={r}")
    if carry is None:
        carry = torch.full(assign.shape[:-1] + (r,), -math.inf,
                           dtype=arrivals.dtype, device=arrivals.device)
    order, flags, counts, heads, ends = _compact(assign, r)
    done_s = _fcfs_segmented(torch.gather(arrivals, -1, order),
                             torch.gather(services, -1, order), flags,
                             heads, carry, impl)
    new_carry = torch.where(counts > 0, torch.gather(done_s, -1, ends),
                            carry)
    return torch.empty_like(done_s).scatter_(-1, order, done_s), new_carry


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Streaming summary statistics of a fork-join simulation.

    Every field carries the run's scenario shape in front (0-dim for a
    single-scenario run, ``(S,)`` for batches).  Warmup queries are
    *discarded* from every accumulator.

    Quantiles come from a fixed-bin logarithmic response-time histogram:
    ``hist[..., k]`` counts responses in
    ``[exp(log_lo + k*step), exp(log_lo + (k+1)*step))``; under/overflow
    is clamped into the edge bins.

    ``tap_response`` is a uniform reservoir sample (without replacement)
    of per-query post-warmup response times, ``tap_size`` slots carried
    through the chunk loop; slots not yet filled hold NaN.

    ``replica_seconds`` / ``elapsed_seconds`` are the autoscaler's cost
    integral — active replica-seconds and simulated wall seconds over the
    whole run (warmup included) — None unless the run carried an
    `AutoscalePolicy`.  ``spill_count`` / ``unavail_count`` /
    ``degraded_count`` are the fault channels, None unless the run
    carried a `FaultSpec`: post-warmup queries re-routed off a down
    replica, queries with no surviving replica to route to, and k-of-p
    results cut short by the broker timeout.

    ``timeline`` is the opt-in per-time-bin telemetry of
    `repro_torch.obs.timeline`: None unless the run passed a
    ``TelemetrySpec``.  Unlike every other field it counts warmup
    queries too (transients are what it is for).
    """

    count: Tensor           # post-warmup samples per scenario
    sum_response: Tensor
    sumsq_response: Tensor
    sum_broker: Tensor      # broker residence sum
    sum_cluster: Tensor     # fork-join (max over servers) residence sum
    sum_server: Tensor      # residence at ONE tagged server
    hist: Tensor            # (..., n_bins) response-time histogram counts
    hist_log_lo: Tensor     # (...,) ln(lowest bin edge, seconds)
    hist_log_step: Tensor   # (...,) ln(bin edge ratio)
    tap_response: Tensor    # (..., tap_size) reservoir sample of responses
    timeline: Optional[Timeline] = None       # per-bin telemetry (obs)
    replica_seconds: Optional[Tensor] = None  # integral of active r dt
    elapsed_seconds: Optional[Tensor] = None  # integral of dt (valid)
    spill_count: Optional[Tensor] = None      # failover-spilled queries
    unavail_count: Optional[Tensor] = None    # no surviving replica
    degraded_count: Optional[Tensor] = None   # k-of-p partial results

    def map(self, fn: Callable[[Tensor], Tensor]) -> "SimResult":
        """A result with ``fn`` applied to every field that is set (and
        to every field of the timeline)."""
        def apply(x):
            if x is None:
                return None
            return x.map(fn) if isinstance(x, Timeline) else fn(x)
        return SimResult(**{f.name: apply(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    @property
    def tap_size(self) -> int:
        return self.tap_response.shape[-1]

    @property
    def mean_active_replicas(self) -> Tensor:
        """Time-average active replica count of an autoscaled run."""
        if self.replica_seconds is None:
            raise ValueError("no autoscaler ran: replica_seconds is only "
                             "recorded under ClusterSpec(autoscale=...)")
        return self.replica_seconds / torch.clamp_min(self.elapsed_seconds,
                                                      1e-30)

    def _fault_channel(self, name: str) -> Tensor:
        val = getattr(self, name)
        if val is None:
            raise ValueError(
                f"no faults were injected: {name} is only recorded "
                "under ClusterSpec(fault=FaultSpec(...))")
        return val

    @property
    def availability(self) -> Tensor:
        """Fraction of post-warmup queries that found a live replica."""
        return 1.0 - self._fault_channel("unavail_count") / self._n

    @property
    def spill_fraction(self) -> Tensor:
        """Fraction of queries failed over off a down replica."""
        return self._fault_channel("spill_count") / self._n

    @property
    def degraded_fraction(self) -> Tensor:
        """Fraction of responses returned on a k-of-p partial quorum."""
        return self._fault_channel("degraded_count") / self._n

    @property
    def _n(self) -> Tensor:
        return torch.clamp_min(self.count, 1.0)

    @property
    def mean_response(self) -> Tensor:
        return self.sum_response / self._n

    @property
    def var_response(self) -> Tensor:
        m = self.mean_response
        return torch.clamp_min(self.sumsq_response / self._n - m * m, 0.0)

    @property
    def std_response(self) -> Tensor:
        return torch.sqrt(self.var_response)

    @property
    def mean_broker_residence(self) -> Tensor:
        return self.sum_broker / self._n

    @property
    def mean_cluster_residence(self) -> Tensor:
        return self.sum_cluster / self._n

    @property
    def mean_server_residence(self) -> Tensor:
        return self.sum_server / self._n

    def quantile(self, q: float) -> Tensor:
        """q-quantile of the response time from the streaming histogram.

        Resolution is one log bin (~5.5% at the default 256 bins over 6
        decades); interpolation inside the bin is log-linear.
        """
        n_bins = self.hist.shape[-1]
        cum = torch.cumsum(self.hist, dim=-1)
        target = q * self.count
        k = torch.sum(cum < target[..., None], dim=-1)
        k = torch.clamp(k, 0, n_bins - 1)
        cum_before = torch.where(
            k > 0,
            torch.gather(cum, -1, torch.clamp_min(k - 1, 0)[..., None]
                         )[..., 0],
            0.0)
        in_bin = torch.gather(self.hist, -1, k[..., None])[..., 0]
        frac = torch.clamp((target - cum_before)
                           / torch.clamp_min(in_bin, 1.0), 0.0, 1.0)
        return torch.exp(self.hist_log_lo + (k + frac) * self.hist_log_step)


# -- RNG plan ---------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """SplitMix64 hash of a word sequence: the port's ``fold_in``."""
    h = 0x243F6A8885A308D3
    for w in words:
        h = ((h ^ (w & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h


def _unit_exponential(seed: int, shape, device: torch.device,
                      dtype: torch.dtype) -> Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.empty(shape, device=device, dtype=dtype).exponential_(
        generator=gen)


def _unit_uniform(seed: int, shape, device: torch.device,
                  dtype: torch.dtype) -> Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def sample_service_times_batch(
    seed: int, n_scenarios: int, n_queries: int, p: int,
    params: ServerParams, mode: str, *,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """(n_scenarios, p, n_queries) service times; params fields are (S,).

    Every scenario gets independent randomness but its own means / hit
    ratio.  In "balanced" mode the result is a broadcast view.
    """
    dev = torch.device(device)
    shape = (n_scenarios, p, n_queries)

    def field(x):
        return from_host(x, dev, dtype)[:, None, None]

    s_mean = service_time_server(params, device=dev,
                                 dtype=dtype).to(dtype)[:, None, None]
    if mode == "exponential":
        return _unit_exponential(_mix(seed, 0), shape, dev, dtype) * s_mean
    if mode == "balanced":
        one = _unit_exponential(_mix(seed, 0), (n_scenarios, 1, n_queries),
                                dev, dtype)
        return (one * s_mean).expand(shape)
    if mode == "cache":
        is_hit = _unit_uniform(_mix(seed, 1), shape, dev, dtype) < field(
            params.hit)
        t_hit = (_unit_exponential(_mix(seed, 2), shape, dev, dtype)
                 * field(params.s_hit))
        t_miss = (_unit_exponential(_mix(seed, 3), shape, dev, dtype)
                  * field(params.s_miss)
                  + _unit_exponential(_mix(seed, 4), shape, dev, dtype)
                  * field(params.s_disk))
        return torch.where(is_hit, t_hit, t_miss)
    raise ValueError(f"unknown service mode: {mode}")


def chunk_random_draws(seed: int, chunk_idx: int, n_scen: int, chunk: int,
                       p: int, params: ServerParams, mode: str, *,
                       with_gaps: bool = True,
                       device: DeviceLike = DEFAULT_DEVICE,
                       dtype: torch.dtype = torch.float32):
    """The canonical per-chunk RNG plan, seeded by ``hash(seed, chunk_idx)``.

    Returns (unit-rate gap draws (S, chunk), unit-mean broker draws
    (S, chunk), service times (S, p, chunk)).  ``with_gaps=False`` skips
    the gap draw (trace replay supplies its own gaps); the broker and
    service streams have their own sub-seeds, so they are unchanged.
    """
    dev = torch.device(device)
    kc = _mix(seed, chunk_idx)
    u_gaps = (_unit_exponential(_mix(kc, 0), (n_scen, chunk), dev, dtype)
              if with_gaps else None)
    u_broker = _unit_exponential(_mix(kc, 1), (n_scen, chunk), dev, dtype)
    services = sample_service_times_batch(_mix(kc, 2), n_scen, chunk, p,
                                          params, mode, device=dev,
                                          dtype=dtype)
    return u_gaps, u_broker, services


def chunk_side_draws(seed: int, chunk_idx: int, n_scen: int, chunk: int, *,
                     route_r: Optional[int] = None,
                     route_uniform: bool = False,
                     cache_hit: Optional[Tensor] = None,
                     tap: bool = False,
                     fault_r: Optional[int] = None,
                     hedge: Optional[tuple[int, int]] = None,
                     device: DeviceLike = DEFAULT_DEVICE,
                     dtype: torch.dtype = torch.float32) -> dict:
    """The salted side streams of chunk ``chunk_idx``, each only if asked.

    * ``"route"`` (random routing over ``route_r`` replicas): (S, chunk)
      int64 replica indices;
    * ``"route_u"`` (``route_uniform``: random routing under an
      autoscaler, which thins over the active count): (S, chunk) U(0, 1)
      from the same stream;
    * ``"cache_hit"`` / ``"cache_unit"`` (result cache with (S,) hit
      ratios ``cache_hit``): (S, chunk) bool hits and unit-mean
      exponential cache services;
    * ``"tap"``: (S, chunk) U(0, 1) reservoir priorities;
    * ``"fault_u"`` (an MTBF/MTTR chain over ``fault_r`` replicas):
      (S, chunk, r) U(0, 1);
    * ``"hedge"`` (``hedge=(attempts, p)``): (attempts, S, p, chunk) unit
      exponentials, one fresh fork a hedged attempt.

    Each stream hashes its salt on top of (seed, chunk), mirroring the
    reference's ``fold_in(fold_in(key, c), SALT)``; the fault streams
    hash one more word (0 for the chain, 1 + j for attempt j).
    """
    dev = torch.device(device)
    shape = (n_scen, chunk)
    side = {}
    if route_r is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_mix(seed, chunk_idx, _ROUTE_SALT))
        side["route"] = torch.randint(0, route_r, shape, generator=gen,
                                      device=dev)
    if route_uniform:
        side["route_u"] = _unit_uniform(_mix(seed, chunk_idx, _ROUTE_SALT),
                                        shape, dev, dtype)
    if fault_r is not None:
        side["fault_u"] = _unit_uniform(
            _mix(seed, chunk_idx, _FAULT_SALT, 0), shape + (fault_r,), dev,
            dtype)
    if hedge is not None:
        attempts, p = hedge
        side["hedge"] = torch.stack([
            _unit_exponential(_mix(seed, chunk_idx, _FAULT_SALT, 1 + j),
                              (n_scen, p, chunk), dev, dtype)
            for j in range(attempts)])
    if cache_hit is not None:
        side["cache_hit"] = _unit_uniform(
            _mix(seed, chunk_idx, _CACHE_SALT, 0), shape, dev,
            dtype) < cache_hit[:, None]
        side["cache_unit"] = _unit_exponential(
            _mix(seed, chunk_idx, _CACHE_SALT, 1), shape, dev, dtype)
    if tap:
        side["tap"] = _unit_uniform(_mix(seed, chunk_idx, _TAP_SALT), shape,
                                    dev, dtype)
    return side


# -- engine -----------------------------------------------------------------

def _vec_params(params: ServerParams, device: torch.device,
                dtype: torch.dtype) -> ServerParams:
    """Every field a tensor with a leading scenario axis."""
    return ServerParams(**{
        f.name: torch.atleast_1d(from_host(getattr(params, f.name), device,
                                           dtype))
        for f in dataclasses.fields(ServerParams)})


def _as_batch_process(arrival: Union[ArrivalProcess, Tensor, float],
                      device: torch.device, dtype: torch.dtype
                      ) -> ArrivalProcess:
    """Promote a scalar/vector rate or 1-D process to (S, n_bins) rates."""
    if isinstance(arrival, ArrivalProcess):
        proc = arrival.to(device, dtype)
        if proc.rates.ndim == 1:
            return dataclasses.replace(proc, rates=proc.rates[None, :])
        if proc.rates.ndim != 2:
            raise ValueError("ArrivalProcess rates must be (n_bins,) or "
                             f"(S, n_bins); got {tuple(proc.rates.shape)}")
        return proc
    return ArrivalProcess.stationary(
        torch.atleast_1d(from_host(arrival, device, dtype)), device=device,
        dtype=dtype)


def _check_trace(proc: ArrivalProcess, n_queries: int) -> None:
    if proc.trace_gaps is not None and proc.trace_gaps.shape[0] < n_queries:
        raise ValueError(
            f"trace has {proc.trace_gaps.shape[0]} arrivals but "
            f"n_queries={n_queries}; shorten the horizon or fold/extend "
            "the trace")


def _clamp_chunk_for_profile(proc: ArrivalProcess, chunk: int) -> int:
    """Keep a chunk's expected duration near one profile bin.

    The engine reads the arrival rate once per chunk (at its start time);
    if a chunk spans many profile bins, the diurnal curve is undersampled.
    For multi-bin profiles, cap the chunk at the expected number of
    queries in the *slowest* bin, floored at ``_MIN_PROFILE_CHUNK``, and
    warn.  Stationary and trace-driven processes are exempt.  Runs on
    the host, once, before the chunk loop.
    """
    if proc.trace_gaps is not None or proc.n_bins == 1:
        return chunk
    pos = torch.where(proc.rates > 0, proc.rates, math.inf)
    min_rate = float(torch.amin(pos))
    bin_s = float(proc.bin_seconds)
    if not math.isfinite(min_rate) or min_rate <= 0.0:
        return chunk
    clamped = max(_MIN_PROFILE_CHUNK, int(min_rate * bin_s))
    if clamped < chunk:
        warnings.warn(
            f"chunk_size clamped {chunk} -> {clamped} so each ~"
            f"{bin_s:g}s profile bin is sampled (slowest bin expects "
            f"~{min_rate * bin_s:.0f} queries); more chunks, faithful "
            "diurnal shape", UserWarning, stacklevel=3)
        return clamped
    return chunk


def _routing_assign(routing: str, r: int, gidx: Tensor, n_scen: int,
                    chunk: int, side: dict, n_act: Optional[Tensor] = None,
                    up: Optional[Tensor] = None):
    """(S, chunk) replica assignment of the oblivious policies.

    Returns ``(assign, spill, unavail)``.  Round-robin assigns by GLOBAL
    query index, so the assignment does not depend on the chunking;
    random reads the ``"route"`` side stream.  ``n_act`` (autoscaling,
    (S, chunk)): round-robin wraps the global index at the active count
    and random thins the ``"route_u"`` uniforms over it, so inactive
    replicas receive no new work.  ``up`` (faults, (S, chunk, r)):
    failover spills a query raw-routed to a down replica onto the next
    surviving active replica cyclically (the smallest offset j with
    up[(raw + j) % r]), which keeps round-robin's even split over the
    survivors; ``spill`` marks re-routed queries, ``unavail`` queries
    with no active replica up (they keep their raw assignment).  Both are
    None without ``up``.
    """
    if routing == "round_robin":
        if n_act is not None:
            raw = gidx[None, :].to(torch.int32) % n_act
        else:
            raw = (gidx % r)[None, :].expand(n_scen, chunk)
    elif n_act is not None:
        raw = torch.minimum((side["route_u"] * n_act).to(torch.int32),
                            n_act - 1)
    else:
        raw = side["route"]
    if up is None:
        return raw, None, None
    replicas = torch.arange(r, device=gidx.device)
    ok = up
    if n_act is not None:
        ok = ok & (replicas < n_act[:, :, None])
    cand = (raw[:, :, None] + replicas) % r
    ok_c = torch.gather(ok, -1, cand)                     # (S, chunk, r)
    j = torch.argmax(ok_c.to(torch.uint8), dim=-1)      # first ok offset
    any_ok = ok_c.any(dim=-1)
    assign = torch.where(any_ok, (raw + j) % r, raw)
    return assign, any_ok & (j > 0), ~any_ok


def _simulate_stream(
    draws: Draws,
    proc: ArrivalProcess,
    params: ServerParams,
    n_queries: int,
    p: int,
    impl: str,
    chunk: int,
    warmup_fraction: float,
    hist_bins: int,
    tap_size: int = 0,
    r: int = 1,
    routing: str = "round_robin",
    cache: Optional[tuple[Tensor, Tensor]] = None,
    replica_impl: str = "fused",
    autoscale: Optional[AutoscalePolicy] = None,
    fault: Optional[FaultSpec] = None,
    telemetry: Optional[TelemetrySpec] = None,
) -> SimResult:
    """The chunked engine behind every entry point.

    ``proc`` and ``params`` are already on the run's device in its dtype;
    ``cache`` is the result cache's ((S,) hit ratio, (S,) mean service)
    or None.  At r = 1 without a cache this is the single-replica program
    of the reference, op for op.  r > 1 runs the fused route-compacted
    engine (``replica_impl="fused"``) or the masked re-scan oracle
    ("masked"); both consume the same routing choices and draws, so their
    sample paths agree query for query.

    ``autoscale`` (callers provision r = max_r) and ``fault`` add their
    carries and side streams only when present, so ``None`` runs the
    program without them op for op.  Each sub-feature of a `FaultSpec`
    gates its own ops, so an all-up spec keeps every branch (the fused
    fast path included) of the fault-free program.  ``telemetry`` adds
    its tallies the same way, and draws nothing.  The chunk loop issues
    device work only: no host sync, no branch on a tensor value.
    """
    dtype = proc.rates.dtype
    device = proc.rates.device
    n_scen = proc.rates.shape[0]
    n_chunks = -(-n_queries // chunk)
    n_warm = int(n_queries * warmup_fraction)
    has_cache = cache is not None
    elastic = autoscale is not None
    faulty = fault is not None
    f_outage = faulty and fault.has_outages
    f_quorum = faulty and fault.broker_timeout_seconds is not None
    f_hedge = faulty and fault.hedge_after_seconds is not None

    s_broker = params.s_broker.to(dtype).expand(n_scen)

    # Per-scenario histogram scale off the Eq 7 analytic ballpark so the
    # fixed bin budget lands where each scenario's mass actually is.  The
    # dispatcher splits arrivals over r replicas and the result cache
    # short-circuits hits, so the per-replica operating point is
    # lam * (1 - hit_r) / r (both exact no-ops at r = 1 without a cache).
    ref_rate = proc.mean_rate.to(dtype).expand(n_scen)
    if has_cache:
        cache_hit, cache_service = cache
        ref_rate = ref_rate * (1.0 - cache_hit)
    s_mean = service_time_server(params).to(dtype).expand(n_scen)
    _, hi = queueing.response_time_bounds(ref_rate / r, params)
    hi = hi.to(dtype).expand(n_scen)
    scale = torch.where(torch.isfinite(hi) & (hi > 0), hi, 100.0 * s_mean)
    ln10 = math.log(10.0)
    hist_log_lo = torch.log(scale) - _HIST_DECADES_BELOW * ln10
    hist_log_step = torch.full((n_scen,), _HIST_DECADES_TOTAL * ln10
                               / hist_bins, dtype=dtype, device=device)

    gap_chunks = None
    if proc.trace_gaps is not None:
        pad = n_chunks * chunk - n_queries
        gap_chunks = F.pad(proc.trace_gaps[:n_queries], (0, pad),
                           value=1.0).reshape(n_chunks, chunk)

    col = torch.arange(chunk, device=device)
    period = proc.period_seconds.to(dtype)
    need = set()
    if r > 1 and routing == "random":
        need.add("route_u" if elastic else "route")
    if has_cache:
        need |= {"cache_hit", "cache_unit"}
    if tap_size > 0:
        need.add("tap")
    if faulty and fault.mtbf_seconds is not None:
        need.add("fault_u")
    if f_hedge:
        need.add("hedge")
    factors = None
    if faulty and fault.degraded:
        # degraded servers: one factor a server column, on every replica
        f_host = [1.0] * p
        for srv, f in fault.degraded:
            f_host[srv % p] *= f
        factors = torch.tensor(f_host, dtype=dtype).to(device)[None, :,
                                                               None]

    def zeros(*shape):
        return torch.zeros((n_scen,) + shape, dtype=dtype, device=device)

    # Max-plus maps are translation-invariant, so the carry is REBASED to
    # each chunk's origin: completion state is stored relative to the last
    # arrival, and only the (period-wrapped) absolute clock `t_origin` is
    # kept for profile lookups.  Clock magnitudes stay O(chunk duration),
    # so float32 accuracy does not depend on the simulated horizon.
    # Replicated carries: broker and cache queues (S, r), servers and the
    # JSQ work tracker (S, r, p).
    t_origin = zeros()
    c_brk, c_srv, c_cache, w_jsq = zeros(r), zeros(r, p), zeros(r), \
        zeros(r, p)
    count, s_resp, ss_resp = zeros(), zeros(), zeros()
    s_br, s_cl, s_sv = zeros(), zeros(), zeros()
    hist = zeros(hist_bins)
    tap_pri = torch.full((n_scen, tap_size), -math.inf, dtype=dtype,
                         device=device)
    tap_val = torch.full((n_scen, tap_size), math.nan, dtype=dtype,
                         device=device)
    if elastic:
        as_state = autoscale_init(autoscale, n_scen, dtype, device=device)
        rep_secs, elapsed = zeros(), zeros()
    f_up = None
    if faulty:
        (f_up,) = fault_init(  # staticcheck: disable=RPR007  (the engine drives the recurrence)  # staticcheck-torch: disable=RPT007 (the engine drives it)
            fault, n_scen, r, device=device)
        # the absolute clock of the outage windows (t_origin wraps with
        # the profile's period; outages must not)
        f_tabs = zeros()
        s_spill, s_unav, s_degr = zeros(), zeros(), zeros()
    if telemetry is not None:
        tl_bins = telemetry.n_bins
        if telemetry.horizon_seconds is not None:
            tl_horizon = torch.full((n_scen,), telemetry.horizon_seconds,
                                    dtype=dtype, device=device)
        else:
            tl_horizon = (n_queries / torch.clamp_min(
                proc.mean_rate.to(dtype), 1e-30)).expand(n_scen)
        tl_bin_w = tl_horizon / tl_bins
        tl_edges = tl_bin_w[:, None] * torch.arange(
            tl_bins, dtype=dtype, device=device)[None, :]       # (S, B)
        tl_slo = (math.inf if telemetry.slo_seconds is None
                  else telemetry.slo_seconds)
        tl_keys = torch.arange(tl_bins * r + 1, device=device).expand(
            n_scen, -1).contiguous()             # the run keys' edges
        # the absolute clock the bins read (t_origin wraps with the
        # profile's period; telemetry must not)
        t_abs = zeros()
        # the per-bin channels, stacked (S, k, B), and the busy ones, the
        # broker's then the p servers' per (bin, replica) run
        tl_chan = (["resp", "slo"] + ["hit"] * has_cache + ["act"] * elastic
                   + (["up"] + ["spill"] * (f_outage and r > 1)
                      + ["degr"] * f_quorum if faulty else []))
        tm_count, tm_rc = zeros(tl_bins), zeros(tl_bins, r)
        tm_chan = zeros(len(tl_chan), tl_bins)
        tm_busy = zeros(p + 1, tl_bins * r)

    def quorum_join(completions: Tensor, fork_base: Tensor, dim: int):
        """Fork-join merge: full quorum, or k-of-p past the timeout.

        The broker waits for all p servers until ``fork_base +
        broker_timeout_seconds``; past it, it returns as soon as k
        answers are in (the k-th order statistic of the per-server
        completions).  Returns ``(join, degraded)``; with no timeout
        this is exactly ``amax`` and ``degraded`` is None.
        """
        full = torch.amax(completions, dim=dim)
        if not f_quorum:
            return full, None
        k = fault.quorum(p)
        if k >= p:
            return full, torch.zeros(full.shape, dtype=torch.bool,
                                     device=device)
        t_k = torch.kthvalue(completions, k, dim=dim).values
        deadline = fork_base + fault.broker_timeout_seconds
        late = full > deadline
        return torch.where(late, torch.maximum(t_k, deadline), full), late

    for c_idx in range(n_chunks):
        u_gaps, u_brk, services, *rest = draws(c_idx)
        side = rest[0] if rest else {}
        if not need <= side.keys():
            raise ValueError(f"draws({c_idx}) lacks the side stream(s) "
                             f"{sorted(need - side.keys())}")
        if gap_chunks is not None:
            gaps = gap_chunks[c_idx][None, :].expand(n_scen, chunk)
        else:
            # the Sec 4.2 structure: homogeneous Poisson within the chunk,
            # at the profile rate read off at the chunk's start time
            rate = torch.clamp_min(proc.rate_at(t_origin), 1e-30)
            gaps = u_gaps / rate[:, None]
        arrivals = torch.cumsum(gaps, dim=-1)   # relative to chunk origin
        # the rebase shift; captured BEFORE the fused branches permute
        # `arrivals` into replica-compacted layout
        last_arrival = arrivals[:, -1]
        gidx = col + c_idx * chunk
        if factors is not None:
            # degraded servers rescale the CANONICAL service draws before
            # anything (the autoscaler's demand included) reads them
            services = services * factors

        if has_cache:
            # hits short-circuit at their replica's broker cache: an FCFS
            # queue with Exp(s_cache) service, no index-server work
            is_hit = side["cache_hit"]
            miss_f = 1.0 - is_hit.to(dtype)
            t_cache = (side["cache_unit"] * cache_service[:, None]
                       * is_hit.to(dtype))
        s_broker_c = u_brk * s_broker[:, None]

        up_q = n_act = None
        if elastic or f_outage:
            # the fleet scan, one launch: the replica-up mask at each
            # arrival (outage windows on the absolute clock, the MTBF/MTTR
            # chain on the salted fault stream) and the autoscaler's
            # active count, fed each query's server-seconds of demand
            # (misses only); the padded tail advances neither
            dem = None
            if elastic:
                dem = torch.sum(services, dim=1)
                if has_cache:
                    dem = dem * miss_f
            t_arr = (f_tabs[:, None] + arrivals
                     if f_outage and fault.outages else None)
            up_q, n_act, f_up, as_state = fleet_ops.fleet_scan(
                gaps, n_valid=n_queries - c_idx * chunk, t_arr=t_arr,
                u=side.get("fault_u"), demand=dem, up_state=f_up,
                as_state=as_state if elastic else None,
                fault=fault if f_outage else None, policy=autoscale, p=p,
                r=r, impl=impl)
        if faulty:
            f_tabs = f_tabs + last_arrival
        if elastic:
            # the cost integral the policy sweeps price: active
            # replica-seconds and wall seconds (warmup included)
            gaps_v = gaps * (gidx < n_queries).to(dtype)[None, :]
            rep_secs = rep_secs + torch.sum(n_act.to(dtype) * gaps_v, -1)
            elapsed = elapsed + torch.sum(gaps_v, -1)

        if telemetry is not None:
            # chunk-order captures BEFORE the branches below permute or
            # rescale anything: arrival offsets and each query's
            # EFFECTIVE demand (cache hits never reach broker or servers)
            tm_arr = arrivals
            tm_svc = services * miss_f[:, None, :] if has_cache else services
            tm_brk = s_broker_c * miss_f if has_cache else s_broker_c
            tm_hit_c = is_hit.to(dtype) if has_cache else None
            tm_gidx = gidx

        degr = None
        spill_q = unav_q = None
        # `perm` maps chunk-order (S, chunk) arrays into the layout the
        # fused branches compute in (replica-compacted); None = identity.
        # The statistics are permutation-invariant, so the epilogue only
        # needs mf, the tap priorities and is_hit permuted likewise.
        perm = None
        if r == 1:
            if has_cache:
                s_broker_c = s_broker_c * miss_f
                services = services * miss_f[:, None, :]
                cache_done = fcfs_completion_times(
                    arrivals, t_cache, impl=impl, carry=c_cache[:, 0])
                c_cache_new = cache_done[:, -1:]
            broker_done = fcfs_completion_times(arrivals, s_broker_c,
                                                impl=impl, carry=c_brk[:, 0])
            # fork: every server sees the broker's completions as arrivals
            completions = fcfs_completion_times(
                broker_done[:, None, :], services, impl=impl,
                carry=c_srv[:, 0])
            join, degr = quorum_join(completions, broker_done, 1)
            server0 = completions[:, 0, :]
            c_brk_new = broker_done[:, -1:]
            c_srv_new = completions[:, None, :, -1]
            w_jsq_new = w_jsq
        else:
            live = miss_f if has_cache else torch.ones_like(gaps)
            w_jsq_new = w_jsq
            up_route = up_q if f_outage else None
            if routing == "jsq":   # needs the carried work state
                routed = jsq_ops.jsq_route(w_jsq, gaps, services, live,
                                           n_act=n_act, up=up_route,
                                           impl=impl)
                assign, w_jsq_new = routed[:2]
                if up_route is not None:
                    spill_q, unav_q = routed[2:]
            else:
                assign, spill_q, unav_q = _routing_assign(
                    routing, r, gidx, n_scen, chunk, side, n_act=n_act,
                    up=up_route)

        if r == 1:
            pass
        elif replica_impl == "masked":
            # Reference oracle: every replica scans the FULL stream;
            # phantom (zero-service) entries cannot delay later real
            # queries.  ~r x redundant work.
            mask = (assign[:, None, :] == torch.arange(
                r, device=device)[None, :, None]).to(dtype)
            # hits occupy their replica's cache queue; only misses enter
            # its broker + index servers
            mask_srv = mask * miss_f[:, None, :] if has_cache else mask
            arr_r = arrivals[:, None, :].expand(n_scen, r, chunk)
            if has_cache:
                cache_done_r = fcfs_completion_times(
                    arr_r, t_cache[:, None, :] * mask, impl=impl,
                    carry=c_cache)
                cache_done = torch.sum(cache_done_r * mask, dim=1)
                c_cache_new = cache_done_r[:, :, -1]
            broker_done_r = fcfs_completion_times(
                arr_r, s_broker_c[:, None, :] * mask_srv, impl=impl,
                carry=c_brk)
            completions = fcfs_completion_times(
                broker_done_r[:, :, None, :],
                services[:, None, :, :] * mask_srv[:, :, None, :],
                impl=impl, carry=c_srv)
            join_r, degr_r = quorum_join(completions, broker_done_r, 2)
            # read each query off its OWN replica's sample path
            broker_done = torch.sum(broker_done_r * mask_srv, dim=1)
            join = torch.sum(join_r * mask_srv, dim=1)
            if f_quorum:
                degr = torch.sum(degr_r.to(dtype) * mask_srv, dim=1) > 0.0
            server0 = torch.sum(completions[:, :, 0, :] * mask_srv, dim=1)
            c_brk_new = broker_done_r[:, :, -1]
            c_srv_new = completions[:, :, :, -1]
        elif (routing == "round_robin" and chunk % r == 0
              and not elastic and not f_outage):
            # Fused fast path: with chunk % r == 0 the round-robin
            # assignment is col % r every chunk, so compaction into
            # per-replica contiguous runs is a pure reshape (no sort) and
            # the plain scan covers the (S, r, ...) queues.  (Autoscaled
            # round-robin wraps at the time-varying active count, and
            # failover spills break the col % r pattern: both take the
            # general path below.)
            ct = chunk // r

            def to_rep(x):                       # (S, chunk) -> (S, r, ct)
                return x.reshape(n_scen, ct, r).transpose(-1, -2)

            def perm(x):
                return to_rep(x.expand(n_scen, chunk)).reshape(n_scen, chunk)

            arr_q = to_rep(arrivals)
            svc_q = services.reshape(n_scen, p, ct, r).permute(0, 3, 1, 2)
            brk_q = to_rep(s_broker_c)
            if has_cache:
                miss_q = to_rep(miss_f)
                brk_q = brk_q * miss_q
                svc_q = svc_q * miss_q[:, :, None, :]
                cache_done_q = fcfs_completion_times(
                    arr_q, to_rep(t_cache), impl=impl, carry=c_cache)
                cache_done = cache_done_q.reshape(n_scen, chunk)
                c_cache_new = cache_done_q[..., -1]
            broker_done_q = fcfs_completion_times(arr_q, brk_q, impl=impl,
                                                  carry=c_brk)
            completions = fcfs_completion_times(
                broker_done_q[:, :, None, :], svc_q, impl=impl, carry=c_srv)
            broker_done = broker_done_q.reshape(n_scen, chunk)
            join_q, degr_q = quorum_join(completions, broker_done_q, 2)
            join = join_q.reshape(n_scen, chunk)
            if f_quorum:
                degr = degr_q.reshape(n_scen, chunk)
            server0 = completions[:, :, 0, :].reshape(n_scen, chunk)
            c_brk_new = broker_done_q[..., -1]
            c_srv_new = completions[..., -1]
            arrivals = arr_q.reshape(n_scen, chunk)
        else:
            # Fused general path (random, jsq, uneven, autoscaled or
            # failed-over round-robin): stable-sort by replica so each
            # replica's queries form a contiguous segment (still in arrival
            # order), seed segment heads from the carries, and run ONE
            # segmented (max, +) scan per queue level.  Gathers index with
            # expanded views, so no (S, p, chunk) index tensor exists.
            order, flags, counts, heads, ends = _compact(assign, r)

            def perm(x):
                return torch.gather(x.expand(n_scen, chunk), -1, order)

            arrivals = perm(arrivals)
            svc_s = torch.gather(services, -1,
                                 order[:, None, :].expand(n_scen, p, chunk))
            brk_s = perm(s_broker_c)
            if has_cache:
                miss_s = perm(miss_f)
                brk_s = brk_s * miss_s
                svc_s = svc_s * miss_s[:, None, :]
                cache_done = _fcfs_segmented(arrivals, perm(t_cache), flags,
                                             heads, c_cache, impl)
                c_cache_new = torch.where(
                    counts > 0, torch.gather(cache_done, -1, ends), c_cache)
            broker_done = _fcfs_segmented(arrivals, brk_s, flags, heads,
                                          c_brk, impl)
            completions = _fcfs_segmented(
                broker_done[:, None, :], svc_s, flags[:, None, :],
                heads[:, None, :], c_srv.transpose(1, 2), impl)
            join, degr = quorum_join(completions, broker_done, 1)
            server0 = completions[:, 0, :]
            c_brk_new = torch.where(
                counts > 0, torch.gather(broker_done, -1, ends), c_brk)
            srv_ends = torch.gather(completions, -1, ends[:, None, :].expand(
                n_scen, p, r))                           # (S, p, r)
            c_srv_new = torch.where(counts[:, :, None] > 0,
                                    srv_ends.transpose(1, 2), c_srv)

        if f_hedge:
            # Hedged retries: each attempt races the (possibly partial-
            # quorum) join with a duplicate fork fired a backoff delay
            # after the broker fork, served off-queue by spare capacity
            # with fresh draws from the salted fault stream.  A response
            # the hedge wins is a full-quorum result: it clears the
            # degraded flag.
            cand = None
            for h_j, h_delay in enumerate(fault.hedge_delays()):
                dup = torch.amax(side["hedge"][h_j], dim=1) * s_mean[:, None]
                if perm is not None:
                    dup = perm(dup)
                c = broker_done + h_delay + dup
                cand = c if cand is None else torch.minimum(cand, c)
            if degr is not None:
                degr = degr & (join <= cand)
            join = torch.minimum(join, cand)

        if has_cache:
            if perm is not None:
                is_hit = perm(is_hit)
            if degr is not None:
                degr = degr & ~is_hit   # hits never fork: always whole
            resp_cache = cache_done - arrivals
            response = torch.where(is_hit, resp_cache, join - arrivals)
            broker_res = torch.where(is_hit, resp_cache,
                                     broker_done - arrivals)
            cluster_res = torch.where(is_hit, 0.0, join - broker_done)
            server_res = torch.where(is_hit, 0.0, server0 - broker_done)
        else:
            response = join - arrivals
            broker_res = broker_done - arrivals
            cluster_res = join - broker_done
            server_res = server0 - broker_done
            c_cache_new = c_cache
        mf = ((gidx >= n_warm) & (gidx < n_queries)).to(dtype)[None, :]
        mf0 = mf                 # chunk order, for the chunk-order flags
        if perm is not None:
            mf = perm(mf)
        count = count + torch.sum(mf, -1).expand(n_scen)
        s_resp = s_resp + torch.sum(response * mf, -1)
        ss_resp = ss_resp + torch.sum(response * response * mf, -1)
        s_br = s_br + torch.sum(broker_res * mf, -1)
        s_cl = s_cl + torch.sum(cluster_res * mf, -1)
        s_sv = s_sv + torch.sum(server_res * mf, -1)
        if faulty:
            # spill / unavail are in chunk (arrival) order, the degraded
            # flag in the engine's layout; the sums do not care
            if f_outage and r > 1:
                s_spill = s_spill + torch.sum(spill_q.to(dtype) * mf0, -1)
                s_unav = s_unav + torch.sum(unav_q.to(dtype) * mf0, -1)
            elif f_outage:       # r == 1: down means nowhere to route
                s_unav = s_unav + torch.sum(
                    (1.0 - up_q[:, :, 0].to(dtype)) * mf0, -1)
            if degr is not None:
                s_degr = s_degr + torch.sum(degr.to(dtype) * mf, -1)

        bins = torch.clamp(
            torch.floor((torch.log(torch.clamp_min(response, 1e-30))
                         - hist_log_lo[:, None]) / hist_log_step[:, None]),
            0, hist_bins - 1).to(torch.int64)
        hist = hist.scatter_add(1, bins, mf.expand(n_scen, chunk))

        if tap_size > 0:
            # Reservoir via random priorities (A-Res with equal weights):
            # every valid query gets an iid U(0,1) priority and the tap
            # keeps the tap_size largest seen so far.  A stable descending
            # sort keeps the LOWER index on ties, as the reference's
            # top_k does: the -inf of masked queries never displaces an
            # unfilled (NaN) slot.
            pri = side["tap"]
            if perm is not None:
                pri = perm(pri)
            pri = torch.where(mf > 0, pri, -math.inf)
            cat_pri = torch.cat([tap_pri, pri], dim=-1)
            cat_val = torch.cat([tap_val, response.expand(n_scen, chunk)],
                                dim=-1)
            top = torch.sort(cat_pri, dim=-1, descending=True, stable=True)
            tap_pri = top.values[:, :tap_size]
            tap_val = torch.gather(cat_val, -1, top.indices[:, :tap_size])

        if telemetry is not None:
            # Timeline tallies (no random numbers).  Bin by arrival time
            # on the absolute clock, warmup included, the padded tail
            # excluded.  Arrivals are nondecreasing within a chunk, so a
            # bin is a contiguous run of the chunk; with r > 1 a stable
            # sort by (bin, replica) makes every (bin, replica) pair one
            # run.  A channel's per-run sums are differences of one
            # cumulative sum read at the run edges: an ordered reduction
            # over (S, [p,] chunk), so the busy tally of the servers
            # never builds the (S, r, p, chunk) product of the
            # replica mask and the services.
            t_arr = t_abs[:, None] + tm_arr                # (S, chunk)
            t_bin = torch.clamp_min(torch.searchsorted(
                tl_edges, t_arr, right=True) - 1, 0)
            key = t_bin if r == 1 else t_bin * r + assign
            # the padded tail (gidx >= n_queries) past every run
            key = torch.where(tm_gidx < n_queries, key, tl_bins * r)
            if r == 1:
                tl_order = None                  # already sorted
                key_s = key
            else:
                key_s, tl_order = torch.sort(key, dim=-1, stable=True)
            pos = torch.searchsorted(key_s, tl_keys)          # (S, Br+1)
            # the sort only permutes within a bin, so a bin's run has the
            # same edges in chunk order: per-bin channels need no gather
            pos_bin = pos[:, ::r]                               # (S, B+1)

            tm_count = tm_count + (pos_bin[:, 1:]
                                   - pos_bin[:, :-1]).to(dtype)
            tm_rc = tm_rc + (pos[:, 1:] - pos[:, :-1]).to(dtype).view(
                n_scen, tl_bins, r)
            busy = torch.cat([tm_brk.expand(n_scen, chunk)[:, None],
                              tm_svc.expand(n_scen, p, chunk)], 1)
            if tl_order is not None:
                busy = torch.gather(busy, -1, tl_order[:, None].expand(
                    busy.shape))
            tm_busy = tm_busy + segment_sums(busy, pos[:, None])
            del busy            # S x p x chunk: not into the next chunk
            # response-side channels live in the engine's layout: bring
            # them back to chunk order through the inverse permutation
            if perm is not None:
                src = perm(col[None, :])
                resp_c = torch.empty_like(response.expand(n_scen, chunk)
                                          ).scatter_(-1, src, response)
            else:
                resp_c = response
            chans = [resp_c, (resp_c > tl_slo).to(dtype)]
            if has_cache:
                chans.append(tm_hit_c)
            if elastic:
                chans.append(n_act.to(dtype))
            if faulty:
                # the up count and spills are in chunk order; the
                # degraded flag rides the same inverse as the responses
                chans.append(torch.sum(up_q.to(dtype), dim=-1) if f_outage
                             else torch.full((n_scen, chunk), float(r),
                                             dtype=dtype, device=device))
                if f_outage and r > 1:
                    chans.append(spill_q.to(dtype))
                if f_quorum:
                    dg = degr.to(dtype).expand(n_scen, chunk)
                    if perm is not None:
                        dg = torch.empty_like(dg).scatter_(-1, src, dg)
                    chans.append(dg)
            tm_chan = tm_chan + segment_sums(
                torch.stack([c.expand(n_scen, chunk) for c in chans], 1),
                pos_bin[:, None])
            t_abs = t_abs + last_arrival

        shift = last_arrival
        c_brk = c_brk_new - shift[:, None]
        c_srv = c_srv_new - shift[:, None, None]
        c_cache = c_cache_new - shift[:, None] if has_cache else c_cache_new
        if elastic or f_outage:
            # An inactive (or failed) replica receives no work, so its
            # rebased carry would drift toward -inf chunk after chunk.
            # Clamping at the chunk origin is EXACT (seeding max(a, c + b)
            # is unchanged for any c <= the segment head's arrival, and
            # arrivals are positive) and pins a drained replica at 0, the
            # cold state a scale-out (or repaired) replica starts from.
            c_brk = torch.clamp_min(c_brk, 0.0)
            c_srv = torch.clamp_min(c_srv, 0.0)
            if has_cache:
                c_cache = torch.clamp_min(c_cache, 0.0)
        w_jsq = w_jsq_new
        t_origin = torch.remainder(t_origin + shift, period)

    extra = {}
    if elastic:
        extra.update(replica_seconds=rep_secs, elapsed_seconds=elapsed)
    if faulty:
        extra.update(spill_count=s_spill, unavail_count=s_unav,
                     degraded_count=s_degr)
    if telemetry is not None:
        ch = {k: v.contiguous() for k, v in zip(tl_chan, tm_chan.unbind(1))}
        busy = tm_busy.view(n_scen, p + 1, tl_bins, r)
        extra["timeline"] = Timeline(  # staticcheck: disable=RPR005  (the engine's own output)  # staticcheck-torch: disable=RPT005 (the engine's own output)
            bin_seconds=tl_bin_w, count=tm_count, resp_sum=ch["resp"],
            busy_broker=busy[:, 0].contiguous(),
            busy_server=busy[:, 1:].permute(0, 2, 3, 1).contiguous(),
            replica_count=tm_rc, hit_count=ch.get("hit", zeros(tl_bins)),
            slo_count=ch["slo"], active_sum=ch.get("act"),
            up_sum=ch.get("up"),
            spill_sum=ch.get("spill", zeros(tl_bins) if faulty else None),
            degraded_sum=ch.get("degr", zeros(tl_bins) if faulty else None))
    return SimResult(
        count=count, sum_response=s_resp, sumsq_response=ss_resp,
        sum_broker=s_br, sum_cluster=s_cl, sum_server=s_sv,
        hist=hist, hist_log_lo=hist_log_lo, hist_log_step=hist_log_step,
        tap_response=tap_val, **extra)


def simulate_fork_join_batch(
    seed: int,
    lam: Union[Tensor, ArrivalProcess],
    params: ServerParams,
    n_queries: int,
    *,
    p: int,
    mode: str = "exponential",
    impl: str = "auto",
    warmup_fraction: float = 0.1,
    chunk_size: int = DEFAULT_CHUNK,
    hist_bins: int = DEFAULT_HIST_BINS,
    tap_size: int = 0,
    cluster: Optional[ClusterSpec] = None,
    telemetry: Optional[TelemetrySpec] = None,
    draws: Optional[Draws] = None,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> SimResult:
    """S fork-join scenarios in one stream; all stats are (S,).

    ``lam`` is an (S,) rate vector or an :class:`ArrivalProcess` with
    (S, n_bins) rates; every ``params`` field is (S,) (or broadcasts).
    All scenarios share the server count ``p`` and the topology
    ``cluster=ClusterSpec(...)`` (None: one replica, no cache; an
    autoscale policy provisions its ``max_r``).  The
    per-chunk FCFS recurrences flatten onto the rows of one kernel launch
    per queue level.  ``tap_size > 0`` carries a reservoir sample of
    responses.  ``draws`` replaces the port's own RNG plan (see the
    module docstring); it is called with the chunk chosen here, after
    the profile clamp.  ``telemetry=TelemetrySpec(...)`` streams the
    per-time-bin `repro_torch.obs.timeline.Timeline` onto the result
    (None, the default, is the program without it).

    Peak memory of the fused replicated engine is S x p x chunk values,
    independent of ``n_queries`` and of r; the carries grow with r, at
    S x r x p values.  The "masked" oracle needs S x r x p x chunk.
    """
    spec = ClusterSpec() if cluster is None else cluster
    if not isinstance(spec, ClusterSpec):
        raise TypeError("cluster must be a repro_torch ClusterSpec; got "
                        f"{type(spec).__name__}")
    dev = torch.device(device)
    mp_ops.resolve_scan_impl(impl, dev)       # reject a bad impl up front
    proc = _as_batch_process(lam, dev, dtype)
    _check_trace(proc, n_queries)
    chunk = _clamp_chunk_for_profile(
        proc, max(1, min(chunk_size, n_queries)))
    vp = _vec_params(params, dev, dtype)
    n_scen = proc.rates.shape[0]
    r = spec.engine_r
    cache = None
    if spec.result_cache is not None:
        cache = tuple(torch.full((n_scen,), v, dtype=dtype, device=dev)
                      for v in spec.result_cache)
    if draws is None:
        with_gaps = proc.trace_gaps is None
        random = r > 1 and spec.routing == "random"
        elastic = spec.autoscale is not None
        fault = spec.fault
        side_kw = dict(
            route_r=r if random and not elastic else None,
            route_uniform=random and elastic,
            cache_hit=None if cache is None else cache[0],
            tap=tap_size > 0,
            fault_r=(r if fault is not None
                     and fault.mtbf_seconds is not None else None),
            hedge=((int(fault.hedge_attempts), p) if fault is not None
                   and fault.hedge_after_seconds is not None else None))

        def draws(chunk_idx: int):
            base = chunk_random_draws(seed, chunk_idx, n_scen, chunk, p, vp,
                                      mode, with_gaps=with_gaps, device=dev,
                                      dtype=dtype)
            side = chunk_side_draws(seed, chunk_idx, n_scen, chunk,
                                    device=dev, dtype=dtype, **side_kw)
            return (*base, side) if side else base
    return _simulate_stream(draws, proc, vp, n_queries, p, impl, chunk,
                            warmup_fraction, hist_bins, tap_size, r=r,
                            routing=spec.routing, cache=cache,
                            replica_impl=spec.replica_impl,
                            autoscale=spec.autoscale, fault=spec.fault,
                            telemetry=telemetry)


def simulate_fork_join(
    seed: int,
    lam: Union[float, ArrivalProcess],
    n_queries: int,
    params: ServerParams,
    *,
    p: Optional[int] = None,
    mode: str = "exponential",
    impl: str = "auto",
    warmup_fraction: float = 0.1,
    chunk_size: int = DEFAULT_CHUNK,
    hist_bins: int = DEFAULT_HIST_BINS,
    tap_size: int = 0,
    cluster: Optional[ClusterSpec] = None,
    telemetry: Optional[TelemetrySpec] = None,
    draws: Optional[Draws] = None,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> SimResult:
    """Simulate the full broker + p-server fork-join network (Fig 8).

    The broker is visited once per query with service S_broker; its
    completions are the fork times.  Each index server runs an
    independent FCFS queue over the forked stream, and the join waits for
    the slowest server.  ``lam`` is the TOTAL rate in qps or any
    :class:`ArrivalProcess`.  ``cluster=ClusterSpec(r=..., routing=...,
    result_cache=..., replica_impl=..., autoscale=..., fault=...)`` sets
    the topology: r replicas behind a dispatcher, the Eq 8 result cache
    at each replica's broker, an autoscaler (the result gains
    ``replica_seconds`` / ``elapsed_seconds``) and injected faults (the
    result gains ``spill_count`` / ``unavail_count`` /
    ``degraded_count``).  ``telemetry=TelemetrySpec(...)`` adds the
    per-time-bin ``timeline``.  Streams through ``chunk_size`` query
    chunks; warmup queries are discarded from the returned statistics,
    whose fields are 0-dim (``tap_response`` is (tap_size,)).
    """
    p = int(params.p) if p is None else p
    res = simulate_fork_join_batch(
        seed, lam, params, n_queries, p=p, mode=mode, impl=impl,
        warmup_fraction=warmup_fraction, chunk_size=chunk_size,
        hist_bins=hist_bins, tap_size=tap_size, cluster=cluster,
        telemetry=telemetry, draws=draws, device=device, dtype=dtype)
    return res.map(lambda x: x[0])


def simulate_mmc(arrivals: Tensor, services: Tensor, c: int) -> Tensor:
    """M/M/c FCFS via the Kiefer-Wolfowitz workload-vector recursion.

    State w = sorted vector of the c servers' remaining work at an arrival.
    On arrival i: start delay = w[0]; after assigning service S_i to the
    least-loaded server and advancing time by the next interarrival gap:

        w' = sort( (w + S_i e_1) - gap )_+

    Runs on the inputs' device, one step per query (a sequential
    recursion; not on the simulator's main path).  Returns response
    times (delay + own service).
    """
    gaps = torch.diff(arrivals, prepend=arrivals[:1] * 0.0)
    w = torch.zeros(c, dtype=services.dtype, device=services.device)
    resp = torch.empty_like(services)
    for i in range(services.shape[0]):
        w = torch.clamp_min(w - gaps[i], 0.0)   # advance to this arrival
        resp[i] = w[0] + services[i]
        w = torch.sort(torch.cat([w[:1] + services[i], w[1:]])).values
    return resp
