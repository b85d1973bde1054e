"""Streaming max-plus discrete-event simulator for fork-join search clusters.

PyTorch port of the single-replica engine of `repro.core.simulator`.

FCFS queueing is a linear recurrence in the (max, +) semiring.  With
arrival times A_i (sorted) and service times S_i, the completion time

    C_i = S_i + max(A_i, C_{i-1})  =  max(a_i, C_{i-1} + b_i),
          a_i = A_i + S_i,  b_i = S_i

and the affine maps c -> max(a, c + b) compose associatively, so a whole
sample path is one scan — and FCFS state *streams*: the engine walks
fixed-size query chunks in a Python loop, carrying only the per-(scenario,
server) last completion times plus running statistics (count, sum, sum of
squares and a fixed-bin log histogram of response times for quantiles).
Peak memory is S x p x chunk values whatever the query count.  Each
chunk's queues run through `repro_torch.kernels.maxplus_scan`: the
hand-written CUDA kernel on the card, the plain PyTorch scan on the CPU.

Simulated system (paper Fig 8): broker FCFS queue -> fork to p index-server
FCFS queues -> join (max over servers) -> response = join - arrival.

Service-time generators cover three regimes:

  * "exponential" — iid Exp(S_server) per (query, server);
  * "cache"       — per-(query, server) Bernoulli(hit) mixture of
    Exp(s_hit) vs Exp(s_miss)+Exp(s_disk) (Sec 3.4);
  * "balanced"    — one service time shared by all servers per query.

RNG plan: all randomness for chunk c comes from generators seeded by a
hash of (seed, c) (`chunk_random_draws`), mirroring the reference's
``fold_in(key, c)``, so a monolithic reconstruction from the same
per-chunk draws follows the same sample path.  Torch's Philox and JAX's
threefry never agree draw for draw, so the engine also takes ``draws=``,
a callable
``chunk_idx -> (u_gaps, u_broker, services)``; tests feed the
reference's own draws through it (`repro_torch.interop.draws_from_numpy`).

Not ported yet: replicas (``cluster=``), the result cache, autoscaling,
faults, telemetry and the reservoir tap.
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
from repro_torch.core.queueing import ServerParams, service_time_server
from repro_torch.kernels.maxplus_scan import ops as mp_ops
from repro_torch.kernels.maxplus_scan.ref import maxplus_combine

Tensor = torch.Tensor
Draws = Callable[[int], tuple[Optional[Tensor], Tensor, Tensor]]

__all__ = [
    "maxplus_combine",
    "fcfs_completion_times",
    "ArrivalProcess",
    "SimResult",
    "simulate_fork_join",
    "simulate_fork_join_batch",
    "simulate_mmc",
    "sample_service_times_batch",
    "chunk_random_draws",
    "DEFAULT_CHUNK",
    "DEFAULT_HIST_BINS",
]

DEFAULT_CHUNK = 4096
DEFAULT_HIST_BINS = 256
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
    """
    a = arrivals + services
    b = services
    if carry is None:
        out_a, _ = mp_ops.maxplus_scan(a, b, impl=impl)
    else:
        out_a, _ = mp_ops.maxplus_scan_seeded(a, b, carry, impl=impl)
    return out_a


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
) -> SimResult:
    """The chunked single-replica engine behind every entry point.

    ``proc`` and ``params`` are already on the run's device in its dtype.
    The chunk loop issues device work only: no host sync, no branch on a
    tensor value.
    """
    dtype = proc.rates.dtype
    device = proc.rates.device
    n_scen = proc.rates.shape[0]
    n_chunks = -(-n_queries // chunk)
    n_warm = int(n_queries * warmup_fraction)

    s_broker = params.s_broker.to(dtype).expand(n_scen)

    # Per-scenario histogram scale off the Eq 7 analytic ballpark so the
    # fixed bin budget lands where each scenario's mass actually is.
    ref_rate = proc.mean_rate.to(dtype).expand(n_scen)
    s_mean = service_time_server(params).to(dtype).expand(n_scen)
    _, hi = queueing.response_time_bounds(ref_rate, params)
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

    def zeros(*shape):
        return torch.zeros((n_scen,) + shape, dtype=dtype, device=device)

    # Max-plus maps are translation-invariant, so the carry is REBASED to
    # each chunk's origin: completion state is stored relative to the last
    # arrival, and only the (period-wrapped) absolute clock `t_origin` is
    # kept for profile lookups.  Clock magnitudes stay O(chunk duration),
    # so float32 accuracy does not depend on the simulated horizon.
    t_origin, c_brk, c_srv = zeros(), zeros(), zeros(p)
    count, s_resp, ss_resp = zeros(), zeros(), zeros()
    s_br, s_cl, s_sv = zeros(), zeros(), zeros()
    hist = zeros(hist_bins)

    for c_idx in range(n_chunks):
        u_gaps, u_brk, services = draws(c_idx)
        if gap_chunks is not None:
            gaps = gap_chunks[c_idx][None, :].expand(n_scen, chunk)
        else:
            # the Sec 4.2 structure: homogeneous Poisson within the chunk,
            # at the profile rate read off at the chunk's start time
            rate = torch.clamp_min(proc.rate_at(t_origin), 1e-30)
            gaps = u_gaps / rate[:, None]
        arrivals = torch.cumsum(gaps, dim=-1)   # relative to chunk origin
        last_arrival = arrivals[:, -1]          # the rebase shift
        gidx = col + c_idx * chunk

        broker_done = fcfs_completion_times(
            arrivals, u_brk * s_broker[:, None], impl=impl, carry=c_brk)
        # fork: every server sees the broker's completions as arrivals
        completions = fcfs_completion_times(
            broker_done[:, None, :], services, impl=impl, carry=c_srv)
        join = torch.amax(completions, dim=1)
        server0 = completions[:, 0, :]

        response = join - arrivals
        mf = ((gidx >= n_warm) & (gidx < n_queries)).to(dtype)[None, :]
        count = count + torch.sum(mf, -1).expand(n_scen)
        s_resp = s_resp + torch.sum(response * mf, -1)
        ss_resp = ss_resp + torch.sum(response * response * mf, -1)
        s_br = s_br + torch.sum((broker_done - arrivals) * mf, -1)
        s_cl = s_cl + torch.sum((join - broker_done) * mf, -1)
        s_sv = s_sv + torch.sum((server0 - broker_done) * mf, -1)

        bins = torch.clamp(
            torch.floor((torch.log(torch.clamp_min(response, 1e-30))
                         - hist_log_lo[:, None]) / hist_log_step[:, None]),
            0, hist_bins - 1).to(torch.int64)
        hist = hist.scatter_add(1, bins, mf.expand(n_scen, chunk))

        c_brk = broker_done[:, -1] - last_arrival
        c_srv = completions[:, :, -1] - last_arrival[:, None]
        t_origin = torch.remainder(t_origin + last_arrival, period)

    return SimResult(
        count=count, sum_response=s_resp, sumsq_response=ss_resp,
        sum_broker=s_br, sum_cluster=s_cl, sum_server=s_sv,
        hist=hist, hist_log_lo=hist_log_lo, hist_log_step=hist_log_step)


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
    draws: Optional[Draws] = None,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> SimResult:
    """S fork-join scenarios in one stream; all stats are (S,).

    ``lam`` is an (S,) rate vector or an :class:`ArrivalProcess` with
    (S, n_bins) rates; every ``params`` field is (S,) (or broadcasts).
    All scenarios share the server count ``p``.  The per-chunk (S, p,
    chunk) and (S, chunk) FCFS recurrences flatten onto the rows of one
    kernel launch each.  ``draws`` replaces the port's own RNG plan (see
    the module docstring); it is called with the chunk chosen here, after
    the profile clamp.
    """
    dev = torch.device(device)
    mp_ops.resolve_scan_impl(impl, dev)       # reject a bad impl up front
    proc = _as_batch_process(lam, dev, dtype)
    _check_trace(proc, n_queries)
    chunk = _clamp_chunk_for_profile(
        proc, max(1, min(chunk_size, n_queries)))
    vp = _vec_params(params, dev, dtype)
    if draws is None:
        n_scen, with_gaps = proc.rates.shape[0], proc.trace_gaps is None

        def draws(chunk_idx: int):
            return chunk_random_draws(seed, chunk_idx, n_scen, chunk, p, vp,
                                      mode, with_gaps=with_gaps, device=dev,
                                      dtype=dtype)
    return _simulate_stream(draws, proc, vp, n_queries, p, impl, chunk,
                            warmup_fraction, hist_bins)


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
    draws: Optional[Draws] = None,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> SimResult:
    """Simulate the full broker + p-server fork-join network (Fig 8).

    The broker is visited once per query with service S_broker; its
    completions are the fork times.  Each index server runs an
    independent FCFS queue over the forked stream, and the join waits for
    the slowest server.  ``lam`` is a constant rate in qps or any
    :class:`ArrivalProcess`.  Streams through ``chunk_size`` query chunks;
    warmup queries are discarded from the returned statistics, whose
    fields are 0-dim.
    """
    p = int(params.p) if p is None else p
    res = simulate_fork_join_batch(
        seed, lam, params, n_queries, p=p, mode=mode, impl=impl,
        warmup_fraction=warmup_fraction, chunk_size=chunk_size,
        hist_bins=hist_bins, draws=draws, device=device, dtype=dtype)
    return SimResult(**{f.name: getattr(res, f.name)[0]
                        for f in dataclasses.fields(SimResult)})


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
