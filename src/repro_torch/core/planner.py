"""Capacity planning for model serving — the paper's methodology applied
to an LM serving cell.

A port of the serving half of `repro.core.planner`.  The paper's
pipeline is: measure a single server -> parameterize Eq 1 -> predict
cluster response time under Poisson load -> size replication (Section 6).
Here the single-server measurement is a serving step's roofline terms
(compute, memory, collective seconds), from counted FLOPs and bytes or a
measured step, which become S_server in the same fork-join queueing
model; replicas of the serving cell take the role of cluster replicas.

The default hardware is `H100_SXM`.  The serving entry points take
``device=`` for the queueing arithmetic (default ``cuda``);
`plan_over_grid`, the Section 6 what-if analysis over a whole
`repro_torch.core.sweep.SweepGrid`, runs on the grid's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch._tensor import DeviceLike
from repro_torch.core import capacity, queueing, sweep

__all__ = ["HardwareSpec", "H100_SXM", "RooflineTerms",
           "terms_from_analysis", "ServingModel", "serving_params",
           "ServingPlan", "plan_serving", "plan_over_grid"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip hardware constants.  Field names are the reference's:
    ``ici_bandwidth`` is the chip-to-chip link, ``vmem_bytes`` the fast
    on-chip memory."""

    name: str
    peak_flops: float        # FLOP/s per chip
    hbm_bandwidth: float     # bytes/s per chip
    ici_bandwidth: float     # bytes/s per link
    vmem_bytes: float = 128 * 2**20
    hbm_bytes: float = 16 * 2**30


# NVIDIA H100 SXM, data sheet, SXM, 700 W: dense bf16 tensor-core rate,
# HBM3 bandwidth, NVLink 4 at 900 GB/s total (450 GB/s each way), 50 MB L2
# as the fast on-chip memory, 80 GB of HBM
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bandwidth=3.35e12,
    ici_bandwidth=450e9,
    vmem_bytes=50e6,
    hbm_bytes=80e9,
)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds (already divided by chips)."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap bound: all three engines run concurrently."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_time_serial_bound(self) -> float:
        """No-overlap (conservative, capacity-planning) bound."""
        return self.compute_s + self.memory_s + self.collective_s


def terms_from_analysis(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    n_chips: int,
    hw: HardwareSpec = H100_SXM,
) -> RooflineTerms:
    """Aggregate step counters -> per-cell roofline terms.  The keyword
    names are the reference's (its counters come from compiled HLO); here
    they are any FLOP and byte counts of one step."""
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * hw.peak_flops),
        memory_s=hlo_bytes / (n_chips * hw.hbm_bandwidth),
        collective_s=collective_bytes / (n_chips * hw.ici_bandwidth),
    )


@dataclasses.dataclass(frozen=True)
class ServingModel:
    """A serving cell: one model replica sharded over n_chips."""

    name: str
    terms: RooflineTerms
    n_chips: int
    batch_per_step: int      # requests retired per step
    dispatch_overhead_s: float = 50e-6   # broker analogue


def serving_params(model: ServingModel, *,
                   overlap_fraction: float = 0.0,
                   straggler_jitter: float = 0.0,
                   device: DeviceLike = None) -> queueing.ServerParams:
    """Map a serving cell onto Eq 1 parameters.

    The step is a synchronous pipeline over n_chips — its chip-level
    fork-join is already serialized inside the step time, so the
    queueing-level server is the CELL (p=1).  Eq 1's decomposition maps
    onto overlap: the "hit" path is a perfectly overlapped step (all three
    engines concurrent), the "miss" path is the serial bound, with
    ``overlap_fraction`` playing the disk-cache hit ratio.  Stochastic
    per-chip jitter (the paper's imbalance) enters as an H_p-scaled
    inflation of the collective (join) term via ``straggler_jitter`` in
    [0, 1]: 0 = deterministic chips, 1 = fully exponential shard times.
    """
    t = model.terms
    jitter_tax = 1.0 + straggler_jitter * (
        float(queueing.harmonic_number(model.n_chips, device=device)) - 1.0)
    return queueing.ServerParams(
        p=1,
        s_broker=model.dispatch_overhead_s,
        s_hit=t.step_time_lower_bound,
        s_miss=t.compute_s + t.memory_s,
        s_disk=t.collective_s * jitter_tax,
        hit=overlap_fraction,
    )


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    model: str
    cells: int
    chips: int
    per_cell_rate: float
    response_upper_ms: float
    utilization: float
    bound: str


def plan_serving(
    model: ServingModel,
    target_rate_per_s: float,
    slo_seconds: float,
    *,
    result_cache: Optional[tuple[float, float]] = None,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> ServingPlan:
    """Section-6 case study for a model serving fleet.

    target_rate is in *requests*/s; a step retires batch_per_step requests,
    so the step arrival rate is rate / batch_per_step (continuous-batching
    approximation).
    """
    params = serving_params(model, device=device)
    step_rate_slo = capacity.max_rate_under_slo(
        params, slo_seconds, result_cache=result_cache, device=device,
        dtype=dtype)
    per_cell_req_rate = float(step_rate_slo) * model.batch_per_step
    if per_cell_req_rate <= 1e-6:
        # SLO below the single-step service time: no fleet size helps —
        # the latency floor is a property of the cell, not of replication
        # (the paper's baseline scenario: infeasible "even at very low
        # query arrival rates").
        return ServingPlan(
            model=model.name, cells=0, chips=0, per_cell_rate=0.0,
            response_upper_ms=float("inf"), utilization=0.0,
            bound=model.terms.bound)
    cells = max(1, math.ceil(target_rate_per_s / per_cell_req_rate))
    rate = target_rate_per_s / cells / model.batch_per_step
    if result_cache is None:
        _, hi = queueing.response_time_bounds(rate, params, device=device,
                                              dtype=dtype)
    else:
        hi = queueing.response_time_with_result_cache(
            rate, params, *result_cache, device=device, dtype=dtype)
    util = queueing.utilization(
        rate, queueing.service_time_server(params, device=device,
                                           dtype=dtype),
        device=device, dtype=dtype)
    return ServingPlan(
        model=model.name,
        cells=cells,
        chips=cells * model.n_chips,
        per_cell_rate=per_cell_req_rate,
        response_upper_ms=float(hi) * 1e3,
        utilization=float(util),
        bound=model.terms.bound,
    )


def plan_over_grid(
    grid: sweep.SweepGrid,
    slo_seconds: float,
    *,
    cost_fn: Optional[Callable] = None,
    simulate: bool = False,
    seed: Optional[int] = None,
    quantile: Optional[float] = None,
    n_queries: Optional[int] = None,
    profile=None,
    profile_bin_seconds: float = 3600.0,
    mesh=None,
    **sim_kwargs,
):
    """Section-6 what-if analysis over a whole configuration grid at once.

    Default: evaluates the analytical (Eq 7 upper bound) response surface
    for every (lambda, p, cpu, disk, hit, r) combination and extracts
    the constraint-satisfying frontier: per arrival rate, the cheapest
    configuration with R_upper <= SLO.  Returns ``(surface result,
    frontier)`` so callers can plot Figs 9-12 style curves from the same
    evaluation.

      * ``simulate=True`` — replace the analytic surface with the
        streaming-simulated one (`sweep.sweep_simulated`, seeded by
        ``seed``, default 0); ``n_queries`` (default 20,000) and any
        extra ``sim_kwargs`` (mode, impl, chunk_size, hist_bins,
        cluster, draws, dtype) pass through.
      * ``quantile=0.95`` — plan against tail latency instead of the
        mean/upper surface (both paths).
      * ``profile=`` a relative-rate curve (e.g. ``loadgen.diurnal_rates``)
        with ``profile_bin_seconds`` — makes every simulated scenario's
        load time-varying, so "the cheapest config whose p95 survives the
        daily peak" is ``simulate=True, quantile=0.95, profile=...``.

    Replication rides the grid itself (``SweepGrid.build(r=[1, 2, 4])``)
    and both paths price r dispatcher-routed replicas per cell.  Elastic
    fleets ride it the same way: ``autoscale=(AutoscalePolicy(...), ...)``
    makes the replica axis a POLICY axis, and with ``simulate=True`` the
    frontier prices each policy by its observed replica-seconds; a
    ``fault=`` axis asks which failure scenarios still meet the SLO.
    Both are simulation-only; the analytic path raises.  ``mesh``
    shards the scenarios over a `repro_torch.launch.mesh.DeviceMesh`
    (`core.sweep`).
    """
    if simulate:
        result = sweep.sweep_simulated(
            grid, 0 if seed is None else seed,
            n_queries=20_000 if n_queries is None else n_queries,
            profile=profile, profile_bin_seconds=profile_bin_seconds,
            mesh=mesh, **sim_kwargs)
    else:
        if (profile is not None or seed is not None
                or n_queries is not None or sim_kwargs):
            raise ValueError(
                "profile/seed/n_queries/simulation kwargs only take effect "
                "with simulate=True; the analytic path would silently "
                "ignore them")
        result = sweep.sweep_analytical(grid, mesh=mesh)
    frontier = sweep.extract_frontier(result, slo_seconds, cost_fn=cost_fn,
                                      quantile=quantile)
    return result, frontier
