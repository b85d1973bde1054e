"""Vectorized what-if sweep engine (paper Sec 6 at grid scale).

PyTorch port of `repro.core.sweep`.  The paper answers "will
configuration X keep response time under the constraint?" one scenario
at a time.  This module evaluates a dense Cartesian grid

    lambda x p x cpu-speedup x disk-speedup x cache-hit-ratio x replicas

two ways:

  * analytical — the Eq 7 bounds from `repro_torch.core.queueing`, which
    broadcast, evaluated over broadcast views of the grid's axes: a
    million-scenario grid costs a few elementwise kernels.
  * simulation — the streaming chunked engine of
    `repro_torch.core.simulator`: one dispatch per distinct (p, r) pair,
    all L*C*D*H scenarios of a dispatch streaming together through the
    (max,+) scan kernels, so peak memory is scenarios x p x chunk values
    whatever the query count; quantile surfaces (p95/p99) come out next
    to the means, and a rate profile makes every scenario's load
    time-varying (diurnal/weekly peaks).

On top sits constraint-satisfying frontier extraction: "for each arrival
rate, the cheapest configuration with R <= SLO", where R can be the
analytic upper bound, the simulated mean, or a simulated quantile such as
p95 (exposed to planners via `repro_torch.core.planner.plan_over_grid`).

The replica axis may be swapped for a POLICY axis (a tuple of
`AutoscalePolicy` values) or a FAULT-SCENARIO axis (a tuple of
`FaultSpec` values, None the fault-free baseline); both are
simulation-only, and the frontier prices policy cells by their observed
replica-seconds.

The grid's tensors live on one device (``SweepGrid.build(device=...)``,
default ``cuda``) and every surface comes back there.  ``mesh=`` (a 1-D
`repro_torch.launch.mesh.make_sweep_mesh`) shards the scenarios across
the mesh's devices: scenarios never communicate, so shard d is
evaluated on ``mesh.devices[d]`` and the pieces are gathered onto the
grid's device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike, as_tensor
from repro_torch.core import capacity, queueing, simulator
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.queueing import ServerParams
from repro_torch.launch.elastic import AutoscalePolicy
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.obs.timeline import TelemetrySpec, Timeline

Tensor = torch.Tensor
TensorLike = Union[Tensor, Sequence[float], float]
# flat dispatch index (i * n_cfg + j) -> the per-chunk draws of that
# dispatch (see `repro_torch.core.simulator`), or None for the port's RNG;
# with a mesh, a tuple of them, one a shard
DispatchDraws = Callable[[int], Union[Optional[simulator.Draws],
                                      Sequence[Optional[simulator.Draws]]]]

__all__ = [
    "SweepGrid",
    "SweepResult",
    "SimSweepResult",
    "Frontier",
    "sweep_analytical",
    "sweep_simulated",
    "default_config_cost",
    "extract_frontier",
]


def _f32(x, device: torch.device) -> Tensor:
    """float32 on ``device``, as the reference's ``asarray(x, float32)``."""
    return as_tensor(x, torch.device(device), torch.float32).to(
        torch.float32)


def _axis(x: TensorLike, device: torch.device) -> Tensor:
    return torch.atleast_1d(_f32(x, device))


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """A dense what-if grid over the paper's Section-6 knobs.

    Axis order is fixed: (lam, p, cpu, disk, hit, r).  ``base`` supplies
    the measured per-server times that the cpu/disk speedups divide
    (paper convention: CPU k-times faster divides every CPU time by k);
    its ``p``/``hit`` fields are ignored in favor of the grid axes.  The
    broker is CPU-bound and grows with p per the paper's linear fit,
    unless ``broker_from_p=False`` pins it to ``base.s_broker``.

    ``r`` is the replica axis (Sec 6 ``replicas_needed`` as a grid
    dimension): ``lam`` stays the TOTAL arrival rate and each replica is
    planned at ``lam / r``.  ``result_cache=(hit_r, s_cache)`` threads
    the Eq 8 broker-level result cache through both evaluation paths
    (conservative un-thinned mixture analytically; a mechanistic
    dispatcher cache queue in the simulator).

    ``autoscale`` replaces the replica axis with a POLICY axis: a tuple
    of `repro_torch.launch.elastic.AutoscalePolicy` values becomes the
    grid's 6th dimension (``r`` must stay at its default — each policy's
    ``max_r`` sets provisioning).  Policy grids are simulation-only, and
    :func:`extract_frontier` prices their cells by observed
    replica-seconds instead of a static replica count.

    ``fault`` likewise replaces the replica axis with a FAULT-SCENARIO
    axis: a tuple of `repro_torch.core.faults.FaultSpec` values (None
    entries are the fault-free baseline), every cell running at the one
    fixed replica count on the ``r`` axis.  Simulation-only too.

    The axes are 1-D tensors on one device; `build` makes them float32.
    """

    lam: Tensor
    p: Tensor
    cpu: Tensor
    disk: Tensor
    hit: Tensor
    base: ServerParams
    broker_from_p: bool = True
    r: Optional[Tensor] = None      # None: one replica
    result_cache: Optional[tuple[float, float]] = None
    autoscale: Optional[tuple] = None
    fault: Optional[tuple] = None

    def __post_init__(self):
        if self.r is None:
            object.__setattr__(self, "r", torch.ones(
                (1,), dtype=torch.float32, device=self.lam.device))
        if self.fault is not None:
            fts = (tuple(self.fault)
                   if isinstance(self.fault, (tuple, list))
                   else (self.fault,))
            if not fts:
                raise ValueError("fault= needs at least one scenario "
                                 "(or None for a fault-free grid)")
            for ft in fts:
                if ft is not None and not isinstance(ft, FaultSpec):
                    raise TypeError(
                        "fault must hold FaultSpec (or None) values; "
                        f"got {type(ft).__name__}")
            if self.autoscale is not None:
                raise ValueError(
                    "autoscale and fault both claim the grid's 6th "
                    "axis; sweep one at a time")
            if self.r.shape[0] != 1:
                raise ValueError(
                    "a fault grid replaces the replica axis; give r ONE "
                    "value (the fixed replica count every scenario "
                    "runs at)")
            object.__setattr__(self, "fault", fts)
        if self.autoscale is None:
            return
        pols = (tuple(self.autoscale)
                if isinstance(self.autoscale, (tuple, list))
                else (self.autoscale,))
        if not pols:
            raise ValueError("autoscale= needs at least one policy "
                             "(or None for a static grid)")
        for pol in pols:
            if not isinstance(pol, AutoscalePolicy):
                raise TypeError(
                    "autoscale must hold AutoscalePolicy values; got "
                    f"{type(pol).__name__}")
        if self.r.shape[0] != 1 or float(self.r[0]) != 1.0:
            raise ValueError(
                "a policy grid replaces the replica axis; leave r at "
                "its default (each policy's max_r sets provisioning)")
        object.__setattr__(self, "autoscale", pols)

    @classmethod
    def build(cls, *, lam: TensorLike, p: TensorLike = 100.0,
              cpu: TensorLike = 1.0, disk: TensorLike = 1.0,
              hit: TensorLike = None, memory: int = 1,
              base: Optional[ServerParams] = None,
              broker_from_p: bool = True,
              r: TensorLike = 1.0,
              result_cache: Optional[tuple[float, float]] = None,
              autoscale=None,
              fault=None,
              device: DeviceLike = DEFAULT_DEVICE,
              ) -> "SweepGrid":
        """Grid from explicit axes; defaults come from Table 6 ``memory``."""
        dev = torch.device(device)
        if base is None:
            s_hit, s_miss, s_disk, h = capacity.MEMORY_TABLE[memory]
            base = ServerParams(
                p=100, s_broker=capacity.broker_service_time(100,
                                                             device=dev),
                s_hit=s_hit, s_miss=s_miss, s_disk=s_disk, hit=h)
        if hit is None:
            hit = base.hit
        return cls(lam=_axis(lam, dev), p=_axis(p, dev), cpu=_axis(cpu, dev),
                   disk=_axis(disk, dev), hit=_axis(hit, dev), base=base,
                   broker_from_p=broker_from_p, r=_axis(r, dev),
                   result_cache=result_cache, autoscale=autoscale,
                   fault=fault)

    @property
    def device(self) -> torch.device:
        return self.lam.device

    @property
    def shape(self) -> tuple[int, ...]:
        if self.autoscale is not None:
            last = len(self.autoscale)
        elif self.fault is not None:
            last = len(self.fault)
        else:
            last = self.r.shape[0]
        return (self.lam.shape[0], self.p.shape[0], self.cpu.shape[0],
                self.disk.shape[0], self.hit.shape[0], last)

    @property
    def n_scenarios(self) -> int:
        return math.prod(self.shape)

    def broadcast(self) -> tuple[Tensor, ServerParams]:
        """(lam, params) with every field shaped to broadcast over `shape`.

        ``lam`` is the total arrival rate; divide by :meth:`lam_replica`'s
        denominator (the broadcast ``r`` axis) for per-replica rates.
        """
        dev = self.device
        lam = self.lam.reshape(-1, 1, 1, 1, 1, 1)
        p = self.p.reshape(1, -1, 1, 1, 1, 1)
        cpu = self.cpu.reshape(1, 1, -1, 1, 1, 1)
        disk = self.disk.reshape(1, 1, 1, -1, 1, 1)
        hit = self.hit.reshape(1, 1, 1, 1, -1, 1)
        if self.broker_from_p:
            s_broker = capacity.broker_service_time(p) / cpu
        else:
            s_broker = _f32(self.base.s_broker, dev) / cpu
        params = ServerParams(
            p=p,
            s_broker=s_broker,
            s_hit=_f32(self.base.s_hit, dev) / cpu,
            s_miss=_f32(self.base.s_miss, dev) / cpu,
            s_disk=_f32(self.base.s_disk, dev) / disk,
            hit=hit,
        )
        return lam, params

    def lam_replica(self) -> Tensor:
        """Per-replica arrival rate, broadcastable over `shape`."""
        if self.autoscale is not None:
            raise ValueError(
                "per-replica rates are undefined on a policy grid: the "
                "active replica count varies over time (simulate instead)")
        lam, _ = self.broadcast()
        return lam / self.r.reshape(1, 1, 1, 1, 1, -1)

    def broadcast_full(self) -> tuple[Tensor, ServerParams]:
        """Like `broadcast`, but every field expanded to `shape` (views).

        The returned ``lam`` is still the TOTAL rate (the simulator's
        dispatcher does the splitting).
        """
        lam, params = self.broadcast()
        shape = self.shape
        full = {
            f.name: _f32(getattr(params, f.name), self.device).expand(shape)
            for f in dataclasses.fields(ServerParams)
        }
        return lam.expand(shape), ServerParams(**full)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Dense response surfaces, all shaped `grid.shape` = (L,P,C,D,H,R)."""

    grid: SweepGrid
    response_lower: Tensor   # Eq 7 lower bound (s); +inf where saturated
    response_upper: Tensor   # Eq 7 upper bound (s); the planning metric
    utilization: Tensor      # index-server utilization lambda * S

    @property
    def response(self) -> Tensor:
        """The conservative (paper-default) planning surface."""
        return self.response_upper

    @property
    def feasible_fraction(self) -> Tensor:
        return torch.mean(torch.isfinite(self.response_upper).float())

    def quantile(self, q: float) -> Tensor:
        """Analytic q-percentile upper estimate over the grid (Sec 7).

        Mirrors :meth:`SimSweepResult.quantile` so frontier extraction can
        target tail latency against either surface.  With a grid-level
        result cache the surface is the Eq-8-style mixture of the no-cache
        quantile and the cache queue's exponential quantile (an upper
        blend — the true quantile of a mixture is below it in the tail).
        """
        _, params = self.grid.broadcast()
        lam_rep = self.grid.lam_replica()
        surf = queueing.response_time_quantile_upper(lam_rep, params, q)
        if self.grid.result_cache is not None:
            hit_r, s_cache = self.grid.result_cache
            r_cache = queueing.mm1_residence_time(lam_rep, s_cache)
            t_cache = -r_cache * torch.log1p(-_f32(q, lam_rep.device))
            surf = surf * (1.0 - hit_r) + t_cache * hit_r
        return torch.broadcast_to(surf, self.grid.shape)


def _bounds_surface(lam: Tensor, params: ServerParams, result_cache=None):
    lo, hi = queueing.response_time_bounds(lam, params)
    if result_cache is not None:
        hit_r, s_cache = result_cache
        # upper: the Eq 8 mixture (conservative, load NOT thinned).  That
        # conservatism is only valid UPWARD — for the lower bound both
        # legs use the mechanistically thinned rates (hits really do
        # bypass the servers), so lo stays a genuine lower bound.
        hi = queueing.apply_result_cache(hi, lam, hit_r, s_cache)
        lo_thin, _ = queueing.response_time_bounds(lam * (1.0 - hit_r),
                                                   params)
        r_cache_thin = queueing.mm1_residence_time(lam * hit_r, s_cache)
        lo = lo_thin * (1.0 - hit_r) + r_cache_thin * hit_r
    util = queueing.utilization(lam, queueing.service_time_server(params))
    return lo, hi, util


def _check_sweep_mesh(mesh: DeviceMesh) -> int:
    """Validate a scenario-sharding mesh; returns its device count.

    Both sweep paths shard over ONE axis (scenarios are embarrassingly
    parallel), so the mesh must be 1-D — build it with
    `repro_torch.launch.mesh.make_sweep_mesh`.
    """
    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a repro_torch DeviceMesh; got "
                        f"{type(mesh).__name__}")
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"scenario sharding needs a 1-D mesh; got axes "
            f"{tuple(mesh.axis_names)} (build one with "
            "repro_torch.launch.mesh.make_sweep_mesh)")
    return mesh.size


def _edge_pad(x: Tensor, n: int) -> Tensor:
    """``x`` with its leading axis padded by ``n`` copies of its last row
    (the reference's ``pad(mode="edge")``)."""
    if not n:
        return x
    return torch.cat([x, x[-1:].expand((n,) + x.shape[1:])])


def sweep_analytical(grid: SweepGrid, *,
                     mesh: Optional[DeviceMesh] = None) -> SweepResult:
    """Evaluate the Eq 7/Eq 8 bounds over the whole grid.

    Replicated cells are evaluated at the per-replica rate ``lam / r``
    (replication splits arrivals evenly — the paper's linear-gain
    assumption, which `sweep_simulated` cross-checks under real routing).
    The bounds are elementwise over broadcast views of the axes; only
    the returned surfaces are expanded to `grid.shape`.

    ``mesh`` — a 1-D mesh from `repro_torch.launch.mesh.make_sweep_mesh`
    — shards the flattened scenario axis: it is padded (edge-replicated)
    to a multiple of the mesh, piece d is evaluated on
    ``mesh.devices[d]``, and the pieces are gathered onto the grid's
    device with the padding sliced off.  Each scenario goes through the
    same elementwise operations in the same dtype as without a mesh, so
    the surfaces are bitwise the unsharded ones.  This is how the
    million-scenario surfaces of ``examples/torch_global_sweep.py`` are
    evaluated.
    """
    if grid.autoscale is not None:
        raise ValueError(
            "sweep_analytical cannot evaluate a policy grid: the Eq 7/8 "
            "bounds assume a fixed replica count (use sweep_simulated)")
    if grid.fault is not None:
        raise ValueError(
            "sweep_analytical cannot evaluate a fault grid: the Eq 7/8 "
            "bounds assume every replica is up (use sweep_simulated)")
    _, params = grid.broadcast()
    lam_rep = grid.lam_replica()
    shape = grid.shape
    if mesh is None:
        lo, hi, util = _bounds_surface(lam_rep, params, grid.result_cache)
        return SweepResult(
            grid=grid,
            response_lower=torch.broadcast_to(lo, shape),
            response_upper=torch.broadcast_to(hi, shape),
            utilization=torch.broadcast_to(util, shape),
        )

    n_dev = _check_sweep_mesh(mesh)
    n = grid.n_scenarios
    pad = (-n) % n_dev
    per = (n + pad) // n_dev

    def flat(x):
        return _edge_pad(torch.broadcast_to(x, shape).reshape(-1), pad)

    lam_flat = flat(lam_rep)
    fields_flat = {f.name: flat(getattr(params, f.name))
                   for f in dataclasses.fields(ServerParams)}
    pieces = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * per, (d + 1) * per)
        params_d = ServerParams(**{k: v[sl].to(dev)
                                   for k, v in fields_flat.items()})
        pieces.append(_bounds_surface(lam_flat[sl].to(dev), params_d,
                                      grid.result_cache))

    def gather(i):
        out = torch.cat([piece[i].to(grid.device) for piece in pieces])
        return out[:n].reshape(shape)
    return SweepResult(grid=grid, response_lower=gather(0),
                       response_upper=gather(1), utilization=gather(2))


@dataclasses.dataclass(frozen=True)
class SimSweepResult:
    """Streaming-simulated surfaces: mean, spread AND quantiles.

    ``stats`` is a :class:`repro_torch.core.simulator.SimResult` whose
    fields all carry the full grid shape (L,P,C,D,H,R) in front (the
    histogram has one trailing bin axis, the tap one trailing sample
    axis), so every summary the streaming engine accumulates is available
    as a dense surface.
    """

    grid: SweepGrid
    stats: simulator.SimResult

    @property
    def mean(self) -> Tensor:
        return self.stats.mean_response

    @property
    def response(self) -> Tensor:
        """The default planning surface for frontier extraction."""
        return self.mean

    @property
    def std(self) -> Tensor:
        return self.stats.std_response

    def quantile(self, q: float) -> Tensor:
        """q-quantile response surface, shaped `grid.shape`."""
        return self.stats.quantile(q)

    @property
    def sample_response(self) -> Tensor:
        """(L,P,C,D,H,R, tap_size) reservoir sample of per-query responses.

        NaN-padded when a scenario saw fewer post-warmup queries than the
        tap size; empty trailing axis unless the sweep ran with
        ``tap_size > 0``.
        """
        return self.stats.tap_response


def _static_count(x: float, axis_name: str) -> int:
    v = int(round(x))
    if abs(v - x) > 1e-3:
        raise ValueError(
            f"simulation needs integer {axis_name} counts; got {x} "
            "(the analytical path accepts fractional values)")
    return v


def _stack(results: Sequence, dim: int,
           join: Optional[Callable[[list], Tensor]] = None):
    """Stack every set tensor field of ``results`` (SimResults, or
    Timelines) along ``dim``, or combine each field's values with
    ``join``."""
    cls = type(results[0])
    join = join or (lambda vals: torch.stack(vals, dim=dim))

    def field(name):
        vals = [getattr(res, name) for res in results]
        if vals[0] is None:
            return None
        if isinstance(vals[0], Timeline):
            return _stack(vals, dim, join)
        return join(vals)
    return cls(**{f.name: field(f.name) for f in dataclasses.fields(cls)})


def _fill_fault_channels(res: simulator.SimResult, r: int
                         ) -> simulator.SimResult:
    """Zero fault channels for a fault axis's ``None`` baseline cell, so
    that its result stacks with the FaultSpec cells': nothing spilled,
    unavailable or degraded, and (with a timeline) every replica up for
    every arrival."""
    if res.spill_count is not None:
        return res
    z = torch.zeros_like(res.count)
    kw = dict(spill_count=z, unavail_count=z, degraded_count=z)
    tl = res.timeline
    if tl is not None and tl.up_sum is None:
        kw["timeline"] = dataclasses.replace(
            tl, up_sum=tl.count * float(r),
            spill_sum=torch.zeros_like(tl.count),
            degraded_sum=torch.zeros_like(tl.count))
    return dataclasses.replace(res, **kw)


def _sharded_batch(run: Callable[..., simulator.SimResult],
                   mesh: DeviceMesh, seed: int, proc: ArrivalProcess,
                   params: ServerParams,
                   draws: Optional[Sequence[Optional[simulator.Draws]]],
                   out_device: torch.device) -> simulator.SimResult:
    """Scenario-shard one (p, r) batch dispatch over a 1-D mesh.

    ``run(seed, proc, params, draws=, device=)`` is the batch entry with
    every static knob bound, the one the unsharded path calls.  The
    slab's scenario axis is padded (edge-replicated) to a multiple of
    the mesh; shard d runs on ``mesh.devices[d]`` from the seed
    ``_mix(seed, d)`` (or ``draws[d]``), and every result field, which
    leads with the scenario axis, is gathered onto ``out_device`` with
    the padding sliced off.
    """
    n_dev = _check_sweep_mesh(mesh)
    if draws is not None and len(draws) != n_dev:
        raise ValueError(f"draws gives {len(draws)} shards' draws for a "
                         f"mesh of {n_dev} devices")
    n_slab = proc.rates.shape[0]
    pad = (-n_slab) % n_dev
    per = (n_slab + pad) // n_dev
    rates = _edge_pad(proc.rates, pad)
    fields = {f.name: _edge_pad(torch.broadcast_to(
        getattr(params, f.name), (n_slab,)), pad)
        for f in dataclasses.fields(ServerParams)}
    shards = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * per, (d + 1) * per)
        proc_d = dataclasses.replace(proc, rates=rates[sl].to(dev),
                                     bin_seconds=proc.bin_seconds.to(dev))
        params_d = ServerParams(**{k: v[sl].to(dev)
                                   for k, v in fields.items()})
        shards.append(run(simulator._mix(seed, d), proc_d, params_d,
                          draws=None if draws is None else draws[d],
                          device=dev))
    return _stack(shards, 0, lambda xs: torch.cat(
        [x.to(out_device) for x in xs])[:n_slab])


def sweep_simulated(
    grid: SweepGrid,
    seed: int = 0,
    *,
    n_queries: int = 20_000,
    mode: str = "exponential",
    impl: str = "auto",
    warmup_fraction: float = 0.1,
    chunk_size: int = simulator.DEFAULT_CHUNK,
    hist_bins: int = simulator.DEFAULT_HIST_BINS,
    tap_size: int = 0,
    profile: Optional[TensorLike] = None,
    profile_bin_seconds: float = 3600.0,
    cluster: Optional[ClusterSpec] = None,
    telemetry: Optional[TelemetrySpec] = None,
    mesh: Optional[DeviceMesh] = None,
    draws: Optional[DispatchDraws] = None,
    dtype: torch.dtype = torch.float32,
) -> SimSweepResult:
    """Streaming-simulated response surfaces over the grid.

    One streaming dispatch per distinct (p, r) pair (static shapes);
    within a dispatch all L*C*D*H scenarios stream together over query
    chunks on the grid's device (``impl="auto"``: the CUDA scan kernels
    on the card).  Peak memory is n_scenarios_per_dispatch * p *
    chunk_size values — the total query count only adds chunks.

    ``cluster=ClusterSpec(...)`` supplies the per-dispatch topology
    (routing policy, result cache, replica engine); the grid's axes
    supply what varies, so ``ClusterSpec.r`` must stay at its default
    (the ``grid.r`` axis is the replica sweep).  A ``result_cache`` may
    live on the spec or on the grid but not both.  Replicated cells run
    the dispatcher topology under the spec's routing; each scenario's
    lam stays the total rate, so the surface cross-checks the analytical
    ``lam / r`` splitting assumption, imbalance included.

    ``grid.autoscale`` swaps the replica axis for a POLICY axis: one
    dispatch per `AutoscalePolicy`, each provisioning ``max_r`` replicas
    with the policy deciding how many are active; every cell then carries
    ``stats.replica_seconds`` / ``stats.elapsed_seconds``, which
    `extract_frontier` prices.  ``grid.fault`` swaps it for a
    FAULT-SCENARIO axis instead: one dispatch per `FaultSpec` (None
    entries are the fault-free baseline, whose fault channels come back
    as zeros), every cell at the grid's one replica count.  Policies and
    faults go on the grid, never on the ClusterSpec.

    ``profile`` makes the load non-stationary: a (n_bins,) relative-rate
    curve (e.g. `repro_torch.workloadgen.loadgen.diurnal_rates`) that
    tiles with period ``n_bins * profile_bin_seconds``.  It is normalized
    to mean 1, so the grid's lam axis stays the *time-averaged* rate.
    ``tap_size > 0`` carries the simulator's reservoir tap through every
    scenario (:attr:`SimSweepResult.sample_response`).

    Dispatch (i, j) — the i-th p and the j-th entry of the 6th axis (r,
    policy or fault scenario) — has flat index ``k = i * n_6 + j`` and
    simulates from the seed ``_mix(seed, k)``.
    ``draws``, if given, maps k to that dispatch's per-chunk draws
    callable (the simulator's ``draws=``), or None for the port's own
    RNG; tests feed the reference's per-dispatch draws through it.
    ``dtype`` is the simulation's float type.  ``telemetry`` streams
    every cell's `repro_torch.obs.timeline.Timeline` onto
    ``stats.timeline``, the grid's shape in front; on a policy axis every
    policy needs the same ``max_r`` (the timelines stack a per-replica
    axis).

    ``mesh`` — a 1-D mesh from `repro_torch.launch.mesh.make_sweep_mesh`
    — shards each dispatch's L*C*D*H scenario slab: the slab is padded
    (edge-replicated) to a multiple of the mesh, shard d runs the same
    batch entry on ``mesh.devices[d]`` from its own seed
    ``_mix(_mix(seed, k), d)``, and the shards' results are gathered onto
    the grid's device with the padding sliced off.  Sharded surfaces are
    therefore statistically equivalent, not bit-identical, to unsharded
    ones.  With a mesh, ``draws(k)`` returns a tuple of per-shard
    per-chunk draws callables (or None).  The chunk loop issues device
    work only, so on a mesh of several cards shard d + 1's launches
    queue while shard d's run; on a mesh that repeats one device the
    shards run in turn, each one's peak temp memory S/n x p x chunk.
    """
    spec = ClusterSpec() if cluster is None else cluster
    if spec.r != 1:
        raise ValueError(
            "sweep_simulated takes replica counts from the grid's r "
            "axis; leave ClusterSpec.r at its default")
    if spec.autoscale is not None:
        raise ValueError(
            "autoscale policies form a sweep axis: put them on "
            "SweepGrid(autoscale=...) rather than the ClusterSpec")
    if spec.fault is not None:
        raise ValueError(
            "fault scenarios form a sweep axis: put them on "
            "SweepGrid(fault=...) rather than the ClusterSpec")
    if spec.result_cache is not None and grid.result_cache is not None:
        raise ValueError(
            "result_cache given on both the ClusterSpec and the grid; "
            "keep exactly one")
    cache = (spec.result_cache if spec.result_cache is not None
             else grid.result_cache)
    if telemetry is not None and grid.autoscale is not None:
        max_rs = {pol.max_r for pol in grid.autoscale}
        if len(max_rs) > 1:
            raise ValueError(
                "telemetry timelines stack a per-replica axis across "
                "policy cells, so every policy needs the same max_r; "
                f"got {sorted(max_rs)}")
    shape = grid.shape
    dev = grid.device
    lam_full, params_full = grid.broadcast_full()

    # one movedim/reshape per field up front — (L,P,C,D,H,R) -> (P, R,
    # L*C*D*H) — so every (p, r) dispatch just indexes a row
    def slab(x):
        return x.movedim((1, 5), (0, 1)).reshape(shape[1], shape[5], -1)

    lam_slabs = slab(lam_full)
    field_slabs = {f.name: slab(getattr(params_full, f.name))
                   for f in dataclasses.fields(ServerParams)}
    if profile is not None:
        base_proc = ArrivalProcess.piecewise(
            profile, profile_bin_seconds, device=dev, dtype=dtype
        ).normalized()

    # the static axes, read on the host once (each read is a sync)
    p_axis = grid.p.tolist()
    r_axis = grid.r.tolist()
    n_p, n_cfg = shape[1], shape[5]
    slab_shape = (shape[0], shape[2], shape[3], shape[4])
    p_slabs = []
    for i in range(n_p):
        p = _static_count(p_axis[i], "server")
        cfg_slabs = []
        for j in range(n_cfg):
            topo = dict(routing=spec.routing, result_cache=cache,
                        replica_impl=spec.replica_impl)
            if grid.autoscale is not None:
                cell = ClusterSpec(autoscale=grid.autoscale[j], **topo)
            elif grid.fault is not None:
                cell = ClusterSpec(r=_static_count(r_axis[0], "replica"),
                                   fault=grid.fault[j], **topo)
            else:
                cell = ClusterSpec(r=_static_count(r_axis[j], "replica"),
                                   **topo)
            lam_ij = lam_slabs[i, j]
            arrival = (ArrivalProcess.stationary(lam_ij, device=dev,
                                                 dtype=dtype)
                       if profile is None else base_proc.scaled_by(lam_ij))
            # the profile clamp reads the whole slab's rates here, on the
            # host, so that every shard of a dispatch runs one chunk size
            chunk = simulator._clamp_chunk_for_profile(
                arrival, max(1, min(chunk_size, n_queries)))
            k = i * n_cfg + j
            run = functools.partial(
                simulator.simulate_fork_join_batch, n_queries=n_queries,
                p=p, mode=mode, impl=impl, warmup_fraction=warmup_fraction,
                chunk_size=chunk, hist_bins=hist_bins, tap_size=tap_size,
                cluster=cell, telemetry=telemetry, dtype=dtype)
            params_ij = ServerParams(
                **{n: v[i, j] for n, v in field_slabs.items()})
            draws_k = None if draws is None else draws(k)
            if mesh is None:
                res = run(simulator._mix(seed, k), arrival, params_ij,
                          draws=draws_k, device=dev)
            else:
                res = _sharded_batch(run, mesh, simulator._mix(seed, k),
                                     arrival, params_ij, draws_k, dev)
            if grid.fault is not None:
                res = _fill_fault_channels(res, cell.r)
            cfg_slabs.append(res.map(
                lambda x: x.reshape(slab_shape + x.shape[1:])))
        # stack the replica / policy / fault axis behind (L,C,D,H) -> 4
        p_slabs.append(_stack(cfg_slabs, 4))
    # stack the p axis into position 1 -> (L,P,C,D,H,R)
    return SimSweepResult(grid=grid, stats=_stack(p_slabs, 1))


def default_config_cost(p: Tensor, cpu: Tensor, disk: Tensor,
                        hit: Tensor) -> Tensor:
    """Illustrative hardware cost: servers are the unit.

    Each server costs 1 baseline, plus 0.5 per unit of extra CPU speed,
    0.25 per unit of extra disk speed, and up to 1.0 for the memory that
    buys a high disk-cache hit ratio.  Replace via the ``cost_fn``
    argument of :func:`extract_frontier` for a real procurement model.
    """
    per_server = (1.0 + 0.5 * (cpu - 1.0) + 0.25 * (disk - 1.0)
                  + 1.0 * hit)
    return p * per_server


@dataclasses.dataclass(frozen=True)
class Frontier:
    """Per-lambda cheapest feasible configuration (all tensors (L,)).

    On a policy grid ``r`` is the chosen policy's MEAN ACTIVE replica
    count (``replica_seconds / elapsed_seconds``, generally fractional)
    and ``autoscale`` holds the chosen `AutoscalePolicy` per rate;
    otherwise ``autoscale`` is None and ``r`` is the static count.  On a
    fault grid ``fault`` holds the chosen cell's `FaultSpec` (or None for
    the fault-free baseline cell) per rate.
    """

    lam: Tensor
    feasible: Tensor    # bool: any config meets the SLO at this rate
    cost: Tensor        # cost of the chosen config; +inf if infeasible
    p: Tensor
    cpu: Tensor
    disk: Tensor
    hit: Tensor
    response: Tensor    # targeted-surface response of the chosen config (s)
    r: Tensor = None    # replicas of the chosen config
    autoscale: Optional[tuple[AutoscalePolicy, ...]] = None
    fault: Optional[tuple[Optional[FaultSpec], ...]] = None

    def describe(self, i: int) -> str:
        if not bool(self.feasible[i]):
            return (f"lam={float(self.lam[i]):g} qps: INFEASIBLE "
                    f"anywhere on the grid")
        if self.autoscale is not None:
            pol = self.autoscale[i]
            rep_s = (f" autoscale {pol.min_r}..{pol.max_r}"
                     f" @{pol.target_utilization:.0%}"
                     f" (mean active {float(self.r[i]):.2f})")
        else:
            reps = 1 if self.r is None else int(round(float(self.r[i])))
            rep_s = f" x{reps} replicas" if reps != 1 else ""
            if self.fault is not None:
                ft = self.fault[i]
                rep_s += (" (fault-free)" if ft is None
                          else f" under {ft!r}")
        return (f"lam={float(self.lam[i]):g} qps: p={float(self.p[i]):g} "
                f"cpu x{float(self.cpu[i]):g} disk x{float(self.disk[i]):g} "
                f"hit={float(self.hit[i]):.2f}{rep_s} -> "
                f"R<={float(self.response[i]) * 1e3:.0f} ms "
                f"(cost {float(self.cost[i]):.1f})")


def extract_frontier(
    result: Union[SweepResult, SimSweepResult],
    slo_seconds: float,
    *,
    cost_fn: Optional[Callable[[Tensor, Tensor, Tensor, Tensor],
                               Tensor]] = None,
    surface: Optional[Tensor] = None,
    quantile: Optional[float] = None,
) -> Frontier:
    """Cheapest config whose response surface meets the SLO, per lambda.

    The targeted surface defaults to ``result.response`` (the Eq 7 upper
    bound for analytical sweeps, the simulated mean for streaming sweeps).
    Pass ``quantile=0.95`` to plan against tail latency instead — "the
    cheapest configuration whose p95 survives the load" — or hand any
    precomputed ``surface`` shaped `grid.shape`.

    Fully vectorized: the (P,C,D,H,R) config-cost tensor is masked by the
    feasibility surface and argmin-reduced per arrival rate (ties go to
    the first index; a rate with no feasible cell gets cost +inf).
    ``cost_fn`` prices ONE replica's hardware (p, cpu, disk, hit);
    replication multiplies it — r copies of the cluster cost r times as
    much.

    On a policy grid the replica multiplier is each cell's OBSERVED
    time-averaged fleet size ``replica_seconds / elapsed_seconds``, so
    "cheapest" means fewest replica-seconds per second — comparable to a
    static-r plan's ``cost * r`` at the same SLO compliance.
    """
    grid = result.grid
    if surface is None:
        surface = (result.quantile(quantile) if quantile is not None
                   else result.response)
    cost_fn = cost_fn or default_config_cost
    costs = cost_fn(
        grid.p.reshape(-1, 1, 1, 1),
        grid.cpu.reshape(1, -1, 1, 1),
        grid.disk.reshape(1, 1, -1, 1),
        grid.hit.reshape(1, 1, 1, -1),
    )
    costs = torch.broadcast_to(costs, grid.shape[1:5])
    if grid.autoscale is not None:
        stats = getattr(result, "stats", None)
        if stats is None or stats.replica_seconds is None:
            raise ValueError(
                "a policy grid prices configurations by simulated "
                "replica-seconds; extract the frontier from a "
                "sweep_simulated result")
        eff_r = stats.replica_seconds / torch.clamp_min(
            stats.elapsed_seconds, 1e-30)             # (L,P,C,D,H,A)
        costs_full = costs[None, :, :, :, :, None] * eff_r
    else:
        costs_full = (costs[..., None]
                      * grid.r.reshape(1, 1, 1, 1, -1))[None]

    feasible = surface <= slo_seconds                     # (L,P,C,D,H,R)
    masked = torch.where(feasible, costs_full, math.inf)
    flat = masked.reshape(grid.shape[0], -1)
    best = torch.argmin(flat, dim=1)
    best_cost = torch.gather(flat, 1, best[:, None])[:, 0]

    ip, ic, id_, ih, ir = torch.unravel_index(best, grid.shape[1:])
    chosen_resp = torch.gather(surface.reshape(grid.shape[0], -1), 1,
                               best[:, None])[:, 0]
    chosen_pol = chosen_fault = None
    if grid.autoscale is not None:
        chosen_r = torch.gather(eff_r.reshape(grid.shape[0], -1), 1,
                                best[:, None])[:, 0]
        chosen_pol = tuple(grid.autoscale[t] for t in ir.tolist())
    elif grid.fault is not None:
        # fault cells all run at the one fixed replica count; the 6th
        # index picks the failure scenario, not the fleet size
        chosen_r = grid.r[:1].expand(ir.shape)
        chosen_fault = tuple(grid.fault[t] for t in ir.tolist())
    else:
        chosen_r = grid.r[ir]
    return Frontier(
        lam=grid.lam,
        feasible=torch.isfinite(best_cost),
        cost=best_cost,
        p=grid.p[ip],
        cpu=grid.cpu[ic],
        disk=grid.disk[id_],
        hit=grid.hit[ih],
        response=chosen_resp,
        r=chosen_r,
        autoscale=chosen_pol,
        fault=chosen_fault,
    )
