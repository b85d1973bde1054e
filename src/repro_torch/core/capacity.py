"""Capacity planning engine (paper Section 6).

PyTorch port of `repro.core.capacity`: the Table 5 validation cluster,
the Table 6 100-server case study with 1x..4x main memory, the Section 6
what-if scenarios, the SLO solver, replica sizing, the manager-facing
`plan_capacity` (optionally cross-checked by the replicated streaming
simulator) and the Fig 13/14 `upgrade_grid` surface.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike, as_tensor, resolve
from repro_torch.core import queueing, simulator
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.queueing import ServerParams
from repro_torch.launch.elastic import AutoscalePolicy

Tensor = torch.Tensor

__all__ = [
    "TABLE5_PARAMS",
    "TABLE5_SBROKER",
    "MEMORY_TABLE",
    "broker_service_time",
    "scenario_params",
    "scenario",
    "upper_bound_curve",
    "max_rate_under_slo",
    "replicas_needed",
    "CapacityPlan",
    "plan_capacity",
    "upgrade_grid",
]

_MS = 1e-3

# --- Paper Table 5: validation cluster (8 servers, b = 1.25M pages) -------
TABLE5_PARAMS = ServerParams(
    p=8, s_broker=0.52 * _MS, s_hit=9.20 * _MS, s_miss=10.04 * _MS,
    s_disk=28.08 * _MS, hit=0.17)

TABLE5_SBROKER = {2: 0.33 * _MS, 4: 0.39 * _MS, 8: 0.52 * _MS}

# --- Paper Table 6: case-study parameters, p=100, b = 10M pages -----------
# Keyed by main-memory size as a multiple of the reference machine.
# (s_hit, s_miss, s_disk, hit)
MEMORY_TABLE = {
    1: (28.23 * _MS, 35.31 * _MS, 66.03 * _MS, 0.02),
    2: (33.38 * _MS, 33.77 * _MS, 35.89 * _MS, 0.09),
    3: (34.57 * _MS, 32.66 * _MS, 30.48 * _MS, 0.15),
    4: (34.68 * _MS, 32.04 * _MS, 26.14 * _MS, 0.18),
}


def broker_service_time(p, *, device: DeviceLike = None) -> Tensor:
    """Paper's broker fit: S_broker = 3.18e-2 * p + 0.265 ms (float32).

    Gives 3.45 ms at p = 100.
    """
    dev, _ = resolve(p, device=device)
    p = torch.as_tensor(p, device=dev).to(torch.float32)
    return (3.18e-2 * p + 0.265) * _MS


def scenario_params(
    *, memory: int = 1, cpu: float = 1.0, disk: float = 1.0, p: int = 100,
    device: DeviceLike = DEFAULT_DEVICE,
) -> ServerParams:
    """Section-6 scenario parameters.

    memory in {1,2,3,4} selects the re-measured Table 6 column; cpu/disk
    are speedup factors (divide CPU times by ``cpu``, disk time by
    ``disk``; the broker is CPU-bound so it scales with cpu).
    """
    s_hit, s_miss, s_disk, hit = MEMORY_TABLE[memory]
    return ServerParams(
        p=p,
        s_broker=broker_service_time(p, device=device) / cpu,
        s_hit=s_hit / cpu,
        s_miss=s_miss / cpu,
        s_disk=s_disk / disk,
        hit=hit,
    )


def scenario(name: str, p: int = 100, *,
             device: DeviceLike = DEFAULT_DEVICE) -> ServerParams:
    """Named paper scenarios (Section 6 / Figure 12)."""
    table = {
        "baseline": dict(memory=1),
        "memory+disks": dict(memory=4, disk=4.0),
        "memory+cpus": dict(memory=4, cpu=4.0),
        "cpus+disks": dict(memory=1, cpu=4.0, disk=4.0),
        "memory+cpus+disks": dict(memory=4, cpu=4.0, disk=4.0),
    }
    return scenario_params(p=p, device=device, **table[name])


def upper_bound_curve(lam_grid, params: ServerParams, *,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Tensor:
    """Eq 7 upper bound over a lambda grid."""
    _, hi = queueing.response_time_bounds(lam_grid, params, device=device,
                                          dtype=dtype)
    return hi


def max_rate_under_slo(
    params: ServerParams,
    slo_seconds: float,
    *,
    result_cache: Optional[tuple[float, float]] = None,
    iters: int = 60,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """Largest lambda with upper-bound response time <= SLO (bisection).

    result_cache: optional (hit_result, s_broker_cache_hit) enabling Eq 8.
    R(lambda) is monotone increasing up to saturation, so bisection on
    [0, saturation_rate) is exact to float precision.  The loop runs on
    the device with no host sync.
    """
    dev, dt = resolve(params, device=device, dtype=dtype)
    lam_max = queueing.saturation_rate(params, device=dev, dtype=dt) * (
        1.0 - 1e-6)

    def response(lam):
        if result_cache is None:
            _, hi = queueing.response_time_bounds(lam, params, device=dev,
                                                  dtype=dt)
            return hi
        hit_r, s_cache = result_cache
        return queueing.response_time_with_result_cache(
            lam, params, hit_r, s_cache, device=dev, dtype=dt)

    lo = torch.zeros((), dtype=lam_max.dtype, device=dev)
    hi = lam_max
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = response(mid) <= slo_seconds
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # infeasible SLO (even lambda->0 exceeds it) -> 0
    feasible = response(torch.full((), 1e-6, dtype=dt, device=dev)
                        ) <= slo_seconds
    return torch.where(feasible, lo, 0.0)


def replicas_needed(
    params: ServerParams,
    target_rate: float,
    slo_seconds: float,
    *,
    result_cache: Optional[tuple[float, float]] = None,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> tuple[Tensor, Tensor]:
    """Cluster replicas to serve target_rate within the SLO (Sec 6).

    Replication splits arrivals evenly; gains are linear per the paper.
    Returns (n_replicas int32, per_replica_rate).
    """
    per_replica = max_rate_under_slo(params, slo_seconds,
                                     result_cache=result_cache,
                                     device=device, dtype=dtype)
    n = torch.ceil(torch.as_tensor(target_rate, device=per_replica.device,
                                   dtype=per_replica.dtype)
                   / torch.clamp_min(per_replica, 1e-9))
    # an infeasible SLO asks for ~1e11 replicas: saturate at the int32
    # maximum as the reference's conversion does (torch's cast wraps)
    n = torch.clamp(n.to(torch.int64), max=torch.iinfo(torch.int32).max)
    return n.to(torch.int32), per_replica


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Output of plan_capacity — the manager-facing answer (Sec 5, Q i-iii).

    ``response_simulated_ms``/``response_simulated_p95_ms`` are filled
    when the plan was cross-checked by the replicated streaming simulator
    (``plan_capacity(..., simulate=True)``): the planned topology —
    ``n_replicas`` dispatcher-routed copies of the p-server cluster,
    result cache included — run at the full target rate.

    ``autoscale``/``mean_active_replicas`` are filled when the cross
    check ran an elastic fleet (``cluster=ClusterSpec(autoscale=...)``):
    the policy that was simulated and the time-averaged active replica
    count it actually used — beside ``n_replicas`` (the static Sec-6
    answer, which stays the provisioning headline) it quantifies the
    elastic saving.

    ``survive_faults``/``response_faulted_p95_ms`` are the N+k
    survivability extension (``plan_capacity(..., survive_faults=k)``):
    the fleet is provisioned with k spare replicas so the SLO holds with
    k replicas down, and — when the simulated cross-check ran —
    ``response_faulted_p95_ms`` is the observed p95 of exactly that
    degraded scenario (k replicas held down for the whole run, failover
    routing spilling their share to the survivors).
    """

    n_replicas: int
    servers_per_replica: int
    total_servers: int
    per_replica_rate_qps: float
    response_upper_ms: float
    response_lower_ms: float
    utilization: float
    response_simulated_ms: Optional[float] = None
    response_simulated_p95_ms: Optional[float] = None
    routing: Optional[str] = None
    autoscale: Optional[AutoscalePolicy] = None
    mean_active_replicas: Optional[float] = None
    survive_faults: int = 0
    response_faulted_p95_ms: Optional[float] = None


_SIM_REPLICA_CAP = 256


def plan_capacity(
    params: ServerParams,
    target_rate: float,
    slo_seconds: float,
    *,
    cluster: Optional[ClusterSpec] = None,
    simulate: bool = False,
    seed: int = 0,
    n_queries: int = 60_000,
    mode: str = "exponential",
    survive_faults: int = 0,
    draws=None,
    device: DeviceLike = None,
) -> CapacityPlan:
    """Section-6 sizing, optionally cross-checked by simulation.

    ``replicas_needed`` sizes the cluster off the Eq 7/Eq 8 upper bound.
    ``simulate=True`` additionally runs the replicated streaming
    simulator (`repro_torch.core.simulator.simulate_fork_join` with
    ``r=n_replicas`` and the same result cache) at the FULL target rate,
    so the plan's headline numbers carry a mechanistic check of the
    even-split assumption under an actual routing policy.

    ``cluster=ClusterSpec(...)`` supplies the topology (routing, result
    cache, replica engine, autoscale policy); its ``r`` must stay at the
    default — sizing the fleet is this function's job.  ``seed`` seeds
    the simulator; ``draws`` replaces its per-chunk random numbers (see
    `repro_torch.core.simulator`; every simulation of the plan reads the
    same callable).  ``device`` places parameters given as Python
    numbers (default: the tensors' device, else ``cuda``).

    With ``autoscale=AutoscalePolicy(...)`` on the spec the simulated
    cross-check runs THAT elastic fleet instead of ``n_replicas`` static
    copies (the policy's ``max_r`` sets provisioning), and the plan
    reports the policy and its ``mean_active_replicas``.  Policies need
    the simulator, so ``simulate=False`` with a policy is an error.

    ``survive_faults=k`` is the N+k survivability criterion: the fleet is
    sized so the SLO still holds with k replicas down — the Eq 7/8 bound
    at the survivor rate ``target_rate / n`` and ``n`` gains k spares.
    With ``simulate=True`` the cross-check runs exactly that degraded
    scenario (k replicas held down for the whole run by a `FaultSpec`
    outage window, failover spilling their share to the survivors), and
    grows the fleet (up to four times) while the observed p95 misses the
    SLO; ``response_faulted_p95_ms`` is that p95.
    """
    spec = ClusterSpec() if cluster is None else cluster
    if spec.r != 1:
        raise ValueError(
            "plan_capacity sizes the fleet itself; leave ClusterSpec.r "
            "at its default")
    if spec.autoscale is not None and not simulate:
        raise ValueError(
            "an autoscale policy only affects the simulated cross-check "
            "(the Eq 7/8 sizing is static); pass simulate=True")
    k_down = int(survive_faults)
    if k_down < 0:
        raise ValueError(f"survive_faults must be >= 0; got {survive_faults}")
    if k_down and spec.autoscale is not None:
        raise ValueError(
            "survive_faults sizes a static fleet; with an autoscale "
            "policy the max_r provisioning is the policy's job — plan "
            "the two separately")
    if k_down and spec.fault is not None:
        raise ValueError(
            "survive_faults synthesizes its own k-replicas-down "
            "FaultSpec; a ClusterSpec.fault would double-inject — give "
            "one or the other")
    dev, _ = resolve(params, device=device)
    cache = spec.result_cache
    n, per_replica = replicas_needed(
        params, target_rate, slo_seconds, result_cache=cache, device=dev)
    # N+k: the bound must hold at the SURVIVOR rate target / n_base, so
    # provisioning gains k spares on top of the fault-free answer
    n_i = int(n) + k_down
    rate = float(target_rate) / max(int(n), 1)
    lo, hi = queueing.response_time_bounds(rate, params, device=dev)
    if cache is not None:
        hi = queueing.response_time_with_result_cache(
            rate, params, *cache, device=dev)
    p = int(params.p)
    util = queueing.utilization(
        rate, queueing.service_time_server(params, device=dev), device=dev)
    sim_ms = sim_p95_ms = mean_active = faulted_p95_ms = None
    sim_r = spec.autoscale.max_r if spec.autoscale is not None else n_i
    feasible = float(per_replica) > 1e-9 or spec.autoscale is not None
    if simulate and feasible and sim_r <= _SIM_REPLICA_CAP:
        sim_spec = (spec if spec.autoscale is not None
                    else dataclasses.replace(spec, r=n_i))
        sim = simulator.simulate_fork_join(
            seed, float(target_rate), n_queries, params, mode=mode,
            cluster=sim_spec, draws=draws, device=dev)
        sim_ms = float(sim.mean_response) * 1e3
        sim_p95_ms = float(sim.quantile(0.95)) * 1e3
        if spec.autoscale is not None:
            mean_active = float(sim.mean_active_replicas)
        if k_down:
            # the survivability check proper: k replicas held down for
            # the WHOLE run (the peak-coincident worst case), failover
            # spilling their share to the survivors; the even-split bound
            # already sized for this, the simulation also sees routing
            # imbalance, so grow the fleet while p95 misses
            horizon = 2.0 * n_queries / max(float(target_rate), 1e-9)
            down = FaultSpec(
                outages=tuple((j, 0.0, horizon) for j in range(k_down)))
            for _ in range(4):
                ft = simulator.simulate_fork_join(
                    seed, float(target_rate), n_queries, params, mode=mode,
                    cluster=dataclasses.replace(spec, r=n_i, fault=down),
                    draws=draws, device=dev)
                faulted_p95_ms = float(ft.quantile(0.95)) * 1e3
                if (faulted_p95_ms <= slo_seconds * 1e3
                        or n_i >= _SIM_REPLICA_CAP):
                    break
                n_i += 1
    elif simulate:
        reason = ("infeasible SLO" if float(per_replica) <= 1e-9
                  else f"above the {_SIM_REPLICA_CAP}-replica simulation "
                       "cap")
        warnings.warn(
            f"skipping the simulated cross-check: the plan needs {sim_r} "
            f"replicas ({reason}); run simulate_fork_join directly with "
            "a smaller chunk_size if you really want this",
            UserWarning, stacklevel=2)
    return CapacityPlan(
        n_replicas=n_i,
        servers_per_replica=p,
        total_servers=n_i * p,
        per_replica_rate_qps=rate,
        response_upper_ms=float(hi) * 1e3,
        response_lower_ms=float(lo) * 1e3,
        utilization=float(util),
        response_simulated_ms=sim_ms,
        response_simulated_p95_ms=sim_p95_ms,
        routing=spec.routing if sim_ms is not None else None,
        autoscale=spec.autoscale if sim_ms is not None else None,
        mean_active_replicas=mean_active,
        survive_faults=k_down,
        response_faulted_p95_ms=faulted_p95_ms,
    )


def upgrade_grid(
    lam: float,
    *,
    memory: int = 1,
    cpu_speeds=None,
    disk_speeds=None,
    p: int = 100,
    result_cache: Optional[tuple[float, float]] = None,
    device: DeviceLike = DEFAULT_DEVICE,
) -> Tensor:
    """Fig 13/14 surface: upper-bound R over (cpu_speed x disk_speed)."""
    def speeds(x):
        if x is None:
            return torch.linspace(1.0, 4.0, 7, device=device)
        return as_tensor(x, torch.device(device), torch.float32)

    cs = speeds(cpu_speeds)[:, None]
    ds = speeds(disk_speeds)[None, :]
    s_hit, s_miss, s_disk, hit = MEMORY_TABLE[memory]
    params = ServerParams(
        p=p,
        s_broker=broker_service_time(p, device=device) / cs,
        s_hit=s_hit / cs,
        s_miss=s_miss / cs,
        s_disk=s_disk / ds,
        hit=hit,
    )
    if result_cache is None:
        _, hi = queueing.response_time_bounds(lam, params)
        return hi
    return queueing.response_time_with_result_cache(lam, params,
                                                    *result_cache)
