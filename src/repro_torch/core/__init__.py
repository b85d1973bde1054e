"""Core: the analytical model, the load, the streaming simulator and the
planning layer built on them.

Modules:
  queueing   — the analytical model (Eq 1-8, fork-join bounds)
  arrivals   — piecewise-rate / trace arrival processes
  cluster    — ClusterSpec, the simulated topology
  faults     — FaultSpec, outage masks, degraded and partial results
  simulator  — streaming (max,+) fork-join simulator, replicated cluster
  capacity   — Section-6 tables, SLO solver, replica sizing, plans
  sweep      — what-if grids, analytic and simulated surfaces, frontiers
  planner    — plan_over_grid, and serving plans for LM cells
  workload   — distribution fits, Zipf, folding (Sec 4)
  imbalance  — disk-cache model of per-server imbalance (Sec 3.4)
"""

from repro_torch.core.queueing import (  # noqa: F401
    ServerParams,
    harmonic_number,
    service_time_server,
    mm1_residence_time,
    utilization,
    fork_join_lower_bound,
    fork_join_upper_bound,
    response_time_bounds,
    response_time_with_result_cache,
    saturation_rate,
)

__all__ = ["ServerParams", "harmonic_number", "service_time_server",
           "mm1_residence_time", "utilization", "fork_join_lower_bound",
           "fork_join_upper_bound", "response_time_bounds",
           "response_time_with_result_cache", "saturation_rate"]
