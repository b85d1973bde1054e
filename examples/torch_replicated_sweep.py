"""Replicate, upgrade, or cache?  The Section-6 scale-out question as
one frontier extraction (PyTorch port of examples/replicated_sweep.py).

The paper sizes replicated clusters analytically (``replicas_needed``,
Eq 8 for the result cache).  The replicated simulation layer lets the
same question be answered three ways on one grid —

  * buy REPLICAS of the cheap memory-1x cluster,
  * buy the memory-4x UPGRADE and replicate less,
  * keep memory-1x but add a broker RESULT CACHE (Eq 8),

— and then cross-checks the winning plan mechanistically: the replicated
streaming simulator runs the chosen topology under join-shortest-queue
routing and a flash-crowd arrival profile, reporting the p95 the
analytical path cannot see.  Seeds 0 and 1 stand for the reference's
``PRNGKey(0)`` and ``PRNGKey(1)``.

Run:  PYTHONPATH=src python examples/torch_replicated_sweep.py
      [--device cpu] [--quick]     (default device: cuda)
"""

import argparse

import torch

from repro_torch.core import capacity, planner, simulator, sweep
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec

# The H_100 join tax puts the memory-1x cluster's latency FLOOR at
# ~520 ms (the paper's "baseline is infeasible even at very low rates"),
# so the constraint must sit above it for replication to compete at all.
SLO = 0.650
MS = 1e3
LAM = (10.0, 20.0, 40.0)            # total qps to serve
REPLICAS = tuple(float(r) for r in range(1, 13))
TARGET = 40.0                       # the cross-checked rate (qps)
PLAN_QUERIES = 60_000               # plan_capacity's simulated run
CROWD_QUERIES = 150_000
CROWD_CHUNK = 1024
CROWD = dict(burst_starts=[600.0], burst_seconds=300.0,
             burst_multiplier=3.0, period_seconds=1800.0, bin_seconds=60.0)


def frontiers(device) -> dict:
    """Each strategy's cheapest feasible configuration per rate, each
    strategy a grid over REPLICAS."""
    kw = dict(lam=list(LAM), p=[100.0], r=list(REPLICAS), device=device)
    strategies = {
        "replicate memory-1x": sweep.SweepGrid.build(memory=1, **kw),
        "upgrade to memory-4x": sweep.SweepGrid.build(memory=4, **kw),
        "memory-1x + result cache":
            sweep.SweepGrid.build(memory=1, result_cache=(0.3, 2e-3), **kw),
    }
    return {name: planner.plan_over_grid(grid, SLO)[1]
            for name, grid in strategies.items()}


def head_to_head(fronts: dict) -> list:
    """Per rate: ({strategy: cost, inf where infeasible}, the cheapest)."""
    out = []
    for i in range(len(LAM)):
        costs = {n: float(f.cost[i]) if bool(f.feasible[i])
                 else float("inf") for n, f in fronts.items()}
        out.append((costs, min(costs, key=costs.get)))
    return out


def cross_check(device, *, n_queries: int = PLAN_QUERIES, draws=None):
    """The analytical plan for TARGET on memory-4x, cross-checked by the
    replicated simulator under JSQ dispatch; (params, plan)."""
    params = capacity.scenario_params(memory=4, p=100, device=device)
    plan = capacity.plan_capacity(
        params, TARGET, SLO, simulate=True,
        cluster=ClusterSpec(routing="jsq"), seed=0, n_queries=n_queries,
        draws=draws, device=device)
    return params, plan


def crowd_run(params, r: int, device, *, n_queries: int = CROWD_QUERIES,
              draws=None, impl: str = "auto"):
    """TARGET qps with a 3x flash crowd for 300 s of every 1,800 s
    against r JSQ-routed replicas (seed 1)."""
    crowd = ArrivalProcess.flash_crowd(TARGET, device=device, **CROWD)
    return simulator.simulate_fork_join(
        1, crowd, n_queries, params,
        cluster=ClusterSpec(r=r, routing="jsq"), chunk_size=CROWD_CHUNK,
        impl=impl, draws=draws, device=device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="shorter simulated runs (the CPU's plain JSQ loop)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    # --quick keeps the crowd's first burst (it ends ~60,000 queries in)
    n_plan, n_crowd = ((PLAN_QUERIES // 4, 64 * CROWD_CHUNK) if args.quick
                       else (PLAN_QUERIES, CROWD_QUERIES))

    print(f"== Cheapest way to serve under R <= {SLO * MS:.0f} ms ==")
    fronts = frontiers(dev)
    for name, frontier in fronts.items():
        print(f"\n  {name}:")
        for i in range(len(LAM)):
            print("   ", frontier.describe(i))

    print("\n== Head to head (cost per total arrival rate) ==")
    for lam, (costs, best) in zip(LAM, head_to_head(fronts)):
        row = "  ".join(f"{n}: {c:7.1f}" for n, c in costs.items())
        print(f"  lam={lam:5.0f} qps  {row}   -> {best}")

    print("\n== Mechanistic cross-check of the analytical plan ==")
    params, plan = cross_check(dev, n_queries=n_plan)
    print(f"  replicas_needed -> {plan.n_replicas} replicas x "
          f"{plan.servers_per_replica} servers "
          f"(util {plan.utilization:.2f}); Eq 7 upper "
          f"{plan.response_upper_ms:.0f} ms")
    print(f"  simulated (jsq dispatch, full {TARGET:.0f} qps): mean "
          f"{plan.response_simulated_ms:.0f} ms, p95 "
          f"{plan.response_simulated_p95_ms:.0f} ms")

    print("\n== The same topology under a 3x flash crowd ==")
    # the stationary plan saturates during the burst (3x load on replicas
    # sized for 1x); provisioning replicas for the PEAK restores the tail
    for r in (plan.n_replicas, 3 * plan.n_replicas):
        res = crowd_run(params, r, dev, n_queries=n_crowd)
        p95 = float(res.quantile(0.95))
        tag = "planned" if r == plan.n_replicas else "peak-provisioned"
        print(f"  r={r} ({tag}): mean {float(res.mean_response) * MS:6.0f} "
              f"ms, p95 {p95 * MS:6.0f} ms "
              f"({'meets' if p95 <= SLO else 'MISSES'} the SLO at p95)")


if __name__ == "__main__":
    main()
