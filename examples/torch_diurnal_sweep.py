"""Plan for the daily peak, not the daily average, on the PyTorch port.

The paper's Section 4.2 shows query traffic is Poisson only *within* a
stable window — across a day the rate swings by ~4x.  The streaming
simulator takes that load as a rate profile that modulates every
scenario's arrival rate chunk by chunk, and its histogram gives p95/p99
surfaces next to the means.

For the Table 5 workload: what is the cheapest server count whose **p95
survives the diurnal peak**, versus the cheaper answer you get by
(mis)planning against the **mean under stationary load** at the same
average rate?

Run:  PYTHONPATH=src python examples/torch_diurnal_sweep.py
      [--device cpu]     (default: cuda)
"""

import argparse

from repro_torch.core import capacity, planner, sweep
from repro_torch.workloadgen import loadgen

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

MS = 1e3
SLO = 0.8          # seconds
N_QUERIES = 40_000

lam = [14.0, 20.0]                          # time-AVERAGED rates (qps)
grid = sweep.SweepGrid.build(
    lam=lam, p=[4.0, 8.0], cpu=[1.0, 2.0, 4.0],
    base=capacity.TABLE5_PARAMS, hit=[0.17], broker_from_p=False,
    device=dev)
cost = sweep.default_config_cost

print("== Frontier 1: stationary load, mean response <= SLO ==")
_, fr_mean = planner.plan_over_grid(
    grid, SLO, simulate=True, seed=0, n_queries=N_QUERIES, cost_fn=cost)
for i in range(len(lam)):
    print("  ", fr_mean.describe(i))

print("\n== Frontier 2: diurnal load (4x peak/trough), p95 <= SLO ==")
profile = loadgen.diurnal_rates(1.0, device=dev)   # weekly, relative
# compress the week so the simulated horizon covers multiple full cycles
horizon_s = N_QUERIES / lam[0]
bin_s = horizon_s / profile.shape[0] / 4
res95, fr_p95 = planner.plan_over_grid(
    grid, SLO, simulate=True, seed=0, n_queries=N_QUERIES, cost_fn=cost,
    quantile=0.95, profile=profile, profile_bin_seconds=bin_s)
for i in range(len(lam)):
    print("  ", fr_p95.describe(i))

print("\n== The gap ==")
for i in range(len(lam)):
    c_mean, c_p95 = float(fr_mean.cost[i]), float(fr_p95.cost[i])
    print(f"  lam={lam[i]:g} qps: mean-planning costs "
          f"{c_mean:g}; surviving the daily peak at p95 costs {c_p95:g}"
          + ("  <- UNDER-PROVISIONED by mean-planning"
             if c_p95 > c_mean else ""))

print("\np95 surface along cpu speedup (lam = {:.0f} qps, p=4, diurnal):"
      .format(lam[1]))
p95 = res95.quantile(0.95)
for j in range(grid.cpu.shape[0]):
    v = float(p95[1, 0, j, 0, 0, 0]) * MS   # trailing axis: r = 1 replica
    print(f"  cpu x{float(grid.cpu[j]):g}: p95 = {v:7.1f} ms "
          + ("(meets SLO)" if v <= SLO * MS else ""))
