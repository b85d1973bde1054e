"""Paper Section 6 as a dense what-if sweep on the PyTorch port (Figs
9-12 at grid scale).

Sweep the full upgrade space — arrival rate x servers x CPU speedup x
disk speedup, for each Table 6 memory column — over one grid per column,
then extract the constraint frontier: the cheapest configuration that
keeps the Eq 7 upper bound under the 300 ms answer-time constraint.  A
streaming simulation on a sub-grid checks the analytical surface.

Run:  PYTHONPATH=src python examples/torch_whatif_sweep.py
      [--device cpu]     (default: cuda)
"""

import argparse
import time

import torch

from repro_torch.core import capacity, planner, sweep

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

SLO = 0.300          # the paper's 300 ms answer-time constraint
MS = 1e3


def sync():
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


print("== Upgrade sweep: lam x p x cpu x disk, per Table 6 memory column ==")
lam = [16.0, 32.0, 56.0, 80.0]
for mem in (1, 2, 3, 4):
    grid = sweep.SweepGrid.build(
        lam=lam, p=[50.0, 100.0, 150.0, 200.0],
        cpu=torch.linspace(1.0, 4.0, 7), disk=torch.linspace(1.0, 4.0, 7),
        memory=mem, device=dev)
    result, frontier = planner.plan_over_grid(grid, SLO)
    hi = result.response_upper
    feas = float(torch.mean((torch.isfinite(hi) & (hi <= SLO)).float()))
    print(f"\n  memory {mem}x — {grid.n_scenarios} scenarios, "
          f"{feas:5.1%} meet the SLO")
    for i in range(len(lam)):
        print("   ", frontier.describe(i))

print("\n== The paper's Scenario 4 point, read off the same surface ==")
grid4 = sweep.SweepGrid.build(lam=[56.0], p=[100.0], cpu=[4.0], disk=[4.0],
                              memory=4, device=dev)
res4 = sweep.sweep_analytical(grid4)
print(f"  R_upper(56 qps | mem 4x, cpu 4x, disk 4x, p=100) = "
      f"{float(res4.response_upper.reshape(())) * MS:.0f} ms (paper: 286 ms)")

print("\n== Simulation cross-check on a sub-grid (streaming engine) ==")
sub = sweep.SweepGrid.build(lam=[10.0, 20.0], p=[8.0],
                            base=capacity.TABLE5_PARAMS, hit=[0.17],
                            broker_from_p=False, device=dev)
sim = sweep.sweep_simulated(sub, 0, n_queries=60_000)
ana = sweep.sweep_analytical(sub)
p95 = sim.quantile(0.95)
for i, l in enumerate([10.0, 20.0]):
    lo = float(ana.response_lower[i].reshape(())) * MS
    hi = float(ana.response_upper[i].reshape(())) * MS
    m = float(sim.mean[i].reshape(())) * MS
    q = float(p95[i].reshape(())) * MS
    inside = "within bounds" if lo <= m <= hi * 1.02 else "OUT OF BOUNDS"
    print(f"  lam={l:4.0f}: simulated {m:6.1f} ms (p95 {q:6.1f} ms) vs "
          f"Eq 7 [{lo:.1f}, {hi:.1f}] ms — {inside}")

print("\n== Throughput: the whole grid in one call ==")
big = sweep.SweepGrid.build(
    lam=torch.linspace(1.0, 80.0, 20), p=torch.linspace(20.0, 200.0, 10),
    cpu=torch.linspace(1.0, 4.0, 7), disk=torch.linspace(1.0, 4.0, 7),
    hit=torch.linspace(0.02, 0.30, 8), device=dev)
out = sweep.sweep_analytical(big).response_upper
sync()
t0 = time.perf_counter()
out = sweep.sweep_analytical(big).response_upper
sync()
dt = time.perf_counter() - t0
where = (torch.cuda.get_device_name(0) if torch.device(dev).type == "cuda"
         else "cpu")
print(f"  {big.n_scenarios} scenarios in {dt * MS:.1f} ms "
      f"({big.n_scenarios / dt / 1e6:.1f}M scenarios/s on {where}); "
      f"{float(torch.mean(torch.isfinite(out).float())):5.1%} below "
      "saturation")
