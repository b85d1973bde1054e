"""Web-scale capacity planning on the PyTorch port: the SNIPPETS.md global
sizing exercise on a MILLION-scenario sharded sweep.

The SCALE_LOAD_ESTIMATIONS document (SNIPPETS.md) plans a global search
deployment top-down: ~38.58M queries/s globally (100B queries/month),
split across 4 regions -> ~9.65M qps per region.  It then sizes workers
by dividing rates by an ASSUMED per-worker throughput.  This example
replaces that assumption with the paper's queueing model, evaluated over
a 1,000,000-scenario what-if grid

    lam x p x cpu-speedup x disk-speedup x cache-hit x replicas

scenario-sharded over every visible card (`launch.mesh.make_sweep_mesh`):
the frontier picks the cheapest replicated cluster cell that honors the
SLO, and dividing the regional rate by the cell's arrival rate gives the
fleet size.  A scenario-sharded run of the fused replicated simulator
then cross-checks the chosen cell's analytic bound mechanistically.

Run:  PYTHONPATH=src python examples/torch_global_sweep.py
      [--device cpu] [--quick]
(default: a mesh of every visible CUDA device; ``--device cpu`` shards
over eight copies of the CPU, the reference's eight virtual devices)
"""

import argparse
import math
import time

import torch

from repro_torch.core import capacity, sweep
from repro_torch.launch.mesh import make_sweep_mesh

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--quick", action="store_true",
                help="small grid + short simulation horizon")
args = ap.parse_args()
dev = torch.device(args.device)

MS = 1e3
SLO = 0.650                 # s; must sit above the H_100 join-tax floor
REGIONS = 4
GLOBAL_QPS = 38.58e6        # the SNIPPETS exercise's ~38M qps target
CACHE = (0.2, 2e-3)


def sync():
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


print("== The workload (SNIPPETS SCALE_LOAD_ESTIMATIONS) ==")
region_qps = GLOBAL_QPS / REGIONS
print(f"  global: {GLOBAL_QPS / 1e6:.2f}M queries/s (~38M qps)")
print(f"  per region ({REGIONS} regions): {region_qps / 1e6:.2f}M qps, "
      f"{region_qps * 86_400 / 1e9:.0f}B queries/day, "
      f"{100e9 / REGIONS / 1e9:.0f}B queries/month of the stated "
      "100B global")

print("\n== Million-scenario planning surface ==")
mesh = (make_sweep_mesh(devices=["cpu"] * 8) if dev.type == "cpu"
        else make_sweep_mesh())
print(f"  mesh: {mesh.size} devices ({', '.join(map(str, mesh.devices))})"
      f", axes {mesh.axis_names}")
if args.quick:
    grid = sweep.SweepGrid.build(
        lam=torch.linspace(10.0, 120.0, 10), p=[50.0, 100.0],
        cpu=[1.0, 2.0], disk=[1.0, 2.0], hit=torch.linspace(0.05, 0.95, 5),
        r=[1.0, 2.0, 4.0], base=capacity.TABLE5_PARAMS,
        result_cache=CACHE, device=dev)
else:
    grid = sweep.SweepGrid.build(
        lam=torch.linspace(10.0, 120.0, 100), p=[50.0, 100.0, 200.0, 400.0],
        cpu=torch.linspace(1.0, 3.0, 5), disk=torch.linspace(1.0, 3.0, 5),
        hit=torch.linspace(0.05, 0.95, 20), r=[1.0, 2.0, 4.0, 8.0, 16.0],
        base=capacity.TABLE5_PARAMS, result_cache=CACHE, device=dev)
sweep.sweep_analytical(grid, mesh=mesh)       # first call: allocator
sync()
t0 = time.perf_counter()
result = sweep.sweep_analytical(grid, mesh=mesh)
sync()
dt = time.perf_counter() - t0
print(f"  {grid.n_scenarios:,} scenarios evaluated in {dt * MS:.2f} ms "
      f"({grid.n_scenarios / dt:,.0f} scenarios/s, sharded)")

frontier = sweep.extract_frontier(result, SLO)
i_best = int(torch.argmax(torch.where(
    frontier.feasible, grid.lam / frontier.cost,
    torch.tensor(-math.inf, device=dev))))
print(f"  best qps-per-cost cell under R <= {SLO * MS:.0f} ms:")
print("   ", frontier.describe(i_best))

print("\n== Sizing the global fleet from the chosen cell ==")
lam_cell = float(grid.lam[i_best])
p_c = int(round(float(frontier.p[i_best])))
r_c = int(round(float(frontier.r[i_best])))
cells_region = math.ceil(region_qps / lam_cell)
servers_global = REGIONS * cells_region * r_c * (p_c + 1)
print(f"  cell serves {lam_cell:.0f} qps -> "
      f"{cells_region:,} cells/region x {REGIONS} regions")
print(f"  fleet: {servers_global / 1e6:.1f}M index+broker servers "
      f"({r_c} replicas x {p_c} servers + broker per cell) vs the "
      "SNIPPETS worker-math answer of rate/throughput workers — same "
      "division, but the denominator now carries an SLO guarantee")

print("\n== Sharded simulated cross-check of the chosen cell ==")
n_q = 20_000 if args.quick else 200_000
sim_grid = sweep.SweepGrid.build(
    lam=torch.linspace(0.6 * lam_cell, lam_cell, 8), p=[float(p_c)],
    cpu=[float(frontier.cpu[i_best])], disk=[float(frontier.disk[i_best])],
    hit=[float(frontier.hit[i_best])], r=[float(r_c)],
    base=capacity.TABLE5_PARAMS, result_cache=CACHE, device=dev)
t0 = time.perf_counter()
sim = sweep.sweep_simulated(sim_grid, 0, n_queries=n_q, chunk_size=4096,
                            mesh=mesh)
sync()
dt = time.perf_counter() - t0
ana = sweep.sweep_analytical(sim_grid, mesh=mesh)
print(f"  {sim_grid.n_scenarios} scenarios x {n_q:,} queries "
      f"(fused replicated engine, {mesh.size} shards) in {dt:.2f} s")
ok = True
for k in range(sim_grid.lam.shape[0]):
    m = float(sim.mean.reshape(-1)[k])
    hi = float(ana.response_upper.reshape(-1)[k])
    tag = "ok" if m <= hi * 1.05 else "ABOVE BOUND"
    ok &= m <= hi * 1.05
    print(f"  lam={float(sim_grid.lam[k]):6.1f} qps  simulated mean "
          f"{m * MS:6.1f} ms  <=  Eq7/8 upper {hi * MS:6.1f} ms  [{tag}]")
if not ok:
    raise SystemExit("simulated mean escaped the analytic planning surface")
print("\nall simulated means under the analytic planning surface — the "
      "38M-qps fleet above is sized on a bound the mechanism respects")
