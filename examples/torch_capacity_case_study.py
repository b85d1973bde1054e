"""Paper Section 6, end to end, on the PyTorch port: the 1-billion-page
case study.

100 index servers x 10M pages each; evaluate Scenarios 1-6 and print the
replication answer.  All numbers check against the paper's published
values (286 ms @ 56 qps, 4x100 replicas; with result caching 282 ms @ 65
qps, 3x100).  The plan for 200 qps is cross-checked by the replicated
streaming simulator under random routing.

Run:  PYTHONPATH=src python examples/torch_capacity_case_study.py
      [--device cpu]     (default: cuda)
"""

import argparse

import torch

from repro_torch.core import capacity, queueing
from repro_torch.core.cluster import ClusterSpec

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

SLO = 0.300
TARGET_QPS = 200.0

print("== Table 6 parameters (p=100, b=10M pages) ==")
for mem in (1, 2, 3, 4):
    s_hit, s_miss, s_disk, hit = capacity.MEMORY_TABLE[mem]
    print(f"  memory {mem}x: S_hit={s_hit * 1e3:.2f}ms "
          f"S_miss={s_miss * 1e3:.2f}ms S_disk={s_disk * 1e3:.2f}ms "
          f"hit={hit:.2f}")

print("\n== Scenario sweep (upper bound on R at selected rates) ==")
lam_grid = torch.tensor([1.0, 4.0, 16.0, 32.0, 56.0], device=dev)
for name in ("baseline", "memory+disks", "memory+cpus", "cpus+disks",
             "memory+cpus+disks"):
    params = capacity.scenario(name, device=dev)
    hi = capacity.upper_bound_curve(lam_grid, params)
    vals = " ".join(f"{v * 1e3:7.0f}" if v != float("inf") else "    sat"
                    for v in hi.tolist())
    print(f"  {name:20s} R(ms) @ {lam_grid.tolist()}: {vals}")

print("\n== Scenario 4: the paper's headline numbers ==")
p4 = capacity.scenario("memory+cpus+disks", device=dev)
_, hi = queueing.response_time_bounds(56.0, p4)
print(f"  R_upper(56 qps) = {float(hi) * 1e3:.0f} ms   (paper: 286 ms)")
plan = capacity.plan_capacity(p4, TARGET_QPS, SLO, simulate=True,
                              cluster=ClusterSpec(routing="random"))
print(f"  plan for {TARGET_QPS:.0f} qps @ {SLO * 1e3:.0f} ms: "
      f"{plan.n_replicas} replicas x {plan.servers_per_replica} = "
      f"{plan.total_servers} servers   (paper: 4 x 100 = 400)")
print(f"  simulated (random routing, {plan.n_replicas} replicas): mean "
      f"{plan.response_simulated_ms:.0f} ms, p95 "
      f"{plan.response_simulated_p95_ms:.0f} ms; Eq 7 "
      f"[{plan.response_lower_ms:.0f}, {plan.response_upper_ms:.0f}] ms")

print("\n== Scenario 6: application-level result caching (Eq 8) ==")
r65 = queueing.response_time_with_result_cache(65.0, p4, 0.5, 0.069e-3)
print(f"  R(65 qps | hit_r=0.5) = {float(r65) * 1e3:.0f} ms "
      f"(paper: 282 ms)")
plan6 = capacity.plan_capacity(
    p4, 195.0, SLO, cluster=ClusterSpec(result_cache=(0.5, 0.069e-3)))
print(f"  plan for 195 qps: {plan6.n_replicas} x 100 "
      f"(paper: 3 x 100 at 65 qps each)")

print("\n== beyond-paper: q-percentile answer (paper future work) ==")
for q in (0.5, 0.95, 0.99):
    t = queueing.response_time_quantile_upper(56.0, p4, q)
    print(f"  p{int(q * 100):02d} upper estimate @56 qps: "
          f"{float(t) * 1e3:.0f} ms")
