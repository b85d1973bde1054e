"""Does the fleet survive losing a replica at the worst moment? (PyTorch
port)

The paper sizes a fleet for peak load (Section 6) assuming every replica
stays up; a real vertical deployment loses machines, and the capacity
question becomes N+k: does the p95 SLO hold while k replicas are down
and failover routing spills their share onto the survivors?  This
example stresses exactly that, as examples/failover_stress.py does
(without its timeline rendering; the port has no timelines yet):

  1. a diurnal + flash-crowd week is replayed against a fixed r-replica
     fleet, fault-free, for the baseline p95;
  2. the same week is replayed with one replica DOWN for the hours
     around the flash crowd (a deterministic `FaultSpec` outage window);
  3. a `SweepGrid` fault axis compares graceful-degradation knobs at
     equal load: full fork-join vs k-of-p partial-quorum merging under
     a broker timeout, with and without the outage;
  4. an N+k plan from `plan_capacity(survive_faults=1)` shows what the
     planner would buy to make step 2 pass by construction.

Run:  PYTHONPATH=src python examples/torch_failover_stress.py
      [--device cpu] [--quick]     (default device: cuda)
"""

import argparse

from repro_torch.core import capacity, simulator, sweep
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.queueing import ServerParams
from repro_torch.workloadgen import loadgen

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--quick", action="store_true",
                help="smoke mode: fewer queries, no simulated N+1 check")
args = ap.parse_args()
dev = args.device

MS = 1e3
SLO = 0.75                     # p95 objective (s)
LAM = 24.0                     # time-averaged total qps
R = 3                          # the provisioned fleet
BIN_S = 2.0                    # seconds per "hour" of the compressed week
N_Q = 6_000 if args.quick else 48_000
CHUNK = 64                     # small: every ~2s profile bin gets sampled

PARAMS = ServerParams(p=4, s_broker=0.004, s_hit=0.0125, s_miss=0.05,
                      s_disk=0.04, hit=0.5)

# -- the load: a diurnal week with a flash crowd on Wednesday 15:00 -----
week = loadgen.diurnal_rates(1.0, peak_to_trough=3.0, device=dev)
crowd_hour = 2 * 24 + 15
week[crowd_hour] *= 2.5
profile = week / week.mean()
arrival = ArrivalProcess.piecewise(LAM * profile, BIN_S, device=dev)

# the outage covers the crowd and the hours around it — the worst window
down_t0, down_t1 = (crowd_hour - 2) * BIN_S, (crowd_hour + 4) * BIN_S
outage = FaultSpec(outages=((0, down_t0, down_t1),))


def run(spec, seed=23):
    return simulator.simulate_fork_join(
        seed, arrival, N_Q, PARAMS, chunk_size=CHUNK, cluster=spec,
        device=dev)


print(f"== failover stress: r={R}, lam={LAM:g} qps avg, flash crowd "
      f"x2.5, p95 SLO {SLO * MS:.0f} ms [{dev}] ==")

base = run(ClusterSpec(r=R, routing="round_robin"))
p95_base = float(base.quantile(0.95))
print(f"  fault-free     p95 {p95_base * MS:7.1f} ms  "
      f"mean {float(base.mean_response) * MS:6.1f} ms")

hit = run(ClusterSpec(r=R, routing="round_robin", fault=outage))
p95_hit = float(hit.quantile(0.95))
ok = p95_hit <= SLO
print(f"  1 replica down p95 {p95_hit * MS:7.1f} ms  "
      f"mean {float(hit.mean_response) * MS:6.1f} ms  "
      f"spill {float(hit.spill_fraction) * 100:.1f}%  "
      f"availability {float(hit.availability) * 100:.2f}%")
print(f"  -> survivors {'HOLD' if ok else 'VIOLATE'} the p95 SLO "
      f"during the outage ({p95_hit * MS:.0f} ms vs {SLO * MS:.0f} ms)")

# -- graceful degradation: full fork-join vs k-of-p quorum --------------
# Under a broker timeout the merge returns with the k fastest servers'
# results; the query is DEGRADED (partial coverage) but fast.  Sweep the
# knob with and without the outage at equal load.
p = int(PARAMS.p)
deadline = 0.6 * SLO
scenarios = (
    None,
    FaultSpec(broker_timeout_seconds=deadline, quorum_k=p - 1),
    FaultSpec(outages=outage.outages),
    FaultSpec(outages=outage.outages,
              broker_timeout_seconds=deadline, quorum_k=p - 1),
)
labels = ("fault-free", f"quorum {p - 1}/{p}", "outage",
          f"outage + quorum {p - 1}/{p}")
grid = sweep.SweepGrid.build(
    lam=[LAM], p=[float(p)], hit=[PARAMS.hit], base=PARAMS,
    broker_from_p=False, r=[float(R)], fault=scenarios, device=dev)
res = sweep.sweep_simulated(
    grid, 5, n_queries=N_Q, chunk_size=CHUNK, profile=profile,
    profile_bin_seconds=BIN_S, cluster=ClusterSpec(routing="round_robin"))
p95s = res.quantile(0.95).reshape(-1)
degr = res.stats.degraded_fraction.reshape(-1)
print("\n== degraded operation vs full fork-join (same week, same fleet) ==")
for j, lab in enumerate(labels):
    d = float(degr[j])
    note = f"  degraded {d * 100:5.1f}%" if d > 0 else ""
    flag = "ok " if float(p95s[j]) <= SLO else "SLO"
    print(f"  {lab:<22} p95 {float(p95s[j]) * MS:7.1f} ms [{flag}]{note}")

# -- what would the planner buy to survive this? ------------------------
plan = capacity.plan_capacity(
    PARAMS, LAM * float(profile.max()), SLO, survive_faults=1,
    simulate=not args.quick, seed=3, n_queries=max(4_000, N_Q // 4),
    device=dev)
print("\n== N+1 plan for the peak rate ==")
print(f"  {plan.n_replicas} replicas x {plan.servers_per_replica} servers "
      f"(k={plan.survive_faults} spare) -> "
      f"{plan.total_servers} servers total")
if plan.response_faulted_p95_ms is not None:
    fok = plan.response_faulted_p95_ms <= SLO * MS
    print(f"  simulated p95 with {plan.survive_faults} replica down: "
          f"{plan.response_faulted_p95_ms:.1f} ms "
          f"[{'holds SLO' if fok else 'exceeds SLO'}]")
