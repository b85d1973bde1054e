"""Which autoscaler config is cheapest under the p95 SLO? (PyTorch port)

The paper sizes a FIXED fleet for the peak (Section 6); a real vertical
deployment scales replicas against load and pays for replica-seconds,
not peak replicas.  This example sweeps `AutoscalePolicy` configs —
(min_r, max_r, utilization trigger, stabilization window) — as a grid
axis over a diurnal + flash-crowd week and extracts the cheapest policy
whose p95 survives, then cross-checks it against the static-r plan the
paper would buy: the autoscaled fleet must meet the same SLO with fewer
replica-seconds.  It mirrors examples/autoscale_sweep.py, the winning
policy's active-replica trajectory (a telemetry `Timeline`) included.

The "week" is time-compressed (a few seconds per hourly bin) so the
whole diurnal + crowd shape fits in a tractable query budget; policy
decision intervals are scaled to match.

Run:  PYTHONPATH=src python examples/torch_autoscale_sweep.py
      [--device cpu] [--quick]     (default device: cuda)
"""

import argparse

from repro_torch.core import planner, simulator, sweep
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.queueing import ServerParams
from repro_torch.launch.elastic import AutoscalePolicy
from repro_torch.obs import TelemetrySpec
from repro_torch.workloadgen import loadgen

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--quick", action="store_true",
                help="smoke mode: fewer queries, fewer policies")
args = ap.parse_args()
dev = args.device

MS = 1e3
SLO = 0.65                     # p95 objective (s)
LAM = [15.0, 30.0]             # time-averaged total qps
BIN_S = 2.0                    # seconds per "hour" of the compressed week
N_Q = 8_000 if args.quick else 80_000
CHUNK = 64                     # small: every ~2s profile bin gets sampled

# a small Table-5-flavored cluster (p=4) so one replica saturates inside
# the sweep's rates and the policy axis has real work to do
PARAMS = ServerParams(p=4, s_broker=0.004, s_hit=0.0125, s_miss=0.05,
                      s_disk=0.04, hit=0.5)

# -- the load: a diurnal week with a flash crowd on Wednesday 15:00 -----
week = loadgen.diurnal_rates(1.0, peak_to_trough=3.0, device=dev)
crowd_hour = 2 * 24 + 15
week[crowd_hour] *= 2.5                                   # the crowd
profile = week / week.mean()                              # mean-1 curve

# -- the policy grid: (min_r, max_r, trigger, stabilization window) ------
# decision interval ~= one compressed hour; stabilization counts intervals
policies = tuple(
    AutoscalePolicy(min_r=mn, max_r=mx, target_utilization=trig,
                    decision_interval_seconds=BIN_S,
                    stabilization_intervals=stab)
    for mn in (1,)
    for mx in ((4,) if args.quick else (2, 4))
    for trig in ((0.6, 0.8) if args.quick else (0.45, 0.6, 0.75))
    for stab in (2, 6)
)
print(f"== {len(policies)} autoscaler configs x {len(LAM)} rates over a "
      f"diurnal + flash-crowd week (p95 <= {SLO * MS:.0f} ms) [{dev}] ==")

sim_kw = dict(simulate=True, quantile=0.95, n_queries=N_Q, seed=7,
              profile=profile, profile_bin_seconds=BIN_S, chunk_size=CHUNK,
              cluster=ClusterSpec(routing="jsq"))
grid = sweep.SweepGrid.build(lam=LAM, p=[4.0], hit=[PARAMS.hit],
                             base=PARAMS, broker_from_p=False,
                             autoscale=policies, device=dev)
_, frontier = planner.plan_over_grid(grid, SLO, **sim_kw)
for i in range(len(LAM)):
    print("  ", frontier.describe(i))

# -- cross-check: the static-r fleet the paper would buy ----------------
static = sweep.SweepGrid.build(lam=LAM, p=[4.0], hit=[PARAMS.hit],
                               base=PARAMS, broker_from_p=False,
                               r=[1.0, 2.0, 3.0, 4.0], device=dev)
_, static_front = planner.plan_over_grid(static, SLO, **sim_kw)

print("\n== Elastic vs static at equal SLO compliance ==")
for i, lam in enumerate(LAM):
    if not (bool(frontier.feasible[i]) and bool(static_front.feasible[i])):
        print(f"  lam={lam:g}: infeasible somewhere "
              f"(elastic {bool(frontier.feasible[i])}, "
              f"static {bool(static_front.feasible[i])})")
        continue
    eff = float(frontier.r[i])            # mean active replicas
    stat = float(static_front.r[i])       # peak-provisioned replicas
    saved = (1.0 - eff / stat) * 100.0
    verdict = "OK" if eff <= stat + 1e-6 else "WORSE (unexpected)"
    print(f"  lam={lam:g} qps: autoscaled {eff:.2f} replica-s/s vs "
          f"static r={stat:.0f} -> {saved:.0f}% replica-seconds saved "
          f"[{verdict}]")

# -- the winning policy's trajectory through the week -------------------
i = len(LAM) - 1
winner = frontier.autoscale[i]
if winner is not None:
    arrival = ArrivalProcess.piecewise(float(LAM[i]) * profile, BIN_S,
                                       device=dev)
    res = simulator.simulate_fork_join(
        11, arrival, N_Q, PARAMS, chunk_size=CHUNK,
        cluster=ClusterSpec(routing="jsq", autoscale=winner),
        telemetry=TelemetrySpec(n_bins=28), device=dev)
    tl = res.timeline
    act = tl.active_replicas.where(tl.count > 0, float("nan"))
    print(f"\n== Active-replica trajectory (lam={LAM[i]:g}, policy "
          f"{winner.min_r}..{winner.max_r}@{winner.target_utilization:.0%},"
          f" stab={winner.stabilization_intervals}) ==")
    blocks = " .:-=+*#"
    lo, hi = 1.0, float(winner.max_r)
    cells = []
    for v in act.tolist():
        if v != v:                        # NaN: bin saw no arrivals
            cells.append(" ")
            continue
        t = (v - lo) / max(hi - lo, 1e-9)
        cells.append(blocks[min(len(blocks) - 1,
                                max(0, int(t * (len(blocks) - 1) + 0.5)))])
    print("  fleet  |" + "".join(cells) + f"|  ({lo:.0f}..{hi:.0f} "
          "replicas)")
    print(f"  mean active {float(res.mean_active_replicas):.2f} of "
          f"{winner.max_r} provisioned; replica-seconds "
          f"{float(res.replica_seconds):.0f} over "
          f"{float(res.elapsed_seconds):.0f} s; p95 "
          f"{float(res.quantile(0.95)) * MS:.0f} ms")
