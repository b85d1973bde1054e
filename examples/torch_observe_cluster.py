"""Observing a replicated cluster through a flash crowd (PyTorch port).

A capacity plan says what a cluster can sustain *on average*; the
observability layer shows what actually happens inside one run.  This
example replays the paper's Table-5 cluster (p=8 index servers) as
three JSQ-routed replicas through a flash crowd — a 4x arrival burst in
the middle of the horizon — and renders the port's observability views,
as examples/observe_cluster.py does (without its roofline table):

  * streaming TIMELINES (`repro_torch.obs.TelemetrySpec`): per-time-bin
    throughput, utilization, queue depth, SLO violations and routing
    imbalance, accumulated chunk by chunk at O(n_bins) memory — the
    burst is visible, the mean hides it;
  * operational-law self-checks: the binned telemetry satisfies
    U = X * S and L = lambda * W per bin as identities;
  * a SPAN TRACE (`repro_torch.obs.trace_export`): a bounded window of
    the same scenario as Chrome-trace JSON — open the file in
    chrome://tracing or https://ui.perfetto.dev;
  * kernel PROFILES (`repro_torch.obs.profile`): first-call time, bytes
    and peak memory of the (max,+) kernel stack.

Run:   PYTHONPATH=src python examples/torch_observe_cluster.py \
           [--device cpu] [--quick] [--trace-json PATH]
       (default device: cuda; default trace path: cluster_trace.json in
       the temporary directory, which follows TMPDIR)
"""

import argparse
import pathlib
import tempfile

from repro_torch.core import capacity, simulator
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec
from repro_torch.obs import TelemetrySpec
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace_export

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--quick", action="store_true",
                help="short horizon + tiny span window (smoke)")
ap.add_argument("--trace-json",
                default=str(pathlib.Path(tempfile.gettempdir())
                            / "cluster_trace.json"),
                help="where to write the Chrome-trace span export")
args = ap.parse_args()
dev = args.device

R, ROUTING, LAM, SLO = 3, "jsq", 24.0, 0.7
N_QUERIES = 4_000 if args.quick else 40_000
N_SPAN = 300 if args.quick else 2_000
BINS = 32 if args.quick else 64

params = capacity.TABLE5_PARAMS
horizon = N_QUERIES / (LAM * 1.6)
flash = ArrivalProcess.flash_crowd(
    LAM, burst_starts=0.35 * horizon, burst_seconds=0.2 * horizon,
    burst_multiplier=4.0, period_seconds=horizon,
    bin_seconds=horizon / 64, device=dev)

print(f"== scenario: flash crowd (lam {LAM:g} qps x4 burst), "
      f"r={R} {ROUTING}, p={int(params.p)}, SLO {SLO:g}s [{dev}] ==\n")

# 1. streaming timelines — one extra keyword on the normal entry point
spec = TelemetrySpec(n_bins=BINS, slo_seconds=SLO)
res = simulator.simulate_fork_join(
    0, flash, N_QUERIES, params, cluster=ClusterSpec(r=R, routing=ROUTING),
    telemetry=spec, device=dev)
print(obs_report.render_timeline(res.timeline, "flash crowd replay"))
print()

# 2. the telemetry proves itself: U = X*S and L = lam*W per bin
law_report, worst = obs_report.oplaw_check(res.timeline)
print(law_report)
if worst > 1e-3:
    raise SystemExit(f"operational-law self-check FAILED ({worst:.2e})")
print()

# 3. span trace of a bounded window of the same scenario
spans = trace_export.simulate_spans(0, flash, N_SPAN, params, r=R,
                                    routing=ROUTING, device=dev)
path = trace_export.export_chrome_trace(spans, args.trace_json)
counts = trace_export.validate_chrome_trace(path)
print(f"== span trace ==\n  {path} — {counts['X']} service spans, "
      f"{counts['async_pairs']} query lifetimes, {counts['lanes']} FCFS "
      f"lanes; schema OK\n  (open in chrome://tracing or "
      f"ui.perfetto.dev)")
print()

# 4. kernel profiles
records = obs_profile.profile_kernels(n_runs=0 if args.quick else 3,
                                      device=dev)
print(obs_report.render_profiles(records))

assert pathlib.Path(path).stat().st_size > 0
print("\nobserve_cluster: OK")
