"""The measure -> fit -> validate -> plan loop on the PyTorch port.

The port of examples/calibrate_and_plan.py, in three acts:

1. **Measure** a "running system" — the fork-join simulator driven by a
   flash-crowd `ArrivalProcess` (baseline qps with recurring burst
   windows, the fit-stability stress case: windows sweep a wide range of
   utilizations) with ground-truth Table-5 parameters the fit never sees.
2. **Fit + validate** — closed-form moment matching recovers the Eq-1
   decomposition, Gauss-Newton fits the Sec-3.4 imbalance blend, and the
   held-out report compares calibrated model vs measurements vs the
   calibrated simulator (the paper's Sec 5.3 discipline).
3. **Plan** — the calibrated parameters drop into `plan_capacity` and a
   `plan_over_grid` what-if sweep: the Section-6 manager answer computed
   from measurements alone.

`--engine` appends the instrumented toy engine: document-partitioned
index shards timed under a query stream (`measure_engine_trace`, the
scorer and the broker merge on the device), then calibrated — with the
(max,+) replay residual too, which runs the CUDA scan and its tangent on
the card — and planned the same way.  `--quick` shrinks the trace for
the CPU.

Run:  PYTHONPATH=src python examples/torch_calibrate_and_plan.py
      [--engine] [--quick] [--device cpu]     (default: cuda)
"""

import argparse
import dataclasses

import torch

from repro_torch.calibrate import (calibrate, calibrate_and_validate,
                                   measure_engine_trace, plan_from_trace,
                                   simulate_trace)
from repro_torch.core import capacity, planner, sweep
from repro_torch.core.arrivals import ArrivalProcess

SLO = 0.300
TARGET_QPS = 120.0


def print_params(tag, p):
    print(f"  {tag}: S_broker={float(p.s_broker) * 1e3:.2f}ms "
          f"S_hit={float(p.s_hit) * 1e3:.2f}ms "
          f"S_miss={float(p.s_miss) * 1e3:.2f}ms "
          f"S_disk={float(p.s_disk) * 1e3:.2f}ms hit={float(p.hit):.3f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=60_000)
    ap.add_argument("--engine", action="store_true",
                    help="also calibrate the instrumented toy engine")
    ap.add_argument("--quick", action="store_true",
                    help="a 12,000-query trace (for the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    n_queries = 12_000 if args.quick else args.queries

    print("== 1. measure: flash-crowd load on the 'production' cluster ==")
    true_params = dataclasses.replace(capacity.TABLE5_PARAMS, p=4)
    crowd = ArrivalProcess.flash_crowd(
        10.0, burst_starts=[900.0], burst_seconds=450.0,
        burst_multiplier=2.2, period_seconds=1800.0, bin_seconds=60.0,
        device=dev)
    print(f"  baseline 10 qps, bursts to {float(crowd.peak_rate):.0f} qps "
          f"(mean {float(crowd.mean_rate):.1f} qps)")
    trace = simulate_trace(0, crowd, n_queries, true_params, device=dev)
    print(f"  trace: {trace.n_queries} queries x {trace.p} servers, "
          f"span {float(trace.arrival[-1] - trace.arrival[0]):.0f}s")

    print("\n== 2. fit + validate (last 25% of the trace held out) ==")
    cal, report = calibrate_and_validate(trace, n_windows=24,
                                         holdout_fraction=0.25)
    print_params("true  ", true_params)
    print_params("fitted", cal.params)
    print(f"  imbalance blend alpha={float(cal.alpha):.3f} "
          f"(0 = Eq 7 lower bound, 1 = H_p upper bound)")
    print(report.summary())

    print("\n== 3. plan from the calibration ==")
    cal2, plan = plan_from_trace(trace, TARGET_QPS, SLO, n_windows=18)
    print(f"  {TARGET_QPS:.0f} qps @ {SLO * 1e3:.0f}ms SLO -> "
          f"{plan.n_replicas} replicas x {plan.servers_per_replica} "
          f"servers = {plan.total_servers} total "
          f"(R_upper {plan.response_upper_ms:.0f}ms, "
          f"util {plan.utilization:.2f})")

    grid = sweep.SweepGrid.build(
        lam=[10.0, 16.0, 22.0], p=[4.0, 8.0, 16.0], cpu=[1.0, 2.0],
        disk=[1.0, 2.0], base=cal.to_server_params(),
        hit=[float(cal.params.hit)], broker_from_p=False, device=dev)
    _, frontier = planner.plan_over_grid(grid, SLO)
    print("  cheapest calibrated config per rate (analytic Eq-7 surface):")
    for i in range(grid.lam.shape[0]):
        print(f"    {frontier.describe(i)}")

    if args.engine:
        print("\n== 4. the same loop on the instrumented toy engine ==")
        import numpy as np

        from repro_torch.engine import corpus as corpus_lib
        from repro_torch.engine import partition, server
        from repro_torch.kernels.maxplus_scan import ops as mp_ops
        from repro_torch.workloadgen import loadgen, querygen

        ccfg = corpus_lib.CorpusConfig(n_docs=3000, vocab_size=2000,
                                       mean_doc_len=40, seed=0)
        corp = corpus_lib.generate_corpus(ccfg)
        parts = partition.partition_documents(corp, 2)
        shards = [server.IndexServer(ix, k_local=10, device=dev)
                  for ix in parts.shards]
        uni = querygen.build_universe(querygen.WorkloadConfig(
            "calib", n_unique_queries=1500, vocab_size=2000, seed=0))
        n_q = 2048
        _, qterms = querygen.sample_query_stream(uni, n_q, seed=3)
        arrivals = loadgen.poisson_arrivals(50.0, n_q / 50.0, seed=5)[:n_q]
        etrace = measure_engine_trace(
            shards, np.asarray(qterms), arrivals,
            cache_bytes=2_000_000, batch=64)
        ecal, eplan = plan_from_trace(etrace, 200.0, SLO, n_windows=8)
        print_params("engine", ecal.params)
        print(f"  alpha={float(ecal.alpha):.3f}; plan for 200 qps @ "
              f"{SLO * 1e3:.0f}ms: {eplan.n_replicas} x "
              f"{eplan.servers_per_replica} servers "
              f"(R_upper {eplan.response_upper_ms:.1f}ms)")
        mp_ops.reset_launch_count()
        mcal = calibrate(etrace, n_windows=8, residual="maxplus", n_iters=4)
        launches = mp_ops.launch_count()
        print(f"  (max,+) replay fit: s_scale={float(mcal.s_scale):.4f} "
              f"alpha={float(mcal.alpha):.3f} ({launches} CUDA scan "
              f"launches{'' if torch.device(dev).type == 'cuda' else ': the plain scan ran'})")


if __name__ == "__main__":
    main()
