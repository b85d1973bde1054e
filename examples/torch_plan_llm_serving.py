"""The paper's capacity-planning methodology applied to the registry's
architectures (PyTorch port): read the dry-run roofline records and
produce Section-6 style serving plans per (arch x shape).

"How many 256-chip serving cells does qwen3-8b decode_32k need for 500
req/s under a 600 ms SLO?" — answered the way the paper sizes search
clusters: each serving shape's step time, the record's roofline terms
on `repro_torch.core.planner.H100_SXM` summed (no overlap), becomes
S_server in the fork-join model, and the cells are sized so that the Eq 7 upper
bound meets the SLO at the target rate (`repro_torch.core.planner
.plan_serving`).  The records are analytic, computed for H100_SXM by
`python -m repro_torch.launch.dryrun --all --out DIR` from a trace of the
path the card runs (the kernels as custom operators, every other operator
reading and writing memory); no card runs.

Run:  PYTHONPATH=src python examples/torch_plan_llm_serving.py \
          --dryrun-dir DIR [--device cpu]
"""

import argparse
import glob
import json
import os

from repro_torch.core import planner
from repro_torch.core.planner import RooflineTerms, ServingModel

SERVE_SHAPES = {"decode_32k": 600e-3, "serve_p99": 20e-3,
                "retrieval_cand": 100e-3, "long_500k": 400e-3}
TARGET_RATES = {"decode_32k": 500.0, "serve_p99": 50_000.0,
                "retrieval_cand": 2_000.0, "long_500k": 20.0}
BATCH = {"decode_32k": 128, "serve_p99": 512, "retrieval_cand": 1,
         "long_500k": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="device of the queueing arithmetic")
    args = ap.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.dryrun_dir,
                                          "*__single.json")))
    if not files:
        raise SystemExit(f"no dry-run records in {args.dryrun_dir}; run "
                         "python -m repro_torch.launch.dryrun --all first")

    print(f"{'arch':24s} {'shape':14s} {'bound':>10s} {'step_ms':>8s} "
          f"{'cells':>6s} {'chips':>7s} {'R_ms':>7s} {'util':>5s}")
    planned = 0
    for f in files:
        with open(f) as fh:
            r = json.load(fh)
        if r["shape"] not in SERVE_SHAPES:
            continue
        terms = RooflineTerms(compute_s=r["compute_s"],
                              memory_s=r["memory_s"],
                              collective_s=r["collective_s"])
        model = ServingModel(
            name=r["arch"], terms=terms, n_chips=r["n_chips"],
            batch_per_step=BATCH[r["shape"]])
        plan = planner.plan_serving(
            model, TARGET_RATES[r["shape"]], SERVE_SHAPES[r["shape"]],
            device=args.device)
        planned += 1
        if plan.cells == 0:
            print(f"{r['arch']:24s} {r['shape']:14s} {plan.bound:>10s} "
                  f"{terms.step_time_serial_bound * 1e3:8.2f} "
                  f"{'SLO infeasible (step > SLO)':>28s}")
        else:
            print(f"{r['arch']:24s} {r['shape']:14s} {plan.bound:>10s} "
                  f"{terms.step_time_serial_bound * 1e3:8.2f} "
                  f"{plan.cells:6d} {plan.chips:7d} "
                  f"{plan.response_upper_ms:7.1f} {plan.utilization:5.2f}")

    print(f"\n({planned} serving cells planned; step_ms = the record's "
          "compute, memory and collective terms summed, per step on "
          "H100_SXM (analytic); cells sized so the Eq 7 upper bound meets "
          "the SLO at the target rate)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
