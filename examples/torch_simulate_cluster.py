"""Simulate fork-join clusters at the scale the paper left as future work
(PyTorch port of examples/simulate_cluster.py).

Sweeps cluster sizes p = 8 .. 1024 under the Table-5 workload and shows
where the measured (simulated) response sits between Eq 7's bounds for
the three service regimes: the model's iid-exponential assumption, the
mechanistic disk-cache mixture, and the prior-work "balanced" assumption.
The seed of each p's runs is p (the reference's ``PRNGKey(p)``).

Run:  PYTHONPATH=src python examples/torch_simulate_cluster.py
      [--device cpu] [--queries 40000] [--lam 15]   (default device: cuda)
"""

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core import capacity, queueing, simulator

PS = (8, 32, 128, 512, 1024)
MODES = ("exponential", "cache", "balanced")


def rows(ps, lam: float, n_queries: int, *, device,
         draws: Optional[Callable] = None, impl: str = "auto") -> list:
    """One row a cluster size p: Eq 7's bounds, each mode's simulated mean
    and p95 (seconds) and the wall of the three runs.

    ``draws(p, mode)``, when given, returns the ``draws=`` callable of that
    run (see `repro_torch.core.simulator`); ``impl`` picks the scans'
    path ("torch" forces the plain version)."""
    out = []
    for p in ps:
        pr = dataclasses.replace(capacity.TABLE5_PARAMS, p=p)
        lo, hi = queueing.response_time_bounds(lam, pr, device=device)
        t0 = time.time()
        mean, p95 = {}, {}
        for mode in MODES:
            res = simulator.simulate_fork_join(
                p, lam, n_queries, pr, mode=mode, impl=impl,
                draws=None if draws is None else draws(p, mode),
                device=device)
            mean[mode] = float(res.mean_response)
            p95[mode] = float(res.quantile(0.95))
        out.append({"p": p, "lower": float(lo), "upper": float(hi),
                    "mean": mean, "p95": p95, "wall_s": time.time() - t0})
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=40_000)
    ap.add_argument("--lam", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    print(f"{'p':>5s} {'lower':>8s} {'upper':>8s} | "
          f"{'exp':>8s} {'cache':>8s} {'balanced':>9s} {'wall_s':>7s}")
    for row in rows(PS, args.lam, args.queries, device=dev):
        sims = row["mean"]
        print(f"{row['p']:5d} {row['lower']:8.3f} {row['upper']:8.3f} | "
              f"{sims['exponential']:8.3f} {sims['cache']:8.3f} "
              f"{sims['balanced']:9.3f} {row['wall_s']:7.1f}")

    print("\nReading: 'balanced' (the Chowdhury & Pass assumption) hugs the"
          "\nlower bound at every scale — the paper's point that ignoring"
          "\nservice-time imbalance underestimates response time by up to"
          "\nthe H_p factor; the exponential regime approaches the upper"
          "\nbound as p grows.")


if __name__ == "__main__":
    main()
