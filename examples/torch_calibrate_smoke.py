"""Calibration smoke check of the PyTorch port, shared by the CPU tests.

The port of examples/calibrate_smoke.py: simulate two tiny measurement
traces from a hidden ground-truth cluster, run the measure -> fit ->
validate pipeline with a minimal iteration budget, and assert the fitted
imbalance blend is sane and the calibrated model tracks its own
simulator.  ``tests/test_torch_calibrate.py`` imports and calls
`run_smoke` on the CPU.

Run:  PYTHONPATH=src python examples/torch_calibrate_smoke.py
      [--device cpu]     (default: cuda)
"""

from __future__ import annotations

import argparse
import dataclasses


def run_smoke(*, device: str = "cuda", n_queries: int = 3_000,
              n_iters: int = 2, simulator_queries: int = 5_000,
              verbose: bool = True):
    """Tiny end-to-end calibration on ``device``; returns (cal, report).

    Raises AssertionError when the pipeline's accuracy contract breaks.
    Sizes are smoke-sized on purpose (seconds on the CPU): the thorough
    accuracy acceptance lives in tests/test_torch_calibrate.py.
    """
    from repro_torch.calibrate import calibrate_and_validate, simulate_trace
    from repro_torch.core import capacity

    true = dataclasses.replace(capacity.TABLE5_PARAMS, p=2)
    traces = [simulate_trace(i, lam, n_queries, true, device=device)
              for i, lam in enumerate([10.0, 18.0])]
    cal, report = calibrate_and_validate(
        traces, n_windows=6, holdout_fraction=0.3, n_iters=n_iters,
        simulator_queries=simulator_queries)
    if verbose:
        print(report.summary())
    assert 0.0 < float(cal.alpha) < 1.0, float(cal.alpha)
    assert report.mean_rel_err_vs_sim < 0.5, report.mean_rel_err_vs_sim
    return cal, report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run_smoke(device=ap.parse_args().device)
    print("calibrate smoke: OK")
