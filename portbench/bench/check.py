"""Whether the timed dispatches' answers are right.

Each sampled dispatch is simulated again by the plain float64 reference
(`portbench.reference.forkjoin`) on the same scenarios and the same
variates, and every scenario's mean and q-quantile of the response are
held against it; every dispatch of the window is held to the exact
post-warm-up count.  Each number compared has its limit in the cell's
workload file.
"""

from __future__ import annotations

import math
import random

import torch

from portbench.bench import system
from portbench.bench.cells import Cell
from portbench.reference import forkjoin


def expected_count(cell: Cell) -> int:
    n = int(cell.config["queries_per_scenario"])
    return n - int(n * float(cell.traffic["warmup_fraction"]))


def sample(seed: int, n_dispatches: int, m: int) -> list[int]:
    """The dispatches whose answers the reference recomputes."""
    return sorted(random.Random(seed).sample(range(n_dispatches),
                                             min(m, n_dispatches)))


def bad_dispatches(cell: Cell, outs: list) -> int:
    """Dispatches with a non-finite answer or a wrong count."""
    want = expected_count(cell)
    return sum(1 for o in outs
               if not bool(torch.isfinite(o).all())
               or bool((o[2] != want).any()))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative gap over the scenarios (inf if any is not finite)."""
    err = (got.double() - want.double()).abs() / want.double().abs()
    return float(err.max()) if bool(torch.isfinite(err).all()) else math.inf


def numbers(cell: Cell, inputs: system.Inputs, outs: list, seed: int,
            picks: list[int]) -> dict:
    """The compared numbers: ``count_diff`` over every dispatch, and over
    the picked ones the worst relative gap of the mean (``mean_rel_err``)
    and of the q-quantile (``p95_rel_err``) from the float64 reference."""
    want = expected_count(cell)
    count_diff = max(float((o[2] - want).abs().max()) for o in outs)
    mean_err = p95_err = 0.0
    kw = system.run_kwargs(cell)
    for k in picks:
        ref = forkjoin.simulate(system.dispatch_seed(seed, k), inputs.lam,
                                inputs.fields, **kw)
        mean_err = max(mean_err, rel_err(outs[k][0], ref["mean"].cpu()))
        p95_err = max(p95_err, rel_err(outs[k][1], ref["quantile"].cpu()))
    return {"count_diff": count_diff, "mean_rel_err": mean_err,
            "p95_rel_err": p95_err}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within limits, {name: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
