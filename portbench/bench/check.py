"""Whether the timed dispatches' answers are right.

Each sampled dispatch is simulated again by the plain float64 reference
(`portbench.reference.forkjoin`) on the same scenarios and the same
variates, and every scenario's mean and q-quantile of the response are
held against it; every dispatch of the window is held to the exact
post-warm-up count.  A dispatch of a grid is simulated shard by shard,
each shard's scenarios from that shard's seed (`reference.rng_plan`'s
copy of the sweep's plan), and the shards' rows are put in grid order
as the sweep gathers them.  Each number compared has its limit in the
cell's workload file.
"""

from __future__ import annotations

import math
import random

import torch

from portbench.bench import system
from portbench.bench.cells import Cell
from portbench.reference import forkjoin, rng_plan


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


def reference(cell: Cell, inputs: system.Inputs, dispatch_seed: int,
              **precision) -> torch.Tensor:
    """(3, S) float64 host tensor: the reference's mean, q-quantile and
    count of the dispatch seeded ``dispatch_seed``, laid out as the
    program's answer.  ``precision`` (``dtype``, ``route_dtype``) makes
    the control."""
    kw = {**system.run_kwargs(cell), **precision}
    if cell.grid is None:
        parts = [(dispatch_seed, None)]
    else:
        parts = zip(rng_plan.shard_seeds(dispatch_seed, cell.chips),
                    rng_plan.shard_rows(inputs.n_scen, cell.chips))
    rows = []
    for seed, idx in parts:
        lam, fields = inputs.lam, inputs.fields
        if idx is not None:
            idx = torch.tensor(idx, device=lam.device)
            lam, fields = lam[idx], {k: v[idx] for k, v in fields.items()}
        ref = forkjoin.simulate(seed, lam, fields, **kw)
        rows.append(torch.stack([ref["mean"].double(),
                                 ref["quantile"].double(),
                                 ref["count"].double()]).cpu())
    return torch.cat(rows, dim=1)[:, :inputs.n_scen]


def errors(cell: Cell, got: torch.Tensor, want: torch.Tensor) -> dict:
    """One dispatch's compared numbers against the reference's rows."""
    return {"count_diff": float((got[2] - expected_count(cell)).abs().max()),
            "mean_rel_err": rel_err(got[0], want[0]),
            "p95_rel_err": rel_err(got[1], want[1])}


def numbers(cell: Cell, inputs: system.Inputs, outs: list, seed: int,
            picks: list[int]) -> dict:
    """The compared numbers: ``count_diff`` over every dispatch, and over
    the picked ones the worst relative gap of the mean (``mean_rel_err``)
    and of the q-quantile (``p95_rel_err``) from the float64 reference."""
    want = expected_count(cell)
    count_diff = max(float((o[2] - want).abs().max()) for o in outs)
    mean_err = p95_err = 0.0
    for k in picks:
        err = errors(cell, outs[k],
                     reference(cell, inputs, system.dispatch_seed(seed, k)))
        mean_err = max(mean_err, err["mean_rel_err"])
        p95_err = max(p95_err, err["p95_rel_err"])
    return {"count_diff": count_diff, "mean_rel_err": mean_err,
            "p95_rel_err": p95_err}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within limits, {name: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
