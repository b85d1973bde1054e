"""Whether the timed dispatches' answers are right.

Each sampled dispatch is simulated again by the plain float64 reference
(`portbench.reference.forkjoin`) on the same scenarios and the same
variates, and every scenario's mean and q-quantile of the response are
held against it; every dispatch of the window is held to the exact
post-warm-up count.  A dispatch of a grid is simulated shard by shard,
each shard's scenarios from that shard's seed (`reference.rng_plan`'s
copy of the sweep's plan), and the shards' rows are put in grid order
as the sweep gathers them.  A faulted cell (a configuration with a
``fault``) is simulated again with its faults (`reference.faulted`), and
each scenario's post-warm-up counts of degraded, spilled and unavailable
queries are held against it too: the first two as shares of the
queries (an answer parted from the reference at a deadline tie moves a
count by one, a large share of a small count), the last exactly.  Each
number compared has its limit in the cell's workload file.
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


def share_gap(got: torch.Tensor, want: torch.Tensor, n: int) -> float:
    """Largest gap of a count over the scenarios, as a share of the ``n``
    queries it counts among (inf if any is not finite)."""
    err = (got.double() - want.double()).abs() / n
    return float(err.max()) if bool(torch.isfinite(err).all()) else math.inf


def reference(cell: Cell, inputs: system.Inputs, dispatch_seed: int,
              **precision) -> torch.Tensor:
    """(3, S) float64 host tensor: the reference's mean, q-quantile and
    count of the dispatch seeded ``dispatch_seed``, laid out as the
    program's answer (a faulted cell's (6, S), with the counts of
    ``system.FAULT_ROWS``).  ``precision`` (``dtype``, ``route_dtype``)
    makes the control."""
    kw = {**system.run_kwargs(cell), **precision}
    keys = ("mean", "quantile", "count") + (
        () if cell.fault is None else system.FAULT_ROWS)
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
        rows.append(torch.stack([ref[k].double() for k in keys]).cpu())
    return torch.cat(rows, dim=1)[:, :inputs.n_scen]


def errors(cell: Cell, got: torch.Tensor, want: torch.Tensor) -> dict:
    """One dispatch's compared numbers against the reference's rows; a
    faulted cell's add the worst gap of the degraded and of the spilled
    share of the post-warm-up queries (``degraded_frac_gap``,
    ``spill_frac_gap``) and the largest gap of the unavailable count
    (``unavail_diff``)."""
    out = {"count_diff": float((got[2] - expected_count(cell)).abs().max()),
           "mean_rel_err": rel_err(got[0], want[0]),
           "p95_rel_err": rel_err(got[1], want[1])}
    if cell.fault is not None:
        n = expected_count(cell)
        gap = (got[5] - want[5]).abs().max()
        out.update(degraded_frac_gap=share_gap(got[3], want[3], n),
                   spill_frac_gap=share_gap(got[4], want[4], n),
                   unavail_diff=float(gap) if bool(torch.isfinite(gap))
                   else math.inf)
    return out


def numbers(cell: Cell, inputs: system.Inputs, outs: list, seed: int,
            picks: list[int]) -> dict:
    """The compared numbers: ``count_diff`` over every dispatch, and over
    the picked ones the worst of each other number of `errors` (the
    relative gap of the mean, ``mean_rel_err``, and of the q-quantile,
    ``p95_rel_err``, and a faulted cell's counts) from the float64
    reference."""
    want = expected_count(cell)
    values = {"count_diff": max(float((o[2] - want).abs().max())
                                for o in outs)}
    for k in picks:
        err = errors(cell, outs[k],
                     reference(cell, inputs, system.dispatch_seed(seed, k)))
        del err["count_diff"]
        for name, value in err.items():
            values[name] = max(values.get(name, 0.0), value)
    return values


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within limits, {name: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
