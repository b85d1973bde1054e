"""The system under test: the port's streaming simulator, one what-if
dispatch at a time.

Only this module calls the program.  A slab runs through its batch
entry (`repro_torch.core.simulator.simulate_fork_join_batch`) on one
card, with its topology (`repro_torch.core.cluster.ClusterSpec`) and the
parameter record it takes; a grid through its multi-card path
(`repro_torch.core.sweep.SweepGrid`, ``sweep_simulated`` on a
`repro_torch.launch.mesh.make_sweep_mesh` over the cell's cards).
(`run.py` imports the package to see where it lies; the traced run
wraps its layer functions in spans.)  Dispatches run the program's own
random numbers.  A configuration's ``fault`` goes to the program as
``ClusterSpec(fault=FaultSpec(...))`` (`repro_torch.core.faults`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.bench.cells import Cell
from portbench.inputs import table6
from portbench.reference import rng_plan

_DISPATCH_WORD = 0xD15C
_WARM_WORD = 0x3A2F


def dispatch_seed(seed: int, k: int) -> int:
    """The program's seed for dispatch ``k`` of a run seeded ``seed``."""
    return rng_plan.mix(_DISPATCH_WORD, seed, k) >> 1


def warm_seed(seed: int, k: int) -> int:
    """Seeds of the set-up's warm-up dispatches, apart from the window's."""
    return rng_plan.mix(_WARM_WORD, seed, k) >> 1


def cards(device, n: int) -> list[torch.device]:
    """The ``n`` cards a cell runs on: the first ``n`` CUDA devices, or
    ``device`` ``n`` times over where it is no card (the CPU tests)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One dispatch's what-if scenarios: (S,) float32 rates and
    parameters (those of a grid in the grid's order)."""

    lam: torch.Tensor
    fields: dict

    @property
    def n_scen(self) -> int:
        return self.lam.shape[0]


def make_inputs(cell: Cell, device) -> Inputs:
    """The cell's scenarios, from the frozen Table 6 arithmetic."""
    cfg = cell.config
    if cell.grid is not None:
        rates, cols = table6.what_if_grid(cell.grid, p=int(cfg["p"]))
    else:
        rates, cols = table6.what_if_slab(cell.traffic["slab"],
                                          p=int(cfg["p"]),
                                          load_scale=float(cfg["replicas"]))

    def t(v):
        return torch.tensor(v, dtype=getattr(torch, cfg["dtype"])).to(device)

    return Inputs(lam=t(rates), fields={k: t(v) for k, v in cols.items()})


# The rows a faulted cell's dispatch adds after (mean, q-quantile, count):
# the program's post-warm-up counts of its fault channels.
FAULT_ROWS = ("degraded_count", "spill_count", "unavail_count")


def run_kwargs(cell: Cell) -> dict:
    """The keyword arguments both the program and the reference take
    (``fault``, the configuration's own dict, only where it has one)."""
    cfg, tr = cell.config, cell.traffic
    cache = cfg["result_cache"]
    kw = dict(p=int(cfg["p"]), n_queries=int(cfg["queries_per_scenario"]),
              chunk=int(tr["chunk"]),
              warmup_fraction=float(tr["warmup_fraction"]),
              hist_bins=int(tr["hist_bins"]), quantile=float(tr["quantile"]),
              mode=tr["service_mode"], r=int(cfg["replicas"]),
              routing=cfg["routing"],
              result_cache=None if cache is None else tuple(cache))
    if cell.fault is not None:
        kw["fault"] = cell.fault
    return kw


def fault_spec(fault: dict):
    """The program's `FaultSpec` of a configuration's ``fault``."""
    from repro_torch.core.faults import FaultSpec
    return FaultSpec(
        outages=tuple(map(tuple, fault["outages"])),
        mtbf_seconds=float(fault["mtbf_seconds"]),
        mttr_seconds=float(fault["mttr_seconds"]),
        degraded=tuple(map(tuple, fault["degraded"])),
        broker_timeout_seconds=float(fault["broker_timeout_seconds"]),
        quorum_k=int(fault["quorum_k"]))


def make_dispatch(cell: Cell, inputs: Inputs, device):
    """``dispatch(seed) -> (3, S) float64 host tensor``: one call of the
    program over the cell's scenarios, then its per-scenario mean,
    q-quantile and count of the response read back to the host (what a
    planner reads off the surface).  A faulted cell's has the rows of
    ``FAULT_ROWS`` after those (NaN where the program reports none)."""
    if cell.grid is not None:
        return _grid_dispatch(cell, device)
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.queueing import ServerParams

    kw = run_kwargs(cell)
    faulted = cell.fault is not None
    spec = ClusterSpec(r=kw["r"], routing=kw["routing"],
                       result_cache=kw["result_cache"],
                       fault=fault_spec(cell.fault) if faulted else None)
    params = ServerParams(p=kw["p"], **inputs.fields)
    q = kw["quantile"]
    dtype = getattr(torch, cell.config["dtype"])

    def dispatch(seed: int) -> torch.Tensor:
        res = simulator.simulate_fork_join_batch(
            seed, inputs.lam, params, kw["n_queries"], p=kw["p"],
            mode=kw["mode"], warmup_fraction=kw["warmup_fraction"],
            chunk_size=kw["chunk"], hist_bins=kw["hist_bins"], cluster=spec,
            device=device, dtype=dtype)
        rows = [res.mean_response, res.quantile(q), res.count]
        if faulted:
            rows += [torch.full_like(res.count, math.nan)
                     if getattr(res, k) is None else getattr(res, k)
                     for k in FAULT_ROWS]
        return torch.stack(rows).to("cpu", torch.float64)

    return dispatch


def _grid_dispatch(cell: Cell, device):
    """A grid's dispatch: `SweepGrid.build` once, on the first card, then
    ``sweep_simulated`` over a mesh of the cell's cards a dispatch (one
    (p, r) dispatch of the sweep, sharded one block of scenarios a card
    and gathered onto the first)."""
    from repro_torch.core import sweep
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.launch.mesh import make_sweep_mesh

    kw = run_kwargs(cell)
    g = cell.grid
    devices = cards(device, cell.chips)
    grid = sweep.SweepGrid.build(lam=g["lam"], p=[kw["p"]], cpu=g["cpu"],
                                 disk=g["disk"], memory=g["memory"],
                                 r=kw["r"], device=devices[0])
    mesh = make_sweep_mesh(devices=devices)
    spec = ClusterSpec(routing=kw["routing"],
                       result_cache=kw["result_cache"])
    q = kw["quantile"]
    dtype = getattr(torch, cell.config["dtype"])

    def dispatch(seed: int) -> torch.Tensor:
        res = sweep.sweep_simulated(
            grid, seed, n_queries=kw["n_queries"], mode=kw["mode"],
            warmup_fraction=kw["warmup_fraction"], chunk_size=kw["chunk"],
            hist_bins=kw["hist_bins"], cluster=spec, mesh=mesh, dtype=dtype)
        out = torch.stack([res.mean.reshape(-1), res.quantile(q).reshape(-1),
                           res.stats.count.reshape(-1)])
        return out.to("cpu", torch.float64)

    return dispatch
