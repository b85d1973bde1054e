"""The system under test: the port's streaming simulator, one what-if
dispatch at a time.

Only this module calls the program: its batch entry
(`repro_torch.core.simulator.simulate_fork_join_batch`), its topology
(`repro_torch.core.cluster.ClusterSpec`) and the parameter record it
takes.  (`run.py` imports the package to see where it lies; the traced
run wraps its layer functions in spans.)  Dispatches run the program's
own random numbers.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One slab of what-if scenarios: (S,) float32 rates and parameters."""

    lam: torch.Tensor
    fields: dict

    @property
    def n_scen(self) -> int:
        return self.lam.shape[0]


def make_inputs(cell: Cell, device) -> Inputs:
    """The cell's scenarios, from the frozen Table 6 arithmetic."""
    cfg = cell.config
    rates, cols = table6.what_if_slab(cell.traffic["slab"], p=int(cfg["p"]),
                                      load_scale=float(cfg["replicas"]))

    def t(v):
        return torch.tensor(v, dtype=getattr(torch, cfg["dtype"])).to(device)

    return Inputs(lam=t(rates), fields={k: t(v) for k, v in cols.items()})


def run_kwargs(cell: Cell) -> dict:
    """The keyword arguments both the program and the reference take."""
    cfg, tr = cell.config, cell.traffic
    cache = cfg["result_cache"]
    return dict(p=int(cfg["p"]), n_queries=int(cfg["queries_per_scenario"]),
                chunk=int(tr["chunk"]),
                warmup_fraction=float(tr["warmup_fraction"]),
                hist_bins=int(tr["hist_bins"]), quantile=float(tr["quantile"]),
                mode=tr["service_mode"], r=int(cfg["replicas"]),
                routing=cfg["routing"],
                result_cache=None if cache is None else tuple(cache))


def make_dispatch(cell: Cell, inputs: Inputs, device):
    """``dispatch(seed) -> (3, S) float64 host tensor``: one call of the
    program's batch entry over the slab, then its per-scenario mean,
    q-quantile and count of the response read back to the host (what a
    planner reads off the surface)."""
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.queueing import ServerParams

    kw = run_kwargs(cell)
    spec = ClusterSpec(r=kw["r"], routing=kw["routing"],
                       result_cache=kw["result_cache"])
    params = ServerParams(p=kw["p"], **inputs.fields)
    q = kw["quantile"]
    dtype = getattr(torch, cell.config["dtype"])

    def dispatch(seed: int) -> torch.Tensor:
        res = simulator.simulate_fork_join_batch(
            seed, inputs.lam, params, kw["n_queries"], p=kw["p"],
            mode=kw["mode"], warmup_fraction=kw["warmup_fraction"],
            chunk_size=kw["chunk"], hist_bins=kw["hist_bins"], cluster=spec,
            device=device, dtype=dtype)
        out = torch.stack([res.mean_response, res.quantile(q), res.count])
        return out.to("cpu", torch.float64)

    return dispatch
