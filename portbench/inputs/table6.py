"""Badue et al. 2010, Sec 6 / Table 6: the case-study cluster's parameters.

A frozen copy of the arithmetic in the port's `core/capacity.py`
(``MEMORY_TABLE``, ``broker_service_time``, ``scenario_params``) and
`core/queueing.py` (``service_time_server``, Eq 1), in plain Python
floats.  The benchmark builds every scenario of a slab from these and
hands the same numbers to the program and to the reference.  A grid's
scenarios the program builds itself (`SweepGrid.build`, in float32);
the reference gets them from here.
"""

from __future__ import annotations

import itertools

_MS = 1e-3

# main memory as a multiple of the reference machine ->
# (s_hit, s_miss, s_disk, hit), seconds (p = 100, b = 10M pages)
MEMORY_TABLE = {
    1: (28.23 * _MS, 35.31 * _MS, 66.03 * _MS, 0.02),
    2: (33.38 * _MS, 33.77 * _MS, 35.89 * _MS, 0.09),
    3: (34.57 * _MS, 32.66 * _MS, 30.48 * _MS, 0.15),
    4: (34.68 * _MS, 32.04 * _MS, 26.14 * _MS, 0.18),
}

FIELDS = ("s_broker", "s_hit", "s_miss", "s_disk", "hit")


def broker_service_time(p: int) -> float:
    """The paper's broker fit, S_broker = 3.18e-2 p + 0.265 ms."""
    return (3.18e-2 * p + 0.265) * _MS


def scenario_params(*, memory: int, cpu: float, disk: float,
                    p: int) -> dict:
    """One Sec 6 what-if: Table 6's memory column, CPU and disk x faster
    (CPU times, the broker's included, divided by ``cpu``; disk time by
    ``disk``)."""
    s_hit, s_miss, s_disk, hit = MEMORY_TABLE[memory]
    return {"s_broker": broker_service_time(p) / cpu, "s_hit": s_hit / cpu,
            "s_miss": s_miss / cpu, "s_disk": s_disk / disk, "hit": hit}


def service_time_server(params: dict) -> float:
    """Eq 1: S_server = hit S_hit + (1 - hit) (S_miss + S_disk)."""
    hit = params["hit"]
    return hit * params["s_hit"] + (1.0 - hit) * (params["s_miss"]
                                                  + params["s_disk"])


def what_if_slab(axes: dict, *, p: int, load_scale: float = 1.0
                 ) -> tuple[list[float], dict]:
    """The scenarios of a what-if slab, in ``itertools.product`` order of
    ``axes["memory"]`` x ``["cpu"]`` x ``["disk"]`` x ``["rho"]``.

    Each scenario's rate is rho / S_server (times ``load_scale``, the
    replica count of a cluster in which every replica carries that
    load).  Returns (rates, {field: values}), plain floats.
    """
    rates, cols = [], {f: [] for f in FIELDS}
    for memory, cpu, disk, rho in itertools.product(
            axes["memory"], axes["cpu"], axes["disk"], axes["rho"]):
        prm = scenario_params(memory=memory, cpu=cpu, disk=disk, p=p)
        rates.append(load_scale * rho / service_time_server(prm))
        for f in FIELDS:
            cols[f].append(prm[f])
    return rates, cols


def what_if_grid(grid: dict, *, p: int) -> tuple[list[float], dict]:
    """The scenarios of a what-if grid, in `SweepGrid`'s axis order
    ``grid["lam"]`` x (the one ``p``) x ``["cpu"]`` x ``["disk"]``, all
    in Table 6's column ``grid["memory"]``.

    Each scenario's rate is the grid's total rate, as `SweepGrid` takes
    it.  Returns (rates, {field: values}), plain floats.
    """
    rates, cols = [], {f: [] for f in FIELDS}
    for lam, cpu, disk in itertools.product(grid["lam"], grid["cpu"],
                                            grid["disk"]):
        prm = scenario_params(memory=grid["memory"], cpu=cpu, disk=disk, p=p)
        rates.append(float(lam))
        for f in FIELDS:
            cols[f].append(prm[f])
    return rates, cols
