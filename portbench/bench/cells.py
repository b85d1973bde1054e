"""Find a cell, its configuration and its traffic mix by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

# Every key a file of each kind may hold.  A key outside these (an
# autoscaler, a hedge) is refused: the harness and the reference would
# not run it, and a cell that silently ran without it could read correct.
KEYS = {
    "workloads": {"config", "traffic", "chips", "why", "check_dispatches",
                  "limits"},
    "configs": {"name", "source", "deployment", "p", "pages", "replicas",
                "routing", "result_cache", "queries_per_scenario", "dtype",
                "fault", "guarantees", "reduced", "assumed"},
    "traffic": {"description", "slab", "grid", "service_mode", "chunk",
                "warmup_fraction", "hist_bins", "quantile", "loop"},
    # a traffic mix's what-if grid: Table 6's memory column and the axes
    # of `SweepGrid` (total queries/s, CPU and disk speed-ups)
    "grid": {"memory", "lam", "cpu", "disk"},
    # a configuration's faults (`repro_torch.core.faults.FaultSpec`
    # without its hedges): outage windows (replica, start_s, end_s), the
    # MTBF/MTTR chain, slowed servers (server, factor), the broker's
    # k-of-p merge past its timeout; every key is given
    "fault": {"outages", "mtbf_seconds", "mttr_seconds", "degraded",
              "broker_timeout_seconds", "quorum_k"},
}
# The values the harness and the reference run, where a file could state
# another: float32 (the JSQ tracker's precision on both sides), Table 6's
# 10M pages, and the routings and service models the reference knows.
RUNS = {
    ("configs", "dtype"): {"float32"},
    ("configs", "pages"): {10_000_000},
    ("configs", "routing"): {"round_robin", "random", "jsq"},
    ("traffic", "service_mode"): {"cache", "exponential"},
    ("grid", "memory"): {1, 2, 3, 4},
}


def _check(kind: str, data: dict, path: pathlib.Path) -> None:
    unknown = sorted(set(data) - KEYS[kind])
    if unknown:
        raise ValueError(f"{path}: keys the harness does not run: {unknown}")
    for (k, key), allowed in RUNS.items():
        if k == kind and key in data and data[key] not in allowed:
            raise ValueError(f"{path}: {key} = {data[key]!r}; the harness "
                             f"runs only {sorted(allowed)}")


def _check_fault(fault: dict, cfg: dict, path: pathlib.Path) -> None:
    """A fault the reference runs: all six keys, in range (a replica
    below ``replicas``, a server below ``p``), under JSQ routing over
    more than one replica."""
    _check("fault", fault, path)
    missing = sorted(KEYS["fault"] - set(fault))
    if missing:
        raise ValueError(f"{path}: the fault lacks {missing}")
    if cfg.get("routing") != "jsq" or int(cfg.get("replicas", 1)) < 2:
        raise ValueError(f"{path}: fault: the reference runs faults under "
                         "jsq routing over two or more replicas")

    def index(x):
        return isinstance(x, int) and not isinstance(x, bool) and x >= 0

    def positive(x):
        return isinstance(x, (int, float)) and not isinstance(x, bool) \
            and x > 0

    r, p = int(cfg["replicas"]), int(cfg["p"])
    for row in fault["outages"]:
        if not (isinstance(row, list) and len(row) == 3 and index(row[0])
                and row[0] < r and positive(row[2])
                and 0 <= row[1] < row[2]):
            raise ValueError(f"{path}: outages: {row!r} is not [replica, "
                             f"start_s, end_s] with replica < {r} and "
                             "0 <= start < end")
    for row in fault["degraded"]:
        if not (isinstance(row, list) and len(row) == 2 and index(row[0])
                and row[0] < p and positive(row[1])):
            raise ValueError(f"{path}: degraded: {row!r} is not [server, "
                             f"factor] with server < {p} and a factor > 0")
    for key in ("mtbf_seconds", "mttr_seconds", "broker_timeout_seconds"):
        if not positive(fault[key]):
            raise ValueError(f"{path}: {key} = {fault[key]!r}, not > 0")
    if not (index(fault["quorum_k"]) and fault["quorum_k"] >= 1):
        raise ValueError(f"{path}: quorum_k = {fault['quorum_k']!r}, not "
                         "an integer >= 1")


def _load(kind: str, name: str, root: pathlib.Path) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    data = json.loads(path.read_text())
    _check(kind, data, path)
    if kind == "configs" and "fault" in data:
        _check_fault(data["fault"], data, path)
    if kind == "traffic":
        if ("slab" in data) == ("grid" in data):
            raise ValueError(f"{path}: a traffic mix holds a slab or a "
                             "grid, and only one")
        if "grid" in data:
            _check("grid", data["grid"], path)
            missing = sorted(KEYS["grid"] - set(data["grid"]))
            if missing:
                raise ValueError(f"{path}: the grid lacks {missing}")
    return data


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload: a deployment under a traffic mix, with its checks."""

    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def limits(self) -> dict:
        return self.workload["limits"]

    @property
    def fault(self) -> dict | None:
        """The configuration's faults, or None for a fault-free one."""
        return self.config.get("fault")

    @property
    def grid(self) -> dict | None:
        """The traffic's what-if grid, or None for a slab."""
        return self.traffic.get("grid")

    @property
    def n_chunks(self) -> int:
        return -(-int(self.config["queries_per_scenario"])
                 // int(self.traffic["chunk"]))


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    workload = _load("workloads", name, root)
    cell = Cell(name=name, workload=workload,
                config=_load("configs", workload["config"], root),
                traffic=_load("traffic", workload["traffic"], root))
    if cell.grid is None and cell.chips != 1:
        raise ValueError(f"{name}: a slab runs on one card; give its "
                         f"{cell.chips} cards a grid")
    if cell.grid is not None and cell.fault is not None:
        raise ValueError(f"{name}: a fault runs on a slab; the harness runs "
                         "a grid fault-free")
    return cell


def names(kind: str, root: pathlib.Path = ROOT) -> list[str]:
    """Every name of one kind (``workloads``, ``configs``, ``traffic``, or
    ``metrics`` for the readers)."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.stem for p in (root / kind).glob(f"*{suffix}")
                  if not p.stem.startswith("_"))


def load_metric(name: str, root: pathlib.Path = ROOT):
    """The per-layer reader ``metrics/<name>.py``: a module with ``UNIT``
    and ``read(view) -> float | None``."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
