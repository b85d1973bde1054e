"""Shared fixtures: the benchmark's folder copied at a size the CPU holds."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench.bench.cells import ROOT

TINY_SLAB = {"memory": [1, 4], "cpu": [1, 4], "disk": [1], "rho": [0.3, 0.85]}
TINY_GRID = {"memory": 1, "lam": [2.0, 8.5], "cpu": [1.0, 4.0],
             "disk": [1.0, 4.0]}


# A fault's chain at a tiny run's horizon (tens of simulated seconds):
# each replica up two thirds of the time, so that it fails and is
# repaired within a run
TINY_CHAIN = {"mtbf_seconds": 10.0, "mttr_seconds": 5.0}


def shrink(root, *, p=8, queries=1024, chunk=256):
    """Cut every configuration and traffic mix under ``root`` in place:
    8 scenarios (a slab's or a grid's), ``p`` servers, ``queries`` a
    scenario in ``chunk``s; a fault's chain to ``TINY_CHAIN`` and its
    quorum to all servers but one."""
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(p=p, queries_per_scenario=queries)
        if "fault" in cfg:
            cfg["fault"].update(TINY_CHAIN, quorum_k=p - 1)
        path.write_text(json.dumps(cfg))
    for path in (root / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update({"grid" if "grid" in tr else "slab":
                   TINY_GRID if "grid" in tr else TINY_SLAB}, chunk=chunk)
        path.write_text(json.dumps(tr))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's data and readers, cut to a tiny size."""
    for kind in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(ROOT / kind, tmp_path / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shrink(tmp_path)
    return tmp_path
