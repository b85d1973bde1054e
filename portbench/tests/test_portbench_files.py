"""Every configuration, cell, traffic mix and reader parses, and
``BENCHMARK.json`` agrees with the files it names."""

from __future__ import annotations

import json
import re

import pytest

from portbench.bench import cells

CHECKOUT = cells.ROOT.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Files of a cell that BENCHMARK.json does not name yet, and of the reader
# only that cell has something to read for (PERF.md, Open questions).
HELD_BACK = {"workloads": ["t6-r1-shard4", "t6-r4-jsq-faulted"],
             "metrics": ["fleet_ms_per_chunk", "shard_start_lag_ms"]}


@pytest.mark.parametrize("name", cells.names("workloads"))
def test_cell_loads(name):
    cell = cells.load_cell(name)
    assert cell.chips in (1, 4)
    assert set(cell.limits) == {"count_diff", "mean_rel_err", "p95_rel_err"} \
        | ({"degraded_frac_gap", "spill_frac_gap", "unavail_diff"}
           if cell.fault is not None else set())
    assert cell.limits["count_diff"] == 0
    assert cell.config["queries_per_scenario"] % cell.traffic["chunk"] == 0
    assert 1 <= len(cell.workload["why"]) <= 200


@pytest.mark.parametrize("name", cells.names("metrics"))
def test_reader_loads(name):
    mod = cells.load_metric(name)
    assert UNIT.match(mod.UNIT) and callable(mod.read)


def test_benchmark_json_matches_files():
    assert sorted(BENCH) == ["command", "configs", "end_to_end", "paths",
                             "per_layer", "run_seconds", "workloads"]
    assert BENCH["paths"] == ["portbench"]
    for cfg in BENCH["configs"]:
        assert NAME.match(cfg["name"])
        data = json.loads((CHECKOUT / cfg["file"]).read_text())
        assert data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"]
        assert data["source"] == cfg["source"]
    assert sorted([x["name"] for x in BENCH["workloads"]]
                  + HELD_BACK["workloads"]) == cells.names("workloads")
    for w in BENCH["workloads"]:
        cell = cells.load_cell(w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell.workload["config"], cell.workload["traffic"], cell.chips,
            cell.workload["why"])
    layers = {}
    for m in BENCH["per_layer"]:
        mod = cells.load_metric(m["name"])
        assert m["unit"] == mod.UNIT
        assert m["moves"] == "sim_queries_per_s"
        assert set(m["workloads"]) <= set(cells.names("workloads"))
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert sorted([x["name"] for x in BENCH["per_layer"]]
                  + HELD_BACK["metrics"]) == cells.names("metrics")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"sim_queries_per_s", "dispatch_p95_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


def test_layers_named_in_perf_md():
    perf = (CHECKOUT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]


@pytest.mark.parametrize("kind,name,cell,change", [
    ("configs", "table6-p100-r4-jsq-cache", "t6-r4-jsq-whatif",
     {"fleet_fault": [0.01, 30.0]}),
    ("configs", "table6-p100-r1", "t6-r1-whatif", {"dtype": "bfloat16"}),
    ("configs", "table6-p100-r1", "t6-r1-whatif", {"pages": 20_000_000}),
    ("configs", "table6-p100-r1", "t6-r1-whatif",
     {"routing": "least_loaded"}),
    ("traffic", "table6-whatif-256", "t6-r1-whatif",
     {"service_mode": "pareto"}),
    ("workloads", "t6-r1-whatif", "t6-r1-whatif", {"hedge_ms": 50}),
])
def test_unrun_setting_is_refused(tiny_root, kind, name, cell, change):
    """A setting the harness and the reference do not run fails loudly."""
    path = tiny_root / kind / f"{name}.json"
    data = json.loads(path.read_text())
    data.update(change)
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=next(iter(change))):
        cells.load_cell(cell, tiny_root)
