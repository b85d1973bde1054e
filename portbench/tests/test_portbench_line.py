"""The result line's format, and no result without a card."""

from __future__ import annotations

import json

import pytest

from portbench import run
from portbench.bench import cells


@pytest.mark.parametrize("name", ["t6-r1-whatif", "t6-r4-jsq-whatif",
                                  "t6-r1-shard4", "t6-r4-jsq-faulted"])
def test_untraced_line(tiny_root, name):
    cell = cells.load_cell(name, tiny_root)
    line = json.loads(json.dumps(run.run_cell(
        cell, seed=2**32 + 9, seconds=0.2, trace=False, device="cpu",
        setup_clock=lambda: 3.5, root=tiny_root)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "setup_marks_s", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert {k: v["unit"] for k, v in line["metrics"].items()} == {
        "sim_queries_per_s": "queries/s", "dispatch_p95_ms": "ms",
        "setup_s": "s"}
    assert line["metrics"]["setup_s"]["value"] == 3.5
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes",
                                   "memory_peak_bytes_per_card"}
    assert line["device"]["count"] == cell.chips
    assert len(line["device"]["memory_peak_bytes_per_card"]) == cell.chips
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_line(tiny_root):
    cell = cells.load_cell("t6-r1-whatif", tiny_root)
    line = run.run_cell(cell, seed=77, seconds=0.2, trace=True,
                        device="cpu", setup_clock=lambda: 1.0,
                        root=tiny_root)
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert line["attempted"] == run.TRACE_DISPATCHES
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU runs no device operation: no device reader has anything
    assert line["metrics"] == {}


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = run.main(["--workload", "t6-r1-whatif", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_seeds_are_large_and_distinct():
    from portbench.bench import system
    seeds = {system.dispatch_seed(s, k) for s in (0, 2**31 + 5, 2**33)
             for k in range(50)}
    assert len(seeds) == 150 and all(0 <= s < 2**63 for s in seeds)


def test_missing_span_target_is_skipped(monkeypatch):
    """A layer function the program no longer has silences its span's
    readers only: the other spans still wrap, and all are restored."""
    from portbench.bench import trace
    from repro_torch.core import simulator
    spans = dict(trace.SPANS)
    spans[trace.PREFIX + "sampling"] = (
        ("repro_torch.core.simulator", "no_such_function"),
        ("repro_torch.no_such_module", "chunk_random_draws"))
    monkeypatch.setattr(trace, "SPANS", spans)
    before = simulator._compact
    with trace.layer_spans():
        assert simulator._compact is not before
        assert not hasattr(simulator, "no_such_function")
    assert simulator._compact is before
