"""A cell, a configuration, a traffic mix and a per-layer reader dropped
into the folder are found by name, with no edit to a file already there."""

from __future__ import annotations

import json

from portbench import run
from portbench.bench import cells


def test_new_files_are_found(tiny_root):
    before = {p: p.read_bytes() for p in tiny_root.rglob("*")
              if p.is_file()}
    cfg = json.loads((tiny_root / "configs" / "table6-p100-r1.json")
                     .read_text())
    cfg.update(name="extra-r2", replicas=2, routing="random",
               result_cache=None)
    (tiny_root / "configs" / "extra-r2.json").write_text(json.dumps(cfg))
    tr = json.loads((tiny_root / "traffic" / "table6-whatif-256.json")
                    .read_text())
    tr["service_mode"] = "exponential"
    (tiny_root / "traffic" / "extra-exp.json").write_text(json.dumps(tr))
    (tiny_root / "workloads" / "extra-cell.json").write_text(json.dumps({
        "config": "extra-r2", "traffic": "extra-exp", "chips": 1,
        "why": "a cell added as files only", "check_dispatches": 1,
        "limits": {"count_diff": 0, "mean_rel_err": 1e-4,
                   "p95_rel_err": 1e-4}}))
    (tiny_root / "metrics" / "extra_metric.py").write_text(
        'UNIT = "dispatches"\n\n\ndef read(view):\n'
        '    return float(view.dispatches)\n')

    assert "extra-cell" in cells.names("workloads", tiny_root)
    assert "extra_metric" in cells.names("metrics", tiny_root)
    cell = cells.load_cell("extra-cell", tiny_root)
    line = run.run_cell(cell, seed=123, seconds=0.1, trace=True,
                        device="cpu", setup_clock=lambda: 1.0,
                        root=tiny_root)
    assert line["correct"] is True
    assert line["metrics"]["extra_metric"] == {
        "value": float(run.TRACE_DISPATCHES), "unit": "dispatches"}
    for path, data in before.items():
        assert path.read_bytes() == data, path
