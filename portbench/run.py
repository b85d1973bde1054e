"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program under ``src/``.  Set-up
(imports, the CUDA context, the kernels' libraries, the scenarios and two
warm-up dispatches at the window's shapes) is timed from process start.
Then a closed loop, one planner waiting for each dispatch, runs
``--seconds`` of what-if dispatches through the program; with ``--trace
1`` a fixed number of dispatches runs under the profiler instead, and the
per-layer readers of ``metrics/`` read the trace.  After the window the
reference checks a sample of the dispatches; each compared number and its
limit are the last lines on standard error, and the result is the last
line on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})
TRACE_DISPATCHES = 5                    # the traced window, every cell


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def banned_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def _paths() -> None:
    """The checkout's program and the benchmark as a package; not the
    benchmark's own folder, whose names could shadow other modules.

    Python's bytecode goes to one fixed folder of the checkout, so that
    only a checkout's first run compiles the modules it imports (torch
    and the libraries it loads lazily included) and later runs load
    them, as they find the kernels already built."""
    sys.pycache_prefix = str(CHECKOUT / ".pycache")
    sys.dont_write_bytecode = False
    if sys.path and sys.path[0] == str(HERE):
        del sys.path[0]
    for path in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if path not in sys.path:
            sys.path.insert(0, path)


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device,
             setup_clock=process_age_s, root: pathlib.Path = HERE,
             setup_marks: dict | None = None) -> dict:
    """Set up, run the window, check; returns the result line's fields,
    the compared numbers last (``"checks"``).  ``root`` is the folder the
    per-layer readers are found in; ``setup_marks`` the caller's earlier
    readings of ``setup_clock`` (reported with the line's own)."""
    import torch

    from portbench.bench import cells, check, system
    from portbench.bench import trace as tr
    from portbench.bench.peaks import peaks_for
    from portbench.reference import rng_plan

    marks = {"start": setup_clock()}
    inputs = system.make_inputs(cell, device)
    dispatch = system.make_dispatch(cell, inputs, device)
    marks["inputs"] = setup_clock()
    for j in range(2):                  # every shape the window uses
        dispatch(system.warm_seed(seed, j))
    on_card = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    setup_s = marks["warm"] = setup_clock()
    if trace:
        dispatch = tr.dispatch_span(dispatch)

    def closed_loop(stop):
        outs, walls = [], []
        t_begin = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            outs.append(dispatch(system.dispatch_seed(seed, len(outs))))
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            if stop(len(outs), t1 - t_begin):
                return outs, walls, t1 - t_begin

    view = None
    if trace:
        n_traced = TRACE_DISPATCHES
        # one card's shapes: a shard's scenarios, edge padding included
        # (a slab's cell has one card, so its one shard is the slab)
        per_card = len(rng_plan.shard_rows(inputs.n_scen, cell.chips)[0])
        shape = dict(n_scen=per_card,
                     p=int(cell.config["p"]),
                     r=int(cell.config["replicas"]),
                     chunk=int(cell.traffic["chunk"]), itemsize=4,
                     result_cache=cell.config["result_cache"] is not None)
        (outs, walls, window_s), view = tr.traced(
            lambda: closed_loop(lambda n, t: n >= n_traced),
            dispatches=n_traced,
            chunks=n_traced * cell.n_chunks * cell.chips,
            shape=shape, peaks=peaks_for(kind), cards=cell.chips)
    else:
        outs, walls, window_s = closed_loop(lambda n, t: t >= seconds)
    peaks = [torch.cuda.max_memory_allocated(d) if on_card else 0
             for d in system.cards(device, cell.chips)]
    if on_card:
        torch.cuda.empty_cache()

    picks = check.sample(seed, len(outs),
                         int(cell.workload["check_dispatches"]))
    values = check.numbers(cell, inputs, outs, seed, picks)
    correct, checks = check.judge(values, cell.limits)
    failed = check.bad_dispatches(cell, outs)

    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": cell.chips, "memory_peak_bytes": max(peaks),
                  "memory_peak_bytes_per_card": peaks}
    line = {"correct": correct and failed == 0, "attempted": len(outs),
            "failed": failed}
    if trace:
        metrics = {}
        for name in cells.names("metrics", root):
            mod = cells.load_metric(name, root)
            value = mod.read(view)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        device_rec.update(busy_s=view.busy_s(), window_s=view.window_s)
        line.update(metrics=metrics, device=device_rec,
                    breakdown=tr.breakdown(view))
    else:
        n_queries = int(cell.config["queries_per_scenario"])
        metrics = {
            "sim_queries_per_s": {
                "value": len(outs) * inputs.n_scen * n_queries / window_s,
                "unit": "queries/s"},
            "dispatch_p95_ms": {
                "value": 1e3 * statistics.quantiles(
                    walls, n=20, method="inclusive")[18]
                if len(walls) > 1 else 1e3 * walls[0],
                "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        line.update(metrics=metrics, device=device_rec)
        # where set-up went: process age at each step (not a metric)
        line["setup_marks_s"] = {**(setup_marks or {}), **marks}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from portbench.bench.cells import load_cell
    cell = load_cell(args.workload)
    marks = {"main": process_age_s()}

    import torch
    marks["torch"] = process_age_s()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{n_cards}", file=sys.stderr)
        return 3
    import repro_torch
    if CHECKOUT not in pathlib.Path(repro_torch.__file__).resolve().parents:
        print(f"repro_torch comes from {repro_torch.__file__}, not from "
              f"this checkout ({CHECKOUT})", file=sys.stderr)
        return 3
    marks["program"] = process_age_s()
    torch.cuda.init()
    marks["cuda"] = process_age_s()

    line = run_cell(cell, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device="cuda", setup_marks=marks)
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
