"""One cell's traced window, read through the program's own layer spans.

    python3 portbench/layers.py --workload <cell> --seed <n>

From the root of a checkout, on the card.  It runs ``run.py --trace 1``'s
own window (``run.run_cell``: set-up, ``run.TRACE_DISPATCHES``
dispatches under the profiler, the check) and keeps the profiler's
events.  From that one trace it prints a JSON line: the ``metrics/``
readers and the readings of `bench/layers.py` (``READERS``); each
layer's device ms and host ms a chunk; the device's idle time a
dispatch; the share of the chunks' device time that a leaf span owns;
the share of kernels launched no later than they ran; and the cost of
one span, off and on, on this host.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def span_cost_us(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    """Microseconds an enter and exit of `layer_span` and of a
    `LayerSpans.open`, with no profiler and under a CPU profiler; empty
    where the program has no such hook."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        from repro_torch.obs.profile import LayerSpans, layer_span
    except ImportError:
        return {}

    def timed(n, body):
        t0 = time.perf_counter()
        body(n)
        return 1e6 * (time.perf_counter() - t0) / n

    def spans(n):
        for _ in range(n):
            with layer_span("repro_torch.sim.probe"):
                pass

    def opens(n):
        with LayerSpans("repro_torch.sim.") as seq:
            for _ in range(n):
                seq.open("probe")

    def empty(n):
        for _ in range(n):
            pass

    out = {"loop_us": timed(n_off, empty),
           "layer_span_off_us": timed(n_off, spans),
           "open_off_us": timed(n_off, opens)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["layer_span_on_us"] = timed(n_on, spans)
        out["open_on_us"] = timed(n_on, opens)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for _ in range(n_on):
            with torch.profiler.record_function("repro_torch.sim.probe"):
                pass
        out["record_function_on_us"] = \
            1e6 * (time.perf_counter() - t0) / n_on
    return out


def read_window(cell, *, seed: int, device) -> dict:
    """``run.run_cell(trace=True)`` on ``cell``, with the window's
    profiler events kept and read by layer as well."""
    from portbench import run
    from portbench.bench import layers as ly
    from portbench.bench import trace as tr

    kept = {}
    plain = tr.view_from_events

    def keep(events, **kw):
        kept.update(kw, events=events)
        return plain(events, **kw)

    tr.view_from_events = keep
    try:
        line = run.run_cell(cell, seed=seed, seconds=0.0, trace=True,
                            device=device)
    finally:
        tr.view_from_events = plain
    dispatches, chunks = kept["dispatches"], kept["chunks"]
    lv = ly.view_from_events(kept["events"], dispatches=dispatches,
                             chunks=chunks)

    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    for name, (_, read) in ly.READERS.items():
        value = read(lv)
        if value is not None:
            metrics[name] = value
    layers = sorted({s[0] for s in lv.spans})
    device_ms = {n: 1e3 * lv.layer_s(n) / chunks for n in layers}
    device_ms["(none)"] = 1e3 * sum(op.seconds for op in lv.ops
                                    if op.layer is None) / chunks
    host_ms = {n: 1e-3 * sum(e - s for s, e in lv.host_intervals(n)) / chunks
               for n in layers}
    return {
        "cell": cell.name, "seed": seed, "kind": line["device"]["kind"],
        "correct": line["correct"], "dispatches": dispatches,
        "chunks": chunks, "window_s": kept["window_s"],
        "busy_s": line["device"]["busy_s"],
        "metrics": metrics,
        "device_ms_per_chunk": device_ms,
        "host_ms_per_chunk": host_ms,
        "setup_host_ms_per_dispatch": 1e-3 * sum(
            e - s for s, e in lv.host_intervals("setup")) / dispatches,
        "idle_ms_per_dispatch": 1e3 * lv.idle_s() / dispatches,
        "leaf_coverage": lv.coverage(),
        "launch_first_share": lv.launch_first_share(),
        "spans_per_dispatch": len(lv.spans) / dispatches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if sys.path and sys.path[0] == str(HERE):
        del sys.path[0]
    sys.path.insert(0, str(HERE.parent))
    from portbench import run
    run._paths()

    from portbench.bench.cells import load_cell

    rec = read_window(load_cell(args.workload), seed=args.seed,
                      device="cuda")
    rec["span_cost_us"] = span_cost_us()
    found = run.banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
