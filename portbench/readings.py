"""The readings that a cell's correctness limits are set from.

    python3 portbench/readings.py --workload <cell> --first-seed N \
        [--out FILE]

On the cell's cards, at its own size and load (one dispatch at a time,
as the window runs them): for each of 12 seeds from ``--first-seed``, the
program's dispatch against the float64 reference (the lower readings,
from sound runs), and for the first 3 the control, the reference itself
computed in bfloat16 and put in the program's place (the upper
readings).  Each line printed is a JSON record; the benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
SEEDS, CONTROL_SEEDS, DEVICE = 12, 3, "cuda"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if sys.path and sys.path[0] == str(HERE):
        del sys.path[0]
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

    import torch

    from portbench.bench import cells, check, system

    cell = cells.load_cell(args.workload)
    inputs = system.make_inputs(cell, DEVICE)
    dispatch = system.make_dispatch(cell, inputs, DEVICE)
    dispatch(system.warm_seed(0, 0))
    records = []

    def record(seed, side, got, want):
        rec = {"cell": cell.name, "seed": seed, "side": side,
               **check.errors(cell, got, want)}
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for i in range(SEEDS):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        out = dispatch(system.dispatch_seed(seed, 0))
        ref = check.reference(cell, inputs, system.dispatch_seed(seed, 0))
        record(seed, "program", out, ref)
        if i < CONTROL_SEEDS:
            ctl = check.reference(cell, inputs, system.dispatch_seed(seed, 0),
                                  dtype=torch.bfloat16,
                                  route_dtype=torch.bfloat16)
            record(seed, "control_bf16", ctl, ref)
        print(f"# seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
