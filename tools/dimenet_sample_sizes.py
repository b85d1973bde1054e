"""How the base graph's average degree sets DimeNet's minibatch_lg sample.

The ``minibatch_lg`` cell samples 1,024 seeds (nodes 0..1023, the most
popular destinations) with fanouts (15, 10) from a 232,965-node power-law
graph, then builds up to 4 triplets an edge.  The reference's graph has
an average degree of 492 (114,615,892 edges); ``chip_smoke.py`` phase 25b
cuts it to 64 so that generation takes seconds.  A node with fewer
in-neighbours than its fanout gives fewer edges, so the cut can shrink the
sample itself.  This script builds the graph at each degree asked for
with the port's numpy sampler (`repro_torch.data.graph_sampler`, seed 0 as
phase 25b) and prints the sampled node, edge and triplet counts beside
the reference cell's buffers, and how long each step took on the host.

    PYTHONPATH=src python tools/dimenet_sample_sizes.py [DEGREE ...]

With no argument it takes 64 and 492.  At 492 the graph's arrays take
~6 GB of host memory at their peak and generation ~1 min on one core.
The last line is one JSON object: degree -> {"nodes", "edges",
"triplets", "seconds"}.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from repro_torch.configs import dimenet
from repro_torch.data import graph_sampler as GS
from repro_torch.launch.specs import gnn_cell_dims

N_NODES, D_FEAT = 232_965, 602
SEEDS, FANOUTS, BUDGET = 1024, (15, 10), 4
_DIMS = gnn_cell_dims(next(s for s in dimenet.SPEC.shapes
                           if s.name == "minibatch_lg"))
BUFFERS = (_DIMS["nodes"], _DIMS["edges"], _DIMS["triplets"])


def sample_sizes(avg_degree: int) -> dict:
    t0 = time.perf_counter()
    g = GS.make_power_law_graph(N_NODES, avg_degree, D_FEAT, seed=0)
    t_graph = time.perf_counter() - t0
    nodes, es, ed = GS.neighbor_sample(g, np.arange(SEEDS), FANOUTS, seed=0)
    t_kj, _ = GS._build_triplets(es, ed, BUFFERS[1], BUDGET,
                                 np.random.default_rng(0))
    out = {"edges_in_graph": int(len(g.csr_indices)), "nodes": len(nodes),
           "edges": len(es), "triplets": len(t_kj),
           "seconds": {"graph": round(t_graph, 1),
                       "sample": round(time.perf_counter() - t0 - t_graph,
                                       1)}}
    print(f"average degree {avg_degree}: {out['edges_in_graph']:,} edges "
          f"(graph {t_graph:.1f} s); sampled {out['nodes']:,} nodes, "
          f"{out['edges']:,} edges, {out['triplets']:,} triplets "
          f"(buffers {BUFFERS[0]:,} / {BUFFERS[1]:,} / {BUFFERS[2]:,}: "
          f"{100 * out['nodes'] / BUFFERS[0]:.1f} / "
          f"{100 * out['edges'] / BUFFERS[1]:.1f} / "
          f"{100 * out['triplets'] / BUFFERS[2]:.1f} % full)", flush=True)
    return out


def main(argv: list[str]) -> None:
    degrees = [int(a) for a in argv] or [64, 492]
    print(json.dumps({d: sample_sizes(d) for d in degrees}))


if __name__ == "__main__":
    main(sys.argv[1:])
