"""Quickstart on the PyTorch port: the paper's methodology in a minute.

Build a small vertical search engine, characterize its workload, measure
one index server (its scorer on the card), parameterize the queueing
model, and answer the manager's three questions (paper Sec 5).  The port
of examples/quickstart.py.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      [--device cpu]     (default: cuda)
"""

import argparse

import numpy as np

from repro_torch.core import capacity, queueing
from repro_torch.engine import corpus as corpus_lib
from repro_torch.engine import index as index_lib
from repro_torch.engine import server
from repro_torch.workloadgen import querygen

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# 1. A synthetic collection with TodoBR-like statistics (Sec 4).
print("== building corpus + inverted index ==")
ccfg = corpus_lib.CorpusConfig(n_docs=5000, vocab_size=3000,
                               mean_doc_len=50, seed=0)
corp = corpus_lib.generate_corpus(ccfg)
idx = index_lib.build_index(corp)
print(f"   {corp.n_docs} docs, {idx.n_postings} postings, "
      f"{idx.index_bytes() / 2**20:.1f} MiB index")

# 2. A Zipf query workload (query alpha = 0.82, term alpha = 0.98).
uni = querygen.build_universe(querygen.WorkloadConfig(
    "demo", n_unique_queries=1000, vocab_size=3000, seed=0))
_, qterms = querygen.sample_query_stream(uni, 512)

# 3. Measure ONE index server (the paper's small-scale experiment).
print(f"== measuring one index server on {dev} ==")
srv = server.IndexServer(idx, k_local=10, device=dev)
params = server.measure_service_params(
    srv, np.tile(qterms, (2, 1)), cache_bytes=idx.index_bytes() // 5,
    p=8, s_broker=0.3e-3, batch=64)
s = float(queueing.service_time_server(params, device=dev))
print(f"   hit={float(params.hit):.2f}  S_server={s * 1e3:.2f} ms")

# 4. Answer the manager's questions (Sec 5: questions i-iii).
lam = 0.5 / s
lo, hi = queueing.response_time_bounds(lam, params, device=dev)
print(f"Q1  At {lam:.0f} qps on p=8 servers: "
      f"{float(lo) * 1e3:.1f} ms <= R <= {float(hi) * 1e3:.1f} ms")

fast = queueing.ServerParams(
    p=8, s_broker=params.s_broker, s_hit=params.s_hit / 2,
    s_miss=params.s_miss / 2, s_disk=params.s_disk, hit=params.hit)
_, hi2 = queueing.response_time_bounds(lam, fast, device=dev)
print(f"Q2  2x faster CPUs would cut the bound to "
      f"{float(hi2) * 1e3:.1f} ms")

plan = capacity.plan_capacity(params, target_rate=20 * lam,
                              slo_seconds=float(hi) * 1.1, device=dev)
print(f"Q3  To serve {20 * lam:.0f} qps under a "
      f"{float(hi) * 1.1 * 1e3:.0f} ms SLO: {plan.n_replicas} replicas "
      f"x {plan.servers_per_replica} servers "
      f"({plan.total_servers} total), each at "
      f"{plan.per_replica_rate_qps:.1f} qps")
