"""End-to-end serving loop (PyTorch port of examples/serve_search.py,
the flagship example: the paper's kind of system is a serving system): a
live vertical search engine under open-loop Poisson load with batched
request processing, an application-level result cache, and
capacity-model-driven admission.

The loop measures actual per-request latencies on this machine and
compares them against the queueing model parameterized from the same
measurements — the full Sec 5.3 validation, live.  Beside the
reference's lines it prints how many batches started behind schedule
and the mean latency of the last second against the first: ``S_query``
times the scorer's launches and device work only, so host work per
batch (cache lookups, padding, the host-to-device copy, the sync) that
outweighs it shows there as a backlog that never drains.

Run:  PYTHONPATH=src python examples/torch_serve_search.py
      [--device cpu] [--duration 15]     (default device: cuda)
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.engine import cache as cache_lib
from repro_torch.engine import corpus as corpus_lib
from repro_torch.engine import index as index_lib
from repro_torch.engine import server
from repro_torch.engine.broker import sync
from repro_torch.launch.elastic import hedge_threshold
from repro_torch.workloadgen import loadgen, querygen

BATCH = 32
CACHE_ENTRIES = 500
LOAD = 0.6                  # offered rate, a fraction of the capacity


@dataclasses.dataclass
class Served:
    """What one open-loop run measured."""

    latencies: np.ndarray   # (served,) seconds, in admission order
    arrivals: np.ndarray    # (served,) each latency's arrival time
    cache_hits: int
    served: int
    batches: int
    behind: int             # batches whose window had closed on arrival

    def drift(self, span: float = 1.0) -> tuple[float, float]:
        """Mean latency of requests arriving in the first and in the last
        ``span`` seconds of the run (NaN where none arrived)."""
        end = float(self.arrivals[-1]) if self.served else 0.0

        def mean(sel):
            return float(self.latencies[sel].mean()) if sel.any() else \
                float("nan")
        return (mean(self.arrivals < span),
                mean(self.arrivals >= end - span))


def serve_open_loop(process, arrivals, qids, qterms, *, batch: int,
                    window_s: float, cache, clock=time.perf_counter,
                    sleep=time.sleep) -> Served:
    """Serve ``arrivals`` (seconds from the start) open loop.

    A batch waits out ``window_s`` after its head arrival (not when the
    loop is already behind: batches then fill from the backlog), then
    admits every request that has ACTUALLY arrived, at most ``batch``.
    The result ``cache`` short-circuits repeats; the misses, padded with
    -1 to ``batch`` rows, go through ``process(terms)`` and a device
    sync.  A request's latency runs from its arrival to its batch's end.
    """
    t0 = clock()
    latencies, cache_hits, served, batches, behind = [], 0, 0, 0, 0
    i = 0
    while i < len(arrivals):
        now = clock() - t0
        if arrivals[i] > now:
            sleep(min(arrivals[i] - now, 0.01))
            continue
        # admitting future arrivals would log negative latencies and
        # corrupt the measured-vs-model compare
        wait_end = arrivals[i] + window_s
        if now < wait_end:
            sleep(wait_end - now)
            now = clock() - t0
        else:
            behind += 1
        j = i
        while j < len(arrivals) and arrivals[j] <= now and j - i < batch:
            j += 1
        req_ids = qids[i:j]
        # result cache short-circuits repeats (Scenario 6)
        misses = [k for k, qid in enumerate(req_ids)
                  if not cache.lookup(int(qid))]
        cache_hits += len(req_ids) - len(misses)
        if misses:
            qt = np.full((batch, qterms.shape[1]), -1, np.int32)
            qt[: len(misses)] = qterms[i:j][misses]
            scores, _ = process(qt)
            sync(scores)
        done = clock() - t0
        latencies.extend(done - arrivals[i:j])
        served += j - i
        batches += 1
        i = j
    return Served(np.asarray(latencies), np.asarray(arrivals[:served]),
                  cache_hits, served, batches, behind)


def build_engine(device):
    """The reference's engine: 4,000 docs, vocabulary 2,500, local top-10;
    (IndexServer, query universe)."""
    corp = corpus_lib.generate_corpus(corpus_lib.CorpusConfig(
        n_docs=4000, vocab_size=2500, mean_doc_len=40, seed=0))
    srv = server.IndexServer(index_lib.build_index(corp), k_local=10,
                             device=device)
    uni = querygen.build_universe(querygen.WorkloadConfig(
        "serve", n_unique_queries=2000, vocab_size=2500, seed=0))
    return srv, uni


def measure_s_query(srv, uni) -> float:
    """Seconds a query at the serving batch size, after a warm batch."""
    _, qterms = querygen.sample_query_stream(uni, 4096, seed=7)
    qt = torch.as_tensor(qterms[:BATCH], device=srv.device)
    srv.timed_process(qt)
    return srv.timed_process(qt) / BATCH


def model_figures(s_query: float, rate: float, device):
    """Eq 7's bounds at ``rate`` for one local server (p = 1) whose
    service time is ``s_query``, and the hedged-duplicate threshold at a
    fan-out of 8: (lo, hi, hedge) in seconds."""
    params = queueing.ServerParams(p=1, s_broker=1e-5, s_hit=s_query,
                                   s_miss=s_query, s_disk=0.0, hit=1.0)
    lo, hi = queueing.response_time_bounds(rate, params, device=device)
    return float(lo), float(hi), hedge_threshold(s_query, 8)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="target qps (default: 60%% of capacity)")
    ap.add_argument("--batch-window-ms", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    print("== build engine ==")
    srv, uni = build_engine(dev)
    s_query = measure_s_query(srv, uni)
    cap = 1.0 / s_query
    rate = args.rate or LOAD * cap
    print(f"   measured S_query={s_query * 1e3:.3f} ms  capacity~{cap:.0f}"
          f" qps  offering {rate:.0f} qps")

    # the model's prediction for this operating point (p=1 local server)
    lo, hi, hedge = model_figures(s_query, rate, dev)
    print(f"   model: {lo * 1e3:.2f} <= R <= {hi * 1e3:.2f}"
          f" ms;  hedged-duplicate threshold {hedge * 1e3:.1f} ms")

    print("== open-loop serving ==")
    arrivals = loadgen.poisson_arrivals(rate, args.duration, seed=3)
    qids, qterms = querygen.sample_query_stream(uni, len(arrivals), seed=9)
    run = serve_open_loop(
        srv.process, arrivals, qids, qterms, batch=BATCH,
        window_s=args.batch_window_ms / 1e3,
        cache=cache_lib.ResultCache(capacity_entries=CACHE_ENTRIES),
        clock=time.perf_counter, sleep=time.sleep)

    lat = run.latencies
    print(f"   served {run.served} requests; result-cache hit "
          f"{run.cache_hits / max(run.served, 1):.2f}")
    print(f"   measured mean={lat.mean() * 1e3:.1f} ms "
          f"p50={np.quantile(lat, .5) * 1e3:.1f} "
          f"p95={np.quantile(lat, .95) * 1e3:.1f} "
          f"p99={np.quantile(lat, .99) * 1e3:.1f} ms")
    print(f"   model bound was [{lo * 1e3:.1f}, "
          f"{hi * 1e3:.1f}] ms + batching window "
          f"{args.batch_window_ms:.0f} ms")
    first, last = run.drift()
    print(f"   {run.behind} of {run.batches} batches started behind "
          f"schedule; mean latency first second {first * 1e3:.1f} ms, "
          f"last second {last * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
