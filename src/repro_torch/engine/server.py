"""Index server: local query processing + the measurement harness.

`IndexServer` wraps one shard's device tensors with the scorer and a
service-time instrumentation path that mirrors the paper's methodology
(Sec 4.3/5.3) as `repro.engine.server` does: the host clock around the
scorer call, ended by a device sync (the reference's
``block_until_ready``), so a batch's time is its launches plus its device
time on the card, and the host copy of its top-k lies outside the window;
disk time comes from the LRU cache replay; the two compose into Eq 1
parameters.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.core.queueing import ServerParams
from repro_torch.engine import cache as cache_lib
from repro_torch.engine.broker import sync
from repro_torch.engine.index import InvertedIndex
from repro_torch.engine.scoring import score_queries

__all__ = ["IndexServer", "measure_service_params", "measure_busy_trace"]


class IndexServer:
    def __init__(self, index: InvertedIndex, *, budget: int = None,
                 k_local: int = 10, device: DeviceLike = DEFAULT_DEVICE):
        self.index = index
        self.device = torch.device(device)
        (self.term_offsets, self.doc_ids,
         self.weights, self.doc_norms) = index.as_device_arrays(self.device)
        max_list = int(index.list_lengths().max()) if index.n_postings else 1
        self.budget = int(budget or max_list)
        self.k_local = k_local

    def process(self, query_terms):
        """Local top-k for a batch of queries (the hot path)."""
        return score_queries(
            self.term_offsets, self.doc_ids, self.weights, self.doc_norms,
            torch.as_tensor(query_terms, device=self.device),
            n_docs=self.index.n_docs, budget=self.budget, k=self.k_local)

    def timed_process(self, query_terms) -> float:
        """Wall-clock seconds for one batch (post-warmup)."""
        t0 = time.perf_counter()
        s, _ = self.process(query_terms)
        sync(s)
        return time.perf_counter() - t0


def _batches(server: IndexServer, query_terms: np.ndarray, batch: int):
    """(n // batch, batch, L) query terms on the server's device."""
    q = query_terms.shape[0]
    return torch.as_tensor(query_terms[: batch * (q // batch)].reshape(
        -1, batch, query_terms.shape[1]), device=server.device)


def measure_service_params(
    server: IndexServer,
    query_terms: np.ndarray,          # (Q, L) int, padded -1
    cache_bytes: int,
    *,
    p: int,
    s_broker: float,
    batch: int = 64,
    warmup_batches: int = 2,
    disk_bw: float = 50e6,
    disk_seek: float = 8e-3,
) -> ServerParams:
    """The paper's parameterization step, end to end.

    CPU time: measured around the scorer per batch, divided by batch
    (hit and miss share the compute path).  Disk time and hit
    probability: LRU replay over this server's list sizes.  Returns Eq 1
    parameters (Python floats) for the queueing model.
    """
    stats, hits, disk_time = cache_lib.measure_cache_behavior(
        query_terms, server.index.list_bytes(), cache_bytes,
        disk_bw=disk_bw, disk_seek=disk_seek,
        warmup=min(query_terms.shape[0] // 10, 2000))

    qt = _batches(server, query_terms, batch)
    times = []
    for i in range(qt.shape[0]):
        dt = server.timed_process(qt[i])
        if i >= warmup_batches:
            times.append(dt / batch)
    s_cpu = float(np.mean(times)) if times else 1e-3

    miss = ~hits
    s_disk = float(disk_time[miss].mean()) if miss.any() else 0.0
    return ServerParams(
        p=p, s_broker=s_broker,
        s_hit=s_cpu, s_miss=s_cpu, s_disk=s_disk,
        hit=stats.hit)


def measure_busy_trace(
    server: IndexServer,
    query_terms: np.ndarray,          # (n, L) int, padded -1
    cache_bytes: int,
    *,
    batch: int = 64,
    warmup_batches: int = 2,
    disk_bw: float = 50e6,
    disk_seek: float = 8e-3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-query instrumentation at ONE shard, for trace calibration.

    Where :func:`measure_service_params` reduces the run to Eq-1 scalars,
    this keeps the whole record: per-query busy time (timed scorer, per
    batch, plus the cache replay's per-query disk time), the full-hit
    flag, the disk split, and the partial top-k results so the broker
    merge can be timed downstream.  ``n`` must be a multiple of
    ``batch``.  Returns numpy (busy, hit, disk, scores, docs) with shapes
    ((n,), (n,), (n,), (n, k_local), (n, k_local)).
    """
    n = query_terms.shape[0]
    if n % batch:
        raise ValueError(f"n={n} must be a multiple of batch={batch}")
    _, hits, disk_time = cache_lib.measure_cache_behavior(
        query_terms, server.index.list_bytes(), cache_bytes,
        disk_bw=disk_bw, disk_seek=disk_seek, warmup=0)

    qt = _batches(server, query_terms, batch)
    for _ in range(max(warmup_batches, 1)):
        server.timed_process(qt[0])   # first-call costs before any timing
    cpu = np.zeros(n, dtype=np.float64)
    scores = np.zeros((n, server.k_local), dtype=np.float32)
    docs = np.zeros((n, server.k_local), dtype=np.int32)
    for i in range(qt.shape[0]):
        t0 = time.perf_counter()
        s, d = server.process(qt[i])
        sync(s)
        cpu[i * batch:(i + 1) * batch] = (time.perf_counter() - t0) / batch
        scores[i * batch:(i + 1) * batch] = s.cpu().numpy()
        docs[i * batch:(i + 1) * batch] = d.cpu().numpy()

    disk = np.where(hits, 0.0, disk_time)
    return cpu + disk, hits.astype(np.float64), disk, scores, docs
