"""Disk-cache and result-cache simulation (paper Sec 3.4 / Scenario 6).

`LruByteCache` simulates the OS page cache over inverted-list bytes at one
index server: queries touch their terms' lists; a query is a *full hit*
when every list is resident (Eq 1's ``hit``).  This is the measurement
instrument that replaces the paper's /proc/diskstats readings and exposes
the mechanism behind service-time imbalance: p servers run the SAME query
stream over 1/p-size lists but their caches diverge only in degree — the
hit/miss split per query is what spreads service times.

`ResultCache` is the broker's application-level query-result cache
(Scenario 6, parameters from Baeza-Yates et al. [8]).

Both are host-side Python (they model OS/broker state machines, not device
compute); their *outputs* parameterize the queueing model.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

__all__ = ["LruByteCache", "CacheStats", "ResultCache",
           "measure_cache_behavior"]


@dataclasses.dataclass
class CacheStats:
    queries: int = 0
    full_hits: int = 0
    bytes_from_disk: int = 0
    bytes_requested: int = 0

    @property
    def hit(self) -> float:
        return self.full_hits / max(self.queries, 1)

    @property
    def disk_fraction(self) -> float:
        return self.bytes_from_disk / max(self.bytes_requested, 1)


class LruByteCache:
    """Byte-capacity LRU over term ids (posting lists)."""

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self._lru: OrderedDict[int, int] = OrderedDict()
        self._used = 0

    def access(self, term: int, size: int) -> bool:
        """Touch one list; returns True on hit.  Inserts on miss."""
        if term in self._lru:
            self._lru.move_to_end(term)
            return True
        size = min(size, self.capacity)
        while self._used + size > self.capacity and self._lru:
            _, evicted = self._lru.popitem(last=False)
            self._used -= evicted
        self._lru[term] = size
        self._used += size
        return False

    def query(self, terms, sizes) -> tuple[bool, int]:
        """Access all of a query's lists; (full_hit, bytes_from_disk)."""
        full_hit = True
        from_disk = 0
        for t, z in zip(terms, sizes):
            if not self.access(int(t), int(z)):
                full_hit = False
                from_disk += int(z)
        return full_hit, from_disk


class ResultCache:
    """LRU cache of final answers keyed by query id (Scenario 6)."""

    def __init__(self, capacity_entries: int):
        self.capacity = int(capacity_entries)
        self._lru: OrderedDict[int, bool] = OrderedDict()
        self.hits = 0
        self.lookups = 0

    def lookup(self, query_id: int) -> bool:
        self.lookups += 1
        if query_id in self._lru:
            self._lru.move_to_end(query_id)
            self.hits += 1
            return True
        if self.capacity > 0:
            if len(self._lru) >= self.capacity:
                self._lru.popitem(last=False)
            self._lru[query_id] = True
        return False

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(self.lookups, 1)


def measure_cache_behavior(
    query_terms: np.ndarray,      # (Q, L) padded with -1
    list_bytes: np.ndarray,       # (V,) per-term list size at this server
    cache_bytes: int,
    *,
    disk_bw: float = 50e6,
    disk_seek: float = 8e-3,
    warmup: int = 0,
) -> tuple[CacheStats, np.ndarray, np.ndarray]:
    """Replay a query stream through the LRU; returns per-query outputs.

    Returns (stats, full_hit[Q] bool, disk_time[Q] seconds).  Mirrors the
    paper's methodology: warm the cache, then measure (``measured after
    warming up the index servers``, Sec 4.3).
    """
    cache = LruByteCache(cache_bytes)
    q = query_terms.shape[0]
    hits = np.zeros(q, dtype=bool)
    disk_time = np.zeros(q, dtype=np.float64)
    stats = CacheStats()
    for i in range(q):
        terms = query_terms[i]
        terms = terms[terms >= 0]
        sizes = list_bytes[terms]
        full_hit, from_disk = cache.query(terms, sizes)
        hits[i] = full_hit
        disk_time[i] = 0.0 if full_hit else disk_seek + from_disk / disk_bw
        if i >= warmup:
            stats.queries += 1
            stats.full_hits += int(full_hit)
            stats.bytes_from_disk += from_disk
            stats.bytes_requested += int(sizes.sum())
    return stats, hits, disk_time
