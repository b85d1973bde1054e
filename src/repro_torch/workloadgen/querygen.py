"""Query workload generator matching the paper's characterization (Sec 4).

A copy of `repro.workloadgen.querygen` (numpy only): the same seed gives
the reference's universe and streams bit for bit.

Builds a *query universe* (unique queries with Zipf popularity, lengths
from Table 2, terms Zipf-distributed over the vocabulary) and samples query
streams from it.  Defaults are the TodoBR measurements: query popularity
alpha = 0.82, term popularity alpha = 0.98, length distribution
{1: 0.32, 2: 0.41, >=3: 0.27}.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WorkloadConfig", "QueryUniverse", "build_universe",
           "sample_query_stream", "TODOBR", "RADIX"]


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    name: str
    n_unique_queries: int = 50_000
    vocab_size: int = 50_000
    query_zipf_alpha: float = 0.82
    term_zipf_alpha: float = 0.98
    # P(len = 1), P(len = 2), remainder spread over 3..max_len
    p_len1: float = 0.32
    p_len2: float = 0.41
    max_len: int = 6
    seed: int = 0


TODOBR = WorkloadConfig("todobr", query_zipf_alpha=0.82,
                        term_zipf_alpha=0.98, p_len1=0.32, p_len2=0.41)
RADIX = WorkloadConfig("radix", query_zipf_alpha=0.89,
                       term_zipf_alpha=1.09, p_len1=0.35, p_len2=0.43)


@dataclasses.dataclass
class QueryUniverse:
    config: WorkloadConfig
    terms: np.ndarray        # (U, max_len) int32, padded with -1
    lengths: np.ndarray      # (U,)
    popularity: np.ndarray   # (U,) sampling probabilities (Zipf)


def _zipf_cdf(n: int, alpha: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    return np.cumsum(w / w.sum())


def build_universe(config: WorkloadConfig) -> QueryUniverse:
    rng = np.random.default_rng(config.seed)
    u, v, ml = config.n_unique_queries, config.vocab_size, config.max_len

    # lengths from the Table-2 distribution, tail geometric over 3..max
    p3 = 1.0 - config.p_len1 - config.p_len2
    tail = np.array([0.5 ** i for i in range(ml - 2)])
    tail = tail / tail.sum() * p3
    probs = np.concatenate([[config.p_len1, config.p_len2], tail])
    lengths = rng.choice(np.arange(1, ml + 1), size=u, p=probs)

    term_cdf = _zipf_cdf(v, config.term_zipf_alpha)
    terms = np.full((u, ml), -1, dtype=np.int32)
    for i in range(u):
        l_i = lengths[i]
        # draw distinct terms for one query
        t = np.unique(np.searchsorted(term_cdf, rng.random(l_i * 3)))[:l_i]
        while len(t) < l_i:
            t = np.unique(np.concatenate(
                [t, np.searchsorted(term_cdf, rng.random(l_i))]))[:l_i]
        terms[i, :l_i] = np.minimum(t, v - 1)

    q_w = np.arange(1, u + 1, dtype=np.float64) ** (-config.query_zipf_alpha)
    popularity = q_w / q_w.sum()
    return QueryUniverse(config=config, terms=terms,
                         lengths=lengths.astype(np.int32),
                         popularity=popularity)


def sample_query_stream(
    universe: QueryUniverse, n_queries: int, *, seed: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """(query_ids, padded term matrix) for a Zipf-popular stream."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(universe.popularity)
    qids = np.searchsorted(cdf, rng.random(n_queries)).astype(np.int64)
    qids = np.minimum(qids, len(cdf) - 1)
    return qids, universe.terms[qids]
