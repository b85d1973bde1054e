"""Synthetic document corpus with the statistics of the TodoBR collection.

The port's copy of `repro.engine.corpus`: the same numpy draws, so the
same seed gives bit-identical arrays.

The real 10M-page TodoBR collection is proprietary (paper Sec 4.2), so the
engine is exercised on a synthetic corpus whose controllable knobs are the
properties the paper shows matter: Zipf term popularity in documents (which
shapes inverted-list sizes), document length distribution, and vocabulary
size.  Index *construction* is an offline batch job and runs host-side in
numpy; the query-time hot path (scoring) runs in torch on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CorpusConfig", "Corpus", "generate_corpus"]


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 100_000
    vocab_size: int = 50_000
    mean_doc_len: int = 150
    term_zipf_alpha: float = 1.0     # term frequency in documents
    seed: int = 0

    # bytes per posting entry: docid (8) + tf (4) — matches the paper's
    # "document identifier and within-document frequency" entry layout.
    entry_bytes: int = 12


@dataclasses.dataclass
class Corpus:
    config: CorpusConfig
    doc_terms: np.ndarray    # (n_postings,) term ids, grouped by doc
    doc_offsets: np.ndarray  # (n_docs + 1,) CSR offsets into doc_terms
    tf: np.ndarray           # (n_postings,) within-doc term frequency

    @property
    def n_docs(self) -> int:
        return self.config.n_docs

    @property
    def n_postings(self) -> int:
        return int(self.doc_terms.shape[0])


def generate_corpus(config: CorpusConfig) -> Corpus:
    """Sample documents as bags of Zipf-distributed terms.

    Each document draws L ~ Poisson(mean_doc_len) tokens from the Zipf term
    distribution; duplicate (doc, term) tokens collapse into tf counts —
    the same unique-terms-per-document structure an inverted file stores.
    """
    rng = np.random.default_rng(config.seed)
    n, v = config.n_docs, config.vocab_size

    lengths = np.maximum(rng.poisson(config.mean_doc_len, size=n), 1)
    total = int(lengths.sum())

    # Zipf term sampling via inverse CDF over ranked probabilities.
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = ranks ** (-config.term_zipf_alpha)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    tokens = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    tokens = np.minimum(tokens, v - 1)

    doc_ids = np.repeat(np.arange(n, dtype=np.int64), lengths)

    # Collapse duplicates: unique (doc, term) with counts.
    key = doc_ids * v + tokens
    uniq, counts = np.unique(key, return_counts=True)
    u_doc = (uniq // v).astype(np.int32)
    u_term = (uniq % v).astype(np.int32)

    order = np.argsort(u_doc, kind="stable")
    u_doc, u_term, counts = u_doc[order], u_term[order], counts[order]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.add.at(offsets, u_doc + 1, 1)
    offsets = np.cumsum(offsets)

    return Corpus(config=config, doc_terms=u_term,
                  doc_offsets=offsets, tf=counts.astype(np.int32))
