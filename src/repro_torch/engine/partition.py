"""Index partitioning strategies (paper Sec 2.1 / 3.2).

Document partitioning (the paper's choice and the de-facto standard) plus
the term-partitioning baseline the related work compares against, so the
framework can reproduce the comparison conclusions.

Documents are assigned to servers randomly (uniform hashing), the policy
the paper cites as balancing storage well [5, 3].
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.engine.corpus import Corpus
from repro_torch.engine.index import InvertedIndex, build_index

__all__ = ["partition_documents", "partition_terms", "Partitioned"]


@dataclasses.dataclass
class Partitioned:
    """A partitioned index: one InvertedIndex per server + routing info."""

    scheme: str                    # "document" | "term"
    shards: List[InvertedIndex]
    doc_base: np.ndarray           # (p,) global doc-id base per shard
    term_owner: np.ndarray | None  # (V,) owning server (term partitioning)

    @property
    def p(self) -> int:
        return len(self.shards)


def partition_documents(corpus: Corpus, p: int, *, seed: int = 0
                        ) -> Partitioned:
    """Random uniform assignment of documents to p servers.

    Each server builds a full local index over its subcollection of size
    b = n/p; global document frequencies are shared so local idf == global
    idf (Sec 3.3).
    """
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, p, size=corpus.n_docs)

    # Global doc freq over the whole collection for idf exchange.
    v = corpus.config.vocab_size
    gdf = np.zeros(v, dtype=np.int64)
    np.add.at(gdf, corpus.doc_terms, 1)

    lengths = np.diff(corpus.doc_offsets)
    shards, bases = [], []
    for s in range(p):
        docs = np.flatnonzero(assign == s)
        bases.append(docs)
        mask = np.isin(
            np.repeat(np.arange(corpus.n_docs), lengths), docs)
        sub_terms = corpus.doc_terms[mask]
        sub_tf = corpus.tf[mask]
        # renumber docs 0..b-1 inside the shard
        sub_lengths = lengths[docs]
        sub_offsets = np.concatenate([[0], np.cumsum(sub_lengths)])
        sub = Corpus(
            config=dataclasses.replace(corpus.config, n_docs=len(docs)),
            doc_terms=sub_terms, doc_offsets=sub_offsets, tf=sub_tf)
        shards.append(build_index(sub, global_doc_freq=gdf,
                                  total_docs=corpus.n_docs))
    # doc_base maps (shard, local_id) -> global id
    doc_base = np.zeros(p, dtype=np.int64)  # kept simple: store tables
    part = Partitioned(scheme="document", shards=shards,
                       doc_base=doc_base, term_owner=None)
    part.local_to_global = bases  # list of arrays
    return part


def partition_hybrid(corpus: Corpus, p: int, *, chunk_docs: int = 256,
                     seed: int = 0) -> Partitioned:
    """Hybrid partitioning (Sornil & Fox; Badue et al. [2], Sec 2.1):
    each inverted list is cut into equal-size chunks which are randomly
    distributed over the servers.

    Realized here by hashing (term, doc_block) pairs to servers: a term's
    postings land on many servers in contiguous chunks, balancing both
    storage AND per-query load (vs document partitioning's per-server
    full-query work or term partitioning's hot owners).
    """
    rng = np.random.default_rng(seed)
    v = corpus.config.vocab_size
    gdf = np.zeros(v, dtype=np.int64)
    np.add.at(gdf, corpus.doc_terms, 1)

    lengths = np.diff(corpus.doc_offsets)
    doc_of_posting = np.repeat(np.arange(corpus.n_docs), lengths)
    # chunk id = (term, doc // chunk_docs); server = hash(chunk) % p
    chunk_key = (corpus.doc_terms.astype(np.int64) * 1_000_003
                 + doc_of_posting // chunk_docs)
    owner = (chunk_key * 2654435761 % 2**32) % p

    shards = []
    for s in range(p):
        mask = owner == s
        sub_docs = doc_of_posting[mask]
        sub_terms = corpus.doc_terms[mask]
        sub_tf = corpus.tf[mask]
        order = np.argsort(sub_docs, kind="stable")
        sub_docs, sub_terms, sub_tf = (
            sub_docs[order], sub_terms[order], sub_tf[order])
        offsets = np.zeros(corpus.n_docs + 1, dtype=np.int64)
        np.add.at(offsets, sub_docs + 1, 1)
        offsets = np.cumsum(offsets)
        sub = Corpus(config=corpus.config, doc_terms=sub_terms,
                     doc_offsets=offsets, tf=sub_tf)
        shards.append(build_index(sub, global_doc_freq=gdf,
                                  total_docs=corpus.n_docs))
    return Partitioned(scheme="hybrid", shards=shards,
                       doc_base=np.zeros(p, dtype=np.int64),
                       term_owner=None)


def partition_terms(corpus: Corpus, p: int) -> Partitioned:
    """Term partitioning baseline: server s owns terms with hash(t) % p == s.

    Every server indexes the *whole* collection restricted to its terms, so
    a query only visits the owners of its terms (here, for the comparison
    benchmark, we still broadcast and let non-owners return empty).
    """
    v = corpus.config.vocab_size
    owner = (np.arange(v) * 2654435761 % 2**32) % p

    gdf = np.zeros(v, dtype=np.int64)
    np.add.at(gdf, corpus.doc_terms, 1)

    lengths = np.diff(corpus.doc_offsets)
    doc_of_posting = np.repeat(np.arange(corpus.n_docs), lengths)
    shards = []
    for s in range(p):
        mask = owner[corpus.doc_terms] == s
        sub_terms = corpus.doc_terms[mask]
        sub_tf = corpus.tf[mask]
        sub_docs = doc_of_posting[mask]
        # rebuild a CSR by doc for build_index
        order = np.argsort(sub_docs, kind="stable")
        sub_docs, sub_terms, sub_tf = (
            sub_docs[order], sub_terms[order], sub_tf[order])
        offsets = np.zeros(corpus.n_docs + 1, dtype=np.int64)
        np.add.at(offsets, sub_docs + 1, 1)
        offsets = np.cumsum(offsets)
        sub = Corpus(config=corpus.config, doc_terms=sub_terms,
                     doc_offsets=offsets, tf=sub_tf)
        shards.append(build_index(sub, global_doc_freq=gdf,
                                  total_docs=corpus.n_docs))
    return Partitioned(scheme="term", shards=shards,
                       doc_base=np.zeros(p, dtype=np.int64),
                       term_owner=owner)
