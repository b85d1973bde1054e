"""Inverted index (paper Sec 3.2): vocabulary + CSR posting lists.

Each term's inverted list holds (doc_id, tf) entries.  Construction is an
offline numpy batch job (the port's copy of `repro.engine.index`, the same
arrays from the same corpus); the resulting arrays are handed to torch,
on the card by default, for the query-time hot path.  Global idf factors
are derived exactly as the paper describes: document frequencies are
exchanged after local index generation (here: computed over the full
collection, then broadcast).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.engine.corpus import Corpus

__all__ = ["InvertedIndex", "build_index"]


@dataclasses.dataclass
class InvertedIndex:
    """CSR inverted file over one (sub)collection."""

    n_docs: int
    vocab_size: int
    term_offsets: np.ndarray   # (V + 1,) int64 — CSR offsets per term
    doc_ids: np.ndarray        # (NNZ,) int32 — postings, doc-sorted per term
    tf: np.ndarray             # (NNZ,) float32 — within-doc frequency
    doc_norms: np.ndarray      # (D,) float32 — vector-model document norms
    idf: np.ndarray            # (V,) float32 — GLOBAL inverse doc frequency
    entry_bytes: int = 12

    @property
    def n_postings(self) -> int:
        return int(self.doc_ids.shape[0])

    def list_lengths(self) -> np.ndarray:
        return np.diff(self.term_offsets)

    def list_bytes(self) -> np.ndarray:
        """Per-term inverted-list size in bytes — drives the disk model."""
        return self.list_lengths() * self.entry_bytes

    def index_bytes(self) -> int:
        return self.n_postings * self.entry_bytes

    def posting_weights(self) -> np.ndarray:
        """(NNZ,) float32 tf * idf of each posting."""
        w = self.tf * self.idf[np.repeat(
            np.arange(self.vocab_size), self.list_lengths())]
        return w.astype(np.float32)

    def as_device_arrays(self, device: DeviceLike = DEFAULT_DEVICE):
        """The query-time tensors on ``device``: (offsets int64, doc_ids
        int32, weights float32, norms float32)."""
        return (torch.as_tensor(self.term_offsets, device=device),
                torch.as_tensor(self.doc_ids, device=device),
                torch.as_tensor(self.posting_weights(), device=device),
                torch.as_tensor(self.doc_norms, device=device))


def build_index(corpus: Corpus, *, global_doc_freq: np.ndarray = None,
                total_docs: int = None) -> InvertedIndex:
    """Invert a (sub)collection.

    global_doc_freq/total_docs inject collection-wide statistics so that a
    partition's local index still ranks with global idf (paper Sec 3.3:
    "each index server may then derive the global idf factor").
    """
    v = corpus.config.vocab_size
    terms = corpus.doc_terms
    tf = corpus.tf.astype(np.float32)

    # doc ids per posting from the CSR doc offsets
    lengths = np.diff(corpus.doc_offsets)
    doc_of_posting = np.repeat(
        np.arange(corpus.n_docs, dtype=np.int32), lengths)

    order = np.argsort(terms, kind="stable")  # stable keeps doc order
    t_sorted = terms[order]
    d_sorted = doc_of_posting[order]
    tf_sorted = tf[order]

    term_offsets = np.zeros(v + 1, dtype=np.int64)
    np.add.at(term_offsets, t_sorted + 1, 1)
    term_offsets = np.cumsum(term_offsets)

    if global_doc_freq is None:
        global_doc_freq = np.diff(term_offsets)
        total_docs = corpus.n_docs
    idf = np.log((total_docs + 1.0) / (global_doc_freq + 1.0)).astype(
        np.float32)

    # Vector-model document norms: ||d|| over tf*idf weights.
    w = tf_sorted * idf[t_sorted]
    norms_sq = np.zeros(corpus.n_docs, dtype=np.float64)
    np.add.at(norms_sq, d_sorted, (w ** 2).astype(np.float64))
    doc_norms = np.sqrt(np.maximum(norms_sq, 1e-12)).astype(np.float32)

    return InvertedIndex(
        n_docs=corpus.n_docs,
        vocab_size=v,
        term_offsets=term_offsets,
        doc_ids=d_sorted,
        tf=tf_sorted,
        doc_norms=doc_norms,
        idf=idf,
    )
