"""Query-time scoring (paper Sec 3.3) — the index-server hot path, in torch.

Vector-space model with tf-idf cosine ranking over the *conjunction* of the
query terms ("standard practice on modern search engines", paper fn. 1).
The paper deliberately evaluates FULL inverted lists (no pruning) to keep
capacity estimates conservative; we follow that, with a static posting
budget P_max per term (lists longer than the budget are truncated; callers
size it from the longest list in the shard for exact results).

Algorithm per (query, shard), as `repro.engine.scoring`:
  1. gather each query term's posting window (doc_ids, weights) from the
     CSR arrays (masked fixed-size gather),
  2. scatter-accumulate per-doc score and per-doc matched-term count,
  3. conjunction: keep docs whose matched count == query length,
  4. cosine-normalize by doc norms, take local top-k.

Step 2 accumulates one query term at a time.  Within a term a document
occurs at most once, and a masked entry at position j parks in its own
dropped slot ``n_docs + j`` (the reference parks them all in ``n_docs``),
so no two updates of a `scatter_add_` meet: the sums are the
reference's, added in term order, and the same from run to run on the
card, where a scatter is atomic — and no row's masked entries queue on
one address.

Top-k ties take the lower index first, as ``jax.lax.top_k`` does: every
document failing the conjunction scores -inf, and a shard with fewer than
k matches returns -inf entries whose ids the broker carries on.
`torch.topk` promises no tie order, so the top-k is the head of a stable
descending sort.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

__all__ = ["score_queries", "local_topk"]


def score_queries(
    term_offsets: Tensor,   # (V+1,) int64
    doc_ids: Tensor,        # (NNZ,) int32
    weights: Tensor,        # (NNZ,) float32 (tf * idf)
    doc_norms: Tensor,      # (D,) float32
    query_terms: Tensor,    # (Q, L) integer, padded with -1
    *,
    n_docs: int,
    budget: int,
    k: int,
) -> tuple[Tensor, Tensor]:
    """Top-k (scores, local doc ids int32) per query, on the index's device.

    budget: max postings processed per term.  Entries beyond a term's
    true list length are masked out; terms longer than the budget are
    truncated — callers size the budget from max list length for exact
    results, or lower for the paper's 'partial evaluation' variant [29].
    """
    dev = term_offsets.device
    query_terms = query_terms.to(dev)
    q_valid = query_terms >= 0
    q_terms = torch.clamp_min(query_terms, 0).to(torch.int64)
    q_len = torch.sum(q_valid, dim=1)                          # (Q,)

    starts = term_offsets[q_terms]                             # (Q, L)
    ends = term_offsets[q_terms + 1]
    lens = (ends - starts) * q_valid                           # (Q, L)

    pos = torch.arange(budget, dtype=starts.dtype, device=dev)  # (P,)
    q, n_terms = query_terms.shape
    scores = torch.zeros((q, n_docs + budget), dtype=weights.dtype,
                         device=dev)
    counts = torch.zeros((q, n_docs + budget), dtype=torch.int32, device=dev)
    park = n_docs + pos                      # a dropped slot a position
    for t in range(n_terms):                 # one term at a time: term order
        mask = (pos < lens[:, t, None]) & q_valid[:, t, None]  # (Q, P)
        idx = torch.clamp_max(starts[:, t, None] + pos, doc_ids.shape[0] - 1)
        d = torch.where(mask, doc_ids[idx].to(torch.int64), park)
        scores.scatter_add_(1, d, weights[idx] * mask)
        counts.scatter_add_(1, d, mask.to(torch.int32))
        del mask, idx, d         # free this term's (Q, P) before the next
    scores, counts = scores[:, :n_docs], counts[:, :n_docs]

    conj = counts == q_len[:, None]                            # conjunction
    cos = torch.where(conj & (q_len[:, None] > 0),
                      scores / doc_norms[None, :], -torch.inf)
    return local_topk(cos, k)


def local_topk(scores: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(values, int32 indices) of the k largest along the last axis, the
    lower index first among equal values."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k].to(torch.int32)
