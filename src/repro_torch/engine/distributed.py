"""Distributed query processing: document partitioning on one device.

The paper's cluster (Fig 1) as `repro.engine.distributed` lays it out:
one index server per shard, the broker broadcast is the replication of
the query batch, the join gathers every shard's local top-k, and the
broker merge is a final top-k.  On one card the p shards are a leading
axis of stacked tensors (padded to the longest shard), each scored by
the single-server hot path (`scoring.score_queries`) in turn, then one
`broker.merge_topk`.  Spreading the shards over a device mesh is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.core.sweep import _not_ported
from repro_torch.engine.broker import merge_topk
from repro_torch.engine.partition import Partitioned
from repro_torch.engine.scoring import score_queries

Tensor = torch.Tensor

__all__ = ["StackedShards", "stack_shards", "make_search_fn"]


@dataclasses.dataclass(frozen=True)
class StackedShards:
    term_offsets: Tensor      # (p, V+1) int64
    doc_ids: Tensor           # (p, NNZ_max) int32
    weights: Tensor           # (p, NNZ_max) float32
    doc_norms: Tensor         # (p, B_max) float32
    local_to_global: Tensor   # (p, B_max) int32
    meta: dict = dataclasses.field(default_factory=dict)


def stack_shards(part: Partitioned, *,
                 device: DeviceLike = DEFAULT_DEVICE) -> StackedShards:
    p = part.p
    nnz_max = max(s.n_postings for s in part.shards)
    b_max = max(s.n_docs for s in part.shards)
    v = part.shards[0].vocab_size

    offs = np.zeros((p, v + 1), np.int64)
    docs = np.zeros((p, nnz_max), np.int32)
    wts = np.zeros((p, nnz_max), np.float32)
    norms = np.ones((p, b_max), np.float32)
    l2g = np.zeros((p, b_max), np.int32)
    budget = 1
    for s, shard in enumerate(part.shards):
        offs[s] = shard.term_offsets
        docs[s, : shard.n_postings] = shard.doc_ids
        wts[s, : shard.n_postings] = shard.posting_weights()
        norms[s, : shard.n_docs] = shard.doc_norms
        if hasattr(part, "local_to_global"):
            g = part.local_to_global[s]
            l2g[s, : len(g)] = g
        else:
            l2g[s, : shard.n_docs] = np.arange(shard.n_docs)
        budget = max(budget, int(shard.list_lengths().max()))

    def put(x):
        return torch.as_tensor(x, device=device)
    return StackedShards(
        term_offsets=put(offs), doc_ids=put(docs), weights=put(wts),
        doc_norms=put(norms), local_to_global=put(l2g),
        meta=dict(p=p, b_max=b_max, budget=budget))


def make_search_fn(mesh, stacked: StackedShards, *, k: int = 10,
                   k_local: Optional[int] = None, axis: str = "servers"):
    """Build the distributed search: queries (Q, L) -> top-k.

    Fork: queries replicated to every shard.  Local processing: the
    single-server scorer.  Join: every shard's (scores, global ids).
    Merge: broker top-k.  ``mesh`` must be None (one device); ``axis``
    names the mesh axis the reference shards over and is unused here.
    """
    if mesh is not None:
        raise _not_ported("make_search_fn(mesh=...)", 12)
    k_local = k_local or k
    n_docs = stacked.meta["b_max"]
    budget = stacked.meta["budget"]
    dev = stacked.term_offsets.device

    def search(queries) -> tuple[Tensor, Tensor]:
        queries = torch.as_tensor(queries, device=dev)
        s_all, g_all = [], []
        for s in range(stacked.meta["p"]):
            sc, d = score_queries(
                stacked.term_offsets[s], stacked.doc_ids[s],
                stacked.weights[s], stacked.doc_norms[s], queries,
                n_docs=n_docs, budget=budget, k=k_local)
            s_all.append(sc)
            g_all.append(stacked.local_to_global[s][d.to(torch.int64)])
        return merge_topk(torch.stack(s_all), torch.stack(g_all), k=k)

    return search
