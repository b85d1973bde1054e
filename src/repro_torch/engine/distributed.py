"""Distributed query processing: document partitioning over devices.

The paper's cluster (Fig 1) as `repro.engine.distributed` lays it out:
one index server per shard, the broker broadcast is the replication of
the query batch, the join gathers every shard's local top-k, and the
broker merge is a final top-k.  The p shards are a leading axis of
stacked tensors (padded to the longest shard), each scored by the
single-server hot path (`scoring.score_queries`), then one
`broker.merge_topk`.  Without a mesh every shard is scored on the
stacked tensors' device in turn; over a `repro_torch.launch.mesh`
``("servers",)`` mesh shard s lives on ``mesh.devices[s % n]`` (one index
server a device) and the join gathers onto the broker's device, the
mesh's first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.engine.broker import merge_topk
from repro_torch.engine.partition import Partitioned
from repro_torch.engine.scoring import score_queries
from repro_torch.launch.mesh import DeviceMesh

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


def make_search_fn(mesh: Optional[DeviceMesh], stacked: StackedShards, *,
                   k: int = 10, k_local: Optional[int] = None,
                   axis: str = "servers"):
    """Build the distributed search: queries (Q, L) -> top-k.

    Fork: queries replicated to every shard.  Local processing: the
    single-server scorer.  Join: every shard's (scores, global ids).
    Merge: broker top-k.  ``mesh=None`` scores every shard on the
    stacked tensors' device.  A mesh must have the axis ``axis`` and no
    other; shard s is copied once, here, to ``mesh.devices[s % n]`` and
    scored there, and the merge runs on ``mesh.devices[0]``, where the
    results are returned.
    """
    k_local = k_local or k
    n_docs = stacked.meta["b_max"]
    budget = stacked.meta["budget"]
    p = stacked.meta["p"]
    fields = ("term_offsets", "doc_ids", "weights", "doc_norms",
              "local_to_global")
    if mesh is None:
        broker = stacked.term_offsets.device
        shards = [tuple(getattr(stacked, f)[s] for f in fields)
                  for s in range(p)]
    else:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a repro_torch DeviceMesh; got "
                            f"{type(mesh).__name__}")
        if mesh.axis_names != (axis,):
            raise ValueError(f"the search shards over a 1-D ({axis!r},) "
                             f"mesh; got axes {mesh.axis_names}")
        broker = mesh.devices[0]
        shards = [tuple(getattr(stacked, f)[s].to(
            mesh.devices[s % mesh.size]) for f in fields) for s in range(p)]

    def search(queries) -> tuple[Tensor, Tensor]:
        s_all, g_all, on = [], [], {}
        for offs, docs, wts, norms, l2g in shards:
            if offs.device not in on:      # the broadcast, once a device
                on[offs.device] = torch.as_tensor(queries, device=offs.device)
            sc, d = score_queries(offs, docs, wts, norms, on[offs.device],
                                  n_docs=n_docs, budget=budget, k=k_local)
            s_all.append(sc.to(broker))
            g_all.append(l2g[d.to(torch.int64)].to(broker))
        return merge_topk(torch.stack(s_all), torch.stack(g_all), k=k)

    return search
