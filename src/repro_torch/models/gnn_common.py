"""GNN substrate: padded graph batches and segment-op message passing.

PyTorch port of `repro.models.gnn_common`.  Graphs travel in fixed-size
(padded, masked) buffers; `repro_torch.data.graph_sampler` builds them.
`GraphBatch` is a frozen dataclass of tensors (``n_graphs`` a plain int)
with `GraphBatch.to` to move it.

The segment ops sum in float32 and round once to the data's dtype, and
repeat bit for bit on the card: a stable sort by segment id and a
log-depth segmented scan (`repro_torch._segment`), never float atomics.
The reference's bfloat16 ``jax.ops.segment_sum`` sums in bfloat16 (a
standing difference, ROADMAP queue 3); the tests hold the two in
float32.  Ids outside [0, num_segments) are dropped, as JAX drops them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._segment import segment_sum as _segment_sum
from repro_torch._tensor import DeviceLike

Tensor = torch.Tensor

__all__ = ["GraphBatch", "segment_sum", "segment_mean", "segment_softmax"]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded graph(s) with triplet structure for directional MP.

    Edge e: src[e] -> dst[e] with length dist[e].
    Triplet t: (k -> j) then (j -> i); tri_kj/tri_ji are EDGE ids, and
    angle[t] is the angle between the two edge directions at j.
    node_graph maps nodes to graph ids for batched readout.
    """

    node_feat: Tensor    # (N, F) float
    edge_src: Tensor     # (E,) int32
    edge_dst: Tensor     # (E,) int32
    edge_dist: Tensor    # (E,) float32
    edge_mask: Tensor    # (E,) bool
    tri_kj: Tensor       # (T,) int32 — edge id of (k->j)
    tri_ji: Tensor       # (T,) int32 — edge id of (j->i)
    tri_angle: Tensor    # (T,) float32
    tri_mask: Tensor     # (T,) bool
    node_graph: Tensor   # (N,) int32
    n_graphs: int = 1

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]

    def to(self, device: DeviceLike) -> "GraphBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "n_graphs"})


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int
                ) -> Tensor:
    return _segment_sum(data, segment_ids, num_segments)


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int
                 ) -> Tensor:
    s = _segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    n = _segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp_min(n, 1.0)[..., None]


def segment_softmax(logits: Tensor, segment_ids: Tensor, num_segments: int
                    ) -> Tensor:
    """Softmax of ``logits`` within each segment (ids in range)."""
    ids = segment_ids.long()
    m = torch.full((num_segments,) + tuple(logits.shape[1:]), -torch.inf,
                   dtype=logits.dtype, device=logits.device)
    idx = ids.reshape((-1,) + (1,) * (logits.ndim - 1)).expand_as(logits)
    m = m.scatter_reduce(0, idx, logits, "amax")      # order-free: a max
    z = torch.exp(logits - m[ids])
    denom = _segment_sum(z, ids, num_segments)
    return z / torch.clamp_min(denom[ids], 1e-30)
