"""Graph generation, neighbor sampling, and triplet construction: the
port's own copy of `repro.data.graph_sampler`.

`minibatch_lg` requires a real neighbor sampler: layered fanout sampling
(GraphSAGE style) from a CSR adjacency, producing padded `GraphBatch`
buffers.  Triplets (k->j->i) for DimeNet's directional messages are built
per edge from the in-edges of its source, capped at a per-edge budget.

Geometry: molecular graphs carry true 3D positions; for non-geometric
assigned graphs (reddit/ogbn-products) positions are synthesized from a
random embedding so distances/angles are well-defined.

numpy on the host, as the reference: for the same arguments and seeds
every array is bit-identical to the reference's.  `build_graph_batch` and
`make_molecule_batch` return the port's `GraphBatch` of tensors on
``device`` (the molecule targets too).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.models.gnn_common import GraphBatch

__all__ = ["SyntheticGraph", "make_power_law_graph", "neighbor_sample",
           "build_graph_batch", "make_molecule_batch"]


@dataclasses.dataclass
class SyntheticGraph:
    n_nodes: int
    csr_offsets: np.ndarray   # (N+1,) in-neighbor CSR
    csr_indices: np.ndarray   # (E,)
    positions: np.ndarray     # (N, 3)
    features: np.ndarray      # (N, F)


def make_power_law_graph(n_nodes: int, avg_degree: int, d_feat: int,
                         *, seed: int = 0) -> SyntheticGraph:
    """Preferential-attachment-ish graph with power-law degree skew."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    # power-law destination popularity (like term popularity in the paper)
    pop = (np.arange(1, n_nodes + 1) ** -0.8)
    pop /= pop.sum()
    dst = rng.choice(n_nodes, size=n_edges, p=pop)
    src = rng.integers(0, n_nodes, size=n_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    offsets = np.zeros(n_nodes + 1, np.int64)
    np.add.at(offsets, dst + 1, 1)
    offsets = np.cumsum(offsets)
    return SyntheticGraph(
        n_nodes=n_nodes,
        csr_offsets=offsets,
        csr_indices=src.astype(np.int32),
        positions=rng.normal(size=(n_nodes, 3)).astype(np.float32),
        features=rng.normal(size=(n_nodes, d_feat)).astype(np.float32) / 8,
    )


def neighbor_sample(graph: SyntheticGraph, seeds: np.ndarray,
                    fanouts: tuple[int, ...], *, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Layered fanout sampling; returns (nodes, edge_src, edge_dst).

    Node ids are *local* to the returned subgraph (seeds first); edges
    point child -> parent (message direction).
    """
    rng = np.random.default_rng(seed)
    local = {int(s): i for i, s in enumerate(seeds)}
    nodes = list(int(s) for s in seeds)
    e_src, e_dst = [], []
    frontier = list(int(s) for s in seeds)
    for fanout in fanouts:
        nxt = []
        for u in frontier:
            lo, hi = graph.csr_offsets[u], graph.csr_offsets[u + 1]
            if hi <= lo:
                continue
            neigh = graph.csr_indices[lo:hi]
            pick = rng.choice(neigh, size=min(fanout, len(neigh)),
                              replace=False)
            for v in pick:
                v = int(v)
                if v not in local:
                    local[v] = len(nodes)
                    nodes.append(v)
                    nxt.append(v)
                e_src.append(local[v])
                e_dst.append(local[u])
        frontier = nxt
    return (np.asarray(nodes, np.int64),
            np.asarray(e_src, np.int32), np.asarray(e_dst, np.int32))


def _build_triplets(e_src, e_dst, n_edges_pad, budget_per_edge, rng):
    """Triplets (k->j->i): for edge e=(j->i), partner edges e'=(k->j)."""
    by_dst: dict[int, list[int]] = {}
    for e, d in enumerate(e_dst):
        by_dst.setdefault(int(d), []).append(e)
    t_kj, t_ji = [], []
    for e in range(len(e_src)):
        partners = by_dst.get(int(e_src[e]), ())
        cnt = 0
        for e2 in partners:
            if e_src[e2] == e_dst[e]:
                continue  # exclude backtracking k == i
            t_kj.append(e2)
            t_ji.append(e)
            cnt += 1
            if cnt >= budget_per_edge:
                break
    return np.asarray(t_kj, np.int32), np.asarray(t_ji, np.int32)


def build_graph_batch(
    graph: SyntheticGraph,
    nodes: np.ndarray, e_src: np.ndarray, e_dst: np.ndarray,
    *,
    pad_nodes: int, pad_edges: int, pad_triplets: int,
    triplet_budget_per_edge: int = 4,
    n_graphs: int = 1,
    node_graph: np.ndarray = None,
    seed: int = 0,
    device: DeviceLike = DEFAULT_DEVICE,
) -> GraphBatch:
    """Pad a sampled subgraph into fixed GraphBatch buffers on ``device``."""
    rng = np.random.default_rng(seed)
    pos = graph.positions[nodes]
    vec = pos[e_dst] - pos[e_src]
    dist = np.linalg.norm(vec, axis=1).astype(np.float32) + 1e-3

    t_kj, t_ji = _build_triplets(e_src, e_dst, pad_edges,
                                 triplet_budget_per_edge, rng)
    # angle between edge (k->j) and (j->i) at node j
    v1 = -vec[t_kj]
    v2 = vec[t_ji]
    cosang = np.sum(v1 * v2, axis=1) / np.maximum(
        np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1), 1e-9)
    angle = np.arccos(np.clip(cosang, -1.0, 1.0)).astype(np.float32)

    nn, ne, nt = len(nodes), len(e_src), len(t_kj)
    assert nn <= pad_nodes and ne <= pad_edges and nt <= pad_triplets, (
        (nn, pad_nodes), (ne, pad_edges), (nt, pad_triplets))

    feat = np.zeros((pad_nodes, graph.features.shape[1]), np.float32)
    feat[:nn] = graph.features[nodes]
    if node_graph is None:
        node_graph = np.zeros(nn, np.int32)

    def pad1(x, n, fill=0):
        out = np.full((n,) + x.shape[1:], fill, x.dtype)
        out[: len(x)] = x
        return out

    def put(x):
        return torch.from_numpy(x).to(device)

    return GraphBatch(
        node_feat=put(feat),
        edge_src=put(pad1(e_src, pad_edges)),
        edge_dst=put(pad1(e_dst, pad_edges)),
        edge_dist=put(pad1(dist, pad_edges, fill=1.0)),
        edge_mask=put(pad1(np.ones(ne, bool), pad_edges, fill=False)),
        tri_kj=put(pad1(t_kj, pad_triplets)),
        tri_ji=put(pad1(t_ji, pad_triplets)),
        tri_angle=put(pad1(angle, pad_triplets)),
        tri_mask=put(pad1(np.ones(nt, bool), pad_triplets, fill=False)),
        node_graph=put(pad1(node_graph.astype(np.int32), pad_nodes,
                            fill=n_graphs - 1)),
        n_graphs=n_graphs,
    )


def make_molecule_batch(n_molecules: int, n_atoms: int, n_bonds: int,
                        d_feat: int, *, pad_triplet_factor: int = 6,
                        seed: int = 0, device: DeviceLike = DEFAULT_DEVICE
                        ) -> tuple[GraphBatch, torch.Tensor]:
    """Batched small molecules (the `molecule` shape); returns (batch, y),
    y (n_molecules, 1) float32, both on ``device``."""
    rng = np.random.default_rng(seed)
    all_src, all_dst, node_graph = [], [], []
    positions, feats = [], []
    for m in range(n_molecules):
        base = m * n_atoms
        pos = rng.normal(size=(n_atoms, 3)).astype(np.float32) * 1.5
        positions.append(pos)
        feats.append(rng.normal(size=(n_atoms, d_feat)).astype(np.float32))
        # connect each atom to nearest neighbors until n_bonds edges
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        order = np.argsort(d, axis=1)
        cnt = 0
        for i in range(n_atoms):
            for j in order[i, :3]:
                all_src.append(base + int(j))
                all_dst.append(base + i)
                cnt += 1
                if cnt >= n_bonds:
                    break
            if cnt >= n_bonds:
                break
        node_graph.extend([m] * n_atoms)

    n_nodes = n_molecules * n_atoms
    g = SyntheticGraph(
        n_nodes=n_nodes,
        csr_offsets=np.zeros(n_nodes + 1, np.int64),
        csr_indices=np.zeros(0, np.int32),
        positions=np.concatenate(positions),
        features=np.concatenate(feats),
    )
    e_src = np.asarray(all_src, np.int32)
    e_dst = np.asarray(all_dst, np.int32)
    batch = build_graph_batch(
        g, np.arange(n_nodes), e_src, e_dst,
        pad_nodes=n_nodes, pad_edges=len(e_src),
        pad_triplets=len(e_src) * pad_triplet_factor,
        n_graphs=n_molecules,
        node_graph=np.asarray(node_graph), seed=seed, device=device)
    y = rng.normal(size=(n_molecules, 1)).astype(np.float32)
    return batch, torch.from_numpy(y).to(device)
