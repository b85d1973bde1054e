"""Config dataclasses of the language models, CTR recommenders and the
GNN the port runs, and their input-shape cells.

A port of `repro.configs.base`: every
architecture field, default and derived property is the reference's, so
a config built here describes the same model (`vocab_padded`,
`n_params`, `n_active_params` and `total_rows` agree with the
reference's; `GNNConfig` and `GNN_SHAPES` are the reference's field for
field).  Of the reference's execution knobs only `attn_chunk` is
kept (training's attention: 0 the full softmax, else the blockwise
path); `scan_layers`, `scan_unroll` and `unroll_attn` choose how JAX
traces the layer and chunk loops, have no meaning here and are left
out.  One `ArchSpec` per architecture lives in
``repro_torch/configs/<id>.py``; the registry maps an id to it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["MoESpec", "LMConfig", "GNNConfig", "RecsysConfig", "ShapeSpec",
           "ArchSpec", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    capacity_factor: float = 1.25
    n_experts_padded: int = 0   # padded up for even expert-parallel sharding

    def padded(self, multiple: int) -> "MoESpec":
        pad = (-self.n_experts) % multiple
        return dataclasses.replace(
            self, n_experts_padded=self.n_experts + pad)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                   # dense FFN hidden (MoE: per-expert = moe.d_expert)
    vocab_size: int
    d_head: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e6
    moe: Optional[MoESpec] = None
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 2048
    attn_chunk: int = 0         # training attention: > 0 blockwise

    @property
    def vocab_padded(self) -> int:
        return self.vocab_size + (-self.vocab_size) % self.vocab_pad_multiple

    @property
    def n_params(self) -> int:
        """Approximate parameter count (for 6ND model FLOPs)."""
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.moe is not None:
            ffn = 3 * d * self.moe.d_expert * self.moe.n_experts
            ffn += d * self.moe.n_experts          # router
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d             # norms
        emb = (1 if self.tie_embeddings else 2) * self.vocab_size * d
        return self.n_layers * per_layer + emb

    @property
    def n_active_params(self) -> int:
        """Activated params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        full_ffn = 3 * d * self.moe.d_expert * self.moe.n_experts
        act_ffn = 3 * d * self.moe.d_expert * self.moe.top_k
        return self.n_params - self.n_layers * (full_ffn - act_ffn)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_out: int = 1
    cutoff: float = 5.0
    triplet_budget_factor: int = 4   # triplets per edge budget
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str                      # fm | cin | self-attn | multi-interest
    n_sparse: int = 39
    embed_dim: int = 10
    field_vocabs: Tuple[int, ...] = ()    # per-field vocab sizes
    mlp: Tuple[int, ...] = (400, 400, 400)
    cin_layers: Tuple[int, ...] = ()
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    n_interests: int = 0
    capsule_iters: int = 0
    hist_len: int = 50                    # behavior sequence (MIND)
    item_vocab: int = 1_000_000           # MIND item universe
    multi_hot: int = 4                    # avg ids per multi-hot field
    dtype: str = "bfloat16"

    @property
    def total_rows(self) -> int:
        return sum(self.field_vocabs) + (
            self.item_vocab if self.interaction == "multi-interest" else 0)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str                    # train | prefill | decode | graph | recsys_*
    dims: Dict[str, int]

    def __getitem__(self, k):
        return self.dims[k]


LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "graph",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeSpec("minibatch_lg", "graph",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout1=15, fanout2=10,
                   # sampled subgraph actually computed per step:
                   # 1024 + 1024*15 + 1024*15*10 nodes; edges = 15360+153600
                   sub_nodes=169984, sub_edges=168960, d_feat=602)),
    ShapeSpec("ogb_products", "graph",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeSpec("molecule", "graph",
              dict(n_nodes=30, n_edges=64, batch=128)),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "recsys_train", dict(batch=65536)),
    ShapeSpec("serve_p99", "recsys_serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "recsys_serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "recsys_retrieval",
              dict(batch=1, n_candidates=1_000_000)),
)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                 # lm | gnn | recsys
    config: object              # LMConfig | GNNConfig | RecsysConfig
    smoke_config: object        # reduced same-family config
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""
    notes: str = ""
