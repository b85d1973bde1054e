"""Roofline terms of a dry-run cell (§Roofline).

PyTorch port of `repro.roofline.analysis`:

  compute term    = FLOPs / (chips x peak FLOP/s)
  memory term     = bytes / (chips x HBM bandwidth)
  collective term = collective bytes / (chips x link bandwidth)

The reference reads these off a compiled XLA executable: FLOPs and bytes
from ``cost_analysis()``, memory from ``memory_analysis()``, and the
collective bytes by parsing the optimised HLO (``parse_collectives``).
Eager PyTorch compiles nothing and has no HLO, so the port takes its
counts from a trace of the step (`repro_torch.launch.dryrun`):
`roofline_from_trace` builds the cell from the dry run's figures, and
each record names which of them were counted and which estimated.
``parse_collectives`` has no counterpart: the collective bytes come from
the rule-based estimate here (`estimate_collectives`), written per
family from the cell's sharding rules and stand-ins, each term in its
function's docstring.

The estimate counts the bytes each device receives over its links for
the collectives a GSPMD-style program of the cell would run, with ring
algorithms on a group of n devices:

  all-gather of a tensor of B bytes      (n - 1) / n x B
  reduce-scatter of B bytes              (n - 1) / n x B
  all-reduce of B bytes              2 x (n - 1) / n x B
  all-to-all of B local bytes            (n - 1) / n x B

Every device of the mesh takes part in its group's collective at once,
so the global figure is the per-device one times the chips.  The default
hardware is `repro_torch.core.planner.H100_SXM`, whose link bandwidth is
NVLink's 450 GB/s each way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional

from repro_torch.core.planner import H100_SXM, HardwareSpec, RooflineTerms
from repro_torch.launch.sharding import mesh_axis_size
from repro_torch.models.recsys import MIND_NEGATIVES

__all__ = ["CollectiveStats", "CellRoofline", "roofline_from_trace",
           "estimate_collectives", "lm_collectives", "recsys_collectives",
           "gnn_collectives"]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_global: float
    bytes_global: float
    collective_bytes_global: float
    terms: RooflineTerms
    model_flops: float             # 6*N*D (or family analogue)
    memory_analysis: Dict[str, float]
    collectives: Dict[str, float]
    counted: tuple = ()            # figures counted from the trace / shards
    estimated: tuple = ()          # figures estimated

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.flops_global, 1.0)

    @property
    def bound(self) -> str:
        return self.terms.bound

    @property
    def roofline_fraction(self) -> float:
        """dominant-term share of the serial step: how close the step is
        to the single-resource roofline (1.0 = perfectly bound by one
        engine, lower = time wasted on non-dominant engines)."""
        t = self.terms
        tot = t.compute_s + t.memory_s + t.collective_s
        return t.step_time_lower_bound / max(tot, 1e-30)

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "collective_bytes_global": self.collective_bytes_global,
            "compute_s": self.terms.compute_s,
            "memory_s": self.terms.memory_s,
            "collective_s": self.terms.collective_s,
            "bound": self.bound,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "memory_analysis": self.memory_analysis,
            "collectives": self.collectives,
            "counted": list(self.counted),
            "estimated": list(self.estimated),
        }


def roofline_from_trace(
    *, arch: str, shape: str, mesh_name: str, n_chips: int,
    flops_global: float, bytes_global: float,
    collectives: CollectiveStats, memory_analysis: Dict[str, float],
    model_flops: float, counted: Iterable[str] = (),
    estimated: Iterable[str] = (), hw: HardwareSpec = H100_SXM,
) -> CellRoofline:
    """The counterpart of the reference's ``roofline_from_compiled``: the
    dry run's counts of one step (global FLOPs and bytes, the collective
    estimate, the per-device memory figures) on ``hw``."""
    coll_global = collectives.total_bytes * n_chips
    terms = RooflineTerms(
        compute_s=flops_global / (n_chips * hw.peak_flops),
        memory_s=bytes_global / (n_chips * hw.hbm_bandwidth),
        collective_s=coll_global / (n_chips * hw.ici_bandwidth),
    )
    return CellRoofline(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        flops_global=float(flops_global), bytes_global=float(bytes_global),
        collective_bytes_global=coll_global, terms=terms,
        model_flops=model_flops, memory_analysis=dict(memory_analysis),
        collectives={f"{k}_bytes": v for k, v in
                     collectives.bytes_by_kind.items()}
        | {f"{k}_count": float(v) for k, v in
           collectives.count_by_kind.items()},
        counted=tuple(counted), estimated=tuple(estimated))


# -------------------------------------------------------------------------
# the rule-based collective estimate
# -------------------------------------------------------------------------

class _Tally:
    """Per-device link bytes and counts by collective kind."""

    def __init__(self):
        self.bytes: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def add(self, kind: str, nbytes: float, n: int, times: int = 1):
        """``times`` ring collectives of ``kind`` over ``n`` devices on a
        tensor of ``nbytes`` (the local buffer for an all-to-all)."""
        if n <= 1 or times <= 0 or nbytes <= 0:
            return
        share = (n - 1) / n * (2.0 if kind == "all-reduce" else 1.0)
        self.bytes[kind] = self.bytes.get(kind, 0.0) + times * share * nbytes
        self.count[kind] = self.count.get(kind, 0) + times

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes), dict(self.count))


def _shard_bytes(t) -> float:
    return float(math.prod(t.shard_shape) * t.element_size())


def _axes(binding) -> tuple:
    if binding is None:
        return ()
    return (binding,) if isinstance(binding, str) else tuple(binding)


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _grad_sync(tally: _Tally, params: Iterable, mesh) -> None:
    """A data-parallel step's parameter traffic.  A parameter sharded over
    data-parallel axes (f shards, FSDP) is all-gathered for the forward
    and again for the backward, and its gradient reduce-scattered; the
    rest of its replication over the data-parallel axes (r = dp / f
    copies, e.g. "pod") all-reduces the gradient shard."""
    dp_axes = _dp_axes(mesh)
    dp = mesh_axis_size(mesh, dp_axes) if dp_axes else 1
    for t in params:
        s = _shard_bytes(t)
        f = math.prod(mesh_axis_size(mesh, a) for b in t.spec
                      for a in _axes(b) if a in dp_axes)
        if f > 1:
            tally.add("all-gather", s * f, f, times=2)
            tally.add("reduce-scatter", s * f, f)
        tally.add("all-reduce", s, dp // f)


def lm_collectives(cfg, shape, rules: dict, mesh, params: Iterable
                   ) -> CollectiveStats:
    """A language-model cell's collectives, per device.

    With B_dev = ceil(B / batch shards) sequences of S tokens a device
    and act = B_dev x S x d_model x the model dtype's bytes (S = 1 for
    decode), tp the "model" axis's size:

    * training: `_grad_sync` over the parameters (FSDP all-gathers and
      reduce-scatters over "data", gradient all-reduces elsewhere);
    * each layer: an all-reduce of act over "model" for each of the
      attention (heads sharded) and the FFN (``ffn`` sharded), once in a
      serving step, three times in training (forward, the rematerialised
      forward, backward);
    * each MoE layer (experts over "model"): training and prefill
      dispatch and combine by all-to-all, each device's buffer
      B_dev x S / tp tokens x top_k x capacity_factor x d_model (twice
      a forward, six times a training step); decode all-reduces act;
    * decode with the KV cache's sequence sharded over k devices: each
      layer all-reduces the attention's float32 partial outputs and
      their two softmax statistics, B_dev x heads x (d_head + 2) x 4 B;
    * the column-sharded embedding: an all-gather of act; training's
      column-sharded LM head: an all-reduce of act (the backward's input
      gradient) and, for each of the chunked loss's two forwards, two
      all-reduces of the log-sum-exp's B_dev x S float32 statistics.
    """
    tally = _Tally()
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    if train:
        _grad_sync(tally, params, mesh)
    tp = mesh_axis_size(mesh, "model")
    b_dev = math.ceil(shape["global_batch"]
                      / mesh_axis_size(mesh, rules["batch"]))
    seq = 1 if decode else shape["seq_len"]
    item = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    act = b_dev * seq * cfg.d_model * item
    passes = 3 if train else 1
    per_layer = (rules["heads"] is not None) + (rules["ffn"] is not None)
    tally.add("all-reduce", act, tp, times=cfg.n_layers * per_layer * passes)
    if cfg.moe is not None and rules["experts"] is not None:
        n_exp = mesh_axis_size(mesh, rules["experts"])
        if decode:
            tally.add("all-reduce", act, n_exp, times=cfg.n_layers)
        else:
            buf = (b_dev * seq / tp * cfg.moe.top_k
                   * cfg.moe.capacity_factor * cfg.d_model * item)
            tally.add("all-to-all", buf, n_exp,
                      times=cfg.n_layers * 2 * passes)
    if decode and rules["kv_seq"] is not None:
        k = mesh_axis_size(mesh, rules["kv_seq"])
        tally.add("all-reduce", b_dev * cfg.n_heads * (cfg.d_head + 2) * 4,
                  k, times=cfg.n_layers)
    tally.add("all-gather", act, tp)
    if train:
        tally.add("all-reduce", act, tp)
        tally.add("all-reduce", b_dev * seq * 4, tp, times=4)
    return tally.stats()


def recsys_collectives(cfg, shape, rules: dict, mesh, params: Iterable
                       ) -> CollectiveStats:
    """A recommender cell's collectives, per device.

    * training, tables row-sharded over "model" (tp shards): every
      lookup from a row-sharded table gives partial sums that are
      all-reduced over "model": the pooled embeddings B_dev x fields x
      (embed_dim + 1 for the wide table) for a CTR model; for MIND the
      history's B_dev x hist_len, the targets' B_dev and the 1,024
      shared negatives' rows of embed_dim; then `_grad_sync`: every
      parameter's gradient (table shards included) all-reduced over the
      data-parallel axes (the dense all-reduce);
    * serving: tables and weights replicated, the batch split over the
      data-parallel axes: nothing;
    * retrieval (candidates over every axis): each device's top 100
      (float32 score, int32 position) all-gathered.
    """
    tally = _Tally()
    item = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    if shape.name == "train_batch":
        tp = mesh_axis_size(mesh, rules["rows"])
        b_dev = math.ceil(shape["batch"]
                          / mesh_axis_size(mesh, rules["batch"]))
        d = cfg.embed_dim
        if cfg.interaction == "multi-interest":
            rows = b_dev * cfg.hist_len + b_dev + MIND_NEGATIVES
            tally.add("all-reduce", rows * d * item, tp)
        else:
            tally.add("all-reduce", b_dev * cfg.n_sparse * (d + 1) * item,
                      tp)
        _grad_sync(tally, params, mesh)
    elif shape.name == "retrieval_cand":
        n = mesh_axis_size(mesh, rules["cand"])
        tally.add("all-gather", n * 100 * (4 + 4), n)
    return tally.stats()


def gnn_collectives(cfg, shape, rules: dict, mesh, params: Iterable,
                    dims: dict) -> CollectiveStats:
    """A DimeNet cell's collectives, per device, with node states
    replicated and edges and triplets split over all n devices
    (``gnn_rules(replicate_nodes=True)``):

    * each block's edge-to-node sum gives partial node states on every
      device: an all-reduce of nodes x d_hidden x the dtype's bytes;
    * each block's triplet gather of edge messages reads edges of other
      shards: an all-gather of edges x d_hidden, and in the backward a
      reduce-scatter of its gradient;
    * the backward of the embedding block's two node gathers: one
      all-reduce of nodes x d_hidden;
    * the weights (replicated): `_grad_sync`, a gradient all-reduce.
    """
    tally = _Tally()
    n = mesh_axis_size(mesh, rules["edges"])
    item = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    node_b = dims["nodes"] * cfg.d_hidden * item
    edge_b = dims["edges"] * cfg.d_hidden * item
    tally.add("all-reduce", node_b, n, times=cfg.n_blocks + 1)
    tally.add("all-gather", edge_b, n, times=cfg.n_blocks)
    tally.add("reduce-scatter", edge_b, n, times=cfg.n_blocks)
    _grad_sync(tally, params, mesh)
    return tally.stats()


def estimate_collectives(arch_spec, shape, rules: dict, mesh,
                         params: Iterable, dims: Optional[dict] = None
                         ) -> CollectiveStats:
    """The family's estimate for one cell; ``params`` are the cell's
    parameter stand-ins, ``dims`` a GNN cell's padded dimensions."""
    params = list(params)
    if arch_spec.family == "lm":
        return lm_collectives(arch_spec.config, shape, rules, mesh, params)
    if arch_spec.family == "recsys":
        return recsys_collectives(arch_spec.config, shape, rules, mesh,
                                  params)
    if arch_spec.family == "gnn":
        return gnn_collectives(arch_spec.config, shape, rules, mesh, params,
                               dims)
    raise ValueError(arch_spec.family)
