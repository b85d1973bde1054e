"""Logical-axis sharding: model code names axes, meshes bind them.

PyTorch port of `repro.launch.sharding`.  A `sharding_rules` context
binds logical axis names ("batch", "heads", "rows", ...) to mesh axis
names (or None, replicated); `spec` turns logical names into the mesh
bindings of one tensor's axes under the active rules: a tuple whose
entries are what the reference's ``PartitionSpec`` holds, None, a mesh
axis name or a tuple of them.  Outside any context every axis is
unbound.

`shard_shape` gives the per-device shape of a global shape under a
spec on a `repro_torch.launch.mesh.DeviceMesh`, with ceil division on
each sharded axis, as a ``NamedSharding.shard_shape`` would; the dry run
(`repro_torch.launch.dryrun`) sizes every stand-in with it.

`constrain` is the reference's sharding hint.  An eager tensor carries
no layout, so it checks the names against the tensor's rank (under
rules) and returns the tensor itself; without rules it returns its input
unchanged, whatever it is.  The port's models do not call it (ROADMAP,
standing differences, slice 15).

The standard rule sets for the production meshes are the reference's:
`lm_rules`, `gnn_rules` and `recsys_rules`.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["AxisBinding", "current_rules", "sharding_rules", "spec",
           "constrain", "mesh_axis_size", "shard_shape", "lm_rules",
           "gnn_rules", "recsys_rules"]

AxisBinding = Union[None, str, Tuple[str, ...]]

_state = threading.local()


def current_rules() -> Optional[Dict[str, AxisBinding]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[Dict[str, AxisBinding]]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def _entry(binding: AxisBinding) -> AxisBinding:
    """A ``PartitionSpec`` entry: a one-name tuple becomes the name."""
    if isinstance(binding, tuple) and len(binding) == 1:
        return binding[0]
    return binding


def spec(*logical: Optional[str]) -> Tuple[AxisBinding, ...]:
    """The mesh bindings of logical axis names under the active rules, as
    the reference's ``PartitionSpec`` holds them (a one-name tuple
    becomes the name)."""
    rules = current_rules() or {}
    return tuple(_entry(rules.get(name)) if name else None
                 for name in logical)


def constrain(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names: a
    no-op without rules; under rules the names must not outnumber the
    tensor's axes, and the tensor comes back as it is."""
    if current_rules() is None:
        return x
    if isinstance(x, torch.Tensor) and len(logical) > x.ndim:
        raise ValueError(f"{len(logical)} logical axes {logical} for a "
                         f"tensor of rank {x.ndim}")
    return x


def mesh_axis_size(mesh, binding: AxisBinding) -> int:
    """How many shards a binding makes on ``mesh``: the product of the
    sizes of the mesh axes it names (1 for None)."""
    if binding is None:
        return 1
    names = (binding,) if isinstance(binding, str) else tuple(binding)
    size = 1
    for name in names:
        if name not in mesh.axis_names:
            raise ValueError(f"mesh axis {name!r} is not in the mesh's "
                             f"axes {mesh.axis_names}")
        size *= mesh.shape[mesh.axis_names.index(name)]
    return size


def shard_shape(shape: Sequence[int], bindings: Sequence[AxisBinding],
                mesh) -> Tuple[int, ...]:
    """Per-device shape of a global ``shape`` laid out by ``bindings``
    (one entry an axis, or fewer: the rest unbound) on ``mesh``: each
    sharded axis ceil-divided by its shard count."""
    if len(bindings) > len(shape):
        raise ValueError(f"spec {tuple(bindings)} has more entries than "
                         f"the shape {tuple(shape)} has axes")
    full = tuple(bindings) + (None,) * (len(shape) - len(bindings))
    return tuple(math.ceil(int(d) / mesh_axis_size(mesh, b))
                 for d, b in zip(shape, full))


# ---------------------------------------------------------------------------
# Standard rule sets.  Mesh axes: ("pod",) "data", "model".
# ---------------------------------------------------------------------------

def lm_rules(multi_pod: bool, *, seq_sharded_decode: bool = True
             ) -> Dict[str, AxisBinding]:
    """Megatron TP + (pod, data) DP + sequence-parallel residual stream."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "seq": "model",        # sequence-parallel residual stream
        "seq_q": None,         # attention runs with heads sharded instead
        "embed": None,
        "heads": "model",      # TP: attention heads
        "kv_heads": "model",
        "qkv": None,
        "ffn": "model",        # TP: FFN hidden
        "experts": "model",    # expert parallelism
        "vocab": "model",      # row-sharded embedding/logits
        "kv_seq": "model" if seq_sharded_decode else None,  # decode KV cache
        "kv_batch": dp,
        "cand": "model",
    }


def gnn_rules(multi_pod: bool, *, replicate_nodes: bool = False
              ) -> Dict[str, AxisBinding]:
    """Edge/triplet partitioning over the whole mesh.

    replicate_nodes=True keeps node states replicated, so a gather
    h[edge_src] is local to every edge shard.
    """
    everything = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "edges": everything,
        "triplets": everything,
        "nodes": None if replicate_nodes else everything,
        "graph_batch": everything,
        "feat": None,
        "hidden": None,
    }


def recsys_rules(multi_pod: bool) -> Dict[str, AxisBinding]:
    """Row-sharded embedding tables; batch DP; candidates model-sharded."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "rows": "model",       # embedding-table rows (the 'index servers')
        "embed": None,
        "fields": None,
        "mlp": None,           # MLP weights are replicated (tiny)
        "cand": "model",       # retrieval candidates
        "hist": None,
    }
