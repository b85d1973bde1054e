"""Per-cell dry-run builders: stand-in arguments, their shardings and the
step function of every (arch x shape) cell.

PyTorch port of `repro.launch.specs`.  For every cell this module
produces a `CellBuild`:

  * ``fn``          — the port's step: a `TrainStep` (loss, backward and
                      AdamW) for training, `transformer.prefill` /
                      `decode_step`, a recommender's logits,
                      `recsys.mind_retrieve`, or MIND's rerank; every
                      call that takes ``impl`` gets ``impl="cuda"``, the
                      path the card runs: each hand-written kernel is a
                      custom operator (``repro_torch::flash_attention``,
                      ``decode_attention``, ``embedding_bag``,
                      ``cin_layer``) whose fake gives its output's shape
                      and whose FLOP formula ``FlopCounterMode`` reads, so
                      a trace on fake CPU tensors follows the card's path
                      and launches nothing;
  * ``args``        — the step's arguments as stand-ins: tensors on the
                      ``meta`` device (nothing is allocated) that carry
                      ``spec``, the mesh binding of each axis, and
                      ``shard_shape``, the per-device shape under it
                      (`sharding.shard_shape`); modules, dicts, lists and
                      `GraphBatch`es hold them as the real arguments do;
  * ``rules``       — the logical-axis rules of the cell;
  * ``model_flops`` — the cell's model FLOPs (6 N D or the family's
                      analogue), for the useful-compute ratio;
  * ``out_specs``   — the specs of the step's outputs that are not its
                      arguments (a training step updates its parameters
                      and moments in place), in the order of their leaves;
  * ``donate``, ``notes`` — the reference's.

The parameters come from the port's own layouts: `transformer.Transformer`
built on ``meta``; the recommenders' and DimeNet's initialisers (which
draw from a `torch.Generator`, and no generator lives on ``meta``) run
under a ``FakeTensorMode`` and every leaf is then replaced by a ``meta``
tensor of its shape and dtype.  AdamW's state is `TrainStep.init_state`'s
own (name -> float32 moments), each moment laid out as its parameter.

The rules and the divisibility policy are the reference's: tensor
dimensions are padded (vocabulary, experts, candidates, graph buffers)
or the logical axis is left unsharded (e.g. granite's 24 heads on a
16-way model axis).  A parameter's spec is the reference's rule applied
to the reference's layout of that parameter (stacked over layers,
(in, out) matrices) and then carried to the port's (one tensor a layer,
`nn.Linear`'s (out, in)), so both packages shard the same axis.

The reference extrapolates the layer scan's cost from compiles at two
unroll factors (``scan_unroll``); the port's layer loop is Python, so a
trace counts every layer and nothing is extrapolated.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, Sequence

import torch
from torch import nn

from repro_torch.configs.base import (ArchSpec, GNNConfig, LMConfig,
                                      RecsysConfig, ShapeSpec)
from repro_torch.interop import _ref_place
from repro_torch.launch.mesh import DeviceMesh, data_axes
from repro_torch.launch.sharding import (gnn_rules, recsys_rules,
                                         shard_shape)
from repro_torch.models import dimenet as DN
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T
from repro_torch.models.gnn_common import GraphBatch
from repro_torch.train.optimizer import AdamW, named_tensors
from repro_torch.train.trainer import TrainStep

Tensor = torch.Tensor

__all__ = ["RETRIEVAL_CAND_PADDED", "CellBuild", "stand_in", "stand_ins",
           "argument_bytes", "lm_rules", "build_lm_cell", "gnn_cell_dims",
           "gnn_model_flops", "build_gnn_cell", "recsys_model_flops",
           "build_recsys_cell", "build_cell", "input_specs"]

# candidate count padded so retrieval shards over the full 512-chip mesh
RETRIEVAL_CAND_PADDED = 1_000_448
# the production mesh's model and data axis sizes: the LM rules' divisibility
# checks are made against them whatever the mesh, as the reference's are
TP = 16
DP = 16


@dataclasses.dataclass
class CellBuild:
    fn: Callable
    args: tuple
    rules: Dict[str, Any]
    model_flops: float
    donate: tuple = ()
    notes: str = ""
    out_specs: tuple = ()


# -------------------------------------------------------------------------
# stand-ins
# -------------------------------------------------------------------------

def _place(t: Tensor, bindings: Sequence, mesh: DeviceMesh) -> Tensor:
    """Tag ``t`` with its spec (one binding an axis) and shard shape."""
    spec = tuple(bindings) + (None,) * (t.ndim - len(bindings))
    t.spec = spec
    t.shard_shape = shard_shape(t.shape, spec, mesh)
    return t


def stand_in(shape: Sequence[int], dtype: torch.dtype, bindings: Sequence,
             mesh: DeviceMesh) -> Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` laid out by
    ``bindings`` on ``mesh``."""
    return _place(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                  bindings, mesh)


def stand_ins(tree: Any) -> Iterator[Tensor]:
    """The tensor leaves of an argument tree, in order: a module's
    parameters, dicts, lists, tuples (NamedTuples too) and dataclasses."""
    if isinstance(tree, Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from stand_ins(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from stand_ins(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from stand_ins(getattr(tree, f.name))


def argument_bytes(args: Any) -> float:
    """Per-device bytes of the stand-ins of ``args``: each leaf's shard
    shape times its element size."""
    return float(sum(math.prod(t.shard_shape) * t.element_size()
                     for t in stand_ins(args)))


def _on_meta(tree: Any) -> Any:
    """``tree`` with every tensor leaf replaced by a ``meta`` tensor of its
    shape and dtype."""
    if isinstance(tree, Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _on_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_meta(v) for v in tree]
    return tree


def _init_on_meta(init: Callable, *args, **kwargs) -> Any:
    """An initialiser's tree, run under a ``FakeTensorMode`` (no values),
    as ``meta`` tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = init(*args, device="cpu", **kwargs)
    return _on_meta(tree)


def _place_named(params: Any, rule: Callable, mesh: DeviceMesh) -> Any:
    """Tag every tensor of ``params`` with ``rule(name, tensor)``."""
    for name, t in named_tensors(params).items():
        _place(t, rule(name, t), mesh)
    return params


def _train_state(step: TrainStep, params: Any, mesh: DeviceMesh) -> dict:
    """`TrainStep.init_state` on the stand-in parameters: the step
    counter replicated, each moment laid out as its parameter."""
    state = step.init_state(params)
    opt = state["opt"]
    _place(opt.step, (), mesh)
    named = named_tensors(params)
    for moments in (opt.m, opt.v):
        for name, t in moments.items():
            _place(t, named[name].spec, mesh)
    return state


# -------------------------------------------------------------------------
# LM family
# -------------------------------------------------------------------------

def _lm_param_pspec(cfg: LMConfig, *, fsdp: bool = False):
    """The reference's rule on its own layout (``key`` its pytree path,
    ``shape`` stacked over layers, (in, out) matrices): TP on the model
    axis; with fsdp=True, additionally shard the first remaining
    (non-layer-stack) dim divisible by DP over ``data`` (ZeRO-3)."""
    heads_ok = cfg.n_heads % TP == 0
    ffn_ok = cfg.d_ff % TP == 0 if cfg.moe is None else False

    def base_rule(key: str, nd: int) -> list:
        if key == "embed":
            return [None, "model"]   # column-sharded: local gathers
        if key == "lm_head":
            return [None, "model"]
        if key.endswith("wq") and heads_ok:
            return [None, None, "model"]
        if key.endswith("wo") and heads_ok:
            return [None, "model", None]
        if (key.endswith("w_gate") or key.endswith("w_up")) and nd == 3 \
                and ffn_ok:
            return [None, None, "model"]           # dense mlp (L, d, ff)
        if key.endswith("w_down") and nd == 3 and ffn_ok:
            return [None, "model", None]
        if "moe" in key and nd == 4:                # (L, E, ., .)
            return [None, "model", None, None]
        return [None] * nd                          # norms, wk/wv, router

    def rule(key: str, shape: tuple) -> list:
        nd = len(shape)
        spec = base_rule(key, nd)
        if fsdp:
            # skip dim 0 of layer-stacked tensors (the layer axis)
            start = 1 if nd >= 2 and key not in ("embed", "lm_head") else 0
            for i in range(start, nd):
                if spec[i] is None and shape[i] % DP == 0:
                    spec[i] = "data"
                    break
        return spec

    return rule


def _lm_port_rule(cfg: LMConfig, *, fsdp: bool) -> Callable:
    """The reference's rule carried to a `Transformer` parameter: its
    reference key and layout from `interop`'s map, the layer axis dropped
    and the spec transposed with the matrix."""
    ref_rule = _lm_param_pspec(cfg, fsdp=fsdp)

    def rule(name: str, t: Tensor) -> list:
        path, layer, transpose = _ref_place(name)
        shape = tuple(t.shape)[::-1] if transpose else tuple(t.shape)
        if layer is not None:
            shape = (cfg.n_layers,) + shape
        spec = ref_rule("/".join(path), shape)
        spec = spec[1:] if layer is not None else spec
        return spec[::-1] if transpose else spec

    return rule


def lm_rules(cfg: LMConfig, shape: ShapeSpec, multi_pod: bool
             ) -> Dict[str, Any]:
    dp = data_axes(multi_pod)
    heads = "model" if cfg.n_heads % TP == 0 else None
    ffn = "model" if (cfg.moe is None and cfg.d_ff % TP == 0) else None
    rules: Dict[str, Any] = {
        "batch": dp, "seq": "model", "seq_q": None, "embed": None,
        "embed_rows": None, "embed_cols": "model",
        "heads": heads, "kv_heads": None, "ffn": ffn, "experts": "model",
        "vocab": "model", "kv_seq": "model", "kv_batch": dp, "cand": None,
        "mlp": None, "fields": None, "rows": None,
    }
    if shape.kind == "decode":
        rules["seq"] = None
        if shape["global_batch"] == 1:             # long_500k
            rules["batch"] = None
            rules["kv_batch"] = None
            rules["kv_seq"] = (("pod", "data", "model") if multi_pod
                               else ("data", "model"))
    return rules


def _lm_params(cfg: LMConfig, mesh: DeviceMesh, *, fsdp: bool
               ) -> T.Transformer:
    return _place_named(T.Transformer(cfg, device="meta"),
                        _lm_port_rule(cfg, fsdp=fsdp), mesh)


def _lm_train_loss(cfg: LMConfig) -> Callable:
    def loss_fn(params, batch: dict) -> Tensor:
        return T.train_step_loss(params, cfg, batch["tokens"],
                                 batch["labels"])
    return loss_fn


def build_lm_cell(spec: ArchSpec, shape: ShapeSpec, mesh: DeviceMesh,
                  multi_pod: bool) -> CellBuild:
    # training runs the blockwise attention at the reference's 2048 chunk
    cfg: LMConfig = dataclasses.replace(
        spec.config, attn_chunk=2048 if shape.kind == "train" else 0)
    dp = data_axes(multi_pod)
    rules = lm_rules(cfg, shape, multi_pod)
    # ZeRO-3 over data for training (optimizer state dominates at 104B);
    # serving keeps params TP-sharded + data-replicated (latency path).
    params = _lm_params(cfg, mesh, fsdp=shape.kind == "train")
    b = shape["global_batch"]
    s = shape["seq_len"]
    batch_spec = (dp, None) if b > 1 else (None, None)
    logits_spec = (rules["batch"], None, rules["vocab"])

    if shape.kind == "train":
        step = TrainStep(_lm_train_loss(cfg), AdamW(lr=1e-4))
        state = _train_state(step, params, mesh)
        batch = {"tokens": stand_in((b, s), torch.int32, batch_spec, mesh),
                 "labels": stand_in((b, s), torch.int32, batch_spec, mesh)}
        flops = 6.0 * cfg.n_active_params * b * s
        return CellBuild(step, (params, state, batch), rules, flops,
                         donate=(0, 1), out_specs=((), ()))

    kv_spec = (None, rules["kv_batch"], rules["kv_seq"], None, None)
    if shape.kind == "prefill":
        def prefill(params, tokens):
            return T.prefill(params, cfg, tokens, chunk=4096, impl="cuda")

        args = (params, stand_in((b, s), torch.int32, batch_spec, mesh))
        flops = 2.0 * cfg.n_active_params * b * s
        return CellBuild(prefill, args, rules, flops,
                         out_specs=(logits_spec, kv_spec, kv_spec))

    # decode (decode_32k / long_500k): one token against a full KV cache
    kv_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    dt = getattr(torch, cfg.dtype)
    cache = {"k": stand_in(kv_shape, dt, kv_spec, mesh),
             "v": stand_in(kv_shape, dt, kv_spec, mesh),
             "len": s - 1}
    def decode(params, tokens, cache):
        return T.decode_step(params, cfg, tokens, cache, impl="cuda")

    args = (params, stand_in((b, 1), torch.int32, (rules["batch"], None),
                             mesh), cache)
    # decode step: 2*N_active per token + KV read "flops" are memory-side
    flops = 2.0 * cfg.n_active_params * b
    return CellBuild(decode, args, rules, flops, donate=(2,),
                     notes="serve_step (decode), not train_step",
                     out_specs=(logits_spec,))


# -------------------------------------------------------------------------
# GNN (DimeNet)
# -------------------------------------------------------------------------

def _pad_to(x: int, m: int) -> int:
    return x + (-x) % m


def gnn_cell_dims(shape: ShapeSpec) -> dict:
    """Padded (nodes, edges, triplets, feat, graphs) for a GNN cell."""
    pad = 512  # lcm of both mesh sizes
    if shape.name == "molecule":
        n = shape["batch"] * shape["n_nodes"]
        e = shape["batch"] * shape["n_edges"]
        return dict(nodes=_pad_to(n, pad), edges=_pad_to(e, pad),
                    triplets=_pad_to(4 * e, pad), feat=32,
                    graphs=shape["batch"])
    if shape.name == "minibatch_lg":
        return dict(nodes=_pad_to(shape["sub_nodes"], pad),
                    edges=_pad_to(shape["sub_edges"], pad),
                    triplets=_pad_to(4 * shape["sub_edges"], pad),
                    feat=shape["d_feat"], graphs=1)
    return dict(nodes=_pad_to(shape["n_nodes"], pad),
                edges=_pad_to(shape["n_edges"], pad),
                triplets=_pad_to(4 * shape["n_edges"], pad),
                feat=shape["d_feat"], graphs=1)


def gnn_model_flops(cfg: GNNConfig, dims: dict, train: bool = True) -> float:
    t, e, h, nb = dims["triplets"], dims["edges"], cfg.d_hidden, cfg.n_bilinear
    s = cfg.n_spherical * cfg.n_radial
    per_block = (2.0 * t * (s * nb + nb * h * h + h)    # sbf proj + bilinear
                 + 2.0 * e * h * h * 4)                 # edge MLPs
    fwd = cfg.n_blocks * per_block + 2.0 * e * h * (3 * h)
    return fwd * (3.0 if train else 1.0)


def build_gnn_cell(spec: ArchSpec, shape: ShapeSpec, mesh: DeviceMesh,
                   multi_pod: bool) -> CellBuild:
    cfg: GNNConfig = spec.config
    dims = gnn_cell_dims(shape)
    # replicated node states: every h[edge_src] gather is local to its
    # edge shard
    rules = gnn_rules(multi_pod, replicate_nodes=True)
    every = rules["edges"]
    nodes = rules["nodes"]
    params = _place_named(
        _init_on_meta(DN.init_params, 0, cfg, dims["feat"]),
        lambda k, t: (None,) * t.ndim, mesh)

    n, e, t = dims["nodes"], dims["edges"], dims["triplets"]
    g = GraphBatch(
        node_feat=stand_in((n, dims["feat"]), getattr(torch, cfg.dtype),
                           (nodes, None), mesh),
        edge_src=stand_in((e,), torch.int32, (every,), mesh),
        edge_dst=stand_in((e,), torch.int32, (every,), mesh),
        edge_dist=stand_in((e,), torch.float32, (every,), mesh),
        edge_mask=stand_in((e,), torch.bool, (every,), mesh),
        tri_kj=stand_in((t,), torch.int32, (every,), mesh),
        tri_ji=stand_in((t,), torch.int32, (every,), mesh),
        tri_angle=stand_in((t,), torch.float32, (every,), mesh),
        tri_mask=stand_in((t,), torch.bool, (every,), mesh),
        node_graph=stand_in((n,), torch.int32, (nodes,), mesh),
        n_graphs=dims["graphs"],
    )
    targets = stand_in((dims["graphs"], cfg.d_out), torch.float32,
                       (None, None), mesh)

    def loss_fn(p, batch: dict) -> Tensor:
        return DN.train_step_loss(p, cfg, batch["graph"], batch["y"])
    step = TrainStep(loss_fn, AdamW(lr=1e-4))
    state = _train_state(step, params, mesh)
    return CellBuild(step, (params, state, {"graph": g, "y": targets}),
                     rules, gnn_model_flops(cfg, dims), donate=(0, 1),
                     notes=f"padded dims {dims}", out_specs=((), ()))


# -------------------------------------------------------------------------
# RecSys
# -------------------------------------------------------------------------

def _recsys_param_pspec(key: str, t: Tensor, *, shard_rows: bool = True
                        ) -> tuple:
    nd = t.ndim
    if key.endswith("table") or key.endswith("wide") \
            or key.endswith("item_table"):
        if shard_rows:
            return ("model",) + (None,) * (nd - 1)  # row-sharded tables
        return (None,) * nd  # serving: replicated read-only table
    return (None,) * nd


def recsys_model_flops(cfg: RecsysConfig, batch: int, train: bool) -> float:
    d, f = cfg.embed_dim, cfg.n_sparse
    flops = 0.0
    sizes = (f * d,) + cfg.mlp + (1,)
    flops += 2.0 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    if cfg.interaction == "fm":
        flops += 4.0 * f * d
    elif cfg.interaction == "cin":
        h_prev = f
        for h in cfg.cin_layers:
            flops += 2.0 * h_prev * f * d * (1 + h)
            h_prev = h
    elif cfg.interaction == "self-attn":
        da = cfg.n_heads * cfg.d_attn
        flops += cfg.n_attn_layers * (
            2.0 * f * cfg.embed_dim * da * 4 + 4.0 * f * f * da)
    elif cfg.interaction == "multi-interest":
        flops += cfg.capsule_iters * 4.0 * cfg.n_interests * cfg.hist_len * d
        flops += 4.0 * cfg.n_interests * d   # label-aware scoring per cand
        flops += 2.0 * d * d * 3             # out MLP per interest (coarse)
    return batch * flops * (3.0 if train else 1.0)


_RECSYS_INIT = {"fm": RS.init_deepfm, "cin": RS.init_xdeepfm,
                "self-attn": RS.init_autoint, "multi-interest": RS.init_mind}
_CTR_LOGITS = {"fm": RS.deepfm_logits, "cin": RS.xdeepfm_logits,
               "self-attn": RS.autoint_logits}


def _mind_rerank(params: dict, hist: Tensor, mask: Tensor, cand: Tensor, *,
                 cfg: RecsysConfig) -> Tensor:
    """MIND serving: the users' interests against 1,024 candidates, the
    best interest a candidate (B, C) in float32."""
    u = RS.mind_user_interests(params, cfg, hist, mask)
    c = params["item_table"][cand.long()]
    return torch.einsum("bkd,cd->bkc", u, c).amax(dim=1).float()


def _ctr_logits(params: dict, ids: Tensor, mask: Tensor, *,
                cfg: RecsysConfig) -> Tensor:
    return _CTR_LOGITS[cfg.interaction](params, cfg, ids, mask,
                                        impl="cuda")


def _mind_retrieve(params: dict, hist: Tensor, mask: Tensor,
                   cand: Tensor, *, cfg: RecsysConfig):
    return RS.mind_retrieve(params, cfg, hist, mask, cand, k=100)


def _ctr_topk(params: dict, ids: Tensor, mask: Tensor, *,
              cfg: RecsysConfig, k: int = 100) -> tuple[Tensor, Tensor]:
    """CTR retrieval: the candidates' logits, then the head of a stable
    descending sort (the lower position first on ties, as
    ``jax.lax.top_k``): (scores, int32 positions) of the top k."""
    scores = _ctr_logits(params, ids, mask, cfg=cfg)
    s, i = torch.sort(scores, descending=True, stable=True)
    return s[:k], i[:k].to(torch.int32)


def build_recsys_cell(spec: ArchSpec, shape: ShapeSpec, mesh: DeviceMesh,
                      multi_pod: bool) -> CellBuild:
    cfg: RecsysConfig = spec.config
    rules = recsys_rules(multi_pod)
    dp = data_axes(multi_pod)
    is_mind = cfg.interaction == "multi-interest"
    # training shards table rows (optimizer state scales with rows);
    # serving replicates the read-only table so every lookup is local
    train_cell = shape.name == "train_batch"
    params = _place_named(
        _init_on_meta(_RECSYS_INIT[cfg.interaction], 0, cfg),
        functools.partial(_recsys_param_pspec, shard_rows=train_cell),
        mesh)
    rules = dict(rules, rows="model" if train_cell else None)

    def ctr_args(b, spec_b):
        m = cfg.multi_hot
        return (stand_in((b, cfg.n_sparse, m), torch.int32,
                         (spec_b, None, None), mesh),
                stand_in((b, cfg.n_sparse, m), torch.bool,
                         (spec_b, None, None), mesh))

    if shape.name == "train_batch":
        b = shape["batch"]
        if is_mind:
            n_neg = RS.MIND_NEGATIVES  # shared sampled negatives
            step = TrainStep(RS.mind_train_loss(cfg), AdamW(lr=1e-4))
            batch = {
                "hist": stand_in((b, cfg.hist_len), torch.int32, (dp, None),
                                 mesh),
                "mask": stand_in((b, cfg.hist_len), torch.bool, (dp, None),
                                 mesh),
                "target": stand_in((b,), torch.int32, (dp,), mesh),
                "negs": stand_in((n_neg,), torch.int32, (None,), mesh)}
        else:
            step = TrainStep(RS.ctr_train_loss(cfg, impl="cuda"),
                             AdamW(lr=1e-4))
            ids, mask = ctr_args(b, dp)
            batch = {"ids": ids, "mask": mask,
                     "labels": stand_in((b,), torch.float32, (dp,), mesh)}
        state = _train_state(step, params, mesh)
        return CellBuild(step, (params, state, batch), rules,
                         recsys_model_flops(cfg, b, True), donate=(0, 1),
                         out_specs=((), ()))

    if shape.name in ("serve_p99", "serve_bulk"):
        b = shape["batch"]
        if is_mind:
            n_rerank = 1024
            fn = functools.partial(_mind_rerank, cfg=cfg)
            args = (params,
                    stand_in((b, cfg.hist_len), torch.int32, (dp, None),
                             mesh),
                    stand_in((b, cfg.hist_len), torch.bool, (dp, None),
                             mesh),
                    stand_in((n_rerank,), torch.int32, (None,), mesh))
            notes = "MIND serve = interests + rerank 1024 candidates"
            out_specs = ((dp, None),)
        else:
            fn = functools.partial(_ctr_logits, cfg=cfg)
            args = (params,) + ctr_args(b, dp)
            notes = ""
            out_specs = ((dp,),)
        return CellBuild(fn, args, rules,
                         recsys_model_flops(cfg, b, False), notes=notes,
                         out_specs=out_specs)

    # retrieval_cand: one query against ~1M candidates
    c = RETRIEVAL_CAND_PADDED
    every = ("pod", "data", "model") if multi_pod else ("data", "model")
    rules = dict(rules, cand=every, rows=None,
                 batch=None if is_mind else every)
    if is_mind:
        fn = functools.partial(_mind_retrieve, cfg=cfg)
        args = (params,
                stand_in((1, cfg.hist_len), torch.int32, (None, None), mesh),
                stand_in((1, cfg.hist_len), torch.bool, (None, None), mesh),
                stand_in((c,), torch.int32, (every,), mesh))
        notes = "ANN-free exact max-interest dot over sharded candidates"
        out_specs = ((None, None), (None, None))
    else:
        # CTR retrieval: fixed user fields + per-candidate item fields
        m = cfg.multi_hot
        fn = functools.partial(_ctr_topk, cfg=cfg)
        args = (params,
                stand_in((c, cfg.n_sparse, m), torch.int32,
                         (every, None, None), mesh),
                stand_in((c, cfg.n_sparse, m), torch.bool,
                         (every, None, None), mesh))
        notes = "bulk candidate scoring, batch axis = candidates"
        out_specs = ((None,), (None,))
    return CellBuild(fn, args, rules,
                     recsys_model_flops(cfg, c, False), notes=notes,
                     out_specs=out_specs)


# -------------------------------------------------------------------------
# entry point
# -------------------------------------------------------------------------

def build_cell(spec: ArchSpec, shape: ShapeSpec, mesh: DeviceMesh,
               multi_pod: bool) -> CellBuild:
    if spec.family == "lm":
        return build_lm_cell(spec, shape, mesh, multi_pod)
    if spec.family == "gnn":
        return build_gnn_cell(spec, shape, mesh, multi_pod)
    if spec.family == "recsys":
        return build_recsys_cell(spec, shape, mesh, multi_pod)
    raise ValueError(spec.family)


def input_specs(arch_id: str, shape_name: str, mesh: DeviceMesh,
                multi_pod: bool) -> tuple:
    """The stand-ins of every model input of one cell."""
    from repro_torch.configs.registry import get_arch
    spec = get_arch(arch_id)
    shape = next(s for s in spec.shapes if s.name == shape_name)
    return build_cell(spec, shape, mesh, multi_pod).args
