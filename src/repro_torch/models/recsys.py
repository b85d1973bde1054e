"""Recommenders the port serves: DeepFM, xDeepFM (CIN), AutoInt, MIND.

PyTorch port of `repro.models.recsys`, serving and training.  The CTR
models' shared substrate is one stacked embedding table (total_rows, D)
with per-field offsets (DLRM layout); a request is a (F, M) bag of
globalized ids with a mask, and a batch of requests (B, F, M) goes
through ``*_logits`` as the reference's serving function does
(`repro.launch.specs`, ``serve_p99`` / ``serve_bulk``).  MIND
(arXiv:1904.08030) turns a behavior history (B, H) into K interest
capsules by B2I dynamic routing and scores candidates against them:
`mind_retrieve` ranks up to 10^6 items for a user with one batched
product and the head of a stable descending sort (the lower id first
among equal scores, as ``jax.lax.top_k``).

Parameters are plain dicts of tensors in the reference's layout:
``{"embedding": {"table", "wide"}, "mlp": [{"w", "b"}, ...], ...}``, MLP
weights (in, out) applied as ``x @ w + b``, CIN weights (Hk*m, O).
`repro_torch.interop.recsys_params_from_numpy` carries the reference's
weights across.  `repro_torch.train.optimizer.named_tensors` is a flat
name -> tensor view of such a dict under the reference's pytree paths (``"embedding/table"``,
``"cin/0"``, ``"mlp/1/w"``), sharing its tensors, so `TrainStep`, `AdamW`
and `SGD` update the dict in place; `ctr_train_loss` and
`mind_train_loss` are the reference's ``train_batch`` losses
(`repro.launch.specs`) as `TrainStep` loss functions, and
`mind_negatives` draws MIND's shared negatives from a `torch.Generator`.

Two calls go through hand-written kernels: `embedding_bag` through
`repro_torch.kernels.embedding_bag` (two launches a logits call: the
table and the wide table) and each CIN layer through
`repro_torch.kernels.cin_fuse` (xDeepFM: one launch a layer).  Both sum in
float32, as the Pallas kernels do; the reference's plain-JAX embedding bag
sums in the model's dtype (ROADMAP queue 3), so in bfloat16 the two differ
by more than output rounding.  Under autograd both calls go through the
kernels' `torch.autograd.Function`s (`kernels/*/autograd.py`): the kernel
forward, a plain-PyTorch backward; MIND's row gathers go through
`repro_torch._segment.gather_rows`.  Every gradient on these paths has
the same bits run to run on the card (no float atomics).
``impl="auto"`` takes the kernels for CUDA tensors and the plain
versions for CPU tensors; ``impl="torch"`` forces the plain versions.
The MLPs, the FM term and AutoInt's field attention are plain torch, as
the reference leaves them to XLA; so is all of MIND, which gathers rows
with an index where the reference uses ``jnp.take``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch._segment import gather_rows
from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.cin_fuse import ops as cin_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops

Tensor = torch.Tensor
Seed = Union[int, torch.Generator]

__all__ = ["field_offsets", "padded_rows", "init_embedding", "embedding_bag",
           "init_deepfm", "fm_interaction", "deepfm_logits", "init_xdeepfm",
           "cin_interaction", "xdeepfm_logits", "init_autoint",
           "autoint_logits", "init_mind", "mind_user_interests",
           "mind_train_logits", "mind_retrieve", "mind_topk", "ctr_loss",
           "sampled_softmax_loss", "ctr_train_loss",
           "mind_negatives", "mind_train_loss", "MIND_NEGATIVES"]

MIND_NEGATIVES = 1024     # the reference's train_batch cell: shared negatives


# -------------------------------------------------------------------------
# Embedding substrate
# -------------------------------------------------------------------------

def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.field_vocabs)]).astype(np.int64)


def padded_rows(n: int) -> int:
    """Round table rows up to a multiple of 2048 (the reference shards
    rows)."""
    return n + (-n) % 2048


def _generator(seed: Seed, device: DeviceLike) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(seed)


def _dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
                scale: Optional[float] = None) -> Tensor:
    """The reference's ``_dense_init``: normal x fan_in^-0.5 (fan_in =
    shape[0]) or x ``scale``, drawn in float32 on the generator's device
    and cast."""
    scale = scale if scale is not None else shape[0] ** -0.5
    draw = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    return draw.mul_(scale).to(dtype)


def _dtype(cfg: RecsysConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_embedding(gen: torch.Generator, cfg: RecsysConfig) -> dict:
    dt = _dtype(cfg)
    rows = padded_rows(int(sum(cfg.field_vocabs)))
    return {"table": _dense_init(gen, (rows, cfg.embed_dim), dt, scale=0.01),
            "wide": _dense_init(gen, (rows, 1), dt, scale=0.01)}


def embedding_bag(table: Tensor, ids: Tensor, mask: Tensor, *,
                  impl: str = "auto") -> Tensor:
    """(rows, D) x (B, F, M) multi-hot ids -> (B, F, D) mean-pooled.

    ids are already globalized (field offset added).  Masked mean over the
    bag axis M, any mask — torch.nn.EmbeddingBag(mode='mean') semantics.
    """
    return bag_ops.embedding_bag(table, ids, mask, impl=impl)


def _mlp_init(gen: torch.Generator, sizes, dt: torch.dtype) -> list:
    return [{"w": _dense_init(gen, (a, b), dt),
             "b": torch.zeros((b,), dtype=dt, device=gen.device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp_apply(ws: list, x: Tensor) -> Tensor:
    """ReLU between layers, none after the last."""
    for i, layer in enumerate(ws):
        x = x @ layer["w"] + layer["b"]
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def _wide(params: dict, ids: Tensor, mask: Tensor, impl: str) -> Tensor:
    return embedding_bag(params["embedding"]["wide"], ids, mask,
                         impl=impl).sum(dim=(1, 2))


# -------------------------------------------------------------------------
# DeepFM
# -------------------------------------------------------------------------

def init_deepfm(seed: Seed, cfg: RecsysConfig, *,
                device: DeviceLike = DEFAULT_DEVICE) -> dict:
    gen = _generator(seed, device)
    sizes = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,)
    return {"embedding": init_embedding(gen, cfg),
            "mlp": _mlp_init(gen, sizes, _dtype(cfg))}


def fm_interaction(v: Tensor) -> Tensor:
    """(B, F, D) -> (B,) second-order FM term."""
    s = v.sum(dim=1)
    sq = (v * v).sum(dim=1)
    return 0.5 * (s * s - sq).sum(dim=-1)


def deepfm_logits(params: dict, cfg: RecsysConfig, ids: Tensor,
                  mask: Tensor, *, impl: str = "auto") -> Tensor:
    v = embedding_bag(params["embedding"]["table"], ids, mask, impl=impl)
    wide = _wide(params, ids, mask, impl)
    fm = fm_interaction(v)
    deep = _mlp_apply(params["mlp"], v.reshape(v.shape[0], -1))[:, 0]
    return (wide + fm + deep).float()


# -------------------------------------------------------------------------
# xDeepFM (CIN)
# -------------------------------------------------------------------------

def init_xdeepfm(seed: Seed, cfg: RecsysConfig, *,
                 device: DeviceLike = DEFAULT_DEVICE) -> dict:
    gen = _generator(seed, device)
    dt = _dtype(cfg)
    embedding = init_embedding(gen, cfg)
    sizes = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,)
    mlp = _mlp_init(gen, sizes, dt)
    cin, h_prev = [], cfg.n_sparse
    for h in cfg.cin_layers:
        cin.append(_dense_init(gen, (h_prev * cfg.n_sparse, h), dt))
        h_prev = h
    return {"embedding": embedding, "mlp": mlp, "cin": cin,
            "cin_out": _dense_init(gen, (sum(cfg.cin_layers), 1), dt)}


def cin_interaction(params: dict, cfg: RecsysConfig, v: Tensor, *,
                    impl: str = "auto") -> Tensor:
    """Compressed Interaction Network: (B, F, D) -> (B,).  Each layer is
    one fused kernel call: the (B, Hk, m, D) outer product is never
    materialized on the card."""
    xk, pooled = v, []
    for w in params["cin"]:
        xk = cin_ops.cin_layer(xk, v, w, impl=impl)      # (B, Hk+1, D)
        pooled.append(xk.sum(dim=-1))                    # (B, Hk+1)
    p = torch.cat(pooled, dim=-1)
    return (p @ params["cin_out"])[:, 0]


def xdeepfm_logits(params: dict, cfg: RecsysConfig, ids: Tensor,
                   mask: Tensor, *, impl: str = "auto") -> Tensor:
    v = embedding_bag(params["embedding"]["table"], ids, mask, impl=impl)
    wide = _wide(params, ids, mask, impl)
    cin = cin_interaction(params, cfg, v, impl=impl)
    deep = _mlp_apply(params["mlp"], v.reshape(v.shape[0], -1))[:, 0]
    return (wide + cin + deep).float()


# -------------------------------------------------------------------------
# AutoInt
# -------------------------------------------------------------------------

def init_autoint(seed: Seed, cfg: RecsysConfig, *,
                 device: DeviceLike = DEFAULT_DEVICE) -> dict:
    gen = _generator(seed, device)
    dt = _dtype(cfg)
    embedding = init_embedding(gen, cfg)
    d_attn_total = cfg.n_heads * cfg.d_attn
    layers, d_in = [], cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        layers.append({name: _dense_init(gen, (d_in, d_attn_total), dt)
                       for name in ("wq", "wk", "wv", "w_res")})
        d_in = d_attn_total
    return {"embedding": embedding, "layers": layers,
            "out": _dense_init(gen, (cfg.n_sparse * d_in, 1), dt)}


def autoint_logits(params: dict, cfg: RecsysConfig, ids: Tensor,
                   mask: Tensor, *, impl: str = "auto") -> Tensor:
    x = embedding_bag(params["embedding"]["table"], ids, mask, impl=impl)
    for lp in params["layers"]:
        b, f, _ = x.shape
        q, k, vv = ((x @ lp[name]).reshape(b, f, cfg.n_heads, cfg.d_attn)
                    for name in ("wq", "wk", "wv"))
        att = torch.softmax(torch.einsum("bfhd,bghd->bhfg", q, k)
                            / np.sqrt(cfg.d_attn), dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", att, vv).reshape(b, f, -1)
        x = torch.relu(o + x @ lp["w_res"])
    wide = _wide(params, ids, mask, impl)
    return (wide + (x.reshape(x.shape[0], -1) @ params["out"])[:, 0]
            ).float()


# -------------------------------------------------------------------------
# MIND (multi-interest capsules)
# -------------------------------------------------------------------------

def init_mind(seed: Seed, cfg: RecsysConfig, *,
              device: DeviceLike = DEFAULT_DEVICE) -> dict:
    gen = _generator(seed, device)
    dt, d = _dtype(cfg), cfg.embed_dim
    return {"item_table": _dense_init(gen, (padded_rows(cfg.item_vocab), d),
                                      dt, scale=0.01),
            "bilinear_s": _dense_init(gen, (d, d), dt),
            "out_mlp": _mlp_init(gen, (d, 2 * d, d), dt)}


def _squash(x: Tensor, dim: int = -1) -> Tensor:
    n2 = (x * x).sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_user_interests(params: dict, cfg: RecsysConfig, hist_ids: Tensor,
                        hist_mask: Tensor) -> Tensor:
    """Behavior history (B, H) -> interest capsules (B, K, D).

    B2I dynamic routing: logits b (B, K, H) updated over
    ``capsule_iters`` unrolled iterations; the routing weights receive no
    gradient through the iterations (``detach``, the reference's
    ``stop_gradient``).
    """
    e = gather_rows(params["item_table"], hist_ids)    # (B, H, D)
    e = e * hist_mask[..., None].to(e.dtype)
    es = e @ params["bilinear_s"]                      # shared bilinear map
    mask = hist_mask[:, None, :]
    b = torch.zeros((e.shape[0], cfg.n_interests, e.shape[1]),
                    dtype=torch.float32, device=e.device)
    es_fixed = es.detach()
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=1) * mask             # over capsules
        z = torch.einsum("bkh,bhd->bkd", w.to(es.dtype), es_fixed)
        u = _squash(z)
        b = b + torch.einsum("bkd,bhd->bkh", u, es_fixed).float()
    w = torch.softmax(b, dim=1) * mask
    u = _squash(torch.einsum("bkh,bhd->bkd", w.to(es.dtype), es))
    return _mlp_apply(params["out_mlp"], u)


def _label_aware_logits(u: Tensor, cand: Tensor) -> Tensor:
    """Label-aware attention score of interests u (B, K, D) against
    candidates cand (C, D), without a (B, C, D) attended-user tensor:
    the score <att-weighted u, t> is sum_k att[b,k,c] * <u[b,k], t[c]>."""
    scores = torch.einsum("bkd,cd->bkc", u, cand).float()
    att = torch.softmax(scores ** 2, dim=1)            # pow-2, per paper
    return (att * scores).sum(dim=1)                   # (B, C)


def mind_train_logits(params: dict, cfg: RecsysConfig, hist_ids: Tensor,
                      hist_mask: Tensor, target_ids: Tensor,
                      neg_ids: Optional[Tensor] = None) -> Tensor:
    """Sampled-softmax logits: column 0 the positive, the rest shared
    sampled negatives (B, 1 + N).  With ``neg_ids`` None, in-batch
    negatives (B, B) with the diagonal positive."""
    u = mind_user_interests(params, cfg, hist_ids, hist_mask)
    table = params["item_table"]
    if neg_ids is None:
        return _label_aware_logits(u, gather_rows(table, target_ids))
    pos = gather_rows(table, target_ids)               # (B, D)
    pos_scores = torch.einsum("bkd,bd->bk", u, pos).float()
    pos_att = torch.softmax(pos_scores ** 2, dim=1)
    pos_logit = (pos_att * pos_scores).sum(dim=1, keepdim=True)
    return torch.cat([pos_logit,
                      _label_aware_logits(u, gather_rows(table, neg_ids))],
                     dim=1)


def mind_retrieve(params: dict, cfg: RecsysConfig, hist_ids: Tensor,
                  hist_mask: Tensor, cand_ids: Tensor, k: int = 100
                  ) -> tuple[Tensor, Tensor]:
    """Score users' interests against a candidate set; (scores, int32
    positions in ``cand_ids``) of the top k, (B, k) each.

    ``cand_ids`` (C,) with C up to 10^6: one batched product over the
    candidates in the model's dtype, the best interest a candidate, then
    the head of a stable descending sort (equal scores keep the lower
    position first, as ``jax.lax.top_k``; in bfloat16 many of a million
    scores are equal).
    """
    u = mind_user_interests(params, cfg, hist_ids, hist_mask)
    return mind_topk(params, u, cand_ids, k)


def mind_topk(params: dict, u: Tensor, cand_ids: Tensor, k: int = 100
              ) -> tuple[Tensor, Tensor]:
    """`mind_retrieve`'s ranking half: interests u (B, K, D) against the
    candidates ``cand_ids`` (C,) -> the top-k (scores, int32 positions)."""
    cand = params["item_table"][cand_ids]              # (C, D)
    best = torch.einsum("bkd,cd->bkc", u, cand).amax(dim=1).float()
    s, i = torch.sort(best, dim=-1, descending=True, stable=True)
    return s[:, :k], i[:, :k].to(torch.int32)


# -------------------------------------------------------------------------
# Shared losses and training
# -------------------------------------------------------------------------

def ctr_loss(logits: Tensor, labels: Tensor) -> Tensor:
    """Binary cross-entropy with logits."""
    z = logits.float()
    return torch.mean(torch.clamp_min(z, 0) - z * labels
                      + torch.log1p(torch.exp(-z.abs())))


def sampled_softmax_loss(logits: Tensor, *, inbatch: bool = True) -> Tensor:
    """inbatch=True: (B, B) logits, diagonal positive.  Otherwise (B, 1+N)
    sampled-negative logits with the positive in column 0."""
    logp = torch.log_softmax(logits, dim=-1)
    if inbatch:
        return -torch.diagonal(logp).mean()
    return -logp[:, 0].mean()


_CTR_LOGITS = {"fm": deepfm_logits, "cin": xdeepfm_logits,
               "self-attn": autoint_logits}


def ctr_train_loss(cfg: RecsysConfig, *, impl: str = "auto"):
    """The reference's CTR ``train_batch`` loss as a `TrainStep` loss
    function: ``(params, batch) -> ctr_loss(logits, labels)`` over a
    batch {"ids" (B, F, M), "mask" (B, F, M), "labels" (B,)}, through the
    config's logits function (DeepFM, xDeepFM or AutoInt)."""
    logits = _CTR_LOGITS[cfg.interaction]

    def loss_fn(params: dict, batch: dict) -> Tensor:
        return ctr_loss(logits(params, cfg, batch["ids"], batch["mask"],
                               impl=impl), batch["labels"])
    return loss_fn


def mind_negatives(seed: Seed, cfg: RecsysConfig, n: int = MIND_NEGATIVES,
                   *, device: DeviceLike = DEFAULT_DEVICE) -> Tensor:
    """``n`` shared negative item ids, uniform over ``cfg.item_vocab``,
    int64 on the generator's device (a seed makes a generator on
    ``device``)."""
    gen = _generator(seed, device)
    return torch.randint(0, cfg.item_vocab, (n,), generator=gen,
                         device=gen.device)


def mind_train_loss(cfg: RecsysConfig):
    """The reference's MIND ``train_batch`` loss as a `TrainStep` loss
    function over a batch {"hist" (B, H), "mask" (B, H), "target" (B,)}
    and optionally "negs" (N,): with negatives, the sampled softmax over
    the positive and the shared negatives (``inbatch=False``), without,
    the in-batch softmax.  Like the reference's `TrainStep`, a `TrainStep`
    with microbatches splits every batch entry, "negs" too."""
    def loss_fn(params: dict, batch: dict) -> Tensor:
        negs = batch.get("negs")
        logits = mind_train_logits(params, cfg, batch["hist"],
                                   batch["mask"], batch["target"], negs)
        return sampled_softmax_loss(logits, inbatch=negs is None)
    return loss_fn
